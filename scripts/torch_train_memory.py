#!/usr/bin/env python3
"""Peak device memory and step time of the port's train step, by batch.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_train_memory.py --arch recurrentgemma-2b \
        --seq 512 --batches 8 6 5 4
    python3 scripts/torch_train_memory.py --arch hubert-xlarge \
        --seq 512 --batches 16 12 8
    python3 scripts/torch_train_memory.py --arch internvl2-76b \
        --layers 1 --seq 256 --batches 4 2 1 --factored

For each batch size, from the largest: params drawn on the card from
seed 0 (``init_params(draw_on=)``), a fresh AdamW state (the launcher's
``AdamWConfig(lr=3e-4)``; ``--factored`` keeps Adafactor-style row and
column factors of its second moment, ``factored_second_moment``), then ``--steps`` steps of
``launch.steps.make_train_step`` (kernel on) on the batches of
``launch.train.make_data`` (``batch x seq``: text tokens, audio frames,
or 256 patches before ``seq`` text tokens, by the config's modality),
as ``launch/train.py`` runs them. Prints the card's
name and power limit, then one JSON line a batch: the params' and the
AdamW state's GB, the peak device memory (``max_memory_allocated``)
over the steps, each step's host-clock ms (synchronised) and the loss;
or, where the card runs out of memory, ``"oom": true`` with the peak
reached before it. ``--layers N`` cuts the depth, ``--reduced --device
cpu`` rehearses the control flow on the CPU (no device memory is
read). Imports neither JAX nor the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def gb(tree) -> float:
    from repro_torch.tree import flatten
    return sum(t.numel() * t.element_size() for _, t in flatten(tree)) / 1e9


def run(args, batch: int) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import cosine_warmup

    cuda = args.device != "cpu"
    cfg = configs.get_config(args.arch, reduced=args.reduced,
                             use_kernel=True)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": batch,
           "seq": args.seq, "device": args.device,
           "factored_second_moment": args.factored}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device=args.device,
                            draw_on=args.device)
    opt_cfg = AdamWConfig(lr=3e-4, factored_second_moment=args.factored)
    opt = adamw_init(params, opt_cfg)
    out["param_gb"], out["opt_gb"] = gb(params), gb(opt)
    step = steps.make_train_step(cfg, opt_cfg,
                                 cosine_warmup(3e-4, 2, args.steps))
    data = train.make_data(cfg, argparse.Namespace(
        seq=args.seq, batch=batch, seed=0, data="synthetic"))
    ms, losses = [], []
    try:
        for s in range(args.steps):
            b = train.to_device(data.batch(s), args.device)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b, s)
            losses.append(float(m["loss"]))            # synchronises
            ms.append((time.perf_counter() - t0) * 1e3)
        out.update(step_ms=ms, loss=losses)
    except torch.cuda.OutOfMemoryError as e:
        out.update(oom=True, error=str(e).splitlines()[0], step_ms=ms)
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 6, 5, 4])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--factored", action="store_true",
                    help="AdamW's factored second moment")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device != "cpu":
        import torch
        if not torch.cuda.is_available():
            print("torch_train_memory: no CUDA device", file=sys.stderr)
            return 1
        from repro_torch.kernels import _build
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        _build.build(("linear_attn_scan",))
    for batch in sorted(args.batches, reverse=True):
        print(json.dumps(run(args, batch)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

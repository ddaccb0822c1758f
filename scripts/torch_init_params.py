#!/usr/bin/env python3
"""Time the port's ``lm.init_params`` at full width.

Prints one JSON line: the torch version, the seconds one
``torch.nn.init.trunc_normal_`` call takes over 2^26 f32 elements on the
CPU with a seeded generator (and ``uniform_`` and ``normal_`` beside
it), then the arch's ``init_params`` at its full width and the depth
asked for, drawn on ``--draw-on``: its seconds, parameters, draws per
second, the process's peak host memory (``ru_maxrss``) and, on a card,
the device memory the params take. Run one arch a process, so the peak is that arch's.

    python3 scripts/torch_init_params.py --arch granite-8b
    python3 scripts/torch_init_params.py --arch granite-8b --draw-on cuda
    python3 scripts/torch_init_params.py --arch qwen3-32b --layers 4
    python3 scripts/torch_init_params.py --arch granite-8b --layers 2 \
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _rate(torch, fill, n):
    t = torch.empty(n)
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    fill(t, gen)
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the config's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draw-on", default="cpu",
                    help="the generator's device (init_params' draw_on)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.tree import flatten

    n = 1 << 26
    probe = {
        "trunc_normal_s": _rate(torch, lambda t, g: torch.nn.init
                                .trunc_normal_(t, a=-2.0, b=2.0,
                                               generator=g), n),
        "uniform_s": _rate(torch, lambda t, g: t.uniform_(generator=g), n),
        "normal_s": _rate(torch, lambda t, g: t.normal_(generator=g), n),
        "elements": n}
    cfg = configs.get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    on_card = args.device.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=args.device,
                            draw_on=args.draw_on)
    if on_card:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    count = sum(t.numel() for _, t in flatten(params))
    out = {"torch": torch.__version__, "threads": torch.get_num_threads(),
           "probe": probe, "arch": cfg.name, "n_layers": cfg.n_layers,
           "device": args.device, "draw_on": args.draw_on,
           "init_s": secs, "params": count,
           "draws_per_s": count / secs,
           "peak_host_gb": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss / 1e6,
           "device_gb": (torch.cuda.max_memory_allocated() / 1e9
                         if on_card else None)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

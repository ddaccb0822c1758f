"""Training launcher: a thin CLI over the port's train step, data streams
and checkpoint store.

Runs on the GPU through the hand-written kernels by default
(``--use-kernel``, ``--device cuda``); ``--no-use-kernel`` selects the
plain PyTorch path and ``--device cpu`` runs on the CPU. ``--kernel``
switches the attention: the PRF kinds (the kernel path), or exact
softmax attention and the random and constant baselines, which have no
kernel and run plain PyTorch (the random one draws its logits from a
generator seeded with the step). Checkpoints are
``{"params", "opt"}`` in the reference's layout, so either package can
finetune from the other's. The data follow the config's modality:
masked audio frames (hubert-xlarge), or patch embeddings before
``--seq`` text tokens (internvl2-76b). The mesh flags,
``--simulate-failure-at`` and the supervisor's restart loop wait with
ROADMAP A13.

Examples:
  # smollm-135m at full width on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 200 --batch 8 --seq 512 --ckpt-dir /tmp/ck

  # the paper's qkv-only finetune from that checkpoint
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --finetune-from /tmp/ck --qkv-only

  # exact softmax attention, the paper's pretraining baseline
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --kernel exact --steps 200 --batch 8 --seq 512 --ckpt-dir /tmp/ex

  # the reduced config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --reduced --device cpu --steps 20 --batch 4 --seq 64

  # hubert-xlarge's masked-frame prediction (512 frames a row)
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
      --steps 4 --batch 8 --seq 512
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch import configs as cfgs
from repro_torch.data import (C4Mock, SyntheticAudio, SyntheticLM,
                              SyntheticVLM)
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.schedules import cosine_warmup

KINDS = ("exact", "performer", "darkformer", "lfk", "random", "constant")


def make_data(cfg: lm.ModelConfig, args):
    """The batch stream for ``cfg``'s modality: audio frames, or patches
    and ``args.seq`` text tokens a row (num_patches + seq positions),
    or text from ``args.data``."""
    if cfg.modality == "audio":
        return SyntheticAudio(cfg.d_model, args.seq, args.batch,
                              vocab=cfg.vocab, seed=args.seed)
    if cfg.modality == "vlm":
        return SyntheticVLM(cfg.d_model, cfg.num_patches, args.seq,
                            args.batch, cfg.vocab, seed=args.seed)
    if args.data == "c4mock":
        return C4Mock(cfg.vocab, args.seq, args.batch, seed=args.seed)
    return SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: integer arrays (tokens,
    labels) as int64, frames and patches f32, the audio mask bool."""
    def one(a):
        t = torch.from_numpy(a)
        if not (t.is_floating_point() or t.dtype == torch.bool):
            t = t.long()
        return t.to(device)
    return {k: one(v) for k, v in batch.items()}


def main(argv=None, on_step: Optional[Callable[[int], None]] = None) -> dict:
    """Train and print a line per logged step. Returns {"params", "opt",
    "metrics" (the logged steps' metrics, each with its "ms"), "config"}.
    ``on_step`` is called with the step's index after each step (a
    profiler's step hook)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(cfgs.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--kernel", default=None, choices=KINDS,
                    help=f"override the attention kernel "
                         f"({'|'.join(KINDS)})")
    ap.add_argument("--features", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "c4mock"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--finetune-from", default=None,
                    help="checkpoint dir with pretrained params")
    ap.add_argument("--qkv-only", action="store_true",
                    help="paper Fig. 4: train only q/k/v + PRF covariance")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--use-kernel", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="run causal attention through the CUDA kernel "
                         "(on a CPU device its plain version); "
                         "--no-use-kernel selects the plain PyTorch path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = cfgs.get_config(args.arch, reduced=args.reduced)
    if args.kernel:
        cfg = cfgs.darkify(cfg, args.kernel,
                           args.features or cfg.attn.num_features)
    cfg = dataclasses.replace(cfg, use_kernel=args.use_kernel)

    params = lm.init_params(cfg, seed=args.seed, device=args.device)
    if args.finetune_from:
        # checkpoints hold {"params", "opt"}: restore the params only, the
        # finetune starts a fresh optimizer
        wrapped, step0 = ckpt_lib.restore_checkpoint(args.finetune_from,
                                                     {"params": params})
        params = wrapped["params"]
        print(f"finetuning from {args.finetune_from} @ step {step0}")
    opt_cfg = AdamWConfig(lr=args.lr)
    opt_state = adamw_init(params, opt_cfg)
    train_step = steps_lib.make_train_step(
        cfg, opt_cfg, cosine_warmup(args.lr, args.warmup, args.steps),
        steps_lib.qkv_only_freeze if args.qkv_only else None)
    data = make_data(cfg, args)

    metrics_log = []
    t_start = time.perf_counter()
    for step in range(args.steps):
        batch = to_device(data.batch(step), args.device)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                step)
        last = step == args.steps - 1
        if step % args.log_every == 0 or last:
            m = {k: float(v) for k, v in metrics.items()}   # synchronises
            m["step"] = step
            m["ms"] = (time.perf_counter() - t0) * 1e3
            metrics_log.append(m)
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"acc {m['accuracy']:.4f} gnorm {m['grad_norm']:.3f} "
                  f"{m['ms']:.1f} ms", flush=True)
        if args.ckpt_dir and (step % args.ckpt_every == args.ckpt_every - 1
                              or last):
            ckpt_lib.save_checkpoint(args.ckpt_dir, step,
                                     {"params": params, "opt": opt_state})
        if on_step is not None:
            on_step(step)
    dt = time.perf_counter() - t_start
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_log, f, indent=1)
    return {"params": params, "opt": opt_state, "metrics": metrics_log,
            "config": cfg}


if __name__ == "__main__":
    main()

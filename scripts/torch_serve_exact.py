#!/usr/bin/env python3
"""Exact softmax attention against the darkformer kernels on the same
traffic, in turns.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_serve_exact.py            # smollm-135m, 3 turns

Serves ``chip_smoke.py`` phase 3's traffic (smollm-135m at full width,
random weights from seed 0; 16 requests of 64-512 prompt and 32-64 new
tokens, all at 0; 8 slots, max_len 1024, chunk_tokens 256) through the
overlapped ``ServingEngine``, the serve CLI's default, with darkformer
attention (B1/B2; ``dark``) and with exact softmax attention over a
per-slot KV cache (no kernel; ``exact``) in turns: dark, exact, exact,
dark, ... (``--turns``), each run on a fresh engine after one warm-up
engine per kind. Every run prints one JSON line with its kind: wall,
throughput, TTFT p50, TPOT p50 and p99, decode stall and dispatch
depth, steps (``scripts/torch_serve_overlap.py``'s ``run``). Then,
unless ``--no-profile``, one profiled run of each kind: the device's busy ms over the run's wall,
its idle share and kernel launches per decode step. Prints the card's
name and power limit first. ``--reduced --device cpu`` rehearses the
control flow on the CPU, where no device time exists. Imports neither
JAX nor the reference.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

from torch_serve_overlap import run  # noqa: E402


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=3,
                    help="rounds of (dark, exact, exact, dark)")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the profiled run of each kind")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_serve_exact: no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)

    from repro_torch import configs
    from repro_torch.models import lm
    dark = configs.get_config("smollm-135m", reduced=args.reduced,
                              use_kernel=True)
    models = {}
    for kind, cfg in (("dark", dark),
                      ("exact", configs.darkify(dark, "exact"))):
        models[kind] = (lm.init_params(cfg, seed=0, device=dev), cfg)
    for kind in models:                        # warm-up, one each
        run(torch, *models[kind], dev, overlap=True)
    for _ in range(args.turns):
        for kind in ("dark", "exact", "exact", "dark"):
            print(json.dumps({"kind": kind, **run(
                torch, *models[kind], dev, overlap=True)}), flush=True)
    for kind in () if args.no_profile else models:
        print(json.dumps({"kind": kind, **run(
            torch, *models[kind], dev, overlap=True, profiled=True)}),
            flush=True)
    print(json.dumps({"device": (torch.cuda.get_device_name(0)
                                 if dev.type == "cuda" else "cpu")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

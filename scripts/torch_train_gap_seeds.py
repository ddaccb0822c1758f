#!/usr/bin/env python3
"""Phase 6 of ``chip_smoke.py`` over several seeds, on one GPU.

    python3 scripts/torch_train_gap_seeds.py [--src DIR] [--seeds 0 1 2 3]
        [--arch smollm-135m|hubert-xlarge]

For each seed, the parameters and the batch are drawn from it, and one
loss and all its gradients of smollm-135m (full width, 4 layers, bf16,
batch 2 x 256) are computed on the card through the B5 kernel and on the
CPU through the plain path (``chip_smoke.phase_train_cross_device``);
with ``--arch hubert-xlarge``, phase 11 (b)'s check instead
(``chip_smoke.hubert_cross_device``: 2 layers, a 2 x 256 SyntheticAudio
batch, in bf16 and f32, no kernel on either side, then the
calibration).
Prints the card's name and power limit, then the phase's JSON line for
each seed: the loss gap and the gradient gap beside their limits, and a
planted fault's gaps. ``--src`` takes the ``repro_torch`` package from
another tree's ``src`` (an unpacked earlier commit, say), so two versions
of the kernel can be held to the same seeds on one card. Exits non-zero
without a CUDA device or when a seed's gaps exceed the limits.
"""
from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None,
                    help="the src directory whose repro_torch is run")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--arch", default="smollm-135m",
                    choices=["smollm-135m", "hubert-xlarge"])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke                   # puts this tree's src on the path
    if args.src is not None:
        sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_train_gap_seeds: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import linear_attn_scan as kl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    print(f"src: {Path(kl.__file__).resolve()}", flush=True)
    dev = torch.device("cuda")
    failed = []
    for seed in args.seeds:
        try:
            if args.arch == "hubert-xlarge":
                counters = {n: (importlib.import_module(
                    f"repro_torch.kernels.{m}"), attr) for n, (m, attr, _, _)
                    in chip_smoke.KERNELS.items()}
                fields, check = chip_smoke.hubert_cross_device(
                    torch, dev, counters, seed=seed)
                chip_smoke.emit({"phase": "hubert_cross_device", **fields})
                check()
            else:
                chip_smoke.phase_train_cross_device(torch, dev, kl,
                                                    seed=seed)
        except SystemExit as e:       # chip_smoke.fail: go on to the next
            print(e, flush=True)
            failed.append(seed)
    if failed:
        print(f"torch_train_gap_seeds: seeds {failed} failed",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

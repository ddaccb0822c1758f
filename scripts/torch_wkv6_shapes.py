#!/usr/bin/env python3
"""Time the port's RWKV-6 WKV kernel (B7, ``wkv6``) on one GPU.

    python3 scripts/torch_wkv6_shapes.py [--src DIR]

Prints the card's name and power limit (nvidia-smi), the ptxas report
(registers, spills) of ``wkv6_scan``, then one JSON line a shape
(:data:`SHAPES`): card ms (CUDA events), device ms (profiler), plain ms,
the bound, max(bytes / 3.35 TB/s, operations / 67 TFLOP/s of f32), and
the bytes and operations it counts (``chip_smoke.wkv6_timing``).

``--src`` takes the ``repro_torch`` package from another tree's ``src``
(an unpacked earlier commit, say), so two versions of the kernel can be
timed on one card, in turns. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (name, rows, L, dh, dtype) at the rwkv6-7b geometry (64 heads, dh 64): a
# batch of 8 prompts being prefilled, one long prompt, and the batch in
# bf16
SHAPES = (
    ("rwkv6-7b batch 8", 512, 512, 64, "float32"),
    ("rwkv6-7b one long prompt", 64, 4096, 64, "float32"),
    ("rwkv6-7b batch 8", 512, 512, 64, "bfloat16"),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None,
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke                   # puts this tree's src on the path
    if args.src is not None:
        sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_wkv6_shapes: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv6_scan as kw

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build_s = _build.build(("wkv6_scan",))
    print("\n".join(ln.strip() for ln in
                    _build.build_log("wkv6_scan").splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln), flush=True)
    print(json.dumps({"src": str(Path(kw.__file__).resolve()),
                      "card": card, "build_s": build_s}), flush=True)
    for name, n, l, dh, dt in SHAPES:
        timing = chip_smoke.wkv6_timing(torch, dev, kw, n, l, dh,
                                        getattr(torch, dt))
        print(json.dumps({"kernel": "wkv6", "config": name, "card": card,
                          **timing}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

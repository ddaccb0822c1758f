#!/usr/bin/env python3
"""Time the port's PRF feature-map kernel (B6, ``prf_featmap``) on one GPU.

    python3 scripts/torch_featmap_shapes.py [--src DIR]

Prints the card's name and power limit (nvidia-smi), the ptxas report
(registers, spills) of ``prf_featmap``, the number of TF32 tensor-core
instructions (mma.sync's ``HMMA`` and wgmma's ``HGMMA`` in ``cuobjdump
-sass`` of the built library) in each of its kernels, then one JSON line a shape (:data:`SHAPES`): card
ms (CUDA events), device ms (profiler), plain ms and both bounds, at the
TF32 rate and at f32's (``chip_smoke.featmap_timing``). A tree whose kernel refuses a shape
(the kernel before the redesign raised ``ValueError`` above the
shared memory a block may use) gets a line with ``raised`` and the
message.

``--src`` takes the ``repro_torch`` package from another tree's ``src``
(an unpacked earlier commit, say), so two versions of the kernel can be
timed on one card, in turns. Exits non-zero without a CUDA device, and,
for this tree's kernel, when a shape raises or a kernel has no TF32
tensor-core instruction.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (name, rows, d, r, m, dark, x dtype): smollm-135m's training batch (8 x
# 512 tokens, 9 query heads) at d_head 64, dark with f32 and bf16 x and
# isotropic; the same rows at d_head 128; darkformer-2b's (8 heads) at
# d_head 256, f32 and bf16 x
SHAPES = (
    ("smollm-135m", 36_864, 64, 64, 256, True, "float32"),
    ("smollm-135m", 36_864, 64, 64, 256, True, "bfloat16"),
    ("smollm-135m", 36_864, 64, 64, 256, False, "float32"),
    ("d_head 128", 36_864, 128, 128, 256, True, "float32"),
    ("darkformer-2b", 32_768, 256, 256, 256, True, "float32"),
    ("darkformer-2b", 32_768, 256, 256, 256, True, "bfloat16"),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None,
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke                   # puts this tree's src on the path
    from torch_lin_attn_shapes import hmma_counts
    if args.src is not None:
        sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_featmap_shapes: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import prf_featmap as kf

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build_s = _build.build(("prf_featmap",))
    print("\n".join(ln.strip() for ln in
                    _build.build_log("prf_featmap").splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln), flush=True)
    hmma = hmma_counts(_build.library_path("prf_featmap"))
    print(json.dumps({"src": str(Path(kf.__file__).resolve()),
                      "card": card, "build_s": build_s,
                      "tf32_hmma_by_kernel": hmma}), flush=True)
    raised = []
    for name, n, d, r, m, dark, dt in SHAPES:
        try:
            timing = chip_smoke.featmap_timing(
                torch, dev, kf, n, d, r, m, dark, getattr(torch, dt))
        except ValueError as e:
            raised.append(name)
            timing = {"shape": f"N={n} d={d} r={r} m={m} dark={dark} x={dt}",
                      "raised": str(e)}
        print(json.dumps({"kernel": "prf_featmap", "config": name,
                          "card": card, **timing}), flush=True)
        torch.cuda.empty_cache()
    if args.src is None:
        if raised:
            print(f"torch_featmap_shapes: raised at {raised}",
                  file=sys.stderr)
            return 1
        if not hmma or not all(hmma.values()):
            print(f"torch_featmap_shapes: no TF32 MMA in {hmma}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the port's fused decode kernel (B1, ``prf_fused_decode``) at the
engine's active-slot counts on one GPU.

    python3 scripts/torch_decode_rows.py [--src DIR]

Prints the card's name and power limit (nvidia-smi), the kernel's ptxas
report (registers, spills), then two JSON lines: for B = 1, 2, 4 and 8
active slots of smollm-135m (bf16 q/k/v, f32 state) the kernel's time
with CUDA events and on the device, cold (a call per pool over 30 or
more independent pools, as a decode step's layers meet them) and warm
(one pool), its plain version's time and its bound
(``chip_smoke.decode_row_timing``); then the device time of each launch
of a call, cold (``chip_smoke.device_ms_by_kernel``). ``--src`` takes
the ``repro_torch`` package from another tree's ``src`` (an unpacked
earlier commit, say), so two versions of the kernel can be timed on one
card, in turns. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = (1, 2, 4, 8)


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
        print("torch_decode_rows: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import prf_fused_decode as kd

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build_s = _build.build(("prf_fused_decode",))
    print("\n".join(ln.strip() for ln in
                    _build.build_log("prf_fused_decode").splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln), flush=True)
    timing = {f"B={b}": chip_smoke.decode_row_timing(torch, dev, kd, b)
              for b in ROWS}
    print(json.dumps({"src": str(Path(kd.__file__).resolve()),
                      "card": card, "build_s": build_s, **timing}),
          flush=True)
    by_launch = {}
    for b in ROWS:
        turn = itertools.cycle(chip_smoke.decode_pools(torch, dev, b))
        by_launch[f"B={b}"] = chip_smoke.device_ms_by_kernel(
            torch, lambda: kd.fused_prf_decode(*next(turn), eps=1e-8), 200)
    print(json.dumps({"device_ms_by_kernel_cold": by_launch}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

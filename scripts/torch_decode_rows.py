#!/usr/bin/env python3
"""Time the port's one-token decode kernels at the engine's active-slot
counts on one GPU: B1 (``prf_fused_decode``, the fused path) and B3
(``prf_decode_step``, the two-stage path).

    python3 scripts/torch_decode_rows.py [--kernel b1|b3|both] [--src DIR]

Prints the card's name and power limit (nvidia-smi) and each kernel's
ptxas report (registers, spills), then for each kernel two JSON lines:
its time with CUDA events and on the device, cold (a call per pool over
30 or more independent pools, as a decode step's layers meet them) and
warm (one pool), its plain version's time and its bound; then the device
time of each launch of a call, cold (``chip_smoke.device_ms_by_kernel``).
B1 at 1, 2, 4 and 8 active slots of smollm-135m (bf16 q/k/v, f32 state;
``chip_smoke.decode_row_timing``); B3 at the same slots and at 1 and 8
slots of darkformer-2b's heads (bf16 v, f32 features and state;
``chip_smoke.decode_step_timing``). ``--src`` takes the ``repro_torch``
package from another tree's ``src`` (an unpacked earlier commit, say),
so two versions of a kernel can be timed on one card, in turns; a B3
that takes only f32 v is timed with v cast first inside the timed call,
as its call site cast it. Exits non-zero without a CUDA device.
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
# B3's shapes: (key, slots, G, Hg, dv), smollm-135m's heads, then
# darkformer-2b's
STEP_SHAPES = (*((f"B={b}", b, 3, 3, 64) for b in ROWS),
               *((f"darkformer-2b B={b}", b, 1, 8, 256) for b in (1, 8)))


def takes_bf16_v(torch, kds) -> bool:
    """Whether this tree's B3 wrapper takes bf16 v (a tiny CPU call)."""
    args = [torch.ones(1, 4), torch.ones(1, 4), torch.ones(1, 4,
            dtype=torch.bfloat16), torch.zeros(1, 4, 4), torch.ones(1, 4),
            torch.ones(1)]
    try:
        kds.linear_attention_decode_step(*args)
    except TypeError:
        return False
    return True


def report(_build, name: str) -> None:
    print("\n".join(ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("b1", "b3", "both"), default="both")
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
    from repro_torch.kernels import prf_decode_step as kds
    from repro_torch.kernels import prf_fused_decode as kd

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    names = {"b1": ("prf_fused_decode",), "b3": ("prf_decode_step",),
             "both": ("prf_fused_decode", "prf_decode_step")}[args.kernel]
    build_s = _build.build(names)
    for name in names:
        report(_build, name)
    if "prf_fused_decode" in names:
        timing = {f"B={b}": chip_smoke.decode_row_timing(torch, dev, kd, b)
                  for b in ROWS}
        print(json.dumps({"kernel": "prf_fused_decode",
                          "src": str(Path(kd.__file__).resolve()),
                          "card": card, "build_s": build_s, **timing}),
              flush=True)
        by_launch = {}
        for b in ROWS:
            turn = itertools.cycle(chip_smoke.decode_pools(torch, dev, b))
            by_launch[f"B={b}"] = chip_smoke.device_ms_by_kernel(
                torch, lambda: kd.fused_prf_decode(*next(turn), eps=1e-8),
                200)
        print(json.dumps({"kernel": "prf_fused_decode",
                          "device_ms_by_kernel_cold": by_launch}),
              flush=True)
    if "prf_decode_step" in names:
        bf16_v = takes_bf16_v(torch, kds)

        def call(a):
            qf, kf, v, s, z, rho = a
            if not bf16_v:              # the cast its call site made
                v = v.float().contiguous()
            return kds.linear_attention_decode_step(qf, kf, v, s, z, rho,
                                                    eps=1e-8)
        timing = {key: chip_smoke.decode_step_timing(torch, dev, kds, b, g,
                                                     hg, dv, call)
                  for key, b, g, hg, dv in STEP_SHAPES}
        print(json.dumps({"kernel": "prf_decode_step",
                          "src": str(Path(kds.__file__).resolve()),
                          "takes_bf16_v": bf16_v, "card": card,
                          "build_s": build_s, **timing}), flush=True)
        by_launch = {}
        for key, b, g, hg, dv in STEP_SHAPES:
            turn = itertools.cycle(
                chip_smoke.decode_step_pools(torch, dev, b, g, hg, dv))
            by_launch[key] = chip_smoke.device_ms_by_kernel(
                torch, lambda: call(next(turn)), 200)
        print(json.dumps({"kernel": "prf_decode_step",
                          "device_ms_by_kernel_cold": by_launch}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

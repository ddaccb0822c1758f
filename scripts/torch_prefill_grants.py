#!/usr/bin/env python3
"""Time the port's fused prefill kernel (B2, ``prf_fused_prefill``) at the
serving packer's four grant shapes on one GPU.

    python3 scripts/torch_prefill_grants.py [--src DIR]

Prints the card's name and power limit (nvidia-smi), the kernel's ptxas
report (registers, spills), then two JSON lines: for each grant (8 x 32,
4 x 64, 2 x 128 and 1 x 256 tokens of smollm-135m, bf16) the kernel's time
with CUDA events and on the device, its plain version's time and its
bound (``chip_smoke.prefill_grant_timing``); then the device time of each
kernel a call launches (the profiler's intervals summed by kernel name).
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
        print("torch_prefill_grants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import prf_fused_prefill as kp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build_s = _build.build(("prf_fused_prefill",))
    print("\n".join(ln.strip() for ln in
                    _build.build_log("prf_fused_prefill").splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln), flush=True)
    timing = chip_smoke.prefill_grant_timing(torch, dev, kp)
    print(json.dumps({"src": str(Path(kp.__file__).resolve()),
                      "card": card, "build_s": build_s, **timing}),
          flush=True)
    print(json.dumps({"device_ms_by_kernel": by_kernel(torch, dev, kp)}),
          flush=True)
    return 0


def by_kernel(torch, dev, kp, iters=20):
    """Device ms per call of each kernel (and memset) that one B2 call
    launches, at each grant (``chip_smoke.device_ms_by_kernel``)."""
    import chip_smoke
    from repro_torch.kernels import check as kc

    out = {}
    for b, l in chip_smoke.GRANTS:
        args = kc.make_inputs(dev, b, 3, 3, 64, 256, 64, l, True, seed=8,
                              dtype=torch.bfloat16)
        vl = torch.full((b,), l, dtype=torch.int32, device=dev)
        out[f"{b}x{l}"] = chip_smoke.device_ms_by_kernel(
            torch, lambda: kp.fused_prf_prefill(*args, vl, eps=1e-8), iters)
    return out


if __name__ == "__main__":
    sys.exit(main())

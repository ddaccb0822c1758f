#!/usr/bin/env python3
"""Time the port's causal linear-attention kernel (B5,
``linear_attention_causal``) and its carried scan (B4) on one GPU.

    python3 scripts/torch_lin_attn_shapes.py [--src DIR]

Prints the card's name and power limit (nvidia-smi), the ptxas report
(registers, spills) of ``linear_attn_scan``, the number of TF32
tensor-core instructions (``HMMA.1688.F32.TF32`` in ``cuobjdump -sass``
of the built library) in each of its kernels, then one JSON line a
shape:

- B5 forward at the smollm-135m training geometry (B 8, G 3, Hg 3, m 256,
  dv 64) at L = 256, 512, 1024 and 2048, bf16 and f32 v, and at
  darkformer-2b's (B 8, G 1, Hg 8, m 256, dv 256, L 512): card ms (CUDA
  events), device ms, device ms of each launch, plain ms and both bounds
  (``chip_smoke.lin_attn_timing``);
- B4 at the packer's four grants at smollm-135m's heads and at
  darkformer-2b's at 8 x 32 and 1 x 256 (``chip_smoke.CARRY_SHAPES``),
  bf16 v, with a ρ < 1 per query row and without: card ms, device ms,
  device ms of each launch, plain ms and both bounds
  (``chip_smoke.carry_times``; a tree whose wrapper takes no ρ gets the
  pool scaled first by two ``mul_`` passes inside the timed call, as its
  call site did).

``--src`` takes the ``repro_torch`` package from another tree's ``src``
(an unpacked earlier commit, say), so two versions of the kernels can be
timed on one card, in turns; ``--b4-only`` skips B5. Exits non-zero
without a CUDA device, and, for this tree's kernels, when a B5 or B4
kernel that multiplies has no TF32 tensor-core instruction.
"""
from __future__ import annotations

import argparse
import collections
import inspect
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TRAIN_LENGTHS = (256, 512, 1024, 2048)
# the kernels that run matrix products (B5's scan launch and B4's final
# one run none)
PRODUCT_KERNELS = ("chunk_delta_kernel", "causal_out_kernel",
                   "carry_prefix_kernel", "carry_out_kernel")


def hmma_counts(lib: Path) -> dict:
    """TF32 tensor-core instructions (mma.sync's HMMA and wgmma's HGMMA)
    in each kernel of ``lib``'s SASS, by its mangled name."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = collections.Counter()
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] += 0
        elif name is not None and "MMA" in line and ".TF32" in line:
            counts[name] += 1
    return dict(counts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None,
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--b4-only", action="store_true",
                    help="time B4 alone")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke                   # puts this tree's src on the path
    if args.src is not None:
        sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_lin_attn_shapes: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import check as kc
    from repro_torch.kernels import linear_attn_scan as kl

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build_s = _build.build(("linear_attn_scan",))
    print("\n".join(ln.strip() for ln in
                    _build.build_log("linear_attn_scan").splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln), flush=True)
    hmma = hmma_counts(_build.library_path("linear_attn_scan"))
    print(json.dumps({"src": str(Path(kl.__file__).resolve()),
                      "card": card, "build_s": build_s,
                      "tf32_hmma_by_kernel": hmma}), flush=True)

    def emit(kernel, timing, fn):
        timing["device_ms_by_kernel"] = chip_smoke.device_ms_by_kernel(
            torch, fn, 10)
        print(json.dumps({"kernel": kernel, "card": card, **timing}),
              flush=True)

    def b5(b, g, hg, l, m, dv, dt):
        args = kc.make_lin_attn_inputs(dev, b, g, hg, l, m, dv, seed=11,
                                       dtype=dt)
        with torch.no_grad():
            emit("linear_attention_causal",
                 chip_smoke.lin_attn_timing(torch, dev, kl, b, g, hg, l, m,
                                            dv, dt),
                 lambda: kl.linear_attention_causal(*args, eps=1e-8))

    if not args.b4_only:
        for l in TRAIN_LENGTHS:
            for dt in (torch.bfloat16, torch.float32):
                b5(8, 3, 3, l, 256, 64, dt)
        b5(8, 1, 8, 512, 256, 256, torch.float32)     # darkformer-2b

    takes_rho = "rho" in inspect.signature(
        kl.linear_attention_prefill_chunk).parameters

    def b4_scaled_first(b, l, g, hg, dv, rho):
        # a wrapper without ρ: the pool scaled in place before the kernel,
        # inside the timed call, with ρ drawn as check.make_carry_rho draws
        # it (that tree's check lacks it)
        carry = kc.make_carry_inputs(dev, b, g, hg, 1, l, 256, dv, seed=14,
                                     dtype=torch.bfloat16)
        s0, z0 = carry[3], carry[4]
        r = torch.tensor(np.exp(-np.random.default_rng(14).exponential(
            size=(b, g, hg))), dtype=torch.float32, device=dev) if rho \
            else None

        def call():
            if r is not None:
                s0.mul_(r[..., None, None])
                z0.mul_(r[..., None])
            return kl.linear_attention_prefill_chunk(*carry, eps=1e-8)
        return chip_smoke.carry_times(
            torch, carry, call,
            lambda: kl.linear_attention_carry_plain(*carry, 1e-8), r,
            by_kernel=True)

    for _, b, l, g, hg, dv in chip_smoke.CARRY_SHAPES:
        for rho in (True, False):
            timing = (chip_smoke.carry_timing(torch, dev, kl, b, l, g, hg,
                                              dv, rho, by_kernel=True)
                      if takes_rho else b4_scaled_first(b, l, g, hg, dv, rho))
            print(json.dumps({"kernel": "linear_attention_carry",
                              "card": card, **timing}), flush=True)
    if args.src is None:
        missing = [k for k, n in hmma.items()
                   if n == 0 and any(p in k for p in PRODUCT_KERNELS)]
        if missing or not all(any(p in k for k in hmma)
                              for p in PRODUCT_KERNELS):
            print(f"torch_lin_attn_shapes: no TF32 HMMA in {missing or hmma}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

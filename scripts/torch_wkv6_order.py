#!/usr/bin/env python3
"""How far B7 (``wkv6``) lies from its mirrored order and from its plain
version, on one GPU.

    python3 scripts/torch_wkv6_order.py

For each case of ``tests/test_torch_cuda.py::
test_wkv6_kernel_follows_its_stepped_order`` (same inputs), prints the
max abs difference of the kernel's output from ``check.wkv6_stepped``
(its order of f32 operations, with the tile ``check.wkv6_tile`` gives
for this card) and from ``wkv6_plain`` (another order of the same
sums), beside that test's tolerance: what shows that the tolerance
tells the two orders apart. Prints the card's name and power limit
first. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (rows, L, dh): every tile the kernel has, its columns split or not
CASES = ((3, 300, 4), (4, 77, 32), (160, 64, 64), (16, 300, 64),
         (64, 1000, 64), (256, 64, 100), (512, 64, 128))
ORDER_RTOL = 2 ** -25         # the test's, of the largest output


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_wkv6_order: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import check
    from repro_torch.kernels import wkv6_scan as kw

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, l, dh in CASES:
        args = check.make_wkv6_inputs(dev, n, l, dh, seed=n + l + dh,
                                      decays="model")
        with torch.no_grad():
            got = kw.wkv6(*args)
            mirror = check.wkv6_stepped(*args, sms)
            plain = kw.wkv6_plain(*args)
        print(json.dumps({
            "rows": n, "L": l, "dh": dh,
            "tile": check.wkv6_tile(n, dh, sms),
            "vs_mirror": (got - mirror).abs().max().item(),
            "bitwise": bool(torch.equal(got, mirror)),
            "vs_plain": (got - plain).abs().max().item(),
            "tolerance": ORDER_RTOL * mirror.abs().max().item()}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and nvcc; every test here is marked ``cuda`` and
skips without a device. The file imports neither JAX nor the reference
package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Inputs and tolerances come from ``repro_torch.kernels.check``, which
``chip_smoke.py`` uses too.
"""
import pytest
import torch

from repro_torch.kernels import check
from repro_torch.kernels import prf_fused_decode as kd
from repro_torch.kernels import prf_fused_prefill as kp


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,hg,d,m,dv,dark,stab", [
    (8, 3, 3, 64, 256, 64, True, True),       # smollm-135m heads
    (8, 3, 3, 64, 256, 64, False, False),
    (4, 1, 8, 256, 256, 256, True, True),     # darkformer-2b heads
    (3, 2, 2, 16, 32, 16, True, False),
])
def test_decode_kernel_matches_plain(dev, b, g, hg, d, m, dv, dark, stab):
    args = check.make_inputs(dev, b, g, hg, d, m, dv, None, dark, seed=b + m)
    check.check_case("decode", kd, kd.fused_prf_decode,
                     kd.prf_fused_decode_plain, args, stabilize=stab)


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,hg,d,m,dv,l,dark,stab,valid_len", [
    (8, 3, 3, 64, 256, 64, 512, True, True,
     (512, 0, 300, 257, 256, 1, 511, 100)),
    (8, 3, 3, 64, 256, 64, 32, False, False, None),
    (4, 1, 8, 256, 256, 256, 300, True, True, (300, 0, 299, 17)),
    (3, 2, 2, 16, 32, 16, 20, True, False, (20, 5, 0)),
])
def test_prefill_kernel_matches_plain(dev, b, g, hg, d, m, dv, l, dark,
                                      stab, valid_len):
    args = check.make_inputs(dev, b, g, hg, d, m, dv, l, dark, seed=b + l)
    vl = (None if valid_len is None
          else torch.tensor(valid_len, dtype=torch.int32, device=dev))
    check.check_case("prefill", kp, kp.fused_prf_prefill,
                     kp.prf_fused_prefill_plain, args, vl, stabilize=stab)


@pytest.mark.cuda
def test_bf16_inputs_match_plain(dev):
    """The main path's input type: bf16 q/k/v, f32 state."""
    args = check.make_inputs(dev, 8, 3, 3, 64, 256, 64, 32, True, 1,
                             torch.bfloat16)
    vl = torch.tensor([32, 20, 1, 32, 7, 32, 32, 9], dtype=torch.int32,
                      device=dev)
    exp = kp.prf_fused_prefill_plain(*check.clone(args), vl, eps=1e-8)
    got = kp.fused_prf_prefill(*args, vl, eps=1e-8)
    assert got[0].dtype == torch.bfloat16
    # bf16 outputs within check.BF16_OUT_TOL, the state within F32_TOL
    check.max_error("prefill bf16", got, exp, vl)

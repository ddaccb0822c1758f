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
from repro_torch.kernels import linear_attn_scan as kl
from repro_torch.kernels import prf_featmap as kf
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,hg,l,m,dv,dtype", [
    (8, 3, 3, 512, 256, 64, torch.bfloat16),  # smollm-135m training
    (2, 3, 3, 777, 256, 64, torch.float32),   # ragged last chunk
    (2, 1, 8, 100, 256, 256, torch.float32),  # darkformer-2b heads
    (3, 2, 2, 1, 32, 16, torch.float32),      # one token
    (1, 2, 3, 256, 32, 80, torch.bfloat16),   # one full chunk, dv > 64
])
def test_linear_attention_kernel_matches_plain(dev, b, g, hg, l, m, dv,
                                               dtype):
    """B5 forward and gradients against autograd of its plain version."""
    args = check.make_lin_attn_inputs(dev, b, g, hg, l, m, dv, seed=l,
                                      dtype=dtype)
    check.check_autograd(
        "linear_attention_causal", kl,
        lambda q, k, v: kl.linear_attention_causal(q, k, v, eps=1e-8),
        lambda q, k, v: kl.linear_attention_causal_plain(q, k, v, 1e-8),
        args, seed=l)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,r,m,dark,dtype", [
    (36_864, 64, 64, 256, True, torch.float32),   # smollm-135m training
    (1000, 64, 32, 256, True, torch.bfloat16),    # rows not a tile multiple
    (777, 64, 64, 256, False, torch.float32),     # isotropic
    (5, 16, 16, 32, True, torch.float32),
])
def test_featmap_kernel_matches_plain(dev, n, d, r, m, dark, dtype):
    """B6 forward and gradients against autograd of its plain version."""
    args = check.make_featmap_inputs(dev, n, d, r, m, dark, seed=n,
                                     dtype=dtype)
    check.check_autograd("prf_featmap", kf, kf.prf_featmap,
                         kf.prf_featmap_plain, args, seed=n)

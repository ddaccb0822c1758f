"""B6's tensor-core arithmetic, mirrored on the CPU, against the reference.

``check.featmap_tf32`` computes the PRF feature map the way the B6 CUDA
kernel does: x̃ = x Mᵀ (x̃ = x when isotropic) and the logits x̃ Wᵀ,
each in 3xTF32 with f32 sums, ‖x̃‖² from that x̃. Here it is held
against ``repro.kernels.ref.prf_featmap_ref`` and ``ops.prf_featmap``
(the reference's Pallas kernel, in interpret mode) on the same
numpy-seeded inputs, at the port's unchanged ``F32_TOL``, at d = r = 64,
128 and 256 (smollm-135m's, the d_head 128 models' and darkformer-2b's
heads) with m = 256, dark and isotropic, f32 and bf16 x, over a row
count that is not a multiple of the kernel's 16-row tiles. The 1xTF32
error is printed beside it, not asserted. The kernel itself is held
against its plain version on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import check

torch.set_num_threads(1)
N, M = 37, 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dark", [True, False], ids=["dark", "iso"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_featmap_tf32_mirror_matches_reference(d, dark, dtype):
    """3xTF32 for both products stays within F32_TOL of the reference's
    oracle and of its Pallas kernel."""
    x, m_mat, w, c = check.make_featmap_inputs("cpu", N, d, d, M, dark,
                                               seed=d + dark, dtype=dtype)
    xn = x.float().numpy()
    mn = None if m_mat is None else m_mat.numpy()
    cn = float(c)
    exp_ref = np.asarray(ref.prf_featmap_ref(xn, mn, w.numpy(), cn))
    exp_ops = np.asarray(ops.prf_featmap(xn, mn, w.numpy(), cn, block_n=16))
    got = check.featmap_tf32(x, m_mat, w, c)
    one = check.featmap_tf32(x, m_mat, w, c, passes=1)
    assert got.shape == (N, M) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    tol = check.F32_TOL
    for name, exp in (("ref", exp_ref), ("pallas", exp_ops)):
        e = torch.from_numpy(np.array(exp, np.float32))
        err = (got - e).abs()
        print(f"d={d} {'dark' if dark else 'iso'} {dtype} vs {name}: "
              f"3xTF32 max abs err {float(err.max()):.3e}, 1xTF32 "
              f"{float((one - e).abs().max()):.3e} (max |phi| "
              f"{float(e.abs().max()):.3e})")
        assert bool((err <= tol["atol"] + tol["rtol"] * e.abs()).all()), (
            name, float(err.max()), tol)

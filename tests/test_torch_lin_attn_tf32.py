"""B5's tensor-core arithmetic, mirrored on the CPU, against the reference.

``check.lin_attn_tf32`` computes causal linear attention the way the B5
CUDA kernel does (64-key chunks, one exclusive prefix state per chunk,
every matrix product in 3xTF32 with f32 sums). Here it is held against
``repro.kernels.ref.linear_attention_causal_ref`` (the reference's O(L²)
oracle, in JAX) on the same numpy-seeded inputs, at the port's unchanged
kernel tolerances: ``F32_TOL`` for f32 v, ``BF16_OUT_TOL`` for bf16 v.
The 1xTF32 error is printed beside it, not asserted. The kernel itself
is held against its plain version on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import check

torch.set_num_threads(1)
B, G, HG, M, DV = 1, 2, 3, 64, 32


def _reference(qf, kf, v, eps):
    """The reference oracle on (N, L, m) rows, kf and v broadcast over the
    query heads, in v's type; returned as f32 in qf's layout."""
    l = qf.shape[-2]
    kb, vb = (x.expand(*qf.shape[:-1], x.shape[-1]) for x in (kf, v))
    vj = jnp.asarray(vb.float().reshape(-1, l, v.shape[-1]).numpy())
    if v.dtype == torch.bfloat16:
        vj = vj.astype(jnp.bfloat16)
    out = ref.linear_attention_causal_ref(
        qf.reshape(-1, l, qf.shape[-1]).numpy(),
        kb.reshape(-1, l, kf.shape[-1]).numpy(), vj, eps=eps)
    return torch.from_numpy(np.array(out, np.float32)).reshape(
        *qf.shape[:-1], v.shape[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hk", [1, HG], ids=["Hk=1", "Hk=H"])
@pytest.mark.parametrize("l", [1, 63, 64, 65, 300])
def test_tf32_mirror_matches_reference(l, hk, dtype):
    """3xTF32 over 64-key chunks with prefix states stays within the
    kernel tolerances of the reference, for one token, one tile less a
    key, one tile, one key past it and five chunks (the last partial),
    with kf and v per KV group or per query head."""
    qf, kf, v = check.make_lin_attn_inputs("cpu", B, G, HG, l, M, DV,
                                           seed=l + hk, dtype=dtype, hk=hk)
    exp = _reference(qf, kf, v, 1e-6)
    got = check.lin_attn_tf32(qf, kf, v, eps=1e-6)
    assert got.shape == exp.shape and got.dtype == dtype
    tol = check.BF16_OUT_TOL if dtype == torch.bfloat16 else check.F32_TOL
    err = (got.float() - exp).abs()
    one = (check.lin_attn_tf32(qf, kf, v, eps=1e-6, passes=1).float()
           - exp).abs()
    print(f"L={l} Hk={hk} {dtype}: 3xTF32 max abs err {float(err.max()):.3e}"
          f", 1xTF32 {float(one.max()):.3e}")
    assert bool(torch.isfinite(got.float()).all())
    assert bool((err <= tol["atol"] + tol["rtol"] * exp.abs()).all()), (
        float(err.max()), tol)


def test_tf32_split_reproduces_f32():
    """hi = TF32(x) rounds to nearest at 10 mantissa bits (ties away from
    zero) with the low 13 bits clear; lo = TF32(x - hi), rounded the same
    way, has them clear too, and hi + lo gives x back within 2^-21 of its
    magnitude."""
    rng = np.random.default_rng(0)
    x = torch.tensor(np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096),
        [1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0, -0.0]]),
        dtype=torch.float32)
    hi, lo = check.tf32_split(x)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    xd = x.double()
    assert bool(((hi.double() - xd).abs() <= 2.0 ** -11 * xd.abs()).all())
    assert bool(((hi.double() + lo.double() - xd).abs()
                 <= 2.0 ** -21 * xd.abs()).all())
    assert hi[-5:].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3.0,
                                -0.0]

"""B5's and B4's tensor-core arithmetic, mirrored on the CPU, against the
reference.

``check.lin_attn_tf32`` computes causal linear attention the way the B5
CUDA kernel does (64-key chunks, one exclusive prefix state per chunk,
every matrix product in 3xTF32 with f32 sums); ``check.carry_tf32`` the
carried scan the way B4's does (32-key chunks, inclusive prefixes per
KV row, S_in = ρ·S0 + prefix, the same products, the final state). Here
they are held against ``repro.kernels.ref.linear_attention_causal_ref``
and ``linear_attention_carry_ref`` (the reference's O(L²) oracles, in
JAX; B4's from ρ·S0, ρ·z0, as the reference's two-stage prefill scales
the pool) on the same numpy-seeded inputs, at the port's unchanged
kernel tolerances: ``F32_TOL`` for f32 v and the state, ``BF16_OUT_TOL``
for bf16 outputs. The 1xTF32 error is printed beside them, not asserted.
The kernels themselves are held against their plain versions on the
card (tests/test_torch_cuda.py).
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hk", [1, HG], ids=["Hk=1", "Hk=H"])
@pytest.mark.parametrize("l", [1, 31, 32, 33, 300])
def test_carry_tf32_mirror_matches_reference(l, hk, dtype):
    """B4's arithmetic from a carried state scaled by ρ < 1 per query row
    stays within the kernel tolerances of the reference, outputs and final
    state, for one token, one chunk less a key, one chunk, one key past it
    and ten chunks (the last partial), kf and v per KV group or per head."""
    qf, kf, v = check.make_lin_attn_inputs("cpu", B, G, HG, l, M, DV,
                                           seed=l + hk, dtype=dtype, hk=hk)
    rng = np.random.default_rng(l)
    s0 = torch.tensor(8 * M ** -0.5 * rng.standard_normal((B, G, HG, M, DV)),
                      dtype=torch.float32)
    z0 = torch.tensor(64 * M ** -0.5 * (rng.uniform(size=(B, G, HG, M)) + 0.5),
                      dtype=torch.float32)
    rho = torch.tensor(np.exp(-rng.exponential(size=(B, G, HG))),
                       dtype=torch.float32)
    n = B * G * HG
    kb, vb = (x.expand(*qf.shape[:-1], x.shape[-1]) for x in (kf, v))
    exp = ref.linear_attention_carry_ref(
        qf.reshape(n, l, M).numpy(), kb.reshape(n, l, M).numpy(),
        vb.float().reshape(n, l, DV).numpy(),
        (s0 * rho[..., None, None]).reshape(n, M, DV).numpy(),
        (z0 * rho[..., None]).reshape(n, M).numpy(), eps=1e-6)
    exp = [torch.from_numpy(np.array(e, np.float32)) for e in exp]
    got = check.carry_tf32(qf, kf, v, s0, z0, rho, eps=1e-6)
    one = check.carry_tf32(qf, kf, v, s0, z0, rho, eps=1e-6, passes=1)[0]
    assert got[0].shape == qf.shape[:-1] + (DV,) and got[0].dtype == dtype
    tol = check.BF16_OUT_TOL if dtype == torch.bfloat16 else check.F32_TOL
    out, e_out = got[0].float().reshape(n, l, DV), exp[0]
    print(f"L={l} Hk={hk} {dtype}: 3xTF32 max abs err "
          f"{float((out - e_out).abs().max()):.3e}, 1xTF32 "
          f"{float((one.float().reshape(n, l, DV) - e_out).abs().max()):.3e}")
    for what, g, e, t in (("out", out, e_out, tol),
                          ("s", got[1].reshape(n, M, DV), exp[1],
                           check.F32_TOL),
                          ("z", got[2].reshape(n, M), exp[2], check.F32_TOL)):
        err = (g - e).abs()
        assert bool(torch.isfinite(g).all()), what
        assert bool((err <= t["atol"] + t["rtol"] * e.abs()).all()), (
            what, float(err.max()), t)


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

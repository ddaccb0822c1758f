"""Hold a kernel's wrapper against its plain version on the same inputs.

Used on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``;
on the CPU a wrapper runs its plain version itself, so there is nothing
to compare there.
"""
from __future__ import annotations

import numpy as np
import torch

# f32: the kernels' token-serial scans and the plain versions' chunked
# matmuls sum in different orders, over up to 512 tokens
F32_TOL = dict(atol=1e-4, rtol=1e-3)
# bf16 outputs (the main path's type): one to two bf16 ulps
BF16_OUT_TOL = dict(atol=2e-2, rtol=2e-2)


def make_inputs(dev, b, g, hg, d, m, dv, l, dark, seed,
                dtype=torch.float32) -> list:
    """[q, k, v, a, m_mat, s, z, c] for one call, from ``seed``.

    Attention-scaled (q, k ~ N(0, d^-1/2), M near the identity) so the
    feature logits have a realistic range; q/k/v in ``dtype``, the rest
    f32. ``l=None`` gives the decode layout, else L tokens a row;
    ``dark=False`` the isotropic variant (m_mat None)."""
    rng = np.random.default_rng(seed)
    lq = () if l is None else (l,)
    sc = d ** -0.25

    def t(a, dt=torch.float32):
        return torch.tensor(np.ascontiguousarray(a, np.float32),
                            device=dev).to(dt)
    q = t(sc * rng.standard_normal((b, g, hg, *lq, d)), dtype)
    k = t(sc * rng.standard_normal((b, g, *lq, d)), dtype)
    v = t(rng.standard_normal((b, g, *lq, dv)), dtype)
    w = rng.standard_normal((g, m, d))
    if dark:
        mm = np.eye(d)[None] + 0.1 * d ** -0.5 * rng.standard_normal(
            (g, d, d))
        a, m_mat = np.einsum("gmr,grd->gdm", w, mm), t(mm)
    else:
        a, m_mat = np.swapaxes(w, -1, -2), None
    s = t(rng.standard_normal((b, g, hg, m, dv)))
    z = t(rng.uniform(size=(b, g, hg, m)) + 0.5)
    c = t(rng.standard_normal((b, g)) + 1.0)
    return [q, k, v, t(a), m_mat, s, z, c]


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def clone(args: list) -> list:
    return [None if x is None else x.clone() for x in args]


def max_error(name: str, got, exp, valid_len=None) -> float:
    """Max abs error over (out, s, z, c). Raises AssertionError on a
    non-finite value or an error beyond F32_TOL (BF16_OUT_TOL for bf16
    outputs). Outputs past a row's ``valid_len`` are not compared: they
    are garbage by contract."""
    worst = 0.0
    bf16_out = got[0].dtype == torch.bfloat16
    for o, e, what in zip(got, exp, ("out", "s", "z", "c")):
        o, e = o.float(), e.float()
        if what == "out" and valid_len is not None:
            mask = (torch.arange(o.shape[3], device=o.device)[None]
                    < valid_len[:, None])[:, None, None, :, None]
            o = torch.where(mask, o, 0.0)
            e = torch.where(mask, e, 0.0)
        tol = BF16_OUT_TOL if what == "out" and bf16_out else F32_TOL
        _require(bool(torch.isfinite(o).all()), f"{name}: non-finite {what}")
        err = (o - e).abs()
        _require(bool((err <= tol["atol"] + tol["rtol"] * e.abs()).all()),
                 f"{name}: {what} off by {float(err.max()):.3e} "
                 f"(tolerance {tol})")
        worst = max(worst, float(err.max()))
    return worst


def check_case(name: str, mod, wrapper, plain, args: list, valid_len=None,
               **kw) -> float:
    """One kernel call against its plain version on copies of the same
    inputs: the same results within tolerance, S/z/c updated where they
    lie, and exactly one launch counted on ``mod.launches``. Returns the
    max abs error."""
    extra = [] if valid_len is None else [valid_len]
    exp = plain(*clone(args), *extra, **kw)
    ptrs = [x.data_ptr() for x in args[5:]]
    n0 = mod.launches
    got = wrapper(*args, *extra, **kw)
    torch.cuda.synchronize()
    _require(mod.launches == n0 + 1,
             f"{name}: launch counter moved by {mod.launches - n0}")
    _require([x.data_ptr() for x in got[1:]] == ptrs,
             f"{name}: state not updated in place")
    return max_error(name, got, exp, valid_len)

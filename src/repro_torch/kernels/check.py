"""Hold a kernel's wrapper against its plain version on the same inputs.

Used on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``;
on the CPU a wrapper runs its plain version itself, so there is nothing
to compare there.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# f32: the kernels' token-serial scans and the plain versions' chunked
# matmuls sum in different orders, over up to 512 tokens
F32_TOL = dict(atol=1e-4, rtol=1e-3)
# bf16 outputs (the main path's type), rounded from f32 results that
# differ in the last f32 bits: two bf16 ulps of the value compared (bf16
# keeps 8 significant bits, so an ulp is at most 2^-7 of the value), plus
# 1e-4 for the f32 rounding differences of results near zero
BF16_OUT_TOL = dict(atol=1e-4, rtol=2 ** -6)


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
    """Max abs error over (out, s, z[, c]). Raises AssertionError on a
    non-finite value or an error beyond F32_TOL (BF16_OUT_TOL for bf16
    outputs). Outputs past a row's ``valid_len`` are not compared: they
    are garbage by contract."""
    worst = 0.0
    bf16_out = got[0].dtype == torch.bfloat16
    for o, e, what in zip(got, exp, ("out", "s", "z", "c")):
        _require(o.shape == e.shape, f"{name}: {what} has shape "
                 f"{tuple(o.shape)}, expected {tuple(e.shape)}")
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


def check_case(name: str, count, wrapper, plain, args: list, state: tuple,
               valid_len=None, **kw) -> float:
    """One call of a kernel that advances ``args[i]`` for i in ``state``
    in place, against its plain version on copies of the same inputs:
    the same results within tolerance (:func:`max_error`), the state
    advanced where it lies, and exactly one launch counted by
    ``count()``. ``valid_len``, when given, follows ``args`` in both
    calls. Returns the max abs error."""
    extra = [] if valid_len is None else [valid_len]
    exp = plain(*clone(args), *extra, **kw)
    ptrs = [args[i].data_ptr() for i in state]
    n0 = count()
    got = wrapper(*args, *extra, **kw)
    torch.cuda.synchronize()
    _require(count() == n0 + 1,
             f"{name}: launch counter moved by {count() - n0}")
    _require([t.data_ptr() for t in got[1:]] == ptrs,
             f"{name}: state not updated in place")
    return max_error(name, got, exp, valid_len)


def _compare(name: str, got: torch.Tensor, exp: torch.Tensor, tol) -> float:
    """Max abs error of ``got`` against ``exp``; raises AssertionError on
    a shape or dtype mismatch, a non-finite value or an error beyond
    ``tol``."""
    _require(got.shape == exp.shape and got.dtype == exp.dtype,
             f"{name}: got {got.dtype}{tuple(got.shape)}, expected "
             f"{exp.dtype}{tuple(exp.shape)}")
    o, e = got.detach().float(), exp.detach().float()
    _require(bool(torch.isfinite(o).all()), f"{name}: non-finite values")
    err = (o - e).abs()
    _require(bool((err <= tol["atol"] + tol["rtol"] * e.abs()).all()),
             f"{name}: off by {float(err.max()):.3e} (tolerance {tol})")
    return float(err.max())


def _tol(t: torch.Tensor) -> dict:
    return BF16_OUT_TOL if t.dtype == torch.bfloat16 else F32_TOL


def check_autograd(name: str, mod, fn, plain, args: list, seed: int):
    """One call of the autograd wrapper ``fn`` against ``plain`` on the
    same inputs: the output within tolerance and exactly one kernel
    launch counted on ``mod.launches``; then the gradients of a random
    projection of the output, through ``fn`` and through autograd of
    ``plain``, for every floating input (``None`` inputs stay None).
    Returns (forward max abs error, gradient max abs error)."""
    ins = [None if a is None else a.detach().clone().requires_grad_(
        a.is_floating_point()) for a in args]
    ref_ins = [None if a is None else a.detach().clone().requires_grad_(
        a.is_floating_point()) for a in args]
    n0 = mod.launches
    got = fn(*ins)
    torch.cuda.synchronize()
    _require(mod.launches == n0 + 1,
             f"{name}: launch counter moved by {mod.launches - n0}")
    exp = plain(*ref_ins)
    fwd = _compare(f"{name} forward", got, exp, _tol(exp))
    gen = torch.Generator(device=got.device).manual_seed(seed)
    g = torch.randn(got.shape, generator=gen, device=got.device,
                    dtype=torch.float32).to(got.dtype)
    diff = [a for a in ins if a is not None and a.requires_grad]
    ref_diff = [a for a in ref_ins if a is not None and a.requires_grad]
    grads = torch.autograd.grad(got, diff, g)
    # an input that reaches no output gets a zero gradient (wkv6's w at
    # L = 1), as the reference's VJP gives
    ref_grads = torch.autograd.grad(exp, ref_diff, g, allow_unused=True,
                                    materialize_grads=True)
    worst = 0.0
    for i, (gg, rg) in enumerate(zip(grads, ref_grads)):
        worst = max(worst, _compare(f"{name} grad {i}", gg, rg, _tol(rg)))
    return fwd, worst


def make_lin_attn_inputs(dev, b, g, hg, l, m, dv, seed,
                         dtype=torch.float32, hk=1) -> list:
    """[qf, kf, v] of one causal linear-attention call at rf_attention's
    layout: qf (B, G, Hg, L, m), kf (B, G, Hk, L, m) f32, positive like
    PRF features (exp(N(0, 1/4))/√m); v (B, G, Hk, L, dv) in ``dtype``.
    Hk = 1 shares kf and v among a group's Hg query heads; Hk = Hg gives
    each head its own."""
    rng = np.random.default_rng(seed)

    def feats(shape):
        a = np.exp(0.5 * rng.standard_normal(shape)) / m ** 0.5
        return torch.tensor(a, dtype=torch.float32, device=dev)
    qf = feats((b, g, hg, l, m))
    kf = feats((b, g, hk, l, m))
    v = torch.tensor(rng.standard_normal((b, g, hk, l, dv)),
                     dtype=torch.float32, device=dev).to(dtype)
    return [qf, kf, v]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the
    nearest value with 10 mantissa bits, ties away from zero (the low 13
    bits of the f32 pattern cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) of B5's 3xTF32 split: hi = TF32(x), lo = TF32(x - hi),
    both rounded to nearest (:func:`tf32_round`), so |x - (hi + lo)| <=
    2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as B5's mma.sync computes it: each operand split
    (:func:`tf32_split`), then hi·lo + lo·hi + hi·hi (each product of TF32
    values exact in f32) summed in f32; ``passes=1`` keeps hi·hi alone
    (1xTF32)."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    if passes == 1:
        return ah @ bh
    return ah @ bl + al @ bh + ah @ bh


def carry_tf32(qf, kf, v, s0, z0, rho=None, eps: float = 1e-6,
               passes: int = 3, chunk: int = 32):
    """Causal linear attention resumed from (S0, z0) computed as B4's
    kernel computes it, on any device: chunks of ``chunk`` keys; per KV
    row the inclusive prefixes P_c = Σ_{c'≤c} K_c'ᵀ V_c' and Pz_c =
    Σ_{c'≤c} Σ K_c' (f32 sums in chunk order); per chunk c S_in = ρ·S0 +
    P_{c-1}, z_in = ρ·z0 + Pz_{c-1}, A = tril(Q_c K_cᵀ), den = rowsum(A)
    + Q_c·z_in (f32) and out = (Q_c S_in + A V_c) / (den + eps), every
    matrix product in 3xTF32 (:func:`_mm_tf32`; ``passes=1`` for 1xTF32);
    then S_L = ρ·S0 + P_last, z_L = ρ·z0 + Pz_last. Shapes as
    ``linear_attention_prefill_chunk`` (rho None means 1). Returns (out
    in v.dtype, S_L, z_L); s0 and z0 are left as they are. For the
    tests: it holds the kernel's algorithm and precision against the
    reference."""
    q, k, vv = qf.float(), kf.float(), v.float()
    s_r, z_r = s0.float(), z0.float()
    if rho is not None:
        s_r, z_r = s_r * rho[..., None, None], z_r * rho[..., None]
    p = q.new_zeros((*k.shape[:-2], k.shape[-1], vv.shape[-1]))
    pz = q.new_zeros((*k.shape[:-2], k.shape[-1]))
    outs = []
    for c0 in range(0, q.shape[-2], chunk):
        qc, kc, vc = (x[..., c0:c0 + chunk, :] for x in (q, k, vv))
        t = qc.shape[-2]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        a = torch.where(mask, _mm_tf32(qc, kc.transpose(-1, -2), passes),
                        0.0)
        den = a.sum(-1, keepdim=True) + qc @ (z_r + pz)[..., None]
        num = _mm_tf32(qc, s_r + p, passes) + _mm_tf32(a, vc, passes)
        outs.append(num / (den + eps))
        p = p + _mm_tf32(kc.transpose(-1, -2), vc, passes)
        pz = pz + kc.sum(-2)
    return torch.cat(outs, -2).to(v.dtype), s_r + p, z_r + pz


def lin_attn_tf32(qf, kf, v, eps: float = 1e-6, passes: int = 3,
                  chunk: int = 64) -> torch.Tensor:
    """Causal linear attention computed as B5's kernel computes it: 64-key
    chunks, one exclusive prefix state per chunk, every matrix product in
    3xTF32 — :func:`carry_tf32` from a zero state (S_in = 0 + P_{c-1} is
    P_{c-1} exactly). Shapes as ``linear_attention_causal``; returns
    v.dtype."""
    k = kf.float()
    zero = k.new_zeros((*k.shape[:-2], k.shape[-1], v.shape[-1]))
    return carry_tf32(qf, kf, v, zero, zero[..., 0], eps=eps,
                      passes=passes, chunk=chunk)[0]


def featmap_tf32(x, m_mat, w, c, passes: int = 3) -> torch.Tensor:
    """φ(x) = exp(W x̃ − ‖x̃‖²/2 − c)/√m computed as B6's kernel computes
    it, on any device: x̃ = x Mᵀ (x̃ = x when ``m_mat`` is None) and the
    logits x̃ Wᵀ, each in 3xTF32 (:func:`_mm_tf32`; ``passes=1`` for
    1xTF32), ‖x̃‖² summed in f32 from that x̃. Shapes as ``prf_featmap``;
    returns (..., m) f32. For the tests: it holds the kernel's precision
    against the reference."""
    xt = x.float()
    if m_mat is not None:
        xt = _mm_tf32(xt, m_mat.float().T, passes)
    logits = _mm_tf32(xt, w.float().T, passes)
    sq = 0.5 * torch.sum(xt * xt, dim=-1, keepdim=True)
    return torch.exp(logits - sq - c) * w.shape[0] ** -0.5


def make_featmap_inputs(dev, n, d, r, m, dark, seed,
                        dtype=torch.float32) -> list:
    """[x, m_mat, w, c] of one feature-map call: attention-scaled rows x
    (N, d) in ``dtype``, M (r, d) near the identity (None when not
    ``dark``; then r = d), a Gaussian W (m, r) and the scalar c, f32."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.tensor(np.asarray(a, np.float32), device=dev).to(dt)
    x = t(d ** -0.25 * rng.standard_normal((n, d)), dtype)
    m_mat = (t(np.eye(r, d) + 0.1 * d ** -0.5 * rng.standard_normal((r, d)))
             if dark else None)
    w = t(rng.standard_normal((m, r if dark else d)))
    return [x, m_mat, w, t(0.5)]


def make_decode_step_inputs(dev, b, g, hg, m, dv, seed, hk=1,
                            dtype=torch.float32) -> list:
    """[qf, kf, v, s, z, rescale] of one two-stage decode step at the
    attention's layout: qf (B, G, Hg, m); kf (B, G, Hk, m), v (B, G, Hk,
    dv) and rescale (B, G, Hk) per KV row (Hk = 1: one per KV group, as
    the serving path passes them; Hk = Hg: one per query head); the
    pool's s (B, G, Hg, m, dv) and z (B, G, Hg, m); rescale in (0, 1], a
    stabilizer that moved. Features positive like PRF features
    (exp(N(0, 1/4))/√m); v in ``dtype``, the rest f32."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.tensor(np.asarray(a, np.float32), device=dev).to(dt)
    return [t(np.exp(0.5 * rng.standard_normal((b, g, hg, m))) / m ** 0.5),
            t(np.exp(0.5 * rng.standard_normal((b, g, hk, m))) / m ** 0.5),
            t(rng.standard_normal((b, g, hk, dv)), dtype),
            t(rng.standard_normal((b, g, hg, m, dv))),
            t(rng.uniform(size=(b, g, hg, m)) + 0.5),
            t(np.exp(-rng.exponential(size=(b, g, hk))))]


def make_carry_inputs(dev, b, g, hg, hk, l, m, dv, seed,
                      dtype=torch.float32) -> list:
    """[qf, kf, v, s0, z0] of one two-stage prefill chunk: qf (B, G, Hg,
    L, m) and kf (B, G, Hk, L, m) f32, positive like PRF features; v (B,
    G, Hk, L, dv) in ``dtype``; the carried s0 (B, G, Hg, m, dv) and z0
    (B, G, Hg, m) f32, nonzero (a prefix of about 64 tokens)."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.tensor(np.asarray(a, np.float32), device=dev).to(dt)

    def feats(shape):
        return t(np.exp(0.5 * rng.standard_normal(shape)) / m ** 0.5)
    return [feats((b, g, hg, l, m)), feats((b, g, hk, l, m)),
            t(rng.standard_normal((b, g, hk, l, dv)), dtype),
            t(8 * m ** -0.5 * rng.standard_normal((b, g, hg, m, dv))),
            t(64 * m ** -0.5 * (rng.uniform(size=(b, g, hg, m)) + 0.5))]


def make_carry_rho(dev, b, g, hg, seed) -> torch.Tensor:
    """ρ (B, G, Hg) f32 for one two-stage prefill chunk: factors in (0, 1]
    like the stabilizer's rescale exp(c_old - c_new), drawn per query row
    (the serving path passes one per KV group; distinct rows catch a row
    that reads another's)."""
    rng = np.random.default_rng(seed)
    return torch.tensor(np.exp(-rng.exponential(size=(b, g, hg))),
                        dtype=torch.float32, device=dev)


def check_carry_chained(dev, seed: int) -> float:
    """Three uneven resumed chunks (256 + 37 + 307 tokens) through the
    carried-scan kernel against one plain pass of the 600 tokens from the
    same nonzero state (smollm-135m heads, 2 slots). Returns the max abs
    error over (out, s, z)."""
    from repro_torch.kernels import linear_attn_scan as kl
    qf, kf, v, s0, z0 = make_carry_inputs(dev, 2, 3, 3, 1, 600, 256, 64,
                                          seed)
    exp = kl.linear_attention_carry_plain(qf, kf, v, s0.clone(), z0.clone(),
                                          1e-8)
    outs = [kl.linear_attention_prefill_chunk(
        qf[..., lo:hi, :].contiguous(), kf[..., lo:hi, :].contiguous(),
        v[..., lo:hi, :].contiguous(), s0, z0, eps=1e-8)[0]
        for lo, hi in ((0, 256), (256, 293), (293, 600))]
    torch.cuda.synchronize()
    return max_error("carry chained", (torch.cat(outs, -2), s0, z0), exp)


def make_wkv6_inputs(dev, n, l, dh, seed, dtype=torch.float32,
                     decays: str = "sigmoid") -> list:
    """[r, k, v, w, u] of one WKV-6 call: r, k, v ~ N(0, 1/√dh), (N, L,
    dh) in ``dtype``; u (dh,) f32. ``decays="sigmoid"`` draws w =
    sigmoid(N(2, 1)) in (0, 1); ``"model"`` draws w = exp(-exp(x)), x ~
    N(0, 2²), as the reference's rwkv6 block does (``exp(-exp(lam_w +
    dd))``; about 1% of it underflows to exactly 0 in f32), sets 2% of
    it to exactly 0 besides, and gives row i a padded tail of its last
    (i % 3) · L/8 tokens with w = 1 and k = 0, as the reference's padding
    does."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.tensor(np.asarray(a, np.float32), device=dev).to(dt)
    r, k, v = (dh ** -0.25 * rng.standard_normal((n, l, dh))
               for _ in range(3))
    if decays == "model":
        w = np.exp(-np.exp(2.0 * rng.standard_normal((n, l, dh))))
        w[rng.uniform(size=(n, l, dh)) < 0.02] = 0.0
        live = (np.arange(l)[None, :, None]
                < (l - np.arange(n) % 3 * (l // 8))[:, None, None])
        w, k = np.where(live, w, 1.0), np.where(live, k, 0.0)
    elif decays == "sigmoid":
        w = 1 / (1 + np.exp(-(rng.standard_normal((n, l, dh)) + 2.0)))
    else:
        raise ValueError(f"decays is 'sigmoid' or 'model', not {decays!r}")
    return [t(r, dtype), t(k, dtype), t(v, dtype), t(w, dtype),
            t(0.3 * rng.standard_normal(dh))]


def _fma(a, b, c):
    """fmaf(a, b, c) of f32 tensors: a·b exact in f64, one rounding of the
    sum (through f64, so a double rounding in rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (a power of two long) as the kernels' xor
    shuffles take it: entries i and i + n/2 first, then the halves of
    what is left."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def wkv6_tile(n: int, dh: int, sms: int) -> tuple[int, int]:
    """(rows a thread, lanes a column group) of the state tile that B7's
    kernel takes for ``n`` rows of width ``dh`` on a card of ``sms`` SMs:
    the rule of ``launch_width`` in ``csrc/wkv6_scan.cu``, mirrored for
    :func:`wkv6_stepped` (the only choice of the launch that changes the
    order of f32 operations)."""
    if dh <= 16:
        return 2, 8
    if dh <= 32:
        return 4, 8
    if dh <= 64:
        return (8, 8) if n * ((dh + 15) // 16) >= 4 * sms else (4, 16)
    return 8, 16


def wkv6_stepped(r, k, v, w, u, sms: int) -> torch.Tensor:
    """RWKV-6 WKV from a zero state computed as B7's kernel computes it,
    on any device: tokens in pairs (t, t + 1), with r~ = r_{t+1} w_t,
    k~ = k_t w_{t+1}, P = w_t w_{t+1} and c = r_{t+1}·k_t,
    o_t = r_tᵀ S + β_t v_t, o_{t+1} = r~ᵀ S + c v_t + β_{t+1} v_{t+1} and
    S'' = P S + k~ v_tᵀ + k_{t+1} v_{t+1}ᵀ (past L, r = k = 0 and w = 1),
    β_t = Σ_d r_t[d] (u[d] k_t[d]); β and c summed by 16 lanes a pair
    (lane j over its dh_p/16 consecutive rows in order, then over the
    lanes by shuffles); a state tile of ``rows`` rows a thread and
    ``lanes`` lanes a column group, as :func:`wkv6_tile` gives them for
    these rows on a card of ``sms`` SMs (lane g holds rows
    q·lanes·V + g·V + i, V = min(rows, 4); its 2 or 4 columns do not
    change the order of its sums), rows past dh zero, each
    lane's share of rᵀS an FMA chain over its rows, summed over the
    lanes of its column group as the reduce-scatter does, then c v_t and
    β v added by one FMA each. Shapes as ``wkv6``; returns v.dtype. For
    the tests: it holds the kernel's order of f32 operations against the
    reference, and the kernel against that order on the card."""
    import torch.nn.functional as nnf

    l, dh = r.shape[-2:]
    rows, lanes = wkv6_tile(math.prod(r.shape[:-2]), dh, sms)
    dhp, vec = rows * lanes, min(rows, 4)
    pad = (0, dhp - dh, 0, l % 2)
    r, k = (nnf.pad(x.float(), pad) for x in (r, k))
    w = nnf.pad(w.float(), pad, value=1.0)
    vf = nnf.pad(v.float(), (0, 0, 0, l % 2))
    up = nnf.pad(u.float(), (0, dhp - dh))
    r0, r1, k0, k1, w0, w1 = (x[..., i::2, :] for x in (r, k, w)
                              for i in (0, 1))
    v0, v1 = vf[..., 0::2, :], vf[..., 1::2, :]

    def lanes_dot(a, b):                  # Σ_d a·b over 16 lanes a pair
        a, b = (x.unflatten(-1, (16, dhp // 16)) for x in (a, b))
        acc = torch.zeros_like(a[..., 0])
        for i in range(dhp // 16):
            acc = _fma(a[..., i], b[..., i], acc)
        return _tree_sum(acc, -1)
    b0, b1 = lanes_dot(r0, up * k0), lanes_dot(r1, up * k1)
    cq = lanes_dot(r1, k0)
    rt, kt, pw = r1 * w0, k0 * w1, w0 * w1
    # rows[g, a]: lane g's a-th row, in the order of its FMA chain
    rows_of = torch.arange(dhp, device=r.device).view(
        rows // vec, lanes, vec).transpose(0, 1).reshape(lanes, rows)
    s = r.new_zeros((*r.shape[:-2], dhp, dh))

    def part(x):                          # xᵀ S by the lanes' tree
        xl, sl = x[..., rows_of], s[..., rows_of, :]
        acc = torch.zeros_like(sl[..., 0, :])
        for a in range(rows):
            acc = _fma(xl[..., a, None], sl[..., a, :], acc)
        return _tree_sum(acc, -2)
    outs = []
    for q in range(r0.shape[-2]):
        outs.append(_fma(b0[..., q, None], v0[..., q, :],
                         part(r0[..., q, :])))
        outs.append(_fma(b1[..., q, None], v1[..., q, :],
                         _fma(cq[..., q, None], v0[..., q, :],
                              part(rt[..., q, :]))))
        s = _fma(k1[..., q, :, None], v1[..., q, None, :],
                 _fma(kt[..., q, :, None], v0[..., q, None, :],
                      pw[..., q, :, None] * s))
    return torch.stack(outs, dim=-2)[..., :l, :].to(v.dtype)


def check_forward(name: str, count, fn, plain, args: list) -> float:
    """One call of ``fn`` against ``plain`` on the same inputs, without
    gradients: the output within tolerance and exactly one launch
    counted by ``count()``. Returns the max abs error."""
    with torch.no_grad():
        n0 = count()
        got = fn(*args)
        torch.cuda.synchronize()
        _require(count() == n0 + 1,
                 f"{name}: launch counter moved by {count() - n0}")
        exp = plain(*args)
    return _compare(name, got, exp, _tol(exp))

"""Causal linear attention, from a zero state (B5) or resumed from a
carried one (B4): the Hopper kernels' wrappers and their plain PyTorch
versions.

Replaces ``repro.kernels.linear_attn_scan.linear_attention_causal_fwd``
and ``linear_attention_causal_carry_fwd`` (Pallas TPU kernels). The CUDA
kernels are ``csrc/linear_attn_scan.cu``; per query row they compute

    out_i = qf_i · S_i / (qf_i · z_i + ε)
    S_i = S0 + Σ_{j≤i} kf_j v_jᵀ,   z_i = z0 + Σ_{j≤i} kf_j

chunk-parallel, with kf and v read once per KV row: the Hk rows of kf and
v serve the H query rows of qf, query head h reading KV head h·Hk/H, so a
GQA group's heads need no broadcast copy (Hk is 1 or H). Both run on the
tensor cores in 3xTF32 (``check.carry_tf32`` mirrors the arithmetic on
the CPU). B5 works over 64-key chunks in three launches: every chunk's
state increment into a scratch, an in-place scan of the scratch into one
prefix state (S_in, z_in) per chunk, then the outputs, a block per 64
query positions and KV row serving up to 4 heads of the group. B4 works
over 32-key chunks, the carried state read once and written once: the
increments' prefixes per KV row, then the outputs, a block per query
row, 32 positions and 64 columns of dv, from ρ·S0 plus the prefix, then
S_L in place. Each wrapper's counter counts one per call.

:func:`linear_attention_causal` (B5, training) starts from S0 = 0, z0 = 0
and is an autograd Function. Its backward is autograd of
:func:`linear_attention_causal_plain`, the O(L²) oracle, recomputed under
``torch.enable_grad()`` — the port of ``repro.kernels.ops._lin_attn_bwd``.
The reference has no backward kernel, so neither has the port (ROADMAP.md
Queue B, "B5 backward").

:func:`linear_attention_prefill_chunk` (B4, the two-stage serving
prefill) starts from the carried (S0, z0) of each query row, scaled by an
optional ρ per row (the stabilizer's rescale; the reference scales the
pool before its kernel, the port's kernel as it reads it), and advances
them in place over the chunk; it is forward-only, as the reference's.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(or raises). ``launches`` counts B5's kernel launches, ``carry_launches``
B4's.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.linear_attention import linear_attention_causal_naive
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (F, I, INPUT_DTYPES, P, check_cuda,
                                         expect, ptr, stream)

F32 = (torch.float32,)
CARRY_CHUNK = 32              # keys per B4 state chunk (kCc in the .cu)
CAUSAL_CHUNK = 64             # keys per B5 state chunk (kC in the .cu)
MAX_ROWS = 65535              # query rows: the launch grid's y extent
launches = 0
carry_launches = 0


# The plain version: the O(L²) masked oracle (port of
# ``repro.kernels.ref.linear_attention_causal_ref``); its einsums broadcast
# the Hk = 1 heads of kf and v over the H heads of qf.
linear_attention_causal_plain = linear_attention_causal_naive


def linear_attention_carry_plain(qf, kf, v, s0, z0, eps: float = 1e-6, *,
                                rho=None):
    """Plain PyTorch version of the carried scan: the O(L²) masked oracle
    (port of ``repro.kernels.ref.linear_attention_carry_ref``) from ρ·S0,
    ρ·z0, advancing s0 and z0 in place like the kernel. Shapes as
    :func:`linear_attention_prefill_chunk`; the Hk heads of kf and v
    broadcast over the H heads of qf. Returns (out in v.dtype, s0, z0)."""
    qf, kff, vf = qf.float(), kf.float(), v.float()
    s_in, z_in = s0, z0
    if rho is not None:
        s_in, z_in = s0 * rho[..., None, None], z0 * rho[..., None]
    scores = torch.einsum("...qm,...km->...qk", qf, kff)
    l = qf.shape[-2]
    mask = torch.ones(l, l, dtype=torch.bool, device=qf.device).tril()
    scores = torch.where(mask, scores, 0.0)
    num = (torch.einsum("...qm,...md->...qd", qf, s_in)
           + torch.einsum("...qk,...kd->...qd", scores, vf))
    den = torch.einsum("...qm,...m->...q", qf, z_in) + scores.sum(-1)
    s_new = s_in + torch.einsum("...lm,...ld->...md", kff, vf)
    z_new = z_in + kff.sum(-2)
    s0.copy_(s_new)
    z0.copy_(z_new)
    return (num / (den[..., None] + eps)).to(v.dtype), s0, z0


@functools.cache
def _c_fns():
    lib = _build.load("linear_attn_scan")
    lib.linear_attn_causal.argtypes = [P] * 6 + [I] * 6 + [F, P]
    lib.linear_attn_causal.restype = I
    lib.linear_attn_carry.argtypes = [P] * 9 + [I] * 6 + [F, P]
    lib.linear_attn_carry.restype = I
    return lib.linear_attn_causal, lib.linear_attn_carry


def _check(qf, kf, v):
    if qf.ndim < 3:
        raise ValueError(f"qf must be (..., H, L, m), got {tuple(qf.shape)}")
    *lead, h, l, m = qf.shape
    hk, dv = kf.shape[-3], v.shape[-1]
    if hk not in (1, h):
        raise ValueError(f"kf has {hk} heads for {h} query heads: expected "
                         f"1 or {h}")
    dev = qf.device
    expect("qf", qf, (*lead, h, l, m), F32, dev)
    expect("kf", kf, (*lead, hk, l, m), F32, dev)
    expect("v", v, (*lead, hk, l, dv), INPUT_DTYPES, dev)
    return qf.numel() // (l * m), kf.numel() // (l * m), l, m, dv


def _launch(qf, kf, v, eps, n, nk, l, m, dv):
    global launches
    if n > MAX_ROWS:
        raise ValueError(f"linear_attention_causal takes at most {MAX_ROWS} "
                         f"query rows, got {n}")
    nc1 = max(-(-l // CAUSAL_CHUNK) - 1, 1)
    dev = qf.device
    s_in = torch.empty((nk, nc1, m, dv), dtype=torch.float32, device=dev)
    z_in = torch.empty((nk, nc1, m), dtype=torch.float32, device=dev)
    out = torch.empty((*qf.shape[:-1], dv), dtype=v.dtype, device=dev)
    err = _c_fns()[0](ptr(qf), ptr(kf), ptr(v), ptr(s_in), ptr(z_in),
                      ptr(out), n, nk, l, m, dv,
                      int(v.dtype == torch.bfloat16), eps, stream(dev))
    check_cuda(err, "linear_attn_causal")
    launches += 1
    return out


class _LinAttnCausal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qf, kf, v, eps):
        dims = _check(qf, kf, v)
        ctx.save_for_backward(qf, kf, v)
        ctx.eps = eps
        if qf.device.type == "cpu":
            return linear_attention_causal_plain(qf, kf, v, eps)
        if qf.device.type != "cuda":
            raise ValueError("linear_attention_causal runs on cuda or cpu, "
                             f"not {qf.device}")
        return _launch(qf, kf, v, eps, *dims)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = linear_attention_causal_plain(*ins, ctx.eps)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, need) if n], g))
        return (*(next(grads) if n else None for n in need), None)


def linear_attention_causal(qf: torch.Tensor, kf: torch.Tensor,
                            v: torch.Tensor, *,
                            eps: float = 1e-6) -> torch.Tensor:
    """Causal PRF attention from a zero state, differentiable.

    qf: (..., H, L, m) f32; kf: (..., Hk, L, m) f32; v: (..., Hk, L, dv)
    f32 or bf16, with Hk = 1 (one KV head shared by the H query heads)
    or Hk = H. Every tensor must be contiguous. Returns (..., H, L, dv)
    in v.dtype; gradients come back in the shapes given."""
    return _LinAttnCausal.apply(qf, kf, v, eps)


def linear_attention_prefill_chunk(qf: torch.Tensor, kf: torch.Tensor,
                                   v: torch.Tensor, s0: torch.Tensor,
                                   z0: torch.Tensor, *, rho=None,
                                   eps: float = 1e-6):
    """Advance a PRF prefix state over a prompt chunk, in place.

    qf: (..., H, L, m) f32; kf: (..., Hk, L, m) f32; v: (..., Hk, L, dv)
    f32 or bf16, Hk = 1 or H; s0: (..., H, m, dv) and z0: (..., H, m)
    f32, the carried state of each query row; rho: None (1) or (..., H)
    f32, a factor per query row that scales s0 and z0 before the chunk
    (the stabilizer's rescale). s0 and z0 end as ρ·S0, ρ·z0 advanced over
    the L tokens, in place. Every tensor must be contiguous. Any L is
    taken: the kernel's 32-key chunks are its own, and the plain version
    has none. Forward-only, as the reference's. Returns (out (..., H, L,
    dv) in v.dtype, s0, z0)."""
    n, nk, l, m, dv = _check(qf, kf, v)
    lead_h = qf.shape[:-2]
    dev = qf.device
    expect("s0", s0, (*lead_h, m, dv), F32, dev)
    expect("z0", z0, (*lead_h, m), F32, dev)
    if rho is not None:
        expect("rho", rho, tuple(lead_h), F32, dev)
    if dev.type == "cpu":
        return linear_attention_carry_plain(qf, kf, v, s0, z0, eps, rho=rho)
    if dev.type != "cuda":
        raise ValueError("linear_attention_prefill_chunk runs on cuda or "
                         f"cpu, not {dev}")
    if n > MAX_ROWS:
        raise ValueError("linear_attention_prefill_chunk takes at most "
                         f"{MAX_ROWS} query rows, got {n}")
    global carry_launches
    nc = -(-l // CARRY_CHUNK)
    pfx = torch.empty((nk, nc, m, dv), dtype=torch.float32, device=dev)
    pz = torch.empty((nk, nc, m), dtype=torch.float32, device=dev)
    out = torch.empty((*qf.shape[:-1], dv), dtype=v.dtype, device=dev)
    err = _c_fns()[1](ptr(qf), ptr(kf), ptr(v), ptr(s0), ptr(z0), ptr(rho),
                      ptr(pfx), ptr(pz), ptr(out), n, nk, l, m, dv,
                      int(v.dtype == torch.bfloat16), eps, stream(dev))
    check_cuda(err, "linear_attn_carry")
    carry_launches += 1
    return out, s0, z0

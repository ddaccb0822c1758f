"""Fused one-token data-aligned PRF decode: the Hopper kernel's wrapper
and its plain PyTorch version.

Replaces ``repro.kernels.prf_fused_decode.prf_fused_decode_fwd`` (a
Pallas TPU kernel). The CUDA kernel is ``csrc/prf_fused_decode.cu``;
per (b, g, h) it computes

    qraw = q A − ‖Mq‖²/2          kraw = k A − ‖Mk‖²/2
    c'   = max(c, max_m kraw)     ρ = exp(c − c')
    qf   = exp(qraw − max_m qraw)/√m        kf = exp(kraw − c')/√m
    S'   = ρ S + kf vᵀ            z' = ρ z + kf
    out  = (qf · S') / (qf · z' + ε)

and writes S, z and c in place. ``stabilize=False`` drops the maxes
(c' = 0, ρ = exp(c)); ``m_mat=None`` is the isotropic kind (norm of x).

A CPU tensor runs :func:`prf_fused_decode_plain`; a CUDA tensor launches
the kernel (or raises): two launches a call, the features once per KV
group (z and c advanced in place) and then the stream of S, each S
element read and written once. ``launches`` counts the wrapper's calls
that launched them.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.feature_maps import inv_sqrt, raw_features
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (F, FEATURE_COUNTS, I, INPUT_DTYPES,
                                         P, check_cuda, expect,
                                         expect_aligned, ptr, stream)

F32 = (torch.float32,)
launches = 0


def prf_fused_decode_plain(q, k, v, a, m_mat, s, z, c, *,
                           stabilize: bool = True, eps: float = 1e-6):
    """Plain PyTorch version of the kernel (port of
    ``repro.kernels.ref.prf_fused_decode_ref``), updating s, z, c in
    place like the kernel. Returns (out (B, G, Hg, dv) f32, s, z, c)."""
    isq = inv_sqrt(a.shape[-1])
    qraw = raw_features(q, a, m_mat, "bghd")             # (B, G, Hg, m)
    kraw = raw_features(k, a, m_mat, "bgd")              # (B, G, m)
    if stabilize:
        qf = torch.exp(qraw - qraw.amax(-1, keepdim=True)) * isq
        c_new = torch.maximum(c, kraw.amax(-1))
        rho = torch.exp(c - c_new)
        kf = torch.exp(kraw - c_new[..., None]) * isq
    else:
        qf = torch.exp(qraw) * isq
        c_new = torch.zeros_like(c)
        rho = torch.exp(c)
        kf = torch.exp(kraw) * isq
    s_new = (s * rho[:, :, None, None, None]
             + kf[:, :, None, :, None] * v.float()[:, :, None, None, :])
    z_new = z * rho[:, :, None, None] + kf[:, :, None, :]
    num = torch.einsum("bghm,bghmd->bghd", qf, s_new)
    den = torch.einsum("bghm,bghm->bgh", qf, z_new)[..., None]
    s.copy_(s_new)
    z.copy_(z_new)
    c.copy_(c_new)
    return num / (den + eps), s, z, c


@functools.cache
def _c_fn():
    fn = _build.load("prf_fused_decode").prf_fused_decode
    fn.argtypes = [P] * 10 + [I] * 9 + [F, F, P]
    fn.restype = I
    return fn


def fused_prf_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     a: torch.Tensor, m_mat: Optional[torch.Tensor],
                     s: torch.Tensor, z: torch.Tensor, c: torch.Tensor, *,
                     stabilize: bool = True, eps: float = 1e-6):
    """Advance a (B, G)-slot pool by one token, fully fused, in place.

    q: (B, G, Hg, d); k, v: (B, G, d|dv) in f32 or bf16; a: (G, d, m)
    f32 precomposed (W M)^T; m_mat: (G, r, d) f32 or None; s: (B, G, Hg,
    m, dv), z: (B, G, Hg, m), c: (B, G), all f32 and updated in place.
    Every tensor must be contiguous. On CUDA the kernel also takes m in
    ``FEATURE_COUNTS``, d and dv multiples of 4 and a, m_mat, s and z on
    16-byte boundaries. Returns (out (B, G, Hg, dv) f32, s, z, c).
    """
    b, g, hg, d = q.shape
    m = a.shape[-1]
    dv = v.shape[-1]
    dev = q.device
    expect("q", q, (b, g, hg, d), INPUT_DTYPES, dev)
    expect("k", k, (b, g, d), (q.dtype,), dev)
    expect("v", v, (b, g, dv), (q.dtype,), dev)
    expect("a", a, (g, d, m), F32, dev)
    r = d
    if m_mat is not None:
        r = m_mat.shape[1]
        expect("m_mat", m_mat, (g, r, d), F32, dev)
    expect("s", s, (b, g, hg, m, dv), F32, dev)
    expect("z", z, (b, g, hg, m), F32, dev)
    expect("c", c, (b, g), F32, dev)
    if dev.type == "cpu":
        return prf_fused_decode_plain(q, k, v, a, m_mat, s, z, c,
                                      stabilize=stabilize, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"fused_prf_decode runs on cuda or cpu, not {dev}")
    if m not in FEATURE_COUNTS or d % 4 or dv % 4:
        raise ValueError(f"prf_fused_decode is built for m in "
                         f"{FEATURE_COUNTS} and d, dv multiples of 4, got "
                         f"m={m}, d={d}, dv={dv}")
    expect_aligned("prf_fused_decode", a=a, s=s, z=z,
                   **({} if m_mat is None else {"m_mat": m_mat}))
    global launches
    out = torch.empty((b, g, hg, dv), dtype=torch.float32, device=dev)
    # per (b, g) the features (qf of the Hg heads, then kf), then ρ per
    # (b, g)
    scratch = torch.empty(b * g * ((hg + 1) * m + 1), dtype=torch.float32,
                          device=dev)
    err = _c_fn()(ptr(q), ptr(k), ptr(v), ptr(a), ptr(m_mat), ptr(s),
                  ptr(z), ptr(c), ptr(scratch), ptr(out),
                  b, g, hg, d, r, m, dv, int(q.dtype == torch.bfloat16),
                  int(stabilize), eps, inv_sqrt(m), stream(dev))
    check_cuda(err, "prf_fused_decode")
    launches += 1
    return out, s, z, c

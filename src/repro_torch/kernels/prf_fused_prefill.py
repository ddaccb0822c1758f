"""Fused resumable data-aligned PRF prefill chunk: the Hopper kernel's
wrapper and its plain PyTorch version.

Replaces ``repro.kernels.prf_fused_prefill.prf_fused_prefill_fwd`` (a
Pallas TPU kernel). The CUDA kernel is ``csrc/prf_fused_prefill.cu``.
Over each internal T-chunk (``chunk`` tokens) of a packed (B, L) chunk:

    qraw = q A − ‖Mq‖²/2          kraw = k A − ‖Mk‖²/2
    c'   = max(c, max_{valid,m} kraw)    ρ = exp(c − c')
    qf   = exp(qraw − max_{valid,m} qraw)/√m
    kf   = [pos < valid_len] · exp(kraw − c')/√m
    out  = (qf·(ρS) + tril(qf kfᵀ)·v) / (qf·(ρz) + Σ tril(qf kfᵀ) + ε)
    S'   = ρS + kfᵀv              z' = ρz + Σ_T kf

with (S, z, c) carried from one T-chunk to the next and written in
place. A row's positions at or past its ``valid_len`` leave no trace in
the state; outputs there are garbage by contract. Since the running max
advances once per T-chunk, the plain version chains the one-chunk
oracle (port of ``repro.kernels.ref.prf_fused_prefill_ref``) T tokens
at a time, as the kernel does.

A CPU tensor runs :func:`prf_fused_prefill_plain`; a CUDA tensor
launches the kernel (or raises): per T-chunk three launches (logits,
outputs, state), four with a prefix launch when the T-chunk holds more
than 64 tokens; the C entry point checks for an error after each.
``launches`` counts the wrapper's calls that launched them.
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
PREFIX_STEP = 64                     # tokens a prefix step (kSub in the .cu)
NEG = torch.finfo(torch.float32).min
launches = 0


def _one_chunk(q, k, v, a, m_mat, s, z, c, valid, stabilize, eps):
    """One T-chunk, one running-max advance: the oracle of the kernel's
    inner step. valid: (B, T) bool. Returns (out f32, s', z', c')."""
    isq = inv_sqrt(a.shape[-1])
    t = q.shape[3]
    qraw = raw_features(q, a, m_mat, "bghld")            # (B, G, Hg, T, m)
    kraw = raw_features(k, a, m_mat, "bgld")             # (B, G, T, m)
    vk = valid[:, None, :, None]
    if stabilize:
        c_new = torch.maximum(
            c, torch.where(vk, kraw, NEG).amax(dim=(-2, -1)))
        rho = torch.exp(c - c_new)
        kf = torch.exp(kraw - c_new[..., None, None]) * isq
        qmax = torch.where(valid[:, None, None, :, None], qraw,
                           NEG).amax(dim=(-2, -1), keepdim=True)
        qf = torch.exp(qraw - qmax) * isq
    else:
        c_new = torch.zeros_like(c)
        rho = torch.exp(c)
        kf = torch.exp(kraw) * isq
        qf = torch.exp(qraw) * isq
    kf = torch.where(vk, kf, 0.0)
    v = v.float()
    s0 = s * rho[:, :, None, None, None]
    z0 = z * rho[:, :, None, None]
    tril = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    local = torch.einsum("bghqm,bgkm->bghqk", qf, kf) * tril
    num = (torch.einsum("bghqm,bghmd->bghqd", qf, s0)
           + torch.einsum("bghqk,bgkd->bghqd", local, v))
    den = torch.einsum("bghqm,bghm->bghq", qf, z0) + local.sum(-1)
    s_new = s0 + torch.einsum("bgkm,bgkd->bgmd", kf, v)[:, :, None]
    z_new = z0 + kf.sum(-2)[:, :, None]
    return num / (den[..., None] + eps), s_new, z_new, c_new


def prf_fused_prefill_plain(q, k, v, a, m_mat, s, z, c, valid_len=None, *,
                            stabilize: bool = True, eps: float = 1e-6,
                            chunk: int = 256):
    """Plain PyTorch version of the kernel, updating s, z, c in place.
    Returns (out (B, G, Hg, L, dv) in v.dtype, s, z, c)."""
    b, _, _, l, _ = q.shape
    pos = torch.arange(l, device=q.device)
    vl = (torch.full((b,), l, device=q.device) if valid_len is None
          else valid_len)
    valid = pos[None] < vl[:, None]
    s_run, z_run, c_run = s, z, c
    outs = []
    for t0 in range(0, l, chunk):
        t1 = min(t0 + chunk, l)
        o, s_run, z_run, c_run = _one_chunk(
            q[:, :, :, t0:t1], k[:, :, t0:t1], v[:, :, t0:t1], a, m_mat,
            s_run, z_run, c_run, valid[:, t0:t1], stabilize, eps)
        outs.append(o)
    s.copy_(s_run)
    z.copy_(z_run)
    c.copy_(c_run)
    return torch.cat(outs, dim=3).to(v.dtype), s, z, c


@functools.cache
def _c_fn():
    fn = _build.load("prf_fused_prefill").prf_fused_prefill
    fn.argtypes = [P] * 11 + [I] * 11 + [F, F, P]
    fn.restype = I
    return fn


def fused_prf_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      a: torch.Tensor, m_mat: Optional[torch.Tensor],
                      s: torch.Tensor, z: torch.Tensor, c: torch.Tensor,
                      valid_len: Optional[torch.Tensor] = None, *,
                      stabilize: bool = True, eps: float = 1e-6,
                      chunk: int = 256):
    """Advance a (B, G)-state pool over a packed L-token chunk, fused,
    in place.

    q: (B, G, Hg, L, d); k, v: (B, G, L, d|dv) in f32 or bf16; a: (G, d,
    m) f32 precomposed (W M)^T; m_mat: (G, r, d) f32 or None; s: (B, G,
    Hg, m, dv), z: (B, G, Hg, m), c: (B, G), all f32 and updated in
    place; valid_len: (B,) int32 or None (all rows full). Every tensor
    must be contiguous. The kernel also takes a, v, s and z on 16-byte
    boundaries, a row of v in whole 16-byte pieces (dv a multiple of 8
    in bf16, of 4 in f32) and r <= 256. Returns (out (B, G, Hg, L, dv) in
    v.dtype, s, z, c).
    """
    b, g, hg, l, d = q.shape
    m = a.shape[-1]
    dv = v.shape[-1]
    dev = q.device
    expect("q", q, (b, g, hg, l, d), INPUT_DTYPES, dev)
    expect("k", k, (b, g, l, d), (q.dtype,), dev)
    expect("v", v, (b, g, l, dv), (q.dtype,), dev)
    expect("a", a, (g, d, m), F32, dev)
    r = d
    if m_mat is not None:
        r = m_mat.shape[1]
        expect("m_mat", m_mat, (g, r, d), F32, dev)
    expect("s", s, (b, g, hg, m, dv), F32, dev)
    expect("z", z, (b, g, hg, m), F32, dev)
    expect("c", c, (b, g), F32, dev)
    if valid_len is not None:
        expect("valid_len", valid_len, (b,), (torch.int32,), dev)
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    if dev.type == "cpu":
        return prf_fused_prefill_plain(q, k, v, a, m_mat, s, z, c,
                                       valid_len, stabilize=stabilize,
                                       eps=eps, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"fused_prf_prefill runs on cuda or cpu, not {dev}")
    if m not in FEATURE_COUNTS:
        raise ValueError(f"prf_fused_prefill is built for m in "
                         f"{FEATURE_COUNTS}, got m={m}")
    if dv * v.element_size() % 16 or (m_mat is not None and r > 256):
        raise ValueError(f"prf_fused_prefill takes rows of v in 16-byte "
                         f"pieces and r <= 256, got dv={dv} of {v.dtype}, "
                         f"r={r}")
    expect_aligned("prf_fused_prefill", a=a, v=v, s=s, z=z)
    global launches
    out = torch.empty((b, g, hg, l, dv), dtype=v.dtype, device=dev)
    # reused by every T-chunk of the call: the raw q and k logits (B, G,
    # Hg + 1, T, m); kf^T v and sum kf of the prefix steps (64 tokens a
    # step) but the last; the running-max slots (B, G, Hg + 1); c' and
    # rho per (b, g)
    t = min(chunk, l)
    steps = -(-t // PREFIX_STEP) - 1
    scratch = torch.empty(
        b * g * ((hg + 1) * t * m + steps * m * (dv + 1) + hg + 3),
        dtype=torch.float32, device=dev)
    err = _c_fn()(ptr(q), ptr(k), ptr(v), ptr(a), ptr(m_mat),
                  ptr(valid_len), ptr(s), ptr(z), ptr(c), ptr(scratch),
                  ptr(out), b, g, hg, l, d, r, m, dv, chunk,
                  int(q.dtype == torch.bfloat16), int(stabilize),
                  eps, inv_sqrt(m), stream(dev))
    check_cuda(err, "prf_fused_prefill")
    launches += 1
    return out, s, z, c

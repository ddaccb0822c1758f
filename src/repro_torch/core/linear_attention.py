"""Linear (random-feature) attention: non-causal, causal naive, and the
chunked causal scan from a zero or a carried state.

The counterpart of ``repro.core.linear_attention`` for the PRF kinds
(exact softmax attention and the random/constant baselines are ROADMAP
A3). Layout: (..., L, m) features, (..., L, dv) values.
"""
from __future__ import annotations

from typing import Optional

import torch


def linear_attention_noncausal(qf: torch.Tensor, kf: torch.Tensor,
                               v: torch.Tensor,
                               eps: float = 1e-6) -> torch.Tensor:
    """(Q' (K'^T V)) / (Q' sum_j K'_j). qf, kf: (..., L, m); v: (..., L,
    dv). Returns v.dtype."""
    qf, kf = qf.float(), kf.float()
    kv = torch.einsum("...lm,...ld->...md", kf, v.float())
    num = torch.einsum("...lm,...md->...ld", qf, kv)
    den = torch.einsum("...lm,...m->...l", qf, kf.sum(-2))
    return (num / (den[..., None] + eps)).to(v.dtype)


def linear_attention_causal_naive(qf: torch.Tensor, kf: torch.Tensor,
                                  v: torch.Tensor,
                                  eps: float = 1e-6) -> torch.Tensor:
    """O(L^2) masked form, the ground truth of the chunked scan and the
    plain version of the causal linear-attention kernel. Leading axes
    broadcast (kf and v may have one head for qf's H). Returns
    v.dtype."""
    scores = torch.einsum("...qm,...km->...qk", qf.float(), kf.float())
    l = qf.shape[-2]
    mask = torch.ones(l, l, dtype=torch.bool, device=qf.device).tril()
    scores = torch.where(mask, scores, 0.0)
    num = torch.einsum("...qk,...kd->...qd", scores, v.float())
    den = scores.sum(-1, keepdim=True)
    return (num / (den + eps)).to(v.dtype)


def linear_attention_causal_carry(qf: torch.Tensor, kf: torch.Tensor,
                                  v: torch.Tensor,
                                  s0: Optional[torch.Tensor] = None,
                                  z0: Optional[torch.Tensor] = None, *,
                                  chunk: int = 256, eps: float = 1e-6):
    """Chunked prefix-state causal linear attention from a carried state:

      per chunk:  out_c = Q'_c S_in + tril(Q'_c K'_c^T) V_c
                  den_c = Q'_c z_in + tril(Q'_c K'_c^T) 1
                  S_out = S_in + K'_c^T V_c ;  z_out = z_in + sum K'_c

    ``s0`` (..., m, dv) / ``z0`` (..., m) seed the scan (zeros when None).
    Returns (out in v.dtype, s_final f32, z_final f32).
    """
    *batch, l, m = qf.shape
    dv = v.shape[-1]
    f32 = torch.float32
    s = (torch.zeros((*batch, m, dv), dtype=f32, device=qf.device)
         if s0 is None else s0.float().expand(*batch, m, dv))
    z = (torch.zeros((*batch, m), dtype=f32, device=qf.device)
         if z0 is None else z0.float().expand(*batch, m))
    outs = []
    for t0 in range(0, l, chunk):
        qb = qf[..., t0:t0 + chunk, :].float()
        kb = kf[..., t0:t0 + chunk, :].float()
        vb = v[..., t0:t0 + chunk, :].float()
        t = qb.shape[-2]
        tri = torch.ones(t, t, dtype=f32, device=qf.device).tril()
        local = torch.einsum("...qm,...km->...qk", qb, kb) * tri
        num = (torch.einsum("...qm,...md->...qd", qb, s)
               + torch.einsum("...qk,...kd->...qd", local, vb))
        den = torch.einsum("...qm,...m->...q", qb, z) + local.sum(-1)
        outs.append(num / (den[..., None] + eps))
        s = s + torch.einsum("...km,...kd->...md", kb, vb)
        z = z + kb.sum(-2)
    return torch.cat(outs, dim=-2).to(v.dtype), s, z


def linear_attention_causal_chunked(qf: torch.Tensor, kf: torch.Tensor,
                                    v: torch.Tensor, chunk: int = 256,
                                    eps: float = 1e-6) -> torch.Tensor:
    """Fresh-sequence (zero initial state) chunked causal linear
    attention."""
    out, _, _ = linear_attention_causal_carry(qf, kf, v, chunk=chunk,
                                              eps=eps)
    return out

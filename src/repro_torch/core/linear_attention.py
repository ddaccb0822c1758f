"""Chunked causal linear attention from a carried state.

The counterpart of ``repro.core.linear_attention`` for the serving path:
only the carried-state scan, which the plain (``use_kernel=False``)
resumed prefill runs. Layout: (..., L, m) features, (..., L, dv) values.
"""
from __future__ import annotations

from typing import Optional

import torch


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

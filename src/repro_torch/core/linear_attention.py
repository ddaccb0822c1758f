"""Linear (random-feature) attention and the exact-softmax baselines.

The counterpart of ``repro.core.linear_attention``: exact softmax
attention (causal, bidirectional, sliding-window) and the paper's
constant and random baselines, which the reference computes in plain
``jnp`` outside any Pallas kernel and the port in plain torch; then
linear attention, non-causal, causal naive, the chunked causal scan from
a zero or a carried state, and the O(1) decode state. Layout: (..., L,
d) queries and keys, (..., L, m) features, (..., L, dv) values.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


# ---------------------------------------------------------------------------
# Exact attention baselines
# ---------------------------------------------------------------------------

def exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_dtype=torch.float32) -> torch.Tensor:
    """Softmax attention; q and k already scaled by d^{-1/4} each.
    Leading axes broadcast (k and v may have one head for q's group).

    The logits are computed in the inputs' type and then cast to
    ``logit_dtype``, as the reference's einsum does (bf16 logits for bf16
    q and k). ``window``: sliding-window size, counted inclusive of the
    current token. Returns v.dtype."""
    l_q, l_k = q.shape[-2], k.shape[-2]
    logits = torch.einsum("...qd,...kd->...qk", q, k).to(logit_dtype)
    idx_q = torch.arange(l_q, device=q.device)[:, None] + (l_k - l_q)
    idx_k = torch.arange(l_k, device=q.device)[None, :]
    mask = torch.ones(l_q, l_k, dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx_k <= idx_q
    if window is not None:
        mask &= idx_k > idx_q - window
    logits = torch.where(mask, logits, torch.finfo(logit_dtype).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("...qk,...kd->...qd", probs,
                        v.to(probs.dtype)).to(v.dtype)


def constant_attention(v: torch.Tensor, *, causal: bool = True
                       ) -> torch.Tensor:
    """Uniform-weights baseline (paper section 6): the causal running mean
    of V, or the mean over all positions. Returns v.dtype."""
    if causal:
        csum = v.float().cumsum(dim=-2)
        denom = torch.arange(1, v.shape[-2] + 1, dtype=torch.float32,
                             device=v.device)
        return (csum / denom[:, None]).to(v.dtype)
    return v.float().mean(dim=-2, keepdim=True).to(v.dtype).expand(v.shape)


def random_draw(l: int, gen: Optional[torch.Generator] = None,
                device="cpu") -> torch.Tensor:
    """The random baseline's (l, l) f32 normal logits, drawn on the CPU
    from ``gen`` and then moved, so a seed gives the same draw on every
    device. (The reference draws with ``jax.random``: other numbers.)"""
    return torch.randn((l, l), generator=gen, dtype=torch.float32
                       ).to(device)


def random_attention(draw: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True) -> torch.Tensor:
    """Fixed random attention weights baseline (paper section 6): the
    softmax of ``draw`` ((L, L) f32 logits, e.g. :func:`random_draw`),
    masked to -inf above the diagonal when causal, applied to v.
    Returns v.dtype."""
    logits = draw.float()
    if causal:
        l = v.shape[-2]
        mask = torch.ones(l, l, dtype=torch.bool, device=v.device).tril()
        logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("qk,...kd->...qd", probs, v.float()).to(v.dtype)


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


class LinearState(NamedTuple):
    """O(1) decode state for linear attention: S (m x dv) and z (m)."""
    s: torch.Tensor   # (..., m, dv) f32
    z: torch.Tensor   # (..., m)     f32

    @classmethod
    def zeros(cls, batch_shape: tuple, m: int, dv: int,
              device="cpu") -> "LinearState":
        return cls(torch.zeros((*batch_shape, m, dv), dtype=torch.float32,
                               device=device),
                   torch.zeros((*batch_shape, m), dtype=torch.float32,
                               device=device))


def linear_attention_prefill(qf: torch.Tensor, kf: torch.Tensor,
                             v: torch.Tensor, chunk: int = 256,
                             eps: float = 1e-6):
    """Full-sequence causal pass that also returns the final decode state.
    Returns (out in v.dtype, LinearState)."""
    out = linear_attention_causal_chunked(qf, kf, v, chunk=chunk, eps=eps)
    s = torch.einsum("...lm,...ld->...md", kf.float(), v.float())
    return out, LinearState(s, kf.float().sum(-2))


def linear_attention_decode(qf: torch.Tensor, kf: torch.Tensor,
                            v: torch.Tensor, state: LinearState,
                            eps: float = 1e-6):
    """One-token decode. qf, kf: (..., m); v: (..., dv). Returns (out in
    v.dtype, the new LinearState)."""
    qf, kf = qf.float(), kf.float()
    s = state.s + kf[..., :, None] * v.float()[..., None, :]
    z = state.z + kf
    num = torch.einsum("...m,...md->...d", qf, s)
    den = torch.einsum("...m,...m->...", qf, z)
    return (num / (den[..., None] + eps)).to(v.dtype), LinearState(s, z)


def sequence_parallel_state_combine(partial_states: LinearState,
                                    group=None) -> LinearState:
    """Sequence-parallel prefill: each rank's prefix state over its own
    slice of the sequence, summed over the ranks of ``group`` (None: the
    default group) with one all-reduce of (S, z) packed in one buffer.
    The state update is associative, so the sum is the whole sequence's
    state. Returns a new LinearState; the inputs are left alone."""
    import torch.distributed as dist
    s, z = partial_states.s, partial_states.z
    buf = torch.cat([s.reshape(-1), z.reshape(-1)])
    dist.all_reduce(buf, group=group)
    return LinearState(buf[:s.numel()].view(s.shape),
                       buf[s.numel():].view(z.shape))

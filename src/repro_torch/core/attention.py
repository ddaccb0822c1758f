"""The paper's PRF attention for serving: resumed prefill and decode.

The counterpart of the serving half of ``repro.core.attention``. Layout:
q is (B, G, Hg, L, d) — G KV groups, Hg query heads per group; k, v are
(B, G, 1, L, d). Feature params are per group: {"w": (G, m, r),
"m_mat": (G, r, d)}.

Stability contract for the PRF kinds: the q features may take any
per-(b, g, h, position) shift, since it cancels in num/den; the k
features need one shift for all positions, so the serve state carries a
running max ``c`` and rescales (S, z) by exp(c_old - c_new) whenever a
new key exceeds it. A fresh state has c = -1e30 (finite, so that
exp(c - c') never meets -inf - -inf).

Both entry points advance the incoming :class:`AttnServeState` IN PLACE
(the fused kernels write S, z and c where they lie; the plain path
copies its result there) and return it beside the attention output.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import kernels as kops
from repro_torch.core import feature_maps as fm
from repro_torch.core import linear_attention as la

PRF_KINDS = fm.PRF_KINDS
NEG = torch.finfo(torch.float32).min


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue A, items A3/A9)")


def _scale_qk(q: torch.Tensor, k: torch.Tensor):
    """Absorb the 1/sqrt(d) softmax temperature symmetrically."""
    s = q.shape[-1] ** -0.25
    return q * s, k * s


def _raw_logits(x: torch.Tensor, fparams: dict, kind: str) -> torch.Tensor:
    """PRF pre-exp logits: w.x - ||x||^2/2 (performer/lfk) or
    w.(Mx) - ||Mx||^2/2 (darkformer). x: (B, G, H, L, d) -> (B, G, H, L,
    m), f32."""
    w = fparams["w"].float()                          # (G, m, r)
    x = x.float()
    if kind == "darkformer":
        x = torch.einsum("bghld,grd->bghlr", x, fparams["m_mat"].float())
    elif kind not in ("performer", "lfk"):
        raise ValueError(f"unsupported feature kind {kind!r}")
    return (torch.einsum("bghlr,gmr->bghlm", x, w)
            - 0.5 * torch.sum(x * x, dim=-1, keepdim=True))


def _stab_max(raw: torch.Tensor, enabled: bool) -> torch.Tensor:
    if not enabled:
        return torch.zeros(raw.shape[:-2] + (1, 1), dtype=raw.dtype,
                           device=raw.device)
    return raw.amax(dim=(-2, -1), keepdim=True)


def _resume_qk_features(qs, ks, fparams, cfg: fm.FeatureConfig, c_in,
                        valid_mask: Optional[torch.Tensor] = None):
    """Feature pair against the running k-stabilizer carried in ``c_in``:
    the new max folds the incoming one, and the carried (S, z) must be
    scaled by ``rescale = exp(c_in - c_new)``. ``valid_mask`` ((B, 1, 1,
    L, 1) bool or None) marks ragged-row padding: masked positions add
    nothing to the maxes and get zero k-features.
    Returns (qf, kf, c_new, rescale)."""
    isq = fm.inv_sqrt(cfg.num_features)
    qraw = _raw_logits(qs, fparams, cfg.kind)
    kraw = _raw_logits(ks, fparams, cfg.kind)
    if valid_mask is not None:
        qraw_m = torch.where(valid_mask, qraw, NEG)
        kraw_m = torch.where(valid_mask, kraw, NEG)
    else:
        qraw_m, kraw_m = qraw, kraw
    qf = torch.exp(qraw - _stab_max(qraw_m, cfg.stabilize)) * isq
    if cfg.stabilize:
        c_new = torch.maximum(c_in, _stab_max(kraw_m, True))
    else:
        c_new = torch.zeros_like(c_in)
    rescale = torch.exp(c_in - c_new)                  # <= 1
    kf = torch.exp(kraw - c_new) * isq
    if valid_mask is not None:
        kf = torch.where(valid_mask, kf, 0.0)
    return qf, kf, c_new, rescale


class AttnServeState(NamedTuple):
    """PRF serving state: running (S, z) plus the running k-stabilizer
    ``c``. Every leaf has a leading batch axis, so the state doubles as a
    slot pool (slot i is batch row i). The exact-attention KV cache and
    its paged form are not ported yet."""
    s: torch.Tensor                 # (B, G, Hg, m, dv) f32
    z: torch.Tensor                 # (B, G, Hg, m)     f32
    c: torch.Tensor                 # (B, G, 1, 1, 1)   f32


def init_linear_serve_state(b, g, hg, m, dv, device="cuda"
                            ) -> AttnServeState:
    f32 = torch.float32
    return AttnServeState(
        s=torch.zeros((b, g, hg, m, dv), dtype=f32, device=device),
        z=torch.zeros((b, g, hg, m), dtype=f32, device=device),
        c=torch.full((b, g, 1, 1, 1), -1e30, dtype=f32, device=device))


def _write_state(state: AttnServeState, s, z, c) -> AttnServeState:
    state.s.copy_(s)
    state.z.copy_(z)
    state.c.copy_(c)
    return state


def rf_attention_prefill(q, k, v, fparams, cfg: fm.FeatureConfig, *,
                         state: Optional[AttnServeState] = None,
                         chunk: int = 256, use_kernel: bool = False,
                         valid_len: Optional[torch.Tensor] = None,
                         proj: Optional[dict] = None):
    """Causal pass over a prompt chunk that resumes from ``state``.

    The chunk attends to the carried prefix, and the stabilizer is a
    running max with an online exp(c_old - c_new) rescale of (S, z).
    ``valid_len`` ((B,) int32) makes the chunk ragged: row b advances over
    its first ``valid_len[b]`` positions only; outputs at padded positions
    are garbage by contract. With ``use_kernel`` and the precomposed
    ``proj`` (``fm.precompose_projection``) the chunk runs the fused
    ``prf_fused_prefill`` kernel; otherwise the plain feature map plus
    the carried-state scan. Returns (out (B, G, Hg, L, dv) in v.dtype,
    state advanced in place).
    """
    if cfg.kind == "exact":
        raise _not_ported("exact-attention prefill")
    if state is None:
        raise _not_ported("whole-prompt prefill without a serve state")
    if cfg.kind not in PRF_KINDS:
        raise ValueError(f"no serving path for kind {cfg.kind!r}")
    b, g, hg, l, _ = q.shape
    dv = v.shape[-1]
    qs, ks = _scale_qk(q, k)
    if use_kernel and proj is not None:
        out, _, _, _ = kops.fused_prf_prefill(
            qs.contiguous(), ks[:, :, 0].contiguous(),
            v[:, :, 0].contiguous(), proj["a"], proj.get("m_mat"),
            state.s, state.z, state.c.view(b, g), valid_len,
            stabilize=cfg.stabilize, eps=cfg.eps, chunk=chunk)
        return out.to(v.dtype), state
    vmask = (None if valid_len is None else
             (torch.arange(l, device=q.device)[None] < valid_len[:, None])
             .reshape(b, 1, 1, l, 1))
    qf, kf, c_new, rescale = _resume_qk_features(qs, ks, fparams, cfg,
                                                 state.c, valid_mask=vmask)
    kfb = kf.expand(b, g, hg, l, cfg.num_features)
    vv = v.expand(b, g, hg, l, dv)
    out, s, z = la.linear_attention_causal_carry(
        qf, kfb, vv, state.s * rescale, state.z * rescale[..., 0],
        chunk=chunk, eps=cfg.eps)
    return out, _write_state(state, s, z, c_new)


def rf_attention_decode(q, k, v, state: AttnServeState, fparams,
                        cfg: fm.FeatureConfig, *, use_kernel: bool = False,
                        proj: Optional[dict] = None):
    """One-token decode. q: (B, G, Hg, 1, d); k, v: (B, G, 1, 1, d).
    With ``use_kernel`` and the precomposed ``proj`` the step runs the
    fused ``prf_fused_decode`` kernel; otherwise the plain feature map
    and rank-1 update. Returns (out (B, G, Hg, 1, dv) in v.dtype, state
    advanced in place)."""
    if cfg.kind == "exact":
        raise _not_ported("exact-attention decode")
    if cfg.kind not in PRF_KINDS:
        raise ValueError(f"no serving path for kind {cfg.kind!r}")
    b, g, hg, _, _ = q.shape
    dv = v.shape[-1]
    qs, ks = _scale_qk(q, k)
    if use_kernel and proj is not None:
        out, _, _, _ = kops.fused_prf_decode(
            qs[..., 0, :].contiguous(), ks[:, :, 0, 0, :].contiguous(),
            v[:, :, 0, 0, :].contiguous(), proj["a"], proj.get("m_mat"),
            state.s, state.z, state.c.view(b, g),
            stabilize=cfg.stabilize, eps=cfg.eps)
        return out.to(v.dtype)[..., None, :], state
    qf, kf, c_new, rescale = _resume_qk_features(qs, ks, fparams, cfg,
                                                 state.c)
    kfb = kf[:, :, :, 0].expand(b, g, hg, cfg.num_features)
    vv = v[:, :, :, 0].expand(b, g, hg, dv).float()
    qf1 = qf[..., 0, :]                                   # (B, G, Hg, m)
    s = state.s * rescale + kfb[..., :, None] * vv[..., None, :]
    z = state.z * rescale[..., 0] + kfb
    num = torch.einsum("bghm,bghmd->bghd", qf1, s)
    den = torch.einsum("bghm,bghm->bgh", qf1, z)
    out = (num / (den[..., None] + cfg.eps)).to(v.dtype)
    return out[..., None, :], _write_state(state, s, z, c_new)

"""The paper's PRF attention: training-time attention, resumed prefill and
decode.

The counterpart of ``repro.core.attention`` for the PRF kinds. Layout:
q is (B, G, Hg, L, d) — G KV groups, Hg query heads per group; k, v are
(B, G, 1, L, d). Feature params are per group: {"w": (G, m, r),
"m_mat": (G, r, d)}.

Stability contract for the PRF kinds: the q features may take any
per-(b, g, h, position) shift, since it cancels in num/den; the k
features need one shift for all positions, so the serve state carries a
running max ``c`` and rescales (S, z) by exp(c_old - c_new) whenever a
new key exceeds it. A fresh state has c = -1e30 (finite, so that
exp(c - c') never meets -inf - -inf).

Trainability contract (paper section 6): the projection W is a fixed
random draw for performer and darkformer (no gradient); only the lfk
baseline trains W, and only darkformer trains M (the learned covariance
Sigma = M^T M). The stabilizers carry no gradient either.

The serving entry points advance the incoming :class:`AttnServeState`
IN PLACE (the kernels write S, z and c where they lie; the plain path
copies its result there) and return it beside the attention output; a
whole-prompt prefill (no incoming state) returns a new one.
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
    m), f32. W carries a gradient for lfk only."""
    w = fparams["w"].float()                          # (G, m, r)
    if kind != "lfk":
        w = w.detach()
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
    return raw.detach().amax(dim=(-2, -1), keepdim=True)


def _qk_feature_pair(q, k, fparams, cfg: fm.FeatureConfig):
    """q: (B, G, Hg, L, d), k: (B, G, 1, L, d) -> qf (B, G, Hg, L, m),
    kf (B, G, 1, L, m), and the k stabilizer."""
    isq = fm.inv_sqrt(cfg.num_features)
    qraw = _raw_logits(q, fparams, cfg.kind)
    kraw = _raw_logits(k, fparams, cfg.kind)
    qf = torch.exp(qraw - _stab_max(qraw, cfg.stabilize)) * isq
    kc = _stab_max(kraw, cfg.stabilize)
    return qf, torch.exp(kraw - kc) * isq, kc


def rf_attention(q, k, v, fparams, cfg: fm.FeatureConfig, *,
                 causal: bool = True, chunk: int = 256,
                 use_kernel: bool = False) -> torch.Tensor:
    """Training-time attention over whole sequences. q: (B, G, Hg, L, d);
    k, v: (B, G, 1, L, d). Causal with ``use_kernel`` runs the hand-written
    ``linear_attention_causal`` kernel (its plain version on a CPU tensor),
    reading k's features and v once per KV group; otherwise the chunked
    plain scan. Returns (B, G, Hg, L, dv) in v.dtype."""
    if cfg.kind in ("exact", "constant", "random"):
        raise _not_ported(f"{cfg.kind!r} attention")
    if cfg.kind not in PRF_KINDS:
        raise ValueError(f"unsupported feature kind {cfg.kind!r}")
    b, g, hg, l, _ = q.shape
    dv = v.shape[-1]
    qs, ks = _scale_qk(q, k)
    qf, kf, _ = _qk_feature_pair(qs, ks, fparams, cfg)
    if causal and use_kernel:
        return kops.linear_attention_causal(
            qf.contiguous(), kf.contiguous(), v.contiguous(), eps=cfg.eps)
    kf = kf.expand(b, g, hg, l, cfg.num_features)
    vv = v.expand(b, g, hg, l, dv)
    if not causal:
        return la.linear_attention_noncausal(qf, kf, vv, eps=cfg.eps)
    return la.linear_attention_causal_chunked(qf, kf, vv, chunk=chunk,
                                              eps=cfg.eps)


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
    """Causal pass over a prompt: the whole prompt (``state`` None) or a
    chunk that resumes from ``state``.

    Whole prompt: causal attention from zero (the ``linear_attention_causal``
    kernel under ``use_kernel``, else the chunked plain scan) and a fresh
    state from the prompt's features. Resumed: the chunk attends to the
    carried prefix, and the stabilizer is a running max with an online
    exp(c_old - c_new) rescale of (S, z). ``valid_len`` ((B,) int32) makes
    the chunk ragged: row b advances over its first ``valid_len[b]``
    positions only; outputs at padded positions are garbage by contract.
    With ``use_kernel`` a resumed chunk runs the fused
    ``prf_fused_prefill`` kernel when ``proj`` carries the precomposed
    projection (``fm.precompose_projection``), and otherwise the two
    stages: the plain feature map, then the carried-scan kernel
    ``linear_attention_prefill_chunk``. Without ``use_kernel``, the plain
    feature map and carried-state scan. Returns (out (B, G, Hg, L, dv) in
    v.dtype, state: a new one for the whole prompt, else ``state``
    advanced in place).
    """
    if cfg.kind == "exact":
        raise _not_ported("exact-attention prefill")
    if cfg.kind not in PRF_KINDS:
        raise ValueError(f"no serving path for kind {cfg.kind!r}")
    if valid_len is not None and state is None:
        raise ValueError("valid_len requires an incoming serve state "
                         "(ragged rows only arise in resumed chunks)")
    b, g, hg, l, _ = q.shape
    dv = v.shape[-1]
    qs, ks = _scale_qk(q, k)
    if state is None:
        qf, kf, kc = _qk_feature_pair(qs, ks, fparams, cfg)
        if use_kernel:
            out = kops.linear_attention_causal(
                qf.contiguous(), kf.contiguous(), v.contiguous(), eps=cfg.eps)
        else:
            out = la.linear_attention_causal_chunked(
                qf, kf.expand(b, g, hg, l, cfg.num_features),
                v.expand(b, g, hg, l, dv), chunk=chunk, eps=cfg.eps)
        s = torch.einsum("bgklm,bgkld->bgkmd", kf, v.float())
        return out, AttnServeState(
            s=s.expand(b, g, hg, *s.shape[-2:]).contiguous(),
            z=kf.sum(-2).expand(b, g, hg, cfg.num_features).contiguous(),
            c=kc)
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
    if use_kernel:
        # the pool rescaled and advanced where it lies, in one pass
        out, _, _ = kops.linear_attention_prefill_chunk(
            qf.contiguous(), kf.contiguous(), v.contiguous(), state.s,
            state.z, rho=rescale[..., 0, 0].expand(b, g, hg).contiguous(),
            eps=cfg.eps)
        state.c.copy_(c_new)
        return out, state
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
    With ``use_kernel`` the step runs the fused ``prf_fused_decode``
    kernel when ``proj`` carries the precomposed projection, and
    otherwise the two stages: the plain feature map, then the
    ``linear_attention_decode_step`` kernel. Without ``use_kernel``, the
    plain feature map and rank-1 update. Returns (out (B, G, Hg, 1, dv)
    in v.dtype, state advanced in place)."""
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
    qf1 = qf[..., 0, :]                                   # (B, G, Hg, m)
    if use_kernel:
        out, _, _ = kops.linear_attention_decode_step(
            qf1.contiguous(), kf[:, :, :, 0].contiguous(),
            v[:, :, :, 0].contiguous(), state.s, state.z,
            rescale[..., 0, 0].contiguous(), eps=cfg.eps)
        state.c.copy_(c_new)
        return out.to(v.dtype)[..., None, :], state
    kfb = kf[:, :, :, 0].expand(b, g, hg, cfg.num_features)
    vv = v[:, :, :, 0].expand(b, g, hg, dv).float()
    s = state.s * rescale + kfb[..., :, None] * vv[..., None, :]
    z = state.z * rescale[..., 0] + kfb
    num = torch.einsum("bghm,bghmd->bghd", qf1, s)
    den = torch.einsum("bghm,bghm->bgh", qf1, z)
    out = (num / (den[..., None] + cfg.eps)).to(v.dtype)
    return out[..., None, :], _write_state(state, s, z, c_new)

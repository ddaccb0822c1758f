"""The paper's attention as one entry point per mode: training-time
attention, resumed prefill and decode, dispatched on FeatureConfig.kind:

  exact       -> softmax attention (optionally sliding-window)
  performer   -> isotropic PRF linear attention
  darkformer  -> data-aware PRF linear attention (the paper's)
  lfk         -> learned-feature-kernel linear attention (baseline)
  random      -> fixed random attention weights (baseline, training)
  constant    -> uniform attention (baseline, training)

The counterpart of ``repro.core.attention`` (its paged exact layout,
``table``, is ROADMAP A9). Layout: q is (B, G, Hg, L, d) — G KV groups,
Hg query heads per group; k, v are (B, G, 1, L, d). Feature params are
per group: {"w": (G, m, r), "m_mat": (G, r, d)}. The exact kind and the
baselines run no kernel, in the reference as here.

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

The serving entry points advance the incoming serve state
(:class:`AttnServeState` for the PRF kinds, :class:`KVCacheState` for
exact) IN PLACE (the kernels write S, z and c where they lie; the plain path
copies its result there; the exact path writes the chunk's keys and
values into the cache where they lie and advances ``length``) and return
it beside the attention output; a whole-prompt prefill (no incoming
state) returns a new one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import kernels as kops
from repro_torch.core import feature_maps as fm
from repro_torch.core import linear_attention as la

PRF_KINDS = fm.PRF_KINDS
NEG = torch.finfo(torch.float32).min


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
                 causal: bool = True, window: Optional[int] = None,
                 chunk: int = 256, use_kernel: bool = False,
                 baseline_draw: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Training-time attention over whole sequences. q: (B, G, Hg, L, d);
    k, v: (B, G, 1, L, d). ``exact`` is softmax attention (``window``
    for sliding-window); ``constant`` and ``random`` are the paper's
    baselines, the latter with ``baseline_draw``, its (L, L) f32 logits.
    For the PRF kinds, causal with ``use_kernel`` runs the hand-written
    ``linear_attention_causal`` kernel (its plain version on a CPU
    tensor), reading k's features and v once per KV group; otherwise the
    chunked plain scan. Returns (B, G, Hg, L, dv) in v.dtype."""
    b, g, hg, l, _ = q.shape
    dv = v.shape[-1]
    if cfg.kind == "exact":
        qs, ks = _scale_qk(q, k)
        return la.exact_attention(qs, ks, v, causal=causal, window=window)
    if cfg.kind == "constant":
        return la.constant_attention(v, causal=causal).expand(b, g, hg, l,
                                                              dv)
    if cfg.kind == "random":
        if baseline_draw is None:
            raise ValueError("the random baseline needs its (L, L) draw")
        return la.random_attention(baseline_draw, v, causal=causal).expand(
            b, g, hg, l, dv)
    if cfg.kind not in PRF_KINDS:
        raise ValueError(f"unsupported feature kind {cfg.kind!r}")
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
    slot pool (slot i is batch row i)."""
    s: torch.Tensor                 # (B, G, Hg, m, dv) f32
    z: torch.Tensor                 # (B, G, Hg, m)     f32
    c: torch.Tensor                 # (B, G, 1, 1, 1)   f32


class KVCacheState(NamedTuple):
    """Exact-attention serving state: the KV cache and its write index.
    The reference keeps these leaves in its ``AttnServeState`` beside
    None PRF leaves; the port gives each kind its own type, so every
    leaf of either is a tensor. ``length`` is () int32 when the batch
    moves in lock-step, (B,) int32 per slot (each slot owns its row of
    the cache and writes at its own index); then every leaf has a
    leading batch axis and the state doubles as a slot pool."""
    kv_k: torch.Tensor              # (B, G, Lmax, d) f32
    kv_v: torch.Tensor              # (B, G, Lmax, d) f32
    length: torch.Tensor            # () or (B,)      int32


def _exact_prefill_resume(qs, ks, v, state: KVCacheState,
                          window: Optional[int], out_dtype,
                          valid_len: Optional[torch.Tensor] = None):
    """Append an l-token chunk to the exact KV cache, in place, and attend
    the chunk's queries over the whole valid prefix. ``state.length`` is
    () or (B,); decode is the l = 1 case.

    Without ``valid_len`` the chunk lands at [start, start + l) with
    start = clamp(length, 0, Lmax - l), as the reference's dynamic
    slice clamps it. ``valid_len`` ((B,) int32, with a (B,) ``length``)
    marks ragged rows: row b writes positions [length[b], length[b] +
    valid_len[b]) and leaves every other position bitwise as it was,
    also where length + l > Lmax (a masked gather over the cache, never
    a slice), and advances by valid_len[b]. Write positions stay on the
    device: nothing here waits for it. Returns (out (B, G, Hg, l, dv) in
    ``out_dtype``, ``state``)."""
    b, g, _, l, _ = qs.shape
    dev = qs.device
    idx = state.length
    lmax = state.kv_k.shape[2]
    kpos = torch.arange(lmax, device=dev)
    ar = torch.arange(l, device=dev)
    knew = ks[:, :, 0].to(state.kv_k.dtype)              # (B, G, l, d)
    vnew = v[:, :, 0].to(state.kv_v.dtype)
    if valid_len is not None:
        # per cache position, the chunk token it takes: positions in
        # [idx, idx + valid_len) take token (pos - idx), the rest keep
        # the old contents
        rel = kpos[None] - idx[:, None]                  # (B, lmax)
        keep = ((rel >= 0) & (rel < valid_len[:, None]))[:, None, :, None]
        relc = rel.clamp(0, l - 1)[:, None, :, None]
        for cache, new in ((state.kv_k, knew), (state.kv_v, vnew)):
            taken = new.gather(2, relc.expand(b, g, lmax, new.shape[-1]))
            cache.copy_(torch.where(keep, taken, cache))
        qpos = idx[:, None] + ar[None]                   # (B, l)
    else:
        start = idx.clamp(0, lmax - l)
        if idx.ndim == 0:
            for cache, new in ((state.kv_k, knew), (state.kv_v, vnew)):
                cache.index_copy_(2, start + ar, new)
            qpos = (idx + ar)[None]                      # (1, l)
        else:
            pos = (start[:, None] + ar[None])[:, None, :, None]
            for cache, new in ((state.kv_k, knew), (state.kv_v, vnew)):
                cache.scatter_(2, pos.expand(b, g, l, new.shape[-1]), new)
            qpos = idx[:, None] + ar[None]               # (B, l)
    valid = kpos[None, None, :] <= qpos[:, :, None]      # (B|1, l, lmax)
    if window is not None:
        valid &= kpos[None, None, :] > qpos[:, :, None] - window
    logits = torch.einsum("bghqd,bgkd->bghqk", qs.float(),
                          state.kv_k.float())
    logits = torch.where(valid[:, None, None], logits, NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bghqk,bgkd->bghqd", probs, state.kv_v.float())
    state.length.add_(l if valid_len is None else valid_len)
    return out.to(out_dtype), state


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
                         state=None,
                         window: Optional[int] = None,
                         max_len: Optional[int] = None,
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
    The exact kind attends over its KV cache instead
    (:func:`_exact_prefill_resume`; a whole prompt gets a cache of
    ``max_len`` positions, default L, and a () length) and selects no
    kernel. With ``use_kernel`` a resumed PRF chunk runs the fused
    ``prf_fused_prefill`` kernel when ``proj`` carries the precomposed
    projection (``fm.precompose_projection``), and otherwise the two
    stages: the plain feature map, then the carried-scan kernel
    ``linear_attention_prefill_chunk``. Without ``use_kernel``, the plain
    feature map and carried-state scan. Returns (out (B, G, Hg, L, dv) in
    v.dtype, state: a new one for the whole prompt, else ``state``
    advanced in place).
    """
    if cfg.kind not in ("exact", *PRF_KINDS):
        raise ValueError(f"no serving path for kind {cfg.kind!r}")
    if valid_len is not None and state is None:
        raise ValueError("valid_len requires an incoming serve state "
                         "(ragged rows only arise in resumed chunks)")
    b, g, hg, l, _ = q.shape
    dv = v.shape[-1]
    qs, ks = _scale_qk(q, k)
    if cfg.kind == "exact":
        if state is not None:
            return _exact_prefill_resume(qs, ks, v, state, window, v.dtype,
                                         valid_len=valid_len)
        out = la.exact_attention(qs, ks, v, causal=True, window=window)
        pad = (0, 0, 0, (max_len or l) - l)
        return out, KVCacheState(
            kv_k=torch.nn.functional.pad(ks[:, :, 0], pad),
            kv_v=torch.nn.functional.pad(v[:, :, 0], pad),
            length=torch.tensor(l, dtype=torch.int32, device=q.device))
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


def rf_attention_decode(q, k, v, state, fparams,
                        cfg: fm.FeatureConfig, *,
                        window: Optional[int] = None,
                        use_kernel: bool = False,
                        proj: Optional[dict] = None):
    """One-token decode. q: (B, G, Hg, 1, d); k, v: (B, G, 1, 1, d).
    The exact kind appends to its KV cache at ``state.length`` (() or
    (B,)) and attends over the valid prefix, the one-token case of the
    resumed prefill chunk; it selects no kernel. For the PRF kinds, with
    ``use_kernel`` the step runs the fused ``prf_fused_decode``
    kernel when ``proj`` carries the precomposed projection, and
    otherwise the two stages: the plain feature map, then the
    ``linear_attention_decode_step`` kernel. Without ``use_kernel``, the
    plain feature map and rank-1 update. Returns (out (B, G, Hg, 1, dv)
    in v.dtype, state advanced in place)."""
    if cfg.kind not in ("exact", *PRF_KINDS):
        raise ValueError(f"no serving path for kind {cfg.kind!r}")
    b, g, hg, _, _ = q.shape
    dv = v.shape[-1]
    qs, ks = _scale_qk(q, k)
    if cfg.kind == "exact":
        return _exact_prefill_resume(qs, ks, v, state, window, v.dtype)
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

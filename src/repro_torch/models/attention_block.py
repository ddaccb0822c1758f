"""Attention mixer block: projections + RoPE + PRF attention, for training
and serving.

The counterpart of ``repro.models.attention_block`` for the PRF kinds.
GQA layout throughout: q -> (B, G, Hg, L, dh); k, v -> (B, G, 1, L, dh).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import attention as rfa
from repro_torch.core import feature_maps as fm
from repro_torch.models import layers as ll


def attn_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
              d_head: int, cfg: fm.FeatureConfig, qk_norm: bool = False,
              dtype=torch.float32) -> dict:
    p = {
        "wq": ll.trunc_normal(gen, (d_model, n_heads * d_head), 1.0, dtype),
        "wk": ll.trunc_normal(gen, (d_model, n_kv * d_head), 1.0, dtype),
        "wv": ll.trunc_normal(gen, (d_model, n_kv * d_head), 1.0, dtype),
        "wo": ll.trunc_normal(gen, (n_heads * d_head, d_model), 1.0, dtype),
    }
    if cfg.kind in fm.PRF_KINDS:
        p["feat"] = fm.init_feature_params(gen, cfg, d_head, n_groups=n_kv,
                                           dtype=torch.float32)
    if qk_norm:
        p["q_norm"] = ll.rmsnorm_init(d_head, dtype)
        p["k_norm"] = ll.rmsnorm_init(d_head, dtype)
    return p


def _project(params, x, n_heads, n_kv, d_head, qk_norm, positions,
             rope_theta):
    b, l, _ = x.shape
    hg = n_heads // n_kv
    q = (x @ params["wq"]).reshape(b, l, n_kv, hg, d_head)
    k = (x @ params["wk"]).reshape(b, l, n_kv, 1, d_head)
    v = (x @ params["wv"]).reshape(b, l, n_kv, 1, d_head)
    q = torch.movedim(q, 1, 3)         # (B, G, Hg, L, dh)
    k = torch.movedim(k, 1, 3)
    v = torch.movedim(v, 1, 3)
    if qk_norm:
        q = ll.rmsnorm(params["q_norm"], q)
        k = ll.rmsnorm(params["k_norm"], k)
    if rope_theta > 0:
        q = ll.apply_rope(q, positions, rope_theta)
        k = ll.apply_rope(k, positions, rope_theta)
    return q, k, v


def _merge_heads(out, params):
    # out: (B, G, Hg, L, dh) -> (B, L, H*dh) @ wo
    b, g, hg, l, dh = out.shape
    out = torch.movedim(out, 3, 1).reshape(b, l, g * hg * dh)
    return out @ params["wo"]


def attn_apply(params: dict, x: torch.Tensor, cfg: fm.FeatureConfig, *,
               n_heads: int, n_kv: int, d_head: int, causal: bool = True,
               qk_norm: bool = False, rope_theta: float = 10000.0,
               positions: Optional[torch.Tensor] = None,
               use_kernel: bool = False) -> torch.Tensor:
    """Training-time attention over whole sequences x: (B, L, d_model),
    at ``positions`` (default 0..L-1). Returns (B, L, d_model)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project(params, x, n_heads, n_kv, d_head, qk_norm,
                       positions, rope_theta)
    out = rfa.rf_attention(q, k, v, params.get("feat"), cfg, causal=causal,
                           use_kernel=use_kernel)
    return _merge_heads(out, params)


def attn_prefill(params, x, cfg, *, n_heads, n_kv, d_head, state, position,
                 qk_norm=False, rope_theta=10000.0, use_kernel=False,
                 valid_len=None, proj=None):
    """Prefill one prompt chunk that resumes from ``state`` at chunk
    start ``position`` (() int, or (B,) per-row starts). ``valid_len``
    marks ragged rows; ``proj`` selects the fused kernel under
    ``use_kernel``. Returns (mix (B, L, d_model), state advanced in
    place)."""
    l = x.shape[1]
    ar = torch.arange(l, device=x.device)
    if position.ndim == 0:
        positions = position + ar
    else:                      # (B,) per-row starts -> (B, 1, 1, L)
        positions = (position[:, None] + ar[None]).reshape(-1, 1, 1, l)
    q, k, v = _project(params, x, n_heads, n_kv, d_head, qk_norm,
                       positions, rope_theta)
    out, state = rfa.rf_attention_prefill(
        q, k, v, params.get("feat"), cfg, state=state,
        use_kernel=use_kernel, valid_len=valid_len, proj=proj)
    return _merge_heads(out, params), state


def attn_decode(params, x, state, cfg, *, n_heads, n_kv, d_head, position,
                qk_norm=False, rope_theta=10000.0, use_kernel=False,
                proj=None):
    """x: (B, 1, d_model); position: () int current index, or (B,) per
    slot. Returns (mix (B, 1, d_model), state advanced in place)."""
    if position.ndim == 0:
        positions = position[None]
    else:
        positions = position.reshape(-1, 1, 1, 1)
    q, k, v = _project(params, x, n_heads, n_kv, d_head, qk_norm,
                       positions, rope_theta)
    out, state = rfa.rf_attention_decode(q, k, v, state, params.get("feat"),
                                         cfg, use_kernel=use_kernel,
                                         proj=proj)
    return _merge_heads(out, params), state


def init_attn_serve_state(cfg: fm.FeatureConfig, b, n_heads, n_kv, d_head,
                          device="cuda") -> rfa.AttnServeState:
    if cfg.kind not in fm.PRF_KINDS:
        raise NotImplementedError(
            f"serve state for kind {cfg.kind!r} is not ported yet "
            "(ROADMAP.md Queue A, item A3)")
    return rfa.init_linear_serve_state(b, n_kv, n_heads // n_kv,
                                       cfg.num_features, d_head, device)

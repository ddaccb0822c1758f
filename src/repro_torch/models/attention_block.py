"""Attention mixer block: projections + RoPE + (PRF | exact) attention,
for training and serving.

The counterpart of ``repro.models.attention_block``. GQA layout
throughout: q -> (B, G, Hg, L, dh);
k, v -> (B, G, 1, L, dh).
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
               window: Optional[int] = None,
               qk_norm: bool = False, rope_theta: float = 10000.0,
               positions: Optional[torch.Tensor] = None,
               use_kernel: bool = False,
               baseline_draw: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Training-time attention over whole sequences x: (B, L, d_model),
    at ``positions`` (default 0..L-1). ``window`` (a "local" block's)
    applies to the exact kind only, as in the reference.
    ``baseline_draw`` is the random baseline's (L, L) draw. Returns (B,
    L, d_model)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project(params, x, n_heads, n_kv, d_head, qk_norm,
                       positions, rope_theta)
    out = rfa.rf_attention(q, k, v, params.get("feat"), cfg, causal=causal,
                           window=window, use_kernel=use_kernel,
                           baseline_draw=baseline_draw)
    return _merge_heads(out, params)


def attn_prefill(params, x, cfg, *, n_heads, n_kv, d_head, state=None,
                 position=None, window=None, qk_norm=False,
                 rope_theta=10000.0, use_kernel=False, valid_len=None,
                 proj=None, pages=None):
    """Prefill a whole prompt (``state`` and ``position`` None: positions
    0..L-1, a new state) or one prompt chunk that resumes from ``state``
    at chunk start ``position`` (() int, or (B,) per-row starts).
    ``window`` as in :func:`attn_apply`;
    ``valid_len`` marks ragged rows; ``proj`` selects the fused kernel
    under ``use_kernel``; ``pages`` are the layer's (k, v) page pools of
    a paged exact ``state``. Returns (mix (B, L, d_model), the new state or
    ``state`` advanced in place)."""
    l = x.shape[1]
    ar = torch.arange(l, device=x.device)
    if position is None:
        positions = ar
    elif position.ndim == 0:
        positions = position + ar
    else:                      # (B,) per-row starts -> (B, 1, 1, L)
        positions = (position[:, None] + ar[None]).reshape(-1, 1, 1, l)
    q, k, v = _project(params, x, n_heads, n_kv, d_head, qk_norm,
                       positions, rope_theta)
    out, state = rfa.rf_attention_prefill(
        q, k, v, params.get("feat"), cfg, state=state, window=window,
        use_kernel=use_kernel, valid_len=valid_len, proj=proj, pages=pages)
    return _merge_heads(out, params), state


def attn_decode(params, x, state, cfg, *, n_heads, n_kv, d_head, position,
                window=None, qk_norm=False, rope_theta=10000.0,
                use_kernel=False, proj=None, pages=None):
    """x: (B, 1, d_model); position: () int current index, or (B,) per slot;
    ``window`` and ``pages`` as in :func:`attn_prefill`. Returns (mix (B,
    1, d_model), state advanced in place)."""
    if position.ndim == 0:
        positions = position[None]
    else:
        positions = position.reshape(-1, 1, 1, 1)
    q, k, v = _project(params, x, n_heads, n_kv, d_head, qk_norm,
                       positions, rope_theta)
    out, state = rfa.rf_attention_decode(q, k, v, state, params.get("feat"),
                                         cfg, window=window,
                                         use_kernel=use_kernel, proj=proj,
                                         pages=pages)
    return _merge_heads(out, params), state


def init_attn_serve_state(cfg: fm.FeatureConfig, b, n_heads, n_kv, d_head,
                          max_len, per_slot=False, device="cuda"):
    """A fresh serving state for one attention block. Exact: a zero f32
    KV cache (b, n_kv, max_len, d_head) with a (b,) int32 length when
    ``per_slot`` (each row, a serving slot, tracks its own write index),
    else a () one. The PRF kinds: the (S, z, c) state."""
    if cfg.kind == "exact":
        cache = (b, n_kv, max_len, d_head)
        return rfa.KVCacheState(
            kv_k=torch.zeros(cache, dtype=torch.float32, device=device),
            kv_v=torch.zeros(cache, dtype=torch.float32, device=device),
            length=torch.zeros((b,) if per_slot else (), dtype=torch.int32,
                               device=device))
    if cfg.kind not in fm.PRF_KINDS:
        raise ValueError(f"no serving state for kind {cfg.kind!r}")
    return rfa.init_linear_serve_state(b, n_kv, n_heads // n_kv,
                                       cfg.num_features, d_head, device)


def init_paged_attn_state(b: int, max_pages: int, device="cuda"
                          ) -> rfa.PagedKVState:
    """A fresh paged exact-KV serve state for one attention block: each
    row's page table (all on the garbage page 0) and write index. The
    shared page pools carry no slot axis and live outside the slot pool
    (``lm.init_kv_pages``), so the slot ops in
    ``repro_torch.serving.slots`` move tables and lengths, never pages."""
    return rfa.PagedKVState(
        table=torch.zeros((b, max_pages), dtype=torch.int64, device=device),
        length=torch.zeros((b,), dtype=torch.int32, device=device))

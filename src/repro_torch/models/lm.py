"""The LM stack: config, init, the training forward and loss, resumable
prefill and decode.

The counterpart of ``repro.models.lm`` for homogeneous attention stacks
in the layer-stacked layout: params and serve state carry a leading
(n_layers,) axis (the state under ``state["layers"]``) and the layers run
as a Python loop over it, in training as in serving. The unit/rem
layout, the recurrent and MoE blocks, the non-text modalities and remat
are not ported yet (ROADMAP Queue A, items A4 and A12).

``prefill_chunk`` and ``decode_step`` advance ``state`` IN PLACE: the
fused kernels write each layer's (S, z, c) where it lies in the stacked
pool, and the plain path copies its result there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import feature_maps as fm
from repro_torch.core.attention import AttnServeState
from repro_torch.models import attention_block as ab
from repro_torch.models import layers as ll
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                       # 0 -> d_model // n_heads
    block_pattern: tuple = ("attn",)      # cycled
    attn: fm.FeatureConfig = fm.FeatureConfig(kind="darkformer")
    rope_theta: float = 10000.0           # <=0 disables RoPE
    qk_norm: bool = False
    mlp_kind: str = "swiglu"              # swiglu|geglu|gelu
    tie_embeddings: bool = True
    norm_kind: str = "rmsnorm"
    embed_scale: bool = False             # gemma-style sqrt(d) embed scale
    logit_softcap: float = 0.0
    dtype: str = "float32"                # param/activation dtype
    use_kernel: bool = False              # hand-written kernel path
    z_loss: float = 1e-4
    causal: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def n_rem(self) -> int:
        return self.n_layers % len(self.block_pattern)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue A, items A4/A12)")


def _check_servable(cfg: ModelConfig) -> None:
    if tuple(cfg.block_pattern) != ("attn",):
        raise _not_ported(f"block pattern {cfg.block_pattern}")


def _block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = cfg.param_dtype
    return {"ln1": ll.norm_init(cfg.norm_kind, cfg.d_model, dt),
            "ln2": ll.norm_init(cfg.norm_kind, cfg.d_model, dt),
            "attn": ab.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                 cfg.head_dim, cfg.attn, cfg.qk_norm, dt),
            "ffn": ll.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                               dt)}


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> dict:
    """Random params from ``seed``, in the reference's tree layout:
    {"embed", "final_norm", "units": {"b0": leaves (n_layers, ...)}}.
    Drawn on the CPU with a ``torch.Generator`` and then moved, so a seed
    gives the same params on every device."""
    _check_servable(cfg)
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.param_dtype
    params: dict[str, Any] = {
        "embed": ll.trunc_normal(gen, (cfg.vocab, cfg.d_model), 1.0, dt),
        "final_norm": ll.norm_init(cfg.norm_kind, cfg.d_model, dt),
        "units": {"b0": _stack([_block_init(gen, cfg)
                                for _ in range(cfg.n_layers)])},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = ll.trunc_normal(gen, (cfg.d_model, cfg.vocab),
                                            1.0, dt)
    return tree_map(lambda t: t.to(device), params)


def can_stack_layers(cfg: ModelConfig) -> bool:
    """True when every layer is the same block kind, so serving states and
    params stack along one leading layer axis."""
    return (cfg.n_units > 0 and cfg.n_rem == 0
            and len(set(cfg.block_pattern)) == 1)


def stack_layer_params(params: dict, cfg: ModelConfig) -> dict:
    """One block tree with leaves (n_layers, ...). For the one-block
    pattern the port serves, unit u is layer u: no copy."""
    _check_servable(cfg)
    return params["units"]["b0"]


def _layers(params: dict, cfg: ModelConfig) -> dict:
    return (params["layers"] if "layers" in params
            else stack_layer_params(params, cfg))


def build_decode_proj(params: dict, cfg: ModelConfig,
                      stacked: bool = True) -> Optional[dict]:
    """Precompose every layer's serve projection A = (W M)^T once, at
    engine build, for the fused prefill and decode kernels. Returns
    {"layers": {"a": (L, G, d, m), "m_mat": (L, G, r, d) | None}}, or
    None when the config has no fused path."""
    if not (cfg.use_kernel and cfg.attn.kind in fm.PRF_KINDS):
        return None
    if not stacked:
        raise _not_ported("the unit/rem serving layout")
    return {"layers": fm.precompose_projection(
        _layers(params, cfg)["attn"]["feat"], cfg.attn.kind)}


def init_serve_state(cfg: ModelConfig, b: int, max_len: int,
                     per_slot: bool = False, stacked: bool = True,
                     device="cuda") -> dict:
    """Initial serving state for b sequences: {"layers": AttnServeState
    with leaves (n_layers, b, ...), "pos": (b,) int32 if ``per_slot``
    else () int32}. The PRF state is fixed-size, so ``max_len`` only
    bounds the engine's context budget."""
    _check_servable(cfg)
    if not stacked or not can_stack_layers(cfg):
        raise _not_ported("the unit/rem serving layout")
    st = ab.init_attn_serve_state(cfg.attn, b * cfg.n_layers, cfg.n_heads,
                                  cfg.n_kv, cfg.head_dim, device)
    layers = AttnServeState(*(t.reshape(cfg.n_layers, b, *t.shape[1:])
                              for t in st))
    return {"layers": layers,
            "pos": torch.zeros((b,) if per_slot else (), dtype=torch.int32,
                               device=device)}


def _layer_slices(params, cfg, state, proj):
    sp = _layers(params, cfg)
    st = state["layers"]
    for li in range(cfg.n_layers):
        lp = tree_map(lambda t: t[li], sp)
        ls = AttnServeState(st.s[li], st.z[li], st.c[li])
        lproj = None if proj is None else tree_map(lambda t: t[li],
                                                   proj["layers"])
        yield lp, ls, lproj


def _apply_block(params, x, cfg: ModelConfig, *, mode, state=None,
                 position=None, valid_len=None, proj=None):
    h = ll.apply_norm(cfg.norm_kind, params["ln1"], x)
    common = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.head_dim,
                  qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
                  use_kernel=cfg.use_kernel)
    if mode == "train":
        mix = ab.attn_apply(params["attn"], h, cfg.attn, causal=cfg.causal,
                            **common)
    elif mode == "prefill":
        mix, _ = ab.attn_prefill(params["attn"], h, cfg.attn, state=state,
                                 position=position, valid_len=valid_len,
                                 proj=proj, **common)
    else:
        mix, _ = ab.attn_decode(params["attn"], h, state, cfg.attn,
                                position=position, proj=proj, **common)
    x = x + mix
    h2 = ll.apply_norm(cfg.norm_kind, params["ln2"], x)
    return x + ll.mlp_apply(params["ffn"], h2, cfg.mlp_kind)


def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token embeddings (text only; audio and vlm inputs are ROADMAP
    A12)."""
    tok = params["embed"][batch["tokens"]]
    if cfg.embed_scale:
        tok = tok * torch.tensor(cfg.d_model ** 0.5, dtype=tok.dtype)
    return tok.to(cfg.param_dtype)


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = ll.apply_norm(cfg.norm_kind, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(x.dtype)).float()
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def forward_train(params, cfg: ModelConfig, batch: dict,
                  gen: Optional[torch.Generator] = None):
    """Full forward over batch["tokens"] (B, L). Returns (logits (B, L, V)
    f32, aux loss 0-d f32). With ``cfg.use_kernel`` every layer's causal
    attention runs the ``linear_attention_causal`` kernel. ``gen`` is the
    draw of the random-attention baseline (ROADMAP A3); the PRF kinds
    read none."""
    _check_servable(cfg)
    x = _embed_inputs(params, cfg, batch)
    sp = _layers(params, cfg)
    for li in range(cfg.n_layers):
        x = _apply_block(tree_map(lambda t: t[li], sp), x, cfg, mode="train")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch: dict,
            gen: Optional[torch.Generator] = None):
    """Next-token cross-entropy plus z-loss over the positions with
    ``labels >= 0``. Returns (loss 0-d f32, metrics {loss, ce, z_loss,
    aux, accuracy}, detached)."""
    logits, aux = forward_train(params, cfg, batch, gen)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    ll_tok = torch.gather(logits, -1,
                          labels.clamp(min=0)[..., None])[..., 0] - logz
    wmask = (labels >= 0).float()
    denom = wmask.sum().clamp(min=1.0)
    ce = -(ll_tok * wmask).sum() / denom
    zl = cfg.z_loss * (logz.square() * wmask).sum() / denom
    loss = ce + zl + aux
    acc = ((logits.argmax(-1) == labels).float() * wmask).sum() / denom
    metrics = {"loss": loss, "ce": ce, "z_loss": zl, "aux": aux,
               "accuracy": acc}
    return loss, {k: t.detach() for k, t in metrics.items()}


def prefill_chunk(params, cfg: ModelConfig, batch: dict, state: dict,
                  valid_len: Optional[torch.Tensor] = None,
                  proj: Optional[dict] = None):
    """Advance ``state`` in place over one prompt chunk (tokens (B, L)).

    ``state["pos"]`` is the chunk's start offset. ``valid_len`` ((B,)
    int32) makes the chunk ragged: row b consumes its first
    ``valid_len[b]`` tokens and the rest leave no trace; logits are
    gathered at each row's last valid position. With ``cfg.use_kernel``
    every layer runs the fused ``prf_fused_prefill`` kernel against
    ``proj`` (built here when None). Returns (logits (B, V) f32, state).
    """
    if "layers" not in state:
        raise _not_ported("the unit/rem serving layout")
    x = _embed_inputs(params, cfg, batch)
    pos = state["pos"]
    proj = proj if proj is not None else build_decode_proj(params, cfg)
    for lp, ls, lproj in _layer_slices(params, cfg, state, proj):
        x = _apply_block(lp, x, cfg, state=ls, mode="prefill",
                         position=pos, valid_len=valid_len, proj=lproj)
    state["pos"] = pos + (x.shape[1] if valid_len is None else valid_len)
    if valid_len is None:
        x_last = x[:, -1]
    else:
        last = (valid_len.long() - 1).clamp(min=0)
        x_last = x[torch.arange(x.shape[0], device=x.device), last]
    return _logits(params, cfg, x_last), state


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, state: dict,
                proj: Optional[dict] = None):
    """One serving step, advancing ``state`` in place. token: (B,) ->
    (logits (B, V) f32, state). With ``cfg.use_kernel`` every layer runs
    the fused ``prf_fused_decode`` kernel against ``proj`` (built here
    when None)."""
    if "layers" not in state:
        raise _not_ported("the unit/rem serving layout")
    pos = state["pos"]
    x = params["embed"][token][:, None]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    x = x.to(cfg.param_dtype)
    proj = proj if proj is not None else build_decode_proj(params, cfg)
    for lp, ls, lproj in _layer_slices(params, cfg, state, proj):
        x = _apply_block(lp, x, cfg, state=ls, mode="decode", position=pos,
                         proj=lproj)
    state["pos"] = pos + 1
    return _logits(params, cfg, x[:, 0]), state

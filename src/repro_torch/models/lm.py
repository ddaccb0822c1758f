"""The LM stack: config, init, the training forward and loss, the
calibration taps and whitening calibration, resumable prefill and
decode.

The counterpart of ``repro.models.lm`` for homogeneous attention stacks
in the layer-stacked layout: params and serve state carry a leading
(n_layers,) axis (the state under ``state["layers"]``) and the layers run
as a Python loop over it, in training as in serving. The feed-forward
is a dense MLP or, with ``cfg.moe``, the capacity-routed mixture of
experts, whose load-balancing loss the training forward sums over the
layers (serving drops it, as the reference does). The unit/rem layout,
the recurrent blocks, the non-text modalities and remat are not ported
yet (ROADMAP Queue A, items A12b, A12c, A12e and A13).

``prefill_chunk`` and ``decode_step`` advance ``state`` IN PLACE: the
kernels write each layer's (S, z, c) where it lies in the stacked pool,
the plain path copies its result there, and the exact kind writes each
layer's keys and values into its KV cache and advances its ``length``.
The paged exact layout (``init_paged_serve_state``) writes them into the
shared page pools (``init_kv_pages``) passed beside the state as
``pages=``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import calibration as cal
from repro_torch.core import feature_maps as fm
from repro_torch.core import linear_attention as la
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
    moe: Optional[ll.MoEConfig] = None
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
        f"{what} is not ported yet (ROADMAP.md Queue A, items A12b/A12c)")


def _check_servable(cfg: ModelConfig) -> None:
    if tuple(cfg.block_pattern) != ("attn",):
        raise _not_ported(f"block pattern {cfg.block_pattern}")


def _block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = cfg.param_dtype
    attn = ab.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                        cfg.head_dim, cfg.attn, cfg.qk_norm, dt)
    ffn = (ll.moe_init(gen, cfg.d_model, cfg.moe, dt) if cfg.moe else
           ll.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dt))
    return {"ln1": ll.norm_init(cfg.norm_kind, cfg.d_model, dt),
            "ln2": ll.norm_init(cfg.norm_kind, cfg.d_model, dt),
            "attn": attn, "ffn": ffn}


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda", draw_on="cpu") -> dict:
    """Random params from ``seed``, in the reference's tree layout:
    {"embed", "final_norm", "units": {"b0": leaves (n_layers, ...)},
    "lm_head" when untied}. Drawn with a ``torch.Generator`` on
    ``draw_on``, layer after layer, each layer written into its slice of
    stacked tensors allocated once on ``device``, so the host holds one
    layer's draws at a time (granite-8b's 8.2 B parameters never sit on
    the host). Drawn on the CPU (the default), a seed gives the same
    params on every device; drawn on a card (``draw_on=device``), other
    numbers, the same on every card, in seconds where the CPU takes
    minutes at full width."""
    _check_servable(cfg)
    gen = torch.Generator(device=draw_on).manual_seed(seed)
    dt = cfg.param_dtype
    params: dict[str, Any] = {
        "embed": ll.trunc_normal(gen, (cfg.vocab, cfg.d_model), 1.0,
                                 dt).to(device),
        "final_norm": tree_map(lambda t: t.to(device), ll.norm_init(
            cfg.norm_kind, cfg.d_model, dt)),
    }
    layers = None
    for li in range(cfg.n_layers):
        block = _block_init(gen, cfg)
        if layers is None:
            layers = tree_map(lambda t: torch.empty(
                (cfg.n_layers, *t.shape), dtype=t.dtype, device=device),
                block)
        tree_map(lambda dst, src: dst[li].copy_(src), layers, block)
    params["units"] = {"b0": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = ll.trunc_normal(gen, (cfg.d_model, cfg.vocab),
                                            1.0, dt).to(device)
    return params


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
    """Initial serving state for b sequences: {"layers": the block's
    state (``AttnServeState``, or ``KVCacheState`` for exact) with leaves
    (n_layers, b, ...), "pos": (b,) int32 if ``per_slot``
    else () int32}. The PRF state is fixed-size, so there ``max_len``
    only bounds the engine's context budget; the exact kind gets a KV
    cache of ``max_len`` positions a layer and a ``length`` of
    (n_layers, b) or, without ``per_slot``, (n_layers,)."""
    _check_servable(cfg)
    if not stacked or not can_stack_layers(cfg):
        raise _not_ported("the unit/rem serving layout")
    st = ab.init_attn_serve_state(cfg.attn, b, cfg.n_heads, cfg.n_kv,
                                  cfg.head_dim, max_len, per_slot=per_slot,
                                  device=device)
    layers = type(st)(*(t.expand(cfg.n_layers, *t.shape).clone()
                        for t in st))
    return {"layers": layers,
            "pos": torch.zeros((b,) if per_slot else (), dtype=torch.int32,
                               device=device)}


def init_paged_serve_state(cfg: ModelConfig, b: int, max_len: int,
                           page_size: int, device="cuda") -> dict:
    """Slot pool for the block-granular paged exact-KV layout: {"layers":
    ``PagedKVState`` with a (n_layers, b, max_pages) page table and a
    (n_layers, b) write index, "pos": (b,) int32}, max_pages =
    ceil(max_len / page_size). Exact and layer-stacked configs only. The
    keys and values live in the shared pools of :func:`init_kv_pages`,
    passed beside the state to :func:`prefill_chunk` and
    :func:`decode_step` as ``pages=``; the slot ops see only this tree,
    so forking a cached prefix into N rows copies page IDS, not keys and
    values (``repro_torch.serving.prefix_cache``)."""
    if cfg.attn.kind != "exact" or not can_stack_layers(cfg):
        raise ValueError(
            f"{cfg.name}: paged KV serve states need an exact-attention "
            f"layer-stacked config (kind={cfg.attn.kind}, "
            f"stackable={can_stack_layers(cfg)})")
    _check_servable(cfg)
    st = ab.init_paged_attn_state(b, -(-max_len // page_size), device)
    return {"layers": type(st)(*(t.expand(cfg.n_layers, *t.shape).clone()
                                 for t in st)),
            "pos": torch.zeros((b,), dtype=torch.int32, device=device)}


def init_kv_pages(cfg: ModelConfig, n_pages: int, page_size: int,
                  device="cuda") -> dict:
    """The shared per-layer exact-KV page pools: {"k", "v"} each
    (n_layers, n_pages, page_size, G, d_head) f32. Page 0 is the garbage
    page that padded writes land on."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.float32, device=device)}


def _layer_slices(params, cfg, state, proj, pages=None):
    """(params, serve state, projections, page pools) of each layer, the
    state's leaves and the pools as views into the stacked tensors, so
    that in-place writes land there."""
    sp = _layers(params, cfg)
    st = state["layers"]
    for li in range(cfg.n_layers):
        lp = tree_map(lambda t: t[li], sp)
        ls = type(st)(*(t[li] for t in st))
        lproj = None if proj is None else tree_map(lambda t: t[li],
                                                   proj["layers"])
        lpages = None if pages is None else (pages["k"][li],
                                             pages["v"][li])
        yield lp, ls, lproj, lpages


def _apply_block(params, x, cfg: ModelConfig, *, mode, state=None,
                 position=None, valid_len=None, proj=None, draw=None,
                 pages=None):
    """One block: attention, then the dense or MoE feed-forward. Returns
    (x, the block's aux loss: 0-d f32 with MoE, else None)."""
    h = ll.apply_norm(cfg.norm_kind, params["ln1"], x)
    common = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.head_dim,
                  qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
                  use_kernel=cfg.use_kernel)
    if mode == "train":
        mix = ab.attn_apply(params["attn"], h, cfg.attn, causal=cfg.causal,
                            baseline_draw=draw, **common)
    elif mode == "prefill":
        mix, _ = ab.attn_prefill(params["attn"], h, cfg.attn, state=state,
                                 position=position, valid_len=valid_len,
                                 proj=proj, pages=pages, **common)
    else:
        mix, _ = ab.attn_decode(params["attn"], h, state, cfg.attn,
                                position=position, proj=proj, pages=pages,
                                **common)
    x = x + mix
    h2 = ll.apply_norm(cfg.norm_kind, params["ln2"], x)
    if cfg.moe:
        f, aux = ll.moe_apply(params["ffn"], h2, cfg.moe)
        return x + f, aux
    return x + ll.mlp_apply(params["ffn"], h2, cfg.mlp_kind), None


def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token embeddings (text only; audio and vlm inputs are ROADMAP
    A12e)."""
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


def baseline_draws(cfg: ModelConfig, l: int,
                   gen: Optional[torch.Generator] = None,
                   device="cpu") -> torch.Tensor:
    """The random baseline's draws for an L-token forward: (n_layers, L,
    L) f32, layer by layer from ``gen`` (a generator seeded 0 when None,
    as the reference keys on PRNGKey(0)), on the CPU and then moved, so a
    seed gives the same draws on every device."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    return torch.stack([la.random_draw(l, gen)
                        for _ in range(cfg.n_layers)]).to(device)


def forward_train(params, cfg: ModelConfig, batch: dict,
                  gen: Optional[torch.Generator] = None):
    """Full forward over batch["tokens"] (B, L). Returns (logits (B, L, V)
    f32, aux loss 0-d f32: the MoE load-balancing losses summed over the
    layers, zero without MoE). With ``cfg.use_kernel`` every layer's causal
    PRF attention runs the ``linear_attention_causal`` kernel. The random
    baseline reads layer i's (L, L) logits from :func:`baseline_draws`
    of ``gen``; the other kinds read none."""
    _check_servable(cfg)
    x = _embed_inputs(params, cfg, batch)
    draws = (baseline_draws(cfg, x.shape[1], gen, x.device)
             if cfg.attn.kind == "random" else None)
    sp = _layers(params, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in range(cfg.n_layers):
        x, aux_l = _apply_block(tree_map(lambda t: t[li], sp), x, cfg,
                                mode="train",
                                draw=None if draws is None else draws[li])
        if aux_l is not None:
            aux = aux + aux_l
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch: dict,
            gen: Optional[torch.Generator] = None):
    """Next-token cross-entropy plus z-loss over the positions with
    ``labels >= 0``; ``gen`` feeds the random baseline
    (:func:`forward_train`). Returns (loss 0-d f32, metrics {loss, ce,
    z_loss, aux, accuracy}, detached)."""
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


def collect_qk(params, cfg: ModelConfig, batch: dict, *,
               draws: Optional[torch.Tensor] = None) -> dict:
    """Run the stack and capture post-RoPE q/k of every attention block.

    Calibration tap for the whitening init (App. C): returns
    {"unit<li>/b0": (q, k)} with q: (B, G, Hg, L, dh), k: (B, G, 1, L, dh),
    in the model's dtype. Every block runs as in :func:`forward_train`,
    without gradient (with ``cfg.use_kernel`` a PRF layer launches
    ``linear_attention_causal`` once). The random baseline reads layer
    li's (L, L) logits from ``draws`` ((n_layers, L, L)), else from
    :func:`baseline_draws` of a generator seeded 0."""
    _check_servable(cfg)
    taps: dict = {}
    with torch.no_grad():
        x = _embed_inputs(params, cfg, batch)
        l = x.shape[1]
        if cfg.attn.kind == "random" and draws is None:
            draws = baseline_draws(cfg, l, device=x.device)
        positions = torch.arange(l, device=x.device)
        sp = _layers(params, cfg)
        for li in range(cfg.n_layers):
            bp = tree_map(lambda t: t[li], sp)
            h = ll.apply_norm(cfg.norm_kind, bp["ln1"], x)
            q, k, _ = ab._project(bp["attn"], h, cfg.n_heads, cfg.n_kv,
                                  cfg.head_dim, cfg.qk_norm, positions,
                                  cfg.rope_theta)
            taps[f"unit{li}/b0"] = (q, k)
            x, _ = _apply_block(bp, x, cfg, mode="train",
                                draw=None if draws is None else draws[li])
    return taps


def whitening_calibrate(params, cfg: ModelConfig, batch: dict,
                        shrink: float = 0.05):
    """Set every darkformer m_mat to Lambda^{-1/2} from a calibration batch
    (scaled q/k statistics; the d^{-1/4} temperature is absorbed so the
    covariance matches what the feature map actually sees).

    Returns a new tree with a new ``m_mat`` (n_layers, G, r, d) and every
    other leaf shared; ``params`` is left as it was, and returned itself
    for any other kind. The taps are cast to f32 before the scale; each
    covariance accumulates in f64 and rounds to f32, and the shrinkage
    and one batched ``eigh`` over every (layer, group) run in f32 on the
    params' device, whatever the model's dtype (the reference's ``eigh``
    raises on bf16). Each row's sign is what ``eigh`` returns, so
    Sigma = M^T M, not M, is what two devices agree on. ``eigh``
    synchronises: calibrate offline, not inside a serving step."""
    if cfg.attn.kind != "darkformer":
        return params
    taps = collect_qk(params, cfg, batch)
    scale = cfg.head_dim ** -0.25
    d = cfg.head_dim

    def lam(t_q, t_k):
        return cal.shrinkage_covariance(torch.cat(
            [(t_q.float() * scale).reshape(-1, d),
             (t_k.float() * scale).reshape(-1, d)]), shrink)
    lams = torch.stack([
        torch.stack([lam(q[:, gi], k[:, gi]) for gi in range(q.shape[1])])
        for q, k in (taps[f"unit{li}/b0"] for li in range(cfg.n_layers))])
    del taps
    new = tree_map(lambda t: t, params)
    fp = _layers(new, cfg)["attn"]["feat"]
    fp["m_mat"] = fm.whitening_init(lams, fp["m_mat"].shape[-2]).to(
        fp["m_mat"].dtype)
    return new


def _serve_proj(params, cfg: ModelConfig, proj: Optional[dict],
                fused: bool) -> Optional[dict]:
    """The projections the fused kernels run against: ``proj``, or built
    here when None; none at all when ``fused`` is False."""
    if not fused:
        return None
    return proj if proj is not None else build_decode_proj(params, cfg)


def prefill_chunk(params, cfg: ModelConfig, batch: dict, state: dict,
                  valid_len: Optional[torch.Tensor] = None,
                  proj: Optional[dict] = None, fused: bool = True,
                  pages: Optional[dict] = None):
    """Advance ``state`` in place over one prompt chunk (tokens (B, L)).

    ``state["pos"]`` is the chunk's start offset. ``valid_len`` ((B,)
    int32) makes the chunk ragged: row b consumes its first
    ``valid_len[b]`` tokens and the rest leave no trace; logits are
    gathered at each row's last valid position. With ``cfg.use_kernel``
    every layer runs the fused ``prf_fused_prefill`` kernel against
    ``proj`` (built here when None); ``fused=False`` drops ``proj`` and
    runs the two stages instead, the plain feature map and the
    ``linear_attention_prefill_chunk`` kernel (the oracle the fused
    kernel is tested against). A paged exact ``state``
    (:func:`init_paged_serve_state`) writes into the page pools ``pages``
    (:func:`init_kv_pages`) in place. Returns (logits (B, V) f32, state).
    """
    if "layers" not in state:
        raise _not_ported("the unit/rem serving layout")
    x = _embed_inputs(params, cfg, batch)
    pos = state["pos"]
    proj = _serve_proj(params, cfg, proj, fused)
    for lp, ls, lproj, lpg in _layer_slices(params, cfg, state, proj, pages):
        x, _ = _apply_block(lp, x, cfg, state=ls, mode="prefill",
                            position=pos, valid_len=valid_len, proj=lproj,
                            pages=lpg)
    state["pos"] = pos + (x.shape[1] if valid_len is None else valid_len)
    if valid_len is None:
        x_last = x[:, -1]
    else:
        last = (valid_len.long() - 1).clamp(min=0)
        x_last = x[torch.arange(x.shape[0], device=x.device), last]
    return _logits(params, cfg, x_last), state


def prefill(params, cfg: ModelConfig, batch: dict, max_len: int):
    """Whole-prompt pass: one ``prefill_chunk`` over batch["tokens"]
    (B, L) from a fresh serve state (the one-chunk schedule). Returns
    (logits (B, 1, V) f32, the new state)."""
    tokens = batch["tokens"]
    state = init_serve_state(cfg, b=tokens.shape[0], max_len=max_len,
                             device=tokens.device)
    logits, state = prefill_chunk(params, cfg, batch, state)
    return logits[:, None], state


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, state: dict,
                proj: Optional[dict] = None, fused: bool = True,
                pages: Optional[dict] = None):
    """One serving step, advancing ``state`` in place. token: (B,) ->
    (logits (B, V) f32, state). With ``cfg.use_kernel`` every layer runs
    the fused ``prf_fused_decode`` kernel against ``proj`` (built here
    when None); ``fused=False`` drops ``proj`` and runs the two stages
    instead, the plain feature map and the
    ``linear_attention_decode_step`` kernel. ``pages`` as in
    :func:`prefill_chunk`."""
    if "layers" not in state:
        raise _not_ported("the unit/rem serving layout")
    pos = state["pos"]
    x = params["embed"][token][:, None]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    x = x.to(cfg.param_dtype)
    proj = _serve_proj(params, cfg, proj, fused)
    for lp, ls, lproj, lpg in _layer_slices(params, cfg, state, proj, pages):
        x, _ = _apply_block(lp, x, cfg, state=ls, mode="decode",
                            position=pos, proj=lproj, pages=lpg)
    state["pos"] = pos + 1
    return _logits(params, cfg, x[:, 0]), state

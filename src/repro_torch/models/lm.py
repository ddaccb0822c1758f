"""The LM stack: config, init, the training forward and loss, the
calibration taps and whitening calibration, resumable prefill and
decode.

The counterpart of ``repro.models.lm`` in both of its layouts. A
homogeneous stack (every layer one block kind) is layer-stacked: params
and serve state carry a leading (n_layers,) axis (the state under
``state["layers"]``) and the layers run as a Python loop over it, in
training as in serving. A heterogeneous pattern (recurrentgemma-2b's
("rec", "rec", "local")) keeps the reference's unit/rem layout: params
``{"units": {"b<i>": leaves (n_units, ...)}, "rem": [block, ...]}`` and
serve state ``{"units": {"b<i>": leaves (n_units, B, ...)}, "rem":
[state (B, ...), ...], "pos"}``, run unit by unit with the pattern
unrolled, then the remainder layers. Blocks are attention (``attn``, and
``local``, whose ``window`` only the exact kind applies, as in the
reference), the RG-LRU (``rec``) or RWKV-6 (``rwkv``: its time mix,
then its channel mix as the feed-forward; rwkv6-7b's homogeneous stack
has no attention layer). The other blocks' feed-forward is a dense MLP
or, with ``cfg.moe``, the capacity-routed mixture of experts, whose
load-balancing loss the training forward sums over the layers (serving
drops it, as the reference does). The calibration taps run over either
layout. Inputs are text tokens, or (``modality``) audio frames whose
masked positions take a learned ``mask_embed`` (hubert-xlarge, an
encoder: ``causal=False``), or a prefix of ``num_patches`` patch
embeddings before the text tokens (internvl2-76b). The training forward
wraps each unit of ``len(block_pattern)`` layers (one layer in the
homogeneous stacks) in ``torch.utils.checkpoint`` under ``cfg.remat``,
as the reference wraps its scanned unit in ``jax.checkpoint``; the
remainder layers run unwrapped (:data:`REMAT_POLICIES`).

``prefill_chunk`` and ``decode_step`` advance ``state`` IN PLACE: the
kernels write each layer's (S, z, c) where it lies in the pool, the
plain path copies its result there, the exact kind writes each layer's
keys and values into its KV cache and advances its ``length``, and the
RG-LRU writes its h and conv tail there, RWKV its S and token shifts.
The paged exact layout
(``init_paged_serve_state``, stacked only) writes them into the shared
page pools (``init_kv_pages``) passed beside the state as ``pages=``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.utils.checkpoint as tcp

from repro_torch.core import calibration as cal
from repro_torch.core import feature_maps as fm
from repro_torch.core import linear_attention as la
from repro_torch.models import attention_block as ab
from repro_torch.models import layers as ll
from repro_torch.models import recurrent as rec
from repro_torch.models import remat as remat_lib
from repro_torch.parallel import tensor_parallel as tpl
from repro_torch.parallel.sharding import gathered
from repro_torch.tree import tree_map

# the reference's remat keys and the JAX policy each names. The port
# runs each as torch.utils.checkpoint (non-reentrant, the form that
# works under the train step's torch.autograd.grad): "none" keeps every
# activation, "full" keeps only the unit's input, "dots" also keeps the
# outputs of the products without a batch dimension (JAX's
# dots_with_no_batch_dims_saveable): x @ W, each through remat.dot, one
# aten.mm of (rows, d) x (d, f). The batched products (MoE's per-expert
# einsums, the attention scores, the feature map's einsums batched over
# the KV groups) reach aten.bmm and are recomputed. The training forward
# has no unbatched einsum: the only aten.bmm of batch 1 there is the
# feature map's over G = 1 group (recurrentgemma-2b's MQA), batched in
# JAX's sense, so it is recomputed too.
REMAT_POLICIES = {
    "none": None,
    "full": "nothing_saveable",
    "dots": "dots_with_no_batch_dims_saveable",
}


def _remat(fn, remat: str):
    """``fn`` under the remat policy ``remat`` (a key of
    :data:`REMAT_POLICIES`); itself for "none", or when no gradient is
    recorded."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r} (known: "
                         f"{', '.join(REMAT_POLICIES)})")
    if REMAT_POLICIES[remat] is None or not torch.is_grad_enabled():
        return fn
    kw = {"context_fn": remat_lib.dots_contexts} if remat == "dots" else {}
    return functools.partial(tcp.checkpoint, fn, use_reentrant=False, **kw)


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
    block_pattern: tuple = ("attn",)      # cycled: attn|local|rec|rwkv
    attn: fm.FeatureConfig = fm.FeatureConfig(kind="darkformer")
    window: Optional[int] = None          # for "local" blocks (exact)
    rope_theta: float = 10000.0           # <=0 disables RoPE
    qk_norm: bool = False
    mlp_kind: str = "swiglu"              # swiglu|geglu|gelu
    moe: Optional[ll.MoEConfig] = None
    tie_embeddings: bool = True
    norm_kind: str = "rmsnorm"
    d_rnn: int = 0                        # rec blocks; 0 -> d_model
    embed_scale: bool = False             # gemma-style sqrt(d) embed scale
    logit_softcap: float = 0.0
    dtype: str = "float32"                # param/activation dtype
    use_kernel: bool = False              # hand-written kernel path
    z_loss: float = 1e-4
    causal: bool = True
    modality: str = "text"                # text|audio|vlm
    num_patches: int = 256                # vlm prefix length
    remat: str = "dots"                   # key of REMAT_POLICIES
    # per-arch sharding-rule overrides, ((path regex, spec tuple), ...),
    # applied before the global rules of repro_torch.parallel.sharding
    sharding_overrides: tuple = ()

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_kinds(self) -> list[str]:
        p = self.block_pattern
        return [p[i % len(p)] for i in range(self.n_layers)]

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def n_rem(self) -> int:
        return self.n_layers % len(self.block_pattern)


SERVED_KINDS = ("attn", "local", "rec", "rwkv")
ATTN_KINDS = ("attn", "local")


def _check_servable(cfg: ModelConfig) -> None:
    """Refuse a block kind the reference does not know either (its
    ``_block_init`` raises ``ValueError`` there)."""
    unknown = set(cfg.block_pattern) - set(SERVED_KINDS)
    if unknown:
        raise ValueError(f"unknown block kind(s) {sorted(unknown)} in "
                         f"{cfg.block_pattern}")


def _rem_kinds(cfg: ModelConfig) -> list[str]:
    """The block kinds of the remainder layers, in order."""
    return cfg.layer_kinds()[cfg.n_units * len(cfg.block_pattern):]


def has_attention(cfg: ModelConfig) -> bool:
    """True when some layer is an attention block (rwkv6-7b has none)."""
    return any(k in ATTN_KINDS for k in cfg.layer_kinds())


def _block_init(gen: torch.Generator, cfg: ModelConfig,
                kind: str = "attn") -> dict:
    """One block's params, drawn as the reference keys them: the mixer
    (attention, or the RG-LRU for ``rec``), then the feed-forward; for
    ``rwkv`` the time mix, then the channel mix."""
    dt = cfg.param_dtype
    norms = {"ln1": ll.norm_init(cfg.norm_kind, cfg.d_model, dt),
             "ln2": ll.norm_init(cfg.norm_kind, cfg.d_model, dt)}
    if kind == "rwkv":
        tmix = rec.rwkv6_init(gen, cfg.d_model, cfg.n_heads, dtype=dt)
        return {**norms, "tmix": tmix, "cmix": rec.rwkv6_channel_mix_init(
            gen, cfg.d_model, cfg.d_ff, dt)}
    if kind == "rec":
        mixer = {"rec": rec.rglru_init(gen, cfg.d_model, cfg.rnn_width, dt)}
    else:
        mixer = {"attn": ab.attn_init(gen, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv, cfg.head_dim, cfg.attn,
                                      cfg.qk_norm, dt)}
    ffn = (ll.moe_init(gen, cfg.d_model, cfg.moe, dt) if cfg.moe else
           ll.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dt))
    return {**norms, **mixer, "ffn": ffn}


def _draw_stacked(n: int, draw, device) -> dict:
    """``n`` trees drawn one after another by ``draw()``, each written
    into its slice of tensors with a leading (n,) axis, allocated once on
    ``device`` at the first draw."""
    out = None
    for i in range(n):
        tree = draw()
        if out is None:
            out = tree_map(lambda t: torch.empty(
                (n, *t.shape), dtype=t.dtype, device=device), tree)
        tree_map(lambda dst, src: dst[i].copy_(src), out, tree)
    return out


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda", draw_on="cpu") -> dict:
    """Random params from ``seed``, in the reference's tree layout:
    {"embed", "final_norm", "units": {"b<i>": leaves (n_units, ...)},
    "rem": [block, ...] when the pattern leaves remainder layers,
    "lm_head" when untied, "mask_embed" (d_model,) for audio}. Drawn
    with a ``torch.Generator`` on ``draw_on``, layer after layer (unit
    by unit, the pattern in order, then the remainder; ``mask_embed``
    last), each layer written into its slice of stacked tensors
    allocated once on ``device``, so the host holds one layer's
    draws at a time (granite-8b's 8.2 B parameters never sit on the
    host). Drawn on the CPU (the default), a seed gives the same params
    on every device; drawn on a card (``draw_on=device``), other
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
    if cfg.n_units:
        params["units"] = _draw_stacked(cfg.n_units, lambda: {
            f"b{i}": _block_init(gen, cfg, kind)
            for i, kind in enumerate(cfg.block_pattern)}, device)
    if cfg.n_rem:
        params["rem"] = [tree_map(lambda t: t.to(device),
                                  _block_init(gen, cfg, kind))
                         for kind in _rem_kinds(cfg)]
    if not cfg.tie_embeddings:
        params["lm_head"] = ll.trunc_normal(gen, (cfg.d_model, cfg.vocab),
                                            1.0, dt).to(device)
    if cfg.modality == "audio":
        params["mask_embed"] = ll.trunc_normal(gen, (cfg.d_model,), 1.0,
                                               dt).to(device)
    return params


def can_stack_layers(cfg: ModelConfig) -> bool:
    """True when every layer is the same block kind, so serving states and
    params stack along one leading layer axis."""
    return (cfg.n_units > 0 and cfg.n_rem == 0
            and len(set(cfg.block_pattern)) == 1)


def stack_layer_params(params: dict, cfg: ModelConfig) -> dict:
    """One block tree with leaves (n_layers, ...): layer u*k + i is
    pattern position i of unit u. For the one-block patterns, unit u is
    layer u: no copy."""
    if not can_stack_layers(cfg):
        raise ValueError(f"{cfg.name}: only a homogeneous pattern stacks "
                         f"(got {cfg.block_pattern}, n_rem={cfg.n_rem})")
    units = params["units"]
    k = len(cfg.block_pattern)
    if k == 1:
        return units["b0"]
    return tree_map(lambda *ts: torch.stack(ts, 1).flatten(0, 1),
                    *(units[f"b{i}"] for i in range(k)))


def _layers(params: dict, cfg: ModelConfig) -> dict:
    return (params["layers"] if "layers" in params
            else stack_layer_params(params, cfg))


def build_decode_proj(params: dict, cfg: ModelConfig,
                      stacked: Optional[bool] = None) -> Optional[dict]:
    """Precompose every attention layer's serve projection A = (W M)^T
    once, at engine build, for the fused prefill and decode kernels.
    Returns a tree mirroring the serve state's layout (``stacked``, by
    default :func:`can_stack_layers`): {"layers": {"a": (L, G, d, m),
    "m_mat": (L, G, r, d) | None}}, or {"units": {"b<i>": ... with
    leaves (n_units, ...) | None}, "rem": [... | None]}, None at the
    blocks without attention; None when the config has no fused path or
    no attention layer. Under a model axis that splits attention
    (:func:`attn_split`), G is this rank's G/M groups."""
    if not (cfg.use_kernel and cfg.attn.kind in fm.PRF_KINDS
            and has_attention(cfg)):
        return None
    if stacked is None:
        stacked = can_stack_layers(cfg)

    def feat(block, kind):
        ax = attn_split(cfg, kind)
        f = block["attn"]["feat"]
        return (gathered(f) if ax is None else
                {k: tpl.block(v, -3, ax) for k, v in f.items()})
    if stacked:
        return {"layers": fm.precompose_projection(
            feat(_layers(params, cfg), cfg.block_pattern[0]),
            cfg.attn.kind)}

    def proj(block, kind):
        return (fm.precompose_projection(feat(block, kind), cfg.attn.kind)
                if kind in ATTN_KINDS else None)
    out: dict[str, Any] = {"units": {
        f"b{i}": proj(params["units"][f"b{i}"], kind)
        for i, kind in enumerate(cfg.block_pattern)}}
    if cfg.n_rem:
        out["rem"] = [proj(bp, kind)
                      for bp, kind in zip(params["rem"], _rem_kinds(cfg))]
    return out


def _init_block_state(cfg: ModelConfig, kind: str, b: int, max_len: int,
                      per_slot: bool, device):
    if kind == "rec":
        return rec.init_rglru_state(b, cfg.rnn_width, device)
    if kind == "rwkv":
        return rec.RWKVBlockState(
            *rec.init_rwkv_state(b, cfg.d_model, cfg.n_heads, device),
            cshift=torch.zeros((b, cfg.d_model), dtype=torch.float32,
                               device=device))
    return ab.init_attn_serve_state(cfg.attn, b, cfg.n_heads, cfg.n_kv,
                                    cfg.head_dim, max_len,
                                    per_slot=per_slot, device=device)


def _stack_state(st, n: int):
    return type(st)(*(t.expand(n, *t.shape).clone() for t in st))


def init_serve_state(cfg: ModelConfig, b: int, max_len: int,
                     per_slot: bool = False,
                     stacked: Optional[bool] = None,
                     device="cuda") -> dict:
    """Initial serving state for b sequences. Stacked (``stacked``, by
    default :func:`can_stack_layers`; a heterogeneous pattern raises
    ``ValueError``): {"layers": the block's state with leaves (n_layers,
    b, ...), "pos"}. Otherwise the unit/rem layout: {"units": {"b<i>":
    leaves (n_units, b, ...)}, "rem": [leaves (b, ...), ...], "pos"}.
    A block's state is ``AttnServeState`` (the PRF kinds),
    ``KVCacheState`` (exact), ``rec.RGLRUState`` or
    ``rec.RWKVBlockState``; "pos" is (b,) int32
    if ``per_slot`` else () int32. The PRF and RG-LRU states are
    fixed-size, so there ``max_len`` only bounds the engine's context
    budget; the exact kind gets a KV cache of ``max_len`` positions a
    layer, with a (b,) ``length`` under ``per_slot``, else ()."""
    _check_servable(cfg)
    if stacked is None:
        stacked = can_stack_layers(cfg)
    pos = torch.zeros((b,) if per_slot else (), dtype=torch.int32,
                      device=device)

    def block(kind):
        return _init_block_state(cfg, kind, b, max_len, per_slot, device)
    if stacked:
        if not can_stack_layers(cfg):
            raise ValueError(
                f"{cfg.name}: stacked serve states need a homogeneous "
                f"block pattern (got {cfg.block_pattern}, "
                f"n_rem={cfg.n_rem})")
        return {"layers": _stack_state(block(cfg.block_pattern[0]),
                                       cfg.n_layers), "pos": pos}
    state: dict[str, Any] = {"units": {
        f"b{i}": _stack_state(block(kind), cfg.n_units)
        for i, kind in enumerate(cfg.block_pattern)}}
    if cfg.n_rem:
        state["rem"] = [block(kind) for kind in _rem_kinds(cfg)]
    state["pos"] = pos
    return state


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


def _state_at(st, i):
    return type(st)(*(t[i] for t in st))


def _blocks(params, cfg: ModelConfig, state=None, proj=None, pages=None):
    """(kind, params, serve state, projection, page pools) of each layer
    in order, in either layout: leaves sliced from the stacked or unit
    tensors as views, so that in-place writes land in the pool. ``state``
    None (training) gives None states; ``proj`` and ``pages`` None give
    None there."""
    if not can_stack_layers(cfg):
        for u in range(cfg.n_units):
            for i, kind in enumerate(cfg.block_pattern):
                key = f"b{i}"
                up = (None if proj is None or proj["units"][key] is None
                      else tree_map(lambda t: t[u], proj["units"][key]))
                yield (kind, tree_map(lambda t: t[u], params["units"][key]),
                       None if state is None
                       else _state_at(state["units"][key], u), up, None)
        for i, kind in enumerate(_rem_kinds(cfg)):
            yield (kind, params["rem"][i],
                   None if state is None else state["rem"][i],
                   None if proj is None else proj["rem"][i], None)
        return
    sp = _layers(params, cfg)
    kind = cfg.block_pattern[0]
    for li in range(cfg.n_layers):
        yield (kind, tree_map(lambda t: t[li], sp),
               None if state is None else _state_at(state["layers"], li),
               None if proj is None else tree_map(lambda t: t[li],
                                                  proj["layers"]),
               None if pages is None else (pages["k"][li], pages["v"][li]))


def attn_split(cfg: ModelConfig, kind: str = "attn"):
    """The model axis a ``kind`` block's attention computes its share of
    (:func:`parallel.tensor_parallel.model_axis`), KV group by KV group:
    None without one, for a block without attention, and where the
    group count n_kv does not divide it (MQA: such a block gathers its
    leaves whole and every ``model`` rank computes all of it)."""
    ax = tpl.model_axis()
    if ax is None or kind not in ATTN_KINDS or cfg.n_kv % ax.size:
        return None
    return ax


def _attn_share(p: dict, ax) -> dict:
    """The attention leaves of this rank's KV groups (G/M of them and
    their query heads): wq, wk, wv's column block, wo's row block, the
    groups' feature params; qk-norm's scales whole."""
    out = {"wq": tpl.block(p["wq"], -1, ax), "wk": tpl.block(p["wk"], -1, ax),
           "wv": tpl.block(p["wv"], -1, ax), "wo": tpl.block(p["wo"], -2, ax)}
    if "feat" in p:
        out["feat"] = {k: tpl.block(v, -3, ax) for k, v in p["feat"].items()}
    for k in ("q_norm", "k_norm"):
        if k in p:
            out[k] = {"scale": tpl.shared(p[k]["scale"], ax)}
    return out


def _mlp_share(p: dict, d_ff: int, ax):
    """(the dense MLP's leaves of this rank's hidden columns, ax), or
    (the whole leaves, None) where d_ff does not divide over ``model``."""
    if ax is None or d_ff % ax.size:
        return gathered(p), None
    out = {k: tpl.block(v, -1, ax) for k, v in p.items() if k != "w_out"}
    out["w_out"] = tpl.block(p["w_out"], -2, ax)
    return out, ax


def _moe_share(p: dict, moe: ll.MoEConfig, ax):
    """(the MoE leaves this rank computes, its ``ll.MoEShare``), or (the
    whole leaves, None). The placement decides: experts split over
    ``model`` run expert-parallel (this rank's E/M experts), an expert
    hidden dim split over it (the rule tables' fallback, granite-moe's
    overrides) runs each expert's hidden columns; unplaced leaves the
    same by the counts (experts if E divides, else the hidden dim)."""
    if ax is None:
        return gathered(p), None
    wg = p["w_gate"]
    if isinstance(wg, tpl.LocalShard) and any(
            "model" in axes for axes in wg.dims):
        mode = ("experts" if "model" in wg.dims[-3] else
                "hidden" if "model" in wg.dims[-1] else None)
    else:
        mode = ("experts" if moe.num_experts % ax.size == 0 else
                "hidden" if moe.d_ff % ax.size == 0 else None)
    if mode is None:
        return gathered(p), None
    out = {"router": gathered(p["router"])}
    if mode == "experts":
        for k in ("w_gate", "w_up", "w_out"):
            out[k] = tpl.block(p[k], -3, ax)
    else:
        out["w_gate"] = tpl.block(p["w_gate"], -1, ax)
        out["w_up"] = tpl.block(p["w_up"], -1, ax)
        out["w_out"] = tpl.block(p["w_out"], -2, ax)
    return out, ll.MoEShare(ax, mode)


def _own_groups(state, g: int, ax):
    """``state`` (a layer's ``AttnServeState`` or ``KVCacheState``) with
    the leaves that hold every KV group cut to this rank's ``g`` groups,
    contiguous for the kernels, and a function that writes them back
    where they lie (None when nothing was cut). The rules place the KV
    cache's groups over ``model`` (each rank holds its own), the linear
    state's (S, z, c) whole on every rank: the reference's
    ``serve_state_specs`` names them ``'s'``, ``'z'``, ``'c'``, which a
    NamedTuple's field path (``.s``) never contains."""
    from repro_torch.core.attention import AttnServeState, KVCacheState
    if not isinstance(state, (AttnServeState, KVCacheState)):
        return state, None
    cut = [t.ndim > 1 and t.shape[1] == g * ax.size for t in state]
    if not any(cut):
        return state, None
    views = [t.narrow(1, ax.rank * g, g) if c else t
             for t, c in zip(state, cut)]
    local = [v.contiguous() for v in views]

    def back():
        for v, t in zip(views, local):
            if t.data_ptr() != v.data_ptr():
                v.copy_(t)
    return type(state)(*local), back


def _apply_block(params, x, cfg: ModelConfig, kind: str = "attn", *, mode,
                 state=None, position=None, valid_len=None, proj=None,
                 draw=None, pages=None):
    """One block: the mixer (attention, ``window`` for a "local" block;
    or the RG-LRU, whose serve state it writes in place), then the dense
    or MoE feed-forward; or RWKV-6's time and channel mixes, whose S and
    token shifts it writes in place. Returns (x, the block's aux loss:
    0-d f32 with MoE, else None).

    ``params`` may hold a sharded step's :class:`parallel.sharding.
    LocalShard` leaves, gathered here. Under a model axis
    (:func:`parallel.tensor_parallel.model_axis`) attention computes
    this rank's KV groups (:func:`attn_split`; ``state``, ``proj`` and
    the paged pools' groups are its own), the MLP its hidden columns
    and MoE its experts or their hidden columns, each summed over
    ``model`` after its output product; the RG-LRU and RWKV-6 blocks
    gather their leaves whole and compute all of it on every rank."""
    ax = tpl.model_axis()
    if ax is None or kind in ("rec", "rwkv"):
        params, ax = gathered(params), None
    h = ll.apply_norm(cfg.norm_kind, gathered(params["ln1"]), x)
    if kind == "rwkv":
        mix, tst = rec.rwkv6_apply(
            params["tmix"], h, cfg.n_heads,
            None if state is None else rec.RWKVState(state.s, state.shift),
            valid_len=valid_len)
        x = x + mix
        h2 = ll.apply_norm(cfg.norm_kind, params["ln2"], x)
        f, cshift = rec.rwkv6_channel_mix(
            params["cmix"], h2, None if state is None else state.cshift,
            valid_len=valid_len)
        if state is not None:
            state.s.copy_(tst.s)
            state.shift.copy_(tst.shift)
            state.cshift.copy_(cshift)
        return x + f, None
    if kind == "rec":
        if mode == "train":
            mix, _ = rec.rglru_apply(params["rec"], h)
        else:
            mix, new = rec.rglru_apply(params["rec"], h, state,
                                       valid_len=valid_len)
            state.h.copy_(new.h)
            state.conv.copy_(new.conv)
    else:
        a_ax = attn_split(cfg, kind)
        n_heads, n_kv, back = cfg.n_heads, cfg.n_kv, None
        if a_ax is None:
            attn = gathered(params["attn"])
        else:
            attn = _attn_share(params["attn"], a_ax)
            n_heads, n_kv = n_heads // a_ax.size, n_kv // a_ax.size
            h = tpl.copy_to_model(h, a_ax)
            if pages is not None:       # the pools hold every group
                pages = tuple(pg.narrow(2, a_ax.rank * n_kv, n_kv)
                              for pg in pages)
            state, back = _own_groups(state, n_kv, a_ax)
        common = dict(n_heads=n_heads, n_kv=n_kv,
                      d_head=cfg.head_dim, qk_norm=cfg.qk_norm,
                      rope_theta=cfg.rope_theta, use_kernel=cfg.use_kernel,
                      window=cfg.window if kind == "local" else None)
        if mode == "train":
            mix = ab.attn_apply(attn, h, cfg.attn,
                                causal=cfg.causal, baseline_draw=draw,
                                **common)
        elif mode == "prefill":
            mix, _ = ab.attn_prefill(attn, h, cfg.attn,
                                     state=state, position=position,
                                     valid_len=valid_len, proj=proj,
                                     pages=pages, **common)
        else:
            mix, _ = ab.attn_decode(attn, h, state, cfg.attn,
                                    position=position, proj=proj,
                                    pages=pages, **common)
        if back is not None:
            back()
        mix = tpl.reduce_from_model(mix, a_ax)
    x = x + mix
    h2 = ll.apply_norm(cfg.norm_kind, gathered(params["ln2"]), x)
    if cfg.moe:
        ffn, share = _moe_share(params["ffn"], cfg.moe, ax)
        f, aux = (ll.moe_apply(ffn, h2, cfg.moe) if share is None
                  else ll.moe_apply(ffn, h2, cfg.moe, share=share))
        return x + f, aux
    ffn, f_ax = _mlp_share(params["ffn"], cfg.d_ff, ax)
    f = ll.mlp_apply(ffn, tpl.copy_to_model(h2, f_ax), cfg.mlp_kind)
    return x + tpl.reduce_from_model(f, f_ax), None


def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The stack's input (B, L, d_model) in the param dtype: token
    embeddings; for audio batch["frames"], with ``mask_embed`` wherever
    batch["mask"] (bool (B, L), optional) is set; for vlm
    batch["patch_embeds"] (B, num_patches, d_model) before the token
    embeddings, so the patches take positions 0..num_patches-1."""
    dt = cfg.param_dtype
    if cfg.modality == "audio":
        x = batch["frames"].to(dt)
        if "mask" in batch:
            x = torch.where(batch["mask"][..., None],
                            gathered(params["mask_embed"]).to(dt), x)
        return x
    tok = _embed_tokens(params, cfg, batch["tokens"])
    if cfg.embed_scale:
        tok = tok * torch.tensor(cfg.d_model ** 0.5, dtype=tok.dtype)
    if cfg.modality == "vlm":
        return torch.cat([batch["patch_embeds"].to(dt), tok.to(dt)], dim=1)
    return tok.to(dt)


def vocab_split(cfg: ModelConfig):
    """The model axis the vocabulary is split over (embedding rows, head
    columns, logits): :func:`parallel.tensor_parallel.model_axis` where
    it divides the vocab, else None."""
    ax = tpl.model_axis()
    return None if ax is None or cfg.vocab % ax.size else ax


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor):
    """The embedding rows of ``tokens``; over a vocab split, each rank's
    rows looked up and summed over ``model``."""
    ax = vocab_split(cfg)
    if ax is None:
        return gathered(params["embed"])[tokens]
    return tpl.vocab_embed(tpl.block(params["embed"], 0, ax), tokens, ax)


def _logits_share(params, cfg: ModelConfig, x: torch.Tensor):
    """(logits f32 of this rank's vocab slice, the model axis) over a
    vocab split (:func:`vocab_split`), else (the whole logits, None)."""
    x = ll.apply_norm(cfg.norm_kind, gathered(params["final_norm"]), x)
    ax = vocab_split(cfg)
    if ax is None:
        head = gathered(params["embed"] if cfg.tie_embeddings
                        else params["lm_head"])
    else:
        head = (tpl.block(params["embed"], 0, ax) if cfg.tie_embeddings
                else tpl.block(params["lm_head"], 1, ax))
        x = tpl.copy_to_model(x, ax)
    head = head.T if cfg.tie_embeddings else head
    logits = (x @ head.to(x.dtype)).float()
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits, ax


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The whole logits f32; over a vocab split, the slices gathered
    (serving gathers only its last positions' rows)."""
    logits, ax = _logits_share(params, cfg, x)
    return logits if ax is None else tpl.gather_model(logits, ax, -1)


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
    """(logits (B, L, V) f32, aux loss) of :func:`_forward`, the
    logits gathered whole over a vocab split."""
    logits, aux, ax = _forward(params, cfg, batch, gen)
    return (logits if ax is None else tpl.gather_model(logits, ax, -1),
            aux)


def _forward(params, cfg: ModelConfig, batch: dict,
                  gen: Optional[torch.Generator] = None):
    """Full forward over the batch's input (:func:`_embed_inputs`: (B, L)
    positions), layer by layer in either layout. Returns (logits (B, L, V)
    f32, aux loss 0-d f32: the MoE load-balancing losses summed over the
    layers, zero without MoE, the model axis the logits' vocab is split
    over or None: then the logits are this rank's (B, L, V/M) slice).
    With ``cfg.use_kernel`` every layer's causal PRF attention runs the
    ``linear_attention_causal`` kernel. The random baseline reads layer
    i's (L, L) logits from :func:`baseline_draws` of ``gen``; the other
    kinds read none. Each unit of ``len(block_pattern)`` layers runs
    under ``cfg.remat`` (:func:`_remat`); under "full" and "dots" its
    forward runs again in the backward, kernel launches included.

    Params may be a sharded train step's :class:`parallel.sharding.
    LocalShard` leaves (``launch.steps.make_sharded_train_step``): each
    is gathered whole where it is used, a layer's leaves inside the
    function that remat wraps, so under "full" and "dots" the recompute
    gathers them again and no full weight stays alive from a unit's
    forward to its backward (under "none" each layer's stay until its
    backward, as its activations do; the remainder layers run
    unwrapped, so theirs stay too). Plain tensors pass through. Under a
    model axis (``parallel.tensor_parallel.over_model``) each block
    computes this rank's share (:func:`_apply_block`), and a leaf split
    over ``model`` is gathered over the other axes only."""
    _check_servable(cfg)
    x = _embed_inputs(params, cfg, batch)
    draws = (baseline_draws(cfg, x.shape[1], gen, x.device)
             if cfg.attn.kind == "random" else None)
    blocks = list(_blocks(params, cfg))
    k = len(cfg.block_pattern)

    def run(x, lo, hi):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for li in range(lo, hi):
            kind, bp = blocks[li][:2]
            x, aux_l = _apply_block(
                bp, x, cfg, kind, mode="train",
                draw=None if draws is None else draws[li])
            if aux_l is not None:
                aux = aux + aux_l
        return x, aux
    unit = _remat(run, cfg.remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(cfg.n_units):
        x, aux_u = unit(x, u * k, (u + 1) * k)
        aux = aux + aux_u
    x, aux_r = run(x, cfg.n_units * k, cfg.n_layers)
    logits, ax = _logits_share(params, cfg, x)
    return logits, aux + aux_r, ax


def loss_weights(cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The positions :func:`loss_fn` averages over, as f32 weights shaped
    as batch["labels"]: the masked frames for audio with a
    batch["mask"], else ``labels >= 0``. Their sum (at least 1) is the
    loss's denominator."""
    if cfg.modality == "audio" and "mask" in batch:
        return batch["mask"].float()
    return (batch["labels"] >= 0).float()


def loss_fn(params, cfg: ModelConfig, batch: dict,
            gen: Optional[torch.Generator] = None):
    """Cross-entropy against batch["labels"] plus z-loss over the
    positions with ``labels >= 0``; for vlm over the text positions only
    (the last ``labels.shape[1]`` of the row), for audio with a
    batch["mask"] over the masked frames only. ``gen`` feeds the random
    baseline (:func:`forward_train`). Returns (loss 0-d f32, metrics
    {loss, ce, z_loss, aux, accuracy}, detached). Over a vocab split
    the cross-entropy is vocab-parallel: the logsumexp's max and sum of
    exps, the label's logit and the argmax all-reduced over ``model``,
    the (B, L, V) logits never gathered."""
    logits, aux, ax = _forward(params, cfg, batch, gen)
    labels = batch["labels"].long()
    if cfg.modality == "vlm":
        logits = logits[:, -labels.shape[1]:]
    if ax is None:
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              labels.clamp(min=0)[..., None])[..., 0]
        pred = logits.argmax(-1)
    else:
        logz = tpl.vocab_logsumexp(logits, ax)
        picked = tpl.vocab_pick(logits, labels.clamp(min=0), ax)
        pred = tpl.vocab_argmax(logits, ax)
    ll_tok = picked - logz
    wmask = loss_weights(cfg, batch)
    denom = wmask.sum().clamp(min=1.0)
    ce = -(ll_tok * wmask).sum() / denom
    zl = cfg.z_loss * (logz.square() * wmask).sum() / denom
    loss = ce + zl + aux
    acc = ((pred == labels).float() * wmask).sum() / denom
    metrics = {"loss": loss, "ce": ce, "z_loss": zl, "aux": aux,
               "accuracy": acc}
    return loss, {k: t.detach() for k, t in metrics.items()}


def _tap_name(cfg: ModelConfig, li: int) -> str:
    """The reference's key of layer ``li``'s taps: ``unit<u>/b<i>`` with
    (u, i) = divmod(li, len(pattern)); a remainder layer's u is
    n_units."""
    u, i = divmod(li, len(cfg.block_pattern))
    return f"unit{u}/b{i}"


def collect_qk(params, cfg: ModelConfig, batch: dict, *,
               draws: Optional[torch.Tensor] = None) -> dict:
    """Run the stack and capture post-RoPE q/k of every attention block.

    Calibration tap for the whitening init (App. C): returns
    {"unit<u>/b<i>": (q, k)} (:func:`_tap_name`, in layer order) with q:
    (B, G, Hg, L, dh), k: (B, G, 1, L, dh), in the model's dtype, for
    every ``attn`` and ``local`` block of either layout. Every block
    runs as in :func:`forward_train`, without gradient (with
    ``cfg.use_kernel`` a PRF layer launches ``linear_attention_causal``
    once; the RG-LRU and RWKV blocks advance x and yield no tap). The
    random baseline reads layer li's (L, L) logits from ``draws``
    ((n_layers, L, L)), else from :func:`baseline_draws` of a generator
    seeded 0."""
    _check_servable(cfg)
    taps: dict = {}
    with torch.no_grad():
        x = _embed_inputs(params, cfg, batch)
        l = x.shape[1]
        if cfg.attn.kind == "random" and draws is None:
            draws = baseline_draws(cfg, l, device=x.device)
        positions = torch.arange(l, device=x.device)
        for li, (kind, bp, _, _, _) in enumerate(_blocks(params, cfg)):
            if kind in ATTN_KINDS:
                h = ll.apply_norm(cfg.norm_kind, bp["ln1"], x)
                q, k, _ = ab._project(bp["attn"], h, cfg.n_heads, cfg.n_kv,
                                      cfg.head_dim, cfg.qk_norm, positions,
                                      cfg.rope_theta)
                taps[_tap_name(cfg, li)] = (q, k)
            x, _ = _apply_block(bp, x, cfg, kind, mode="train",
                                draw=None if draws is None else draws[li])
    return taps


def whitening_calibrate(params, cfg: ModelConfig, batch: dict,
                        shrink: float = 0.05):
    """Set every darkformer m_mat to Lambda^{-1/2} from a calibration batch
    (scaled q/k statistics; the d^{-1/4} temperature is absorbed so the
    covariance matches what the feature map actually sees).

    Returns a new tree with a new ``m_mat`` at every attention block (a
    unit's (n_units, G, r, d) leaf, or a remainder block's (G, r, d))
    and every other leaf shared; ``params`` is left as it was, and
    returned itself for any other kind. The taps are cast to f32 before
    the scale; each covariance accumulates in f64 and rounds to f32, and
    the shrinkage and one batched ``eigh`` over every (attention layer,
    group) run in f32 on the params' device, whatever the model's dtype
    (the reference's ``eigh`` raises on bf16). Each row's sign is what
    ``eigh`` returns, so Sigma = M^T M, not M, is what two devices agree
    on. ``eigh`` synchronises: calibrate offline, not inside a serving
    step."""
    if cfg.attn.kind != "darkformer" or not has_attention(cfg):
        return params
    taps = collect_qk(params, cfg, batch)
    scale = cfg.head_dim ** -0.25
    d = cfg.head_dim

    def lam(t_q, t_k):
        return cal.shrinkage_covariance(torch.cat(
            [(t_q.float() * scale).reshape(-1, d),
             (t_k.float() * scale).reshape(-1, d)]), shrink)
    layers = [li for li, kind in enumerate(cfg.layer_kinds())
              if kind in ATTN_KINDS]
    lams = torch.stack([
        torch.stack([lam(q[:, gi], k[:, gi]) for gi in range(q.shape[1])])
        for q, k in (taps[_tap_name(cfg, li)] for li in layers)])
    del taps
    ms = fm.whitening_init(lams, cfg.attn.rank(d))
    new = tree_map(lambda t: t, params)
    plen = len(cfg.block_pattern)
    by_unit: dict = {}
    for li, m in zip(layers, ms):
        u, i = divmod(li, plen)
        if u < cfg.n_units:
            by_unit.setdefault(f"b{i}", []).append(m)
        else:
            fp = new["rem"][li - cfg.n_units * plen]["attn"]["feat"]
            fp["m_mat"] = m.to(fp["m_mat"].dtype)
    for key, mats in by_unit.items():
        fp = new["units"][key]["attn"]["feat"]
        fp["m_mat"] = torch.stack(mats).to(fp["m_mat"].dtype)
    return new


def _serve_proj(params, cfg: ModelConfig, proj: Optional[dict],
                fused: bool, state: dict) -> Optional[dict]:
    """The projections the fused kernels run against: ``proj``, or built
    here in ``state``'s layout when None; none at all when ``fused`` is
    False."""
    if not fused:
        return None
    return (proj if proj is not None else
            build_decode_proj(params, cfg, stacked="layers" in state))


def prefill_chunk(params, cfg: ModelConfig, batch: dict, state: dict,
                  valid_len: Optional[torch.Tensor] = None,
                  proj: Optional[dict] = None, fused: bool = True,
                  pages: Optional[dict] = None):
    """Advance ``state`` in place over one prompt chunk (tokens (B, L)).

    ``state["pos"]`` is the chunk's start offset. ``valid_len`` ((B,)
    int32) makes the chunk ragged: row b consumes its first
    ``valid_len[b]`` tokens and the rest leave no trace; logits are
    gathered at each row's last valid position. With ``cfg.use_kernel``
    every attention layer runs the fused ``prf_fused_prefill`` kernel
    against ``proj`` (built here when None); ``fused=False`` drops
    ``proj`` and runs the two stages instead, the plain feature map and
    the ``linear_attention_prefill_chunk`` kernel (the oracle the fused
    kernel is tested against). A paged exact ``state``
    (:func:`init_paged_serve_state`) writes into the page pools ``pages``
    (:func:`init_kv_pages`) in place. Returns (logits (B, V) f32, state).
    """
    x = _embed_inputs(params, cfg, batch)
    pos = state["pos"]
    proj = _serve_proj(params, cfg, proj, fused, state)
    for kind, lp, ls, lproj, lpg in _blocks(params, cfg, state, proj,
                                            pages):
        x, _ = _apply_block(lp, x, cfg, kind, state=ls, mode="prefill",
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
    """Whole-prompt pass: one ``prefill_chunk`` over the batch's input
    (:func:`_embed_inputs`: tokens (B, L), audio frames, or patches then
    tokens, so a vlm row ends at ``pos`` = num_patches + L) from a fresh
    serve state (the one-chunk schedule). An audio config runs this
    causal serving path too: the reference's ``attn_prefill`` takes no
    ``causal``. Returns (logits (B, 1, V) f32, the new state)."""
    lead = batch["frames" if cfg.modality == "audio" else "tokens"]
    state = init_serve_state(cfg, b=lead.shape[0], max_len=max_len,
                             device=lead.device)
    logits, state = prefill_chunk(params, cfg, batch, state)
    return logits[:, None], state


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, state: dict,
                proj: Optional[dict] = None, fused: bool = True,
                pages: Optional[dict] = None):
    """One serving step, advancing ``state`` in place. token: (B,) ->
    (logits (B, V) f32, state). With ``cfg.use_kernel`` every attention
    layer runs the fused ``prf_fused_decode`` kernel against ``proj``
    (built here when None); ``fused=False`` drops ``proj`` and runs the
    two stages instead, the plain feature map and the
    ``linear_attention_decode_step`` kernel. ``pages`` as in
    :func:`prefill_chunk`."""
    pos = state["pos"]
    x = _embed_tokens(params, cfg, token)[:, None]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    x = x.to(cfg.param_dtype)
    proj = _serve_proj(params, cfg, proj, fused, state)
    for kind, lp, ls, lproj, lpg in _blocks(params, cfg, state, proj,
                                            pages):
        x, _ = _apply_block(lp, x, cfg, kind, state=ls, mode="decode",
                            position=pos, proj=lproj, pages=lpg)
    state["pos"] = pos + 1
    return _logits(params, cfg, x[:, 0]), state

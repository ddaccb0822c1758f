"""Model substrate: init, norms, RoPE, the dense MLPs and MoE.

The counterpart of ``repro.models.layers``. Params are plain dicts of
tensors with the reference's key names, so a reference param tree maps
leaf for leaf (``bridge``). MoE's ``dispatch_spec`` pins the dispatch
buffers' placements when they are DTensors; the port computes on local
tensors (``launch.steps``, the mesh engine), so on its paths the pin is
the identity. Under tensor parallelism MoE runs this rank's share of
the experts (:class:`MoEShare`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.remat import dot
from repro_torch.parallel import tensor_parallel as tpl


def trunc_normal(gen: torch.Generator, shape, scale: float,
                 dtype=torch.float32) -> torch.Tensor:
    """N(0, scale / fan_in) truncated at two standard deviations, drawn
    on ``gen``'s device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = (scale / fan_in) ** 0.5
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=gen)
    return (std * t).to(dtype)


def rmsnorm_init(d: int, dtype=torch.float32) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype)}    # gemma-style 1+scale


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dt)


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


def norm_init(kind: str, d: int, dtype=torch.float32) -> dict:
    if kind == "rmsnorm":
        return rmsnorm_init(d, dtype)
    return {"scale": torch.ones((d,), dtype=dtype),
            "bias": torch.zeros((d,), dtype=dtype)}


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., L, d_head); positions: (L,) or broadcastable int."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    ang = positions[..., :, None].float() * freqs       # (..., L, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype=torch.float32) -> dict:
    # draw order follows the reference's key split: gate, up, out
    gate = trunc_normal(gen, (d_model, d_ff), 1.0, dtype)
    up = trunc_normal(gen, (d_model, d_ff), 1.0, dtype)
    p = {"w_out": trunc_normal(gen, (d_ff, d_model), 1.0, dtype),
         "w_up": up}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = gate
    return p


def mlp_apply(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(dot(x, params["w_gate"])) * dot(x, params["w_up"])
    elif kind == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = (F.gelu(dot(x, params["w_gate"]), approximate="tanh")
             * dot(x, params["w_up"]))
    else:
        h = F.gelu(dot(x, params["w_up"]), approximate="tanh")
    return dot(h, params["w_out"])


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-based dispatch, GShard style)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # Optional (dp_axes, expert_axis), the reference's: the (B, E, C, d)
    # dispatch buffers and the (B, L, K, d) gather get batch on dp_axes
    # and, for the former, the expert dim on expert_axis ("model" under
    # EP, None under the TP-expert fallback). See _pin.
    dispatch_spec: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class MoEShare:
    """The share of the experts one rank computes over the mesh's
    ``model`` axis ``ax`` (a ``parallel.tensor_parallel.ModelAxis``):
    ``mode`` "experts", its E/M experts whole (expert parallelism), or
    "hidden", every expert's d_ff/M hidden columns."""
    ax: object
    mode: str


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.float32) -> dict:
    # draw order follows the reference's key split: router, gate, up, out
    e, f = cfg.num_experts, cfg.d_ff
    return {"router": trunc_normal(gen, (d_model, e), 1.0, torch.float32),
            "w_gate": trunc_normal(gen, (e, d_model, f), 1.0, dtype),
            "w_up": trunc_normal(gen, (e, d_model, f), 1.0, dtype),
            "w_out": trunc_normal(gen, (e, f, d_model), 1.0, dtype)}


def moe_route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """The routing of :func:`moe_apply`: x (B, L, d) -> (probs (B, L, E)
    f32, gates (B, L, K) f32 renormalised, idx (B, L, K) expert ids in
    descending probability, pos (B, L, K) each pair's slot in its
    expert's capacity buffer, in_cap (B, L, K) bool, cap). One capacity
    group per batch row: the row's (token, k) pairs take their expert's
    slots in (l, k) order, and a pair at ``pos >= cap`` is dropped."""
    l = x.shape[1]
    e, k = cfg.num_experts, cfg.top_k
    cap = max(1, int(cfg.capacity_factor * k * l / e))
    probs = torch.softmax(dot(x.float(), router), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1, sorted=True)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return probs, gates, idx, *moe_positions(idx, e, cap), cap


def moe_positions(idx: torch.Tensor, num_experts: int, cap: int):
    """idx (B, L, K) expert ids -> (pos (B, L, K) each pair's slot in its
    expert's capacity buffer, in_cap (B, L, K) bool): a cumulative sum
    over each row's (token, k) pairs in (l, k) order; ``pos >= cap``
    is dropped."""
    b, l, k = idx.shape
    sel = (idx[..., None] == torch.arange(num_experts, device=idx.device)
           ).int()
    pos_e = sel.reshape(b, l * k, num_experts).cumsum(1) - 1  # (B, L*K, E)
    pos = pos_e.reshape(b, l, k, num_experts).gather(
        -1, idx[..., None])[..., 0]
    return pos, pos < cap


# (me, ce) -> the whole batch's (me, ce); set by moe_balance_over
_whole_batch: Optional[Callable] = None


@contextlib.contextmanager
def moe_balance_over(whole_batch: Callable):
    """Within, :func:`moe_apply` forms its load-balancing loss from
    ``whole_batch(me, ce)`` instead of its own (me, ce): the
    data-parallel step's statistics over every rank's rows. A module
    global, not a thread's: a remat recompute that autograd runs on a
    device thread reads it too."""
    global _whole_batch
    prev, _whole_batch = _whole_batch, whole_batch
    try:
        yield
    finally:
        _whole_batch = prev


def _pin(t: torch.Tensor, cfg: MoEConfig, expert_axis: bool):
    """``t`` redistributed to ``cfg.dispatch_spec``'s placements on its
    own mesh when it is a DTensor (the reference's sharding constraint);
    a plain tensor, or no spec, passes through unchanged. The port's
    steps and the mesh engine compute on local tensors, so on its paths
    the pin is the identity."""
    if cfg.dispatch_spec is None:
        return t
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    from repro_torch.parallel.sharding import P, NamedSharding
    dp, eax = cfg.dispatch_spec
    axes = [tuple(dp)] + [None] * (t.ndim - 1)
    if expert_axis:
        axes[1] = eax
    return t.redistribute(t.device_mesh,
                          NamedSharding(t.device_mesh, P(*axes)).placements)


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig,
              share: Optional[MoEShare] = None):
    """x: (B, L, d) -> (out (B, L, d) in x's dtype, aux loss 0-d f32).

    Router logits in f32, softmax, top-k with the gates renormalised;
    the Switch load-balancing loss w · E · Σ_e mean(probs_e) ·
    mean(top-1 == e), both means over the whole batch
    (:func:`moe_balance_over`). Each kept (token, k) pair is scattered
    into a (B, E, cap, d) buffer by ADDING, as the reference's ``.at[].add``: a
    dropped pair lands on slot cap - 1 as zeros and leaves the token that
    holds the slot as it is. The experts' SwiGLU runs as batched
    products over the buffer; the outputs are gathered back and combined
    with the gates (zero for dropped pairs) in x's dtype. The buffers
    and the gather pass through :func:`_pin` as the reference's do.

    With ``share`` every rank of its ``model`` axis routes the same rows
    (the router whole), and runs its share of the experts: "experts"
    scatters only the pairs of its E/M experts into a (B, E/M, cap, d)
    buffer (``params``' expert leaves are those experts), "hidden" every
    pair through its d_ff/M columns of each expert (a partial sum). The
    gathered (B, L, K, d) outputs, zeros for another rank's experts, are
    summed over ``model`` before the gates combine them, so the router's
    gradient is whole on every rank; the dispatched input's gradient is
    summed over ``model`` (``tensor_parallel.copy_to_model``)."""
    b, l, d = x.shape
    e = cfg.num_experts
    probs, gate_vals, idx, pos, in_cap, cap = moe_route(
        x, params["router"], cfg)
    me = probs.mean((0, 1))                                  # (E,)
    ce = (idx[..., 0, None] == torch.arange(e, device=x.device)
          ).float().mean((0, 1))
    if _whole_batch is not None:
        me, ce = _whole_batch(me, ce)
    aux = cfg.aux_loss_weight * e * (me * ce).sum()
    pos_c = pos.clamp(0, cap - 1)
    b_idx = torch.arange(b, device=x.device)[:, None, None].expand_as(idx)
    ax = None if share is None else share.ax
    keep, eidx, n_e = in_cap, idx, e
    if share is not None and share.mode == "experts":
        n_e = params["w_gate"].shape[0]
        local = idx - ax.rank * n_e
        keep = in_cap & (local >= 0) & (local < n_e)
        eidx = local.clamp(0, n_e - 1)
    upd = tpl.copy_to_model(x, ax)[:, :, None, :] * keep[..., None].to(
        x.dtype)
    xin = torch.zeros((b, n_e, cap, d), dtype=x.dtype,
                      device=x.device).index_put(
        (b_idx, eidx, pos_c), upd, accumulate=True)          # (B, E, C, d)
    xin = _pin(xin, cfg, True)
    h = (F.silu(torch.einsum("becd,edf->becf", xin, params["w_gate"]))
         * torch.einsum("becd,edf->becf", xin, params["w_up"]))
    xout = _pin(torch.einsum("becf,efd->becd", h, params["w_out"]), cfg,
                True)
    got = xout[b_idx, eidx, pos_c]                           # (B, L, K, d)
    if keep is not in_cap:
        got = torch.where(keep[..., None], got, torch.zeros(
            (), dtype=got.dtype, device=got.device))
    got = _pin(tpl.reduce_from_model(got, ax), cfg, False)
    gates = (gate_vals * in_cap.float()).to(x.dtype)
    return torch.einsum("blkd,blk->bld", got, gates), aux

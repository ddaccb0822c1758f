"""Tensor parallelism over the mesh's ``model`` axis: the collectives the
layers place around their split products, and how a layer takes its
share of a leaf.

The reference's "2d" rules split attention's q/k/v projections and the
MLP's gate and up by column over ``("model", "data")``, attention's
output and the MLP's down projection by row over ``model``, MoE's
experts over ``model`` (or, where their count does not divide it, each
expert's hidden dim), and the vocabulary of the embedding and the head
over ``model``; XLA then runs each rank's heads, columns, experts and
vocab slice. The port does the same by hand, Megatron-style:

  * :func:`copy_to_model` (identity forward, all-reduce over ``model``
    backward) before a column-split product, so the replicated input's
    gradient sums every rank's partial one;
  * :func:`reduce_from_model` (all-reduce forward, identity backward)
    after a row-split product, so every rank holds the whole output.

:func:`over_model` sets the model axis for the code run within (the
sharded train step and the mesh engine set it); :func:`model_axis` is
None outside it, and on a mesh whose ``model`` axis has one rank (below
``_MIN_RANKS``), so without a mesh every layer computes exactly as
it did. :func:`block`
gives a layer its share of a leaf: a :class:`sharding.LocalShard`
placed split major over ``model`` along that dim is gathered over the
other axes only (``LocalShard.block``, no ``model`` collective); any
other leaf (replicated, plain, or split another way) is taken whole and
cut, through :func:`copy_to_model`, so that its gradient, partial on
each rank, is summed over ``model`` before the step's DP mean. The
vocab-parallel pieces (:func:`vocab_embed`, :func:`vocab_logsumexp`,
:func:`vocab_pick`, :func:`vocab_argmax`) compute the embedding lookup,
the cross-entropy's terms and the accuracy's argmax from each rank's
vocab slice, never gathering the (B, L, V) logits.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import LocalShard, gathered


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The ``model`` axis of a mesh as this rank sees it: ``size`` ranks,
    this one at ``rank``, their process ``group``."""
    size: int
    rank: int
    group: Any


_AXIS: Optional[ModelAxis] = None
# the fewest ``model`` ranks that compute on shards. A test seam, not an
# option: chip_smoke.py lowers it to 1 so that a one-rank axis runs the
# tensor-parallel branches (each rank's share the whole), the only way a
# single card runs them; the port itself never changes it
_MIN_RANKS = 2


@contextlib.contextmanager
def over_model(mesh):
    """Within, :func:`model_axis` is ``mesh``'s ``model`` axis when it
    has at least ``_MIN_RANKS`` ranks (else None). A module global,
    not a thread's: a remat recompute that autograd runs on a device
    thread reads it too."""
    global _AXIS
    ax = None
    if mesh is not None and "model" in mesh.mesh_dim_names:
        k = mesh.mesh_dim_names.index("model")
        if mesh.size(k) >= _MIN_RANKS:
            ax = ModelAxis(mesh.size(k), mesh.get_local_rank(k),
                           mesh.get_group(k))
    prev, _AXIS = _AXIS, ax
    try:
        yield ax
    finally:
        _AXIS = prev


def model_axis() -> Optional[ModelAxis]:
    return _AXIS


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        x0 = x.movedim(dim, 0).contiguous()
        out = x0.new_empty((ax.size * x0.shape[0], *x0.shape[1:]))
        dist.all_gather_into_tensor(out, x0, group=ax.group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.ax.size
        return g.narrow(ctx.dim, ctx.ax.rank * n, n), None, None


def copy_to_model(x: torch.Tensor, ax: Optional[ModelAxis]):
    """``x`` itself; its gradient all-reduced over ``model`` (``x``
    itself when ``ax`` is None)."""
    return x if ax is None else _Copy.apply(x, ax.group)


def reduce_from_model(x: torch.Tensor, ax: Optional[ModelAxis]):
    """``x`` summed over ``model``; its gradient passed through (``x``
    itself when ``ax`` is None)."""
    return x if ax is None else _Reduce.apply(x, ax.group)


def gather_model(x: torch.Tensor, ax: ModelAxis, dim: int = -1):
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    serving logits' vocab slices); the gradient is this rank's piece."""
    return _GatherModel.apply(x, dim % x.ndim, ax)


def is_block(leaf, dim: int) -> bool:
    """True when ``leaf`` is a :class:`sharding.LocalShard` that
    ``model`` splits along ``dim`` only, as its major axis (an axis of
    one rank, which splits nothing, may stand before it): then
    :func:`block` gathers it over the other axes only."""
    if not isinstance(leaf, LocalShard):
        return False
    dim %= len(leaf.dims)
    names = leaf.mesh.mesh_dim_names
    axes = [a for a in leaf.dims[dim]
            if a == "model" or leaf.mesh.size(names.index(a)) > 1]
    return (axes[:1] == ["model"]
            and all("model" not in axes for i, axes in enumerate(leaf.dims)
                    if i != dim))


def block(leaf, dim: int, ax: ModelAxis) -> torch.Tensor:
    """This rank's block m of M along ``dim`` of ``leaf`` (a
    :class:`sharding.LocalShard` or a plain tensor, the whole leaf): by
    a gather over the other axes where ``model`` splits it so
    (:func:`is_block`), else the whole leaf cut, its gradient summed
    over ``model`` (:func:`copy_to_model`)."""
    if is_block(leaf, dim):
        return leaf.block()
    full = copy_to_model(gathered(leaf), ax)
    dim %= full.ndim
    n = full.shape[dim] // ax.size
    return full.narrow(dim, ax.rank * n, n)


def shared(leaf, ax: ModelAxis) -> torch.Tensor:
    """``leaf`` whole, for a use that each rank makes on its own heads
    only (qk-norm's scales): its gradient summed over ``model``."""
    return copy_to_model(gathered(leaf), ax)


# -- the vocabulary split over ``model`` ------------------------------------


def _vocab_local(ids: torch.Tensor, n: int, ax: ModelAxis):
    local = ids - ax.rank * n
    inside = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), inside


def vocab_embed(rows: torch.Tensor, tokens: torch.Tensor,
                ax: ModelAxis) -> torch.Tensor:
    """The embedding lookup from this rank's vocab rows ``rows`` (V/M,
    d): each rank looks up the tokens in its range, zeros elsewhere,
    summed over ``model`` (exactly the whole table's lookup)."""
    local, inside = _vocab_local(tokens, rows.shape[0], ax)
    x = rows[local]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return reduce_from_model(x, ax)


def vocab_logsumexp(logits: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """log Σ exp over the whole vocab of the logits whose slice (..., V/M)
    this rank holds: the max and the sum of exps all-reduced over
    ``model``."""
    m = logits.detach().amax(-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=ax.group)
    s = reduce_from_model(torch.exp(logits - m[..., None]).sum(-1), ax)
    return m + torch.log(s)


def vocab_pick(logits: torch.Tensor, ids: torch.Tensor,
               ax: ModelAxis) -> torch.Tensor:
    """The logit of each position's ``ids`` (labels, in range) from the
    vocab slices: the rank that holds it, summed over ``model``."""
    local, inside = _vocab_local(ids, logits.shape[-1], ax)
    v = torch.gather(logits, -1, local[..., None])[..., 0]
    return reduce_from_model(torch.where(inside, v, 0.0), ax)


def vocab_argmax(logits: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """The whole vocab's argmax from the slices, the first index among
    equal maxima (as ``argmax`` takes it)."""
    n = logits.shape[-1]
    mx, am = logits.detach().max(-1)
    top = mx.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=ax.group)
    cand = torch.where(mx == top, am + ax.rank * n, n * ax.size)
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=ax.group)
    return cand

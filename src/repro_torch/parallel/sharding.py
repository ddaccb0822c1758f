"""Sharding rules: logical param/batch/state layouts -> partition specs,
and specs -> DTensor placements (port of ``repro.parallel.sharding``).

Axis roles:
  pod    — data parallelism across pods (the slower inter-host axis)
  data   — data parallelism + FSDP/ZeRO param sharding
  model  — tensor/expert parallelism

A spec is a :class:`P`, a tuple with one entry per tensor dimension, as
the reference's ``PartitionSpec``: None (replicated), an axis name, or a
tuple of axis names. Rules are regexes over a leaf's key path (the
reference's ``keystr``, which ``repro_torch.tree.flatten`` yields);
unit-stacked params carry a leading (n_units,) dim that gets a None
prefix (detected by the ``['units']`` path component). The rule
functions take any mesh with axis names and sizes: a ``DeviceMesh``, or
``launch.mesh.AbstractMesh`` to compute specs without a process group.

:func:`make_shardings` turns each spec into DTensor placements on a
``DeviceMesh``: mesh dimension ``a`` gets ``Shard(i)`` when tensor dim i
names ``a``, else ``Replicate()``. A dim sharded over a tuple of axes is
split in the tuple's order, the first axis major, as JAX splits it: on
a (data, model) mesh, ("model", "data") gives rank (d, m) chunk
m * D + d, so the ranks of one ``model`` coordinate hold its contiguous
block m of M once gathered over ``data`` (whole heads, whole KV groups:
what tensor parallelism computes on). DTensor splits in mesh order, so
a tuple axis that comes earlier in the mesh than a more major one gets
``_StridedShard(i, split_factor=<the major axes' size>)``, DTensor's
placement for that right-to-left split; every function here reads it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch

PyTree = Any


class P(tuple):
    """A partition spec: ``P("model", None)``, ``P(None, ("model",
    "data"))``; ``P()`` for a scalar. A one-name tuple entry is that
    name, as ``PartitionSpec`` has it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _map_with_path(fn, tree, path: str = ""):
    """``fn(keystr path, leaf)`` over dicts, lists and NamedTuples (a
    field's path is ``.name``, as ``jax.tree_util.keystr`` writes it); a
    :class:`P` and anything else is a leaf, None stays None."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{path}[{i}]")
                for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, f"{path}.{f}")
                            for f, v in zip(tree._fields, tree)))
    return None if tree is None else fn(path, tree)


def _leaves_with_path(tree) -> list:
    out: list = []
    _map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def _sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of anything with
    ``axis_names`` and a ``shape`` mapping (the reference's meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_names(mesh) -> tuple:
    return tuple(_sizes(mesh))


# (regex over keystr path, spec WITHOUT the scan-unit prefix)
#
# Rule of thumb (the reference's): never shard a matmul CONTRACTION dim
# over 'data'. The batch is data-sharded, so a d-over-data weight makes
# the partitioner all-reduce activations over 'data' or replicate the
# batch. Weight dims sharded over 'data' must be non-contraction dims
# (ZeRO-style weight all-gather, bytes = params).
_PARAM_RULES: list[tuple[str, P]] = [
    (r"\['embed'\]$",               P("model", None)),     # vocab x d
    (r"\['lm_head'\]$",             P(None, "model")),
    (r"\['mask_embed'\]$",          P(None)),
    (r"\['attn'\]\['wq'\]$",        P(None, ("model", "data"))),
    (r"\['attn'\]\['wk'\]$",        P(None, ("model", "data"))),
    (r"\['attn'\]\['wv'\]$",        P(None, ("model", "data"))),
    (r"\['attn'\]\['wo'\]$",        P("model", "data")),
    (r"\['feat'\]\['w'\]$",         P(None, None, None)),  # (G, m, r) small
    (r"\['feat'\]\['m_mat'\]$",     P(None, None, None)),
    (r"\['(q_norm|k_norm)'\]\['scale'\]$", P(None)),
    # dense mlp
    (r"\['ffn'\]\['w_gate'\]$",     P(None, ("model", "data"))),
    (r"\['ffn'\]\['w_up'\]$",       P(None, ("model", "data"))),
    (r"\['ffn'\]\['w_out'\]$",      P("model", "data")),
    # moe (E, d, f) / (E, f, d): experts on model (EP), d_model on data
    (r"\['ffn'\]\['router'\]$",     P(None, None)),
    # rg-lru
    (r"\['rec'\]\['wx'\]$",         P(None, ("model", "data"))),
    (r"\['rec'\]\['wg'\]$",         P(None, ("model", "data"))),
    (r"\['rec'\]\['conv_w'\]$",     P(None, "model")),
    (r"\['rec'\]\['wa'\]$",         P("model", None)),
    (r"\['rec'\]\['wi'\]$",         P("model", None)),
    (r"\['rec'\]\['lam'\]$",        P("model")),
    (r"\['rec'\]\['wo'\]$",         P("model", "data")),
    # rwkv
    (r"\['tmix'\]\['w[rkvg]'\]$",   P(None, ("model", "data"))),
    (r"\['tmix'\]\['wo'\]$",        P("model", "data")),
    (r"\['tmix'\]\['decay_a'\]$",   P(None, None)),
    (r"\['tmix'\]\['decay_b'\]$",   P(None, "model")),
    (r"\['tmix'\]\['u'\]$",         P(None, None)),
    (r"\['tmix'\]\['mu'\]$",        P(None, None)),
    (r"\['tmix'\]\['lam_w'\]$",     P(None)),
    (r"\['tmix'\]\['ln_x'\]",       P(None)),
    (r"\['cmix'\]\['wk'\]$",        P(None, ("model", "data"))),
    (r"\['cmix'\]\['wv'\]$",        P("model", "data")),
    (r"\['cmix'\]\['wr'\]$",        P(None, ("model", "data"))),
    (r"\['cmix'\]\['mu'\]$",        P(None, None)),
    # norms / misc
    (r"\['scale'\]$",               P(None)),
    (r"\['bias'\]$",                P(None)),
]

_MOE_RULES: list[tuple[str, P]] = [
    (r"\['ffn'\]\['w_gate'\]$",     P("model", None, "data")),
    (r"\['ffn'\]\['w_up'\]$",       P("model", None, "data")),
    (r"\['ffn'\]\['w_out'\]$",      P("model", None, "data")),
]

# When num_experts does not divide the model axis (granite-moe's 40
# experts on a 16-way axis) the EP spec above is dropped by _divisible
# and expert compute would run replicated across 'model'. Fall back to
# sharding each expert's hidden dim over 'model' (TP inside each expert).
_MOE_RULES_TP: list[tuple[str, P]] = [
    (r"\['ffn'\]\['w_gate'\]$",     P(None, None, "model")),
    (r"\['ffn'\]\['w_up'\]$",       P(None, None, "model")),
    (r"\['ffn'\]\['w_out'\]$",      P(None, "model", None)),
]


def dp_axes(mesh) -> tuple:
    names = _axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _match(path_str: str, moe: bool, moe_tp: bool = False) -> Optional[P]:
    if moe:
        rules = _MOE_RULES_TP if moe_tp else _MOE_RULES
        for pat, spec in rules:
            if re.search(pat, path_str):
                return spec
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path_str):
            return spec
    return None


def _divisible(shape, spec: P, mesh) -> P:
    """Drop sharding on dims that do not divide evenly (small dims like
    MQA kv heads stay replicated)."""
    sizes = _sizes(mesh)
    new = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) -
                                                       len(spec))):
        if ax is None:
            new.append(None)
            continue
        size = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size *= sizes[a]
        new.append(ax if dim % size == 0 else None)
    return P(*new)


def param_specs(params: PyTree, mesh, moe: bool = False,
                preset: str = "2d", shard_features: bool = False,
                overrides: tuple = ()) -> PyTree:
    """A :class:`P` tree mirroring ``params`` (any leaves with a
    ``shape``: tensors, ``device="meta"`` tensors).

    preset:
      "2d"   — TP over 'model' + FSDP over 'data' (the rule table above).
      "fsdp" — no tensor parallelism: every >=2-D param sharded on its
               largest dim over the combined ('data', 'model') axes
               (ZeRO-3); the batch then spans both axes too.
    shard_features — shard the PRF feature dim m of the per-group
      projection W over 'model'.
    overrides — ((path regex, spec tuple), ...) tried before the rules
      (a config's ``sharding_overrides``).
    """
    flat = _leaves_with_path(params)
    sizes = _sizes(mesh)
    # detect EP-infeasible expert counts once (see _MOE_RULES_TP)
    moe_tp = False
    if moe:
        for ps, leaf in flat:
            if ps.endswith("['ffn']['w_gate']"):
                e_dim = leaf.shape[1 if "['units']" in ps else 0]
                moe_tp = e_dim % sizes["model"] != 0
                break

    def spec_of(ps, leaf):
        shape = tuple(leaf.shape)
        scanned = "['units']" in ps
        if preset == "fsdp":
            body = shape[1:] if scanned else shape
            if len(body) >= 2:
                big = max(range(len(body)), key=lambda i: body[i])
                t = [None] * len(body)
                t[big] = ("data", "model")
                spec = P(*t)
            else:
                spec = P(*([None] * len(body)))
            if scanned:
                spec = P(*((None,) + tuple(spec)))
            return _divisible(shape, spec, mesh)
        spec = None
        for pat, tspec in overrides:
            if re.search(pat, ps):
                spec = P(*tspec)
                break
        if spec is None:
            spec = _match(ps, moe, moe_tp)
        if shard_features and "['feat']" in ps:
            # (G, m, r) / (G, r, d): shard m (W's dim -2) over model
            spec = P(None, "model", None) if ps.endswith("['w']") else spec
        if spec is None:
            spec = P(*([None] * len(shape)))
        if scanned:
            spec = P(*((None,) + tuple(spec)))
        # pad/truncate to rank
        t = tuple(spec)[: len(shape)]
        t = t + (None,) * (len(shape) - len(t))
        return _divisible(shape, P(*t), mesh)
    return _map_with_path(spec_of, params)


def opt_state_specs(opt_state: PyTree, pspecs: PyTree, mesh) -> PyTree:
    """Optimizer-state specs mirror the param specs (mu/nu shadow the
    params; the factored nu's row and col inherit the reduced spec; the
    count is replicated)."""
    pflat = dict(_leaves_with_path(pspecs))

    def spec_of(ps, leaf):
        if ps.endswith("['count']"):
            return P()
        # strip the leading ['mu'] / ['nu'] component and factored suffix
        inner = ps.split("]", 1)[1]
        suffix = None
        if inner.endswith("['row']") or inner.endswith("['col']"):
            suffix = inner[-6:-2]
            inner = inner[: -len("['row']")]
        base = pflat.get(inner)
        if base is None:
            return P(*([None] * leaf.ndim))
        t = tuple(base)
        if suffix == "row":            # param shape minus last dim
            t = t[:-1]
        elif suffix == "col":          # minus second-to-last dim
            t = t[:-2] + t[-1:]
        t = t[: leaf.ndim] + (None,) * max(0, leaf.ndim - len(t))
        return _divisible(tuple(leaf.shape), P(*t), mesh)
    return _map_with_path(spec_of, opt_state)


def batch_specs(batch: PyTree, mesh, preset: str = "2d") -> PyTree:
    """Shard the leading batch dim over the DP axes (replicate if it does
    not divide). Under the "fsdp" preset the batch spans ('data',
    'model') too. Leaves: tensors or numpy arrays."""
    dp = dp_axes(mesh)
    if preset == "fsdp":
        dp = dp + ("model",)
    sizes = _sizes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]

    def spec(_, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        if shape[0] % dp_size == 0 and shape[0] > 0:
            return P(dp, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))
    return _map_with_path(spec, batch)


def serve_state_specs(state: PyTree, mesh) -> PyTree:
    """Serving state: batch on the DP axes where divisible; the KV-cache
    head-group dim additionally on 'model' where divisible. Paths follow
    ``jax.tree_util.keystr``, a NamedTuple state's fields as ``.name``,
    so the rules read as the reference's."""
    dp = dp_axes(mesh)
    sizes = _sizes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    msize = sizes.get("model", 1)

    def spec(ps, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        # stacked leading layer dim ('units' per-unit stacks, 'layers'
        # the layer-stacked homogeneous layout)
        off = 1 if ("['units']" in ps or "['layers']" in ps) else 0
        axes: list = [None] * len(shape)
        if len(shape) > off and shape[off] % dp_size == 0:
            axes[off] = dp
        # group/head dim right after batch for kv caches & linear states
        if len(shape) > off + 1 and shape[off + 1] % msize == 0 and \
                any(t in ps for t in ("kv_k", "kv_v", "'s'", "'z'", "'c'")):
            axes[off + 1] = "model"
        return P(*axes)
    return _map_with_path(spec, state)


def local_batch(batch: dict, mesh) -> dict:
    """This rank's shard of ``batch`` (the whole batch, equal on every
    rank: tensors or numpy arrays) by :func:`batch_specs` ("2d"): along dim 0
    the chunk at this rank's coordinate over the DP axes (row-major in
    the spec's axis order); a leaf the spec replicates whole."""
    sizes = _sizes(mesh)
    names = list(mesh.mesh_dim_names)

    def shard(_, x, spec):
        if not spec or spec[0] is None:
            return x
        idx, n = 0, 1
        for a in (spec[0] if isinstance(spec[0], tuple) else (spec[0],)):
            idx = idx * sizes[a] + mesh.get_local_rank(names.index(a))
            n *= sizes[a]
        rows = x.shape[0] // n
        return x[idx * rows:(idx + 1) * rows]
    specs = dict(_leaves_with_path(batch_specs(batch, mesh)))
    return _map_with_path(lambda p, x: shard(p, x, specs[p]), batch)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``, as the reference's ``NamedSharding``;
    ``placements`` are its DTensor placements (module docstring)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(self.mesh.mesh_dim_names)
        sizes = _sizes(self.mesh)
        out = []
        for a in names:
            dims = [i for i, ax in enumerate(self.spec)
                    if ax == a or (isinstance(ax, tuple) and a in ax)]
            if not dims:
                out.append(Replicate())
                continue
            ax = self.spec[dims[0]]
            # the tuple's axes more major than a that DTensor splits after
            # it (later in the mesh): a's split is strided by their size
            major = ax[:ax.index(a)] if isinstance(ax, tuple) else ()
            sf = 1
            for b in major:
                if names.index(b) > names.index(a):
                    sf *= sizes[b]
            out.append(Shard(dims[0]) if sf == 1
                       else _strided(dims[0], sf))
        return tuple(out)


def _strided(dim: int, split_factor: int):
    from torch.distributed.tensor.placement_types import _StridedShard
    return _StridedShard(dim, split_factor=split_factor)


def _shard_dim(pl) -> Optional[int]:
    """The tensor dim a placement splits (``Shard`` or ``_StridedShard``,
    which some torch versions do not count as ``is_shard()``), else
    None."""
    if pl.is_shard() or type(pl).__name__ == "_StridedShard":
        return pl.dim
    return None


def placement_dims(mesh, placements, ndim: int) -> tuple:
    """Per tensor dim, the mesh axes that split it, major first: mesh
    order, except that a strided split (``_StridedShard``) is minor to
    the later axes that split the same dim."""
    names = mesh.mesh_dim_names
    dims: list = [[] for _ in range(ndim)]
    for k, pl in enumerate(placements):
        i = _shard_dim(pl)
        if i is not None:           # a strided split sorts after the rest
            dims[i].append((getattr(pl, "split_factor", 1) > 1, k))
    return tuple(tuple(names[k] for _, k in sorted(d)) for d in dims)


def make_shardings(specs: PyTree, mesh) -> PyTree:
    """A :class:`NamedSharding` tree mirroring ``specs``."""
    return _map_with_path(lambda _, s: NamedSharding(mesh, s), specs)


def local_slice(t: torch.Tensor, mesh, placements,
                axes: Optional[tuple] = None) -> torch.Tensor:
    """This rank's slice of ``t`` (the full value) under ``placements``:
    along each split dim, the chunk at this rank's coordinates over the
    axes that split it, major first (:func:`placement_dims`; the rule
    tables drop a split that does not divide). With ``axes``, ``t`` is
    cut along those mesh axes only (its other splits already taken). A
    view of ``t``."""
    names = mesh.mesh_dim_names
    for i, order in enumerate(placement_dims(mesh, placements, t.ndim)):
        for a in order:                     # major first
            if axes is not None and a not in axes:
                continue
            k = names.index(a)
            n, r = mesh.size(k), mesh.get_local_rank(k)
            size = t.shape[i] // n
            t = t.narrow(i, r * size, size)
    return t


def place(t: torch.Tensor, mesh, placements):
    """``t`` (the full value, equal on every rank, on any device) as a
    DTensor on ``mesh`` with ``placements``: each rank slices its own
    shard where ``t`` lies and moves only that to the mesh's device,
    with no communication. The shard never aliases a larger ``t``, so
    dropping ``t`` frees it."""
    from torch.distributed.tensor import DTensor
    local = local_slice(t, mesh, placements).to(mesh.device_type)
    local = local.contiguous()
    if local.numel() < t.numel() and (local.untyped_storage().data_ptr()
                                      == t.untyped_storage().data_ptr()):
        local = local.clone()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def zeros_placed(tree: PyTree, shardings: PyTree) -> PyTree:
    """Zeros shaped and typed as ``tree``'s leaves (anything with
    ``shape`` and ``dtype``: ``meta`` tensors) as DTensors placed by
    the mirroring :class:`NamedSharding` tree: each rank allocates its
    shard alone."""
    from torch.distributed.tensor import DTensor
    flat = dict(_leaves_with_path(shardings))

    def zeros(p, t):
        sh = flat[p]
        shape = list(t.shape)
        for k, pl in enumerate(sh.placements):
            if _shard_dim(pl) is not None:
                shape[pl.dim] //= sh.mesh.size(k)
        local = torch.zeros(shape, dtype=t.dtype,
                            device=sh.mesh.device_type)
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False, shape=t.shape,
                                  stride=_contiguous_stride(t.shape))
    return _map_with_path(zeros, tree)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def place_tree(tree: PyTree, shardings: PyTree) -> PyTree:
    """:func:`place` over a tree and its mirroring
    :class:`NamedSharding` tree."""
    flat = dict(_leaves_with_path(shardings))
    return _map_with_path(
        lambda p, t: place(t, flat[p].mesh, flat[p].placements), tree)


def full_tensors(tree: PyTree) -> PyTree:
    """``tree`` with each DTensor leaf gathered whole (``full_tensor()``,
    a collective every rank of its mesh makes) and every other leaf as
    it is."""
    from torch.distributed.tensor import DTensor
    return _map_with_path(
        lambda _, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def constrain_batch_axis(x: torch.Tensor, mesh):
    """``x`` as a DTensor with its leading batch dim sharded over the DP
    axes and replicated elsewhere (the reference's sharding constraint at
    block boundaries): a DTensor is redistributed, a plain tensor (equal
    on every rank) placed."""
    from torch.distributed.tensor import DTensor
    sh = NamedSharding(mesh, P(dp_axes(mesh), *([None] * (x.ndim - 1))))
    if isinstance(x, DTensor):
        return x.redistribute(mesh, sh.placements)
    return place(x, mesh, sh.placements)


# -- ZeRO-3 execution: each leaf gathered just in time, its gradient
# reduce-scattered back to the shard ---------------------------------------


def shard_dims(t: torch.Tensor) -> tuple:
    """Per dim of ``t``, the mesh axes that split it, major first (the
    spec's tuple order: :func:`placement_dims`): () for every dim of a
    plain tensor or a replicated DTensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return placement_dims(t.device_mesh, t.placements, t.ndim)
    return ((),) * t.ndim


class GatherGauge:
    """What :class:`LocalShard` gathers: ``gathers`` (all-gathered leaves,
    one collective per sharded axis each), ``over_model`` (those of them
    gathered over a ``model`` axis of more than one rank too: whole
    leaves that tensor parallelism would split), ``live`` (bytes of gathered tensors still
    alive: a ``weakref.finalize`` on each takes its bytes off when
    autograd and the model have dropped it) and ``peak`` (the most
    ``live`` held since :meth:`reset`)."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self.live = self.peak = self.gathers = self.over_model = 0

    def reset(self) -> None:
        with self._lock:
            self.peak, self.gathers, self.over_model = self.live, 0, 0

    def _alloc(self, nbytes: int, over_model: bool = False) -> None:
        with self._lock:
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            self.gathers += 1
            self.over_model += over_model

    def _free(self, nbytes: int) -> None:
        with self._lock:
            self.live -= nbytes


GAUGE = GatherGauge()


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """``x``'s pieces on the ``n`` ranks of ``group`` concatenated along
    ``dim`` in rank order."""
    import torch.distributed as dist
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((n * x0.shape[0], *x0.shape[1:]))
    dist.all_gather_into_tensor(out, x0, group=group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _reduce_scatter(g: torch.Tensor, dim: int, group, n: int
                    ) -> torch.Tensor:
    """This rank's piece along ``dim`` of the sum of ``g`` over the ``n``
    ranks of ``group``."""
    import torch.distributed as dist
    g0 = g.movedim(dim, 0).contiguous()
    out = g0.new_empty((g0.shape[0] // n, *g0.shape[1:]))
    dist.reduce_scatter(out, list(g0.chunk(n)), group=group)
    return out if dim == 0 else out.movedim(0, dim)


def _gather_dims(local: torch.Tensor, mesh, dims: tuple,
                 skip: tuple = ()) -> torch.Tensor:
    """``local`` (a shard split as ``dims``: per tensor dim its axes,
    major first) gathered along every split dim over its axes, minor
    axis first, except the axes in ``skip``, which stay split: a skipped
    major axis leaves this rank's contiguous block of it."""
    names = mesh.mesh_dim_names
    full = local
    for i, axes in enumerate(dims):
        for a in reversed(axes):
            if a in skip:
                continue
            full = _all_gather(full, i, mesh.get_group(a),
                               mesh.size(names.index(a)))
    return full


def grad_to_shard(g: torch.Tensor, shard: "LocalShard",
                  skip: tuple = ()) -> torch.Tensor:
    """The backward of :class:`LocalShard`'s gather: ``g``, the gradient
    of the gathered tensor on this rank (its loss already weighted by the
    rank's share of the batch), brought to this rank's shard and averaged
    over the DP axes, as ``compressed_psum_mean(..., "none")`` averages a
    whole gradient. Along a dim, the DP axes that split it reduce-scatter
    and a ``model`` axis takes this rank's piece with no reduction (the
    ranks of one ``model`` group hold the same gradient of a leaf they
    gather whole: the model sums partial uses over ``model`` itself,
    ``parallel.tensor_parallel.copy_to_model``); an axis in ``skip`` was
    not gathered, so ``g`` is already its piece; a DP axis that splits
    no dim all-reduces the shard."""
    import torch.distributed as dist
    mesh, names = shard.mesh, shard.mesh.mesh_dim_names
    dp = dp_axes(mesh)
    incoming = g
    for i, axes in enumerate(shard.dims):
        for a in axes:                      # outer axis first
            if a in skip:
                continue
            k = names.index(a)
            n, r = mesh.size(k), mesh.get_local_rank(k)
            if a in dp:
                g = _reduce_scatter(g, i, mesh.get_group(a), n)
            else:
                g = g.narrow(i, r * (g.shape[i] // n), g.shape[i] // n)
    used = {a for axes in shard.dims for a in axes}
    rest = [a for a in dp if a not in used]
    if rest:        # reduced in place: never into autograd's own buffer
        g = (g.clone(memory_format=torch.contiguous_format)
             if g.untyped_storage().data_ptr()
             == incoming.untyped_storage().data_ptr() else g.contiguous())
        for a in rest:
            dist.all_reduce(g, group=mesh.get_group(a))
    n_dp = 1
    for a in dp:
        n_dp *= mesh.size(names.index(a))
    return (g / n_dp).contiguous()


class _Gather(torch.autograd.Function):
    """The leaf from this rank's shard, gathered over every axis that
    splits it but those in ``skip`` (:func:`_gather_dims`); backward is
    :func:`grad_to_shard`."""

    @staticmethod
    def forward(ctx, local, shard, skip):
        import weakref
        ctx.shard, ctx.skip = shard, skip
        if all(a in skip for axes in shard.dims for a in axes):
            return local.view_as(local)     # nothing to gather
        full = _gather_dims(local, shard.mesh, shard.dims, skip)
        nbytes = full.numel() * full.element_size()
        names = shard.mesh.mesh_dim_names
        GAUGE._alloc(nbytes, "model" not in skip and any(
            "model" in axes for axes in shard.dims)
            and shard.mesh.size(names.index("model")) > 1)
        weakref.finalize(full, GAUGE._free, nbytes)
        return full

    @staticmethod
    def backward(ctx, g):
        g = (grad_to_shard(g, ctx.shard, ctx.skip) if ctx.skip
             else grad_to_shard(g, ctx.shard))
        return g, None, None


class LocalShard:
    """This rank's shard of one leaf inside a sharded step, handed to
    the model in the leaf's place: ``local`` (a plain tensor, the step's
    differentiable input), ``mesh`` and ``dims`` (per dim, the axes that
    split it, major first: :func:`shard_dims`). :meth:`full` gathers the
    whole leaf where the model uses it, :meth:`block` only over the
    axes other than ``model`` (tensor parallelism's share), and a
    gather's backward reduce-scatters the gradient to ``local``.
    ``shard[u]`` is unit u of a stacked ``(n_units, ...)`` leaf, whose
    unit dim no rule splits."""

    def __init__(self, local: torch.Tensor, mesh, dims: tuple):
        self.local, self.mesh, self.dims = local, mesh, dims

    def __getitem__(self, u: int) -> "LocalShard":
        if self.dims[0]:
            raise ValueError(f"the leading dim is split over {self.dims[0]}"
                             f": a unit slice would not be one unit")
        return LocalShard(self.local[u], self.mesh, self.dims[1:])

    def full(self) -> torch.Tensor:
        return _Gather.apply(self.local, self, ())

    def block(self) -> torch.Tensor:
        """The leaf gathered over every axis but ``model``: along the dim
        that ``model`` splits major, this rank's contiguous block m of
        M (no communication when only ``model`` splits the leaf; its
        gradient is still averaged over the DP axes)."""
        return _Gather.apply(self.local, self, ("model",))


def gathered(tree: PyTree) -> PyTree:
    """``tree`` with each :class:`LocalShard` leaf gathered whole
    (:meth:`LocalShard.full`, a collective every rank of its mesh makes)
    and every other leaf as it is: without a mesh, the tree itself."""
    if isinstance(tree, LocalShard):
        return tree.full()
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gathered(v) for v in tree]
    return tree


def local_shards(tree: PyTree) -> PyTree:
    """``tree`` (DTensor leaves, or plain) with each DTensor that some
    placement splits as a :class:`LocalShard` of its local tensor and
    every other DTensor as its local tensor: what a sharded step hands
    the model."""
    from torch.distributed.tensor import DTensor

    def conv(_, t):
        if not isinstance(t, DTensor):
            return t
        dims = shard_dims(t)
        return (LocalShard(t.to_local(), t.device_mesh, dims)
                if any(dims) else t.to_local())
    return _map_with_path(conv, tree)


# -- values local over ``model``: each rank's own KV groups ---------------


def dp_local(tree: PyTree) -> PyTree:
    """``tree`` with each DTensor leaf gathered over the DP axes of its
    mesh only: a plain tensor whole along the dims those axes split and
    still this rank's piece along a dim ``model`` splits. Plain leaves
    as they are. A collective every rank of the mesh makes."""
    from torch.distributed.tensor import DTensor

    def conv(_, t):
        if not isinstance(t, DTensor):
            return t
        mesh = t.device_mesh
        keep = tuple(a for a in mesh.mesh_dim_names
                     if a not in dp_axes(mesh))
        return _gather_dims(t.to_local(), mesh, shard_dims(t), keep)
    return _map_with_path(conv, tree)


def place_dp_local(tree: PyTree, shardings: PyTree) -> PyTree:
    """The inverse of :func:`dp_local`: each leaf of ``tree`` (whole
    over the DP axes, already this rank's piece over the others) as a
    DTensor placed by the mirroring :class:`NamedSharding` tree, each
    rank cutting only along the DP axes; no communication."""
    from torch.distributed.tensor import DTensor
    flat = dict(_leaves_with_path(shardings))

    def conv(p, t):
        sh = flat[p]
        mesh, pl = sh.mesh, sh.placements
        dp = dp_axes(mesh)
        shape = list(t.shape)
        for i, axes in enumerate(placement_dims(mesh, pl, t.ndim)):
            for a in axes:
                if a not in dp:
                    shape[i] *= mesh.size(mesh.mesh_dim_names.index(a))
        local = local_slice(t, mesh, pl, axes=dp).contiguous()
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))
    return _map_with_path(conv, tree)


def model_local(tree: PyTree, shardings: PyTree) -> PyTree:
    """Each leaf of ``tree`` (the full value) cut to this rank's piece
    along the ``model`` axis only, by the mirroring
    :class:`NamedSharding` tree: what :func:`dp_local` gives of it once
    placed."""
    flat = dict(_leaves_with_path(shardings))

    def cut(p, t):
        sh = flat[p]
        keep = tuple(a for a in sh.mesh.mesh_dim_names
                     if a not in dp_axes(sh.mesh))
        return local_slice(t, sh.mesh, sh.placements, axes=keep).clone()
    return _map_with_path(cut, tree)

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
names ``a``, else ``Replicate()``. A dim sharded over a tuple of axes,
e.g. ("model", "data"), gets ``Shard(i)`` on both mesh dims; DTensor
splits such a dim in mesh order (data-major on a (data, model) mesh)
where JAX splits it in the tuple's order (model-major), so a rank holds
another slice than its JAX counterpart. Values are unaffected: every
checkpoint holds full arrays.
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
        out = []
        for a in self.mesh.mesh_dim_names:
            dims = [i for i, ax in enumerate(self.spec)
                    if ax == a or (isinstance(ax, tuple) and a in ax)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def make_shardings(specs: PyTree, mesh) -> PyTree:
    """A :class:`NamedSharding` tree mirroring ``specs``."""
    return _map_with_path(lambda _, s: NamedSharding(mesh, s), specs)


def place(t: torch.Tensor, mesh, placements):
    """``t`` (the full value, equal on every rank) as a DTensor on
    ``mesh`` with ``placements``: each rank keeps its own slice, with no
    communication (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.to(mesh.device_type), mesh, placements,
                             src_data_rank=None)


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

"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro.optim.adamw``, functional like it: the update returns
new trees and leaves its inputs alone. Moments are f32 whatever the param
dtype; the update is computed in f32 and cast back.
``factored_second_moment`` keeps Adafactor-style row and column factors
of v for matrices.

On a mesh (``mesh=``, ``dims=``: a sharded train step's local shards,
``launch.steps.make_sharded_train_step``) the update runs on each
rank's shards as it is, elementwise; its two reductions are made
global. The clip norm all-reduces the local sums of squares over every
mesh axis, each element counted once (a leaf replicated over an axis
contributes from that axis's first coordinate), and the factored ν's
row and column means all-reduce over the axes that split the dim they
average. Without a mesh it is the reference's update.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import flatten, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    factored_second_moment: bool = False


def _owns(dims: tuple, mesh) -> bool:
    """True on the one coordinate of each axis that replicates the leaf
    whose dims ``dims`` (``parallel.sharding.shard_dims``) are split."""
    used = {a for axes in dims for a in axes}
    return all(mesh.get_local_rank(k) == 0
               for k, a in enumerate(mesh.mesh_dim_names) if a not in used)


def global_norm(tree, mesh=None, dims=None) -> torch.Tensor:
    """The L2 norm over every leaf; on a mesh, of the whole leaves of
    which ``tree`` holds this rank's shards (``dims`` a tree mirroring
    it of :func:`parallel.sharding.shard_dims` tuples)."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(x.float().square())
                              for _, x in flatten(tree)))
    import torch.distributed as dist
    leaves = flatten(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0][1].device)
    for (_, x), (_, d) in zip(leaves, flatten(dims)):
        if _owns(d, mesh):
            total = total + torch.sum(x.float().square())
    for a in mesh.mesh_dim_names:
        dist.all_reduce(total, group=mesh.get_group(a))
    return torch.sqrt(total)


def _mean(x: torch.Tensor, dim: int, axes: tuple, mesh) -> torch.Tensor:
    """``x.mean(dim)`` of the whole tensor whose dim ``dim`` ``axes``
    split evenly (the rule tables drop an uneven split): the local
    means, summed over those axes and divided by their size."""
    m = x.mean(dim)
    if axes:
        import torch.distributed as dist
        names = mesh.mesh_dim_names
        for a in axes:
            dist.all_reduce(m, group=mesh.get_group(a))
        m = m / math.prod(mesh.size(names.index(a)) for a in axes)
    return m


def clip_by_global_norm(tree, max_norm: float, mesh=None, dims=None):
    norm = global_norm(tree, mesh, dims)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    def v_init(p):
        if cfg.factored_second_moment and _factored(p.shape):
            return {"row": _zeros(p.shape[:-1], p),
                    "col": _zeros(p.shape[:-2] + p.shape[-1:], p)}
        return _zeros(p.shape, p)
    device = flatten(params)[0][1].device
    return {"mu": tree_map(lambda p: _zeros(p.shape, p), params),
            "nu": tree_map(v_init, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _upd_factored_nu(nu, g, b2, dims=None, mesh=None):
    g2 = g.float().square() + 1e-30
    if isinstance(nu, dict):
        d = dims or ((),) * g.ndim
        return {"row": b2 * nu["row"] + (1 - b2) * _mean(g2, -1, d[-1],
                                                         mesh),
                "col": b2 * nu["col"] + (1 - b2) * _mean(g2, -2, d[-2],
                                                         mesh)}
    return b2 * nu + (1 - b2) * g2


def _nu_to_v(nu, dims=None, mesh=None):
    if isinstance(nu, dict):
        d = dims or ((),) * (nu["row"].ndim + 1)
        denom = _mean(nu["row"], -1, d[-2], mesh)[..., None, None] + 1e-30
        return nu["row"][..., :, None] * nu["col"][..., None, :] / denom
    return nu


def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr, *,
                 mesh=None, dims=None):
    """One step. Returns (new_params, new_state, metrics {grad_norm,
    lr}). On ``mesh`` every tree holds this rank's shards and ``dims``
    mirrors ``params`` with each leaf's
    :func:`parallel.sharding.shard_dims` (module docstring)."""
    if dims is None:
        dims = tree_map(lambda p: None, params)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, mesh,
                                       None if mesh is None else dims)
    count = state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()
    new_mu = tree_map(lambda g, mu: cfg.b1 * mu + (1.0 - cfg.b1) * g.float(),
                      grads, state["mu"])
    if cfg.factored_second_moment:
        new_nu = tree_map(lambda g, nu, d: _upd_factored_nu(
            nu, g, cfg.b2, d, mesh), grads, state["nu"], dims)
    else:
        new_nu = tree_map(lambda g, nu: cfg.b2 * nu + (1 - cfg.b2)
                          * g.float().square(), grads, state["nu"])

    def upd_p(p, mu, nu, d):
        step = (mu / c1) / (torch.sqrt(_nu_to_v(nu, d, mesh) / c2)
                            + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = tree_map(upd_p, params, new_mu, new_nu, dims)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    return (new_params, {"mu": new_mu, "nu": new_nu, "count": count},
            {"grad_norm": gnorm, "lr": lr})

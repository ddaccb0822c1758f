"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro.optim.adamw``, functional like it: the update returns
new trees and leaves its inputs alone. Moments are f32 whatever the param
dtype; the update is computed in f32 and cast back.
``factored_second_moment`` keeps Adafactor-style row and column factors
of v for matrices.
"""
from __future__ import annotations

import dataclasses

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


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float().square())
                          for _, x in flatten(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
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


def _upd_factored_nu(nu, g, b2):
    g2 = g.float().square() + 1e-30
    if isinstance(nu, dict):
        return {"row": b2 * nu["row"] + (1 - b2) * g2.mean(-1),
                "col": b2 * nu["col"] + (1 - b2) * g2.mean(-2)}
    return b2 * nu + (1 - b2) * g2


def _nu_to_v(nu):
    if isinstance(nu, dict):
        denom = nu["row"].mean(-1)[..., None, None] + 1e-30
        return nu["row"][..., :, None] * nu["col"][..., None, :] / denom
    return nu


def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr):
    """One step. Returns (new_params, new_state, metrics {grad_norm,
    lr})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    count = state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()
    new_mu = tree_map(lambda g, mu: cfg.b1 * mu + (1.0 - cfg.b1) * g.float(),
                      grads, state["mu"])
    if cfg.factored_second_moment:
        new_nu = tree_map(lambda g, nu: _upd_factored_nu(nu, g, cfg.b2), grads,
                          state["nu"])
    else:
        new_nu = tree_map(lambda g, nu: cfg.b2 * nu + (1 - cfg.b2)
                          * g.float().square(), grads, state["nu"])

    def upd_p(p, mu, nu):
        step = (mu / c1) / (torch.sqrt(_nu_to_v(nu) / c2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = tree_map(upd_p, params, new_mu, new_nu)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    return (new_params, {"mu": new_mu, "nu": new_nu, "count": count},
            {"grad_norm": gnorm, "lr": lr})

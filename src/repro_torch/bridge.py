"""Bring the reference package's params and optimizer state across to the
port.

The caller converts the reference param pytree to numpy (e.g.
``jax.tree_util.tree_map(np.asarray, params)``); this module never sees
JAX. The tree layouts are the same, so the conversion is leaf for leaf:
``units.b0`` leaves keep their leading (n_units,) axis, and for the
one-block pattern the port serves unit u is layer u. The feature draws
(``feat.w`` and ``feat.m_mat``) come across with everything else, and
the AdamW state (``mu``, ``nu`` with its factored {"row", "col"} leaves,
``count``) maps the same way, so a train step can start in both packages
from one shared state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.tree import tree_map


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: reinterpret
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                 # ships with the reference's stack
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_from_jax(tree_of_numpy: dict, device="cuda") -> dict:
    """Any nested-dict tree of numpy leaves (e.g. the reference's AdamW
    state ``{"mu", "nu", "count"}``), leaf for leaf, as tensors."""
    return tree_map(lambda a: _to_torch(a, device), tree_of_numpy)


def params_from_jax(tree_of_numpy: dict, cfg: lm.ModelConfig,
                    device="cuda") -> dict:
    """The port's params from the reference's param tree (as numpy).
    Refuses layouts the port does not serve yet (remainder layers)."""
    if "rem" in tree_of_numpy:
        raise NotImplementedError(
            "remainder (unscanned) layers are not ported yet "
            "(ROADMAP.md Queue A, item A4)")
    lm._check_servable(cfg)
    return tree_from_jax(tree_of_numpy, device)


def params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`params_from_jax`: every leaf as a numpy array."""
    return tree_map(_to_numpy, params)

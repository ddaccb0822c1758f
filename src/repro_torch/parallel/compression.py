"""Gradient compression for the data-parallel reduction (bf16 / int8 with
error feedback; port of ``repro.parallel.compression``).

Compressing the payload 2x (bf16) or 4x (int8) scales the collective
term of a cross-host gradient all-reduce. int8 uses per-tensor max-abs
scaling with an error-feedback accumulator (Seide et al.; Karimireddy et
al. 2019), so the quantisation noise is compensated in the next step
instead of biasing the update. The arithmetic is the reference's; as
there, the reduction itself sums the dequantised values in f32.

Usage, on every rank of ``mesh``, with plain local tensors:
    grads, eb = compressed_psum_mean(grads, ("pod", "data"), method, eb,
                                     mesh=mesh)
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.tree import flatten, map_with_path, tree_map

PyTree = Any


def init_error_feedback(grads: PyTree) -> PyTree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _axes(axis_names) -> tuple:
    return axis_names if isinstance(axis_names, tuple) else (axis_names,)


def _psum_mean(x: torch.Tensor, axis_names, mesh) -> torch.Tensor:
    """Mean of ``x`` over the ranks spanned by ``axis_names`` of ``mesh``:
    one all-reduce (sum) over each axis's sub-group, then / their size."""
    y = x.clone()
    n = 1
    for a in _axes(axis_names):
        dist.all_reduce(y, group=mesh.get_group(a))
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return y / n


def compressed_psum_mean(grads: PyTree, axis_names, method: str = "none",
                         error_feedback: Optional[PyTree] = None, *,
                         mesh) -> tuple[PyTree, Optional[PyTree]]:
    """Mean all-reduce of ``grads`` (a tree of plain tensors, the rank's
    own) over the sub-groups of ``mesh`` along ``axis_names``, with
    optional compression.

    method: none | bf16 | int8. Returns (grads, new_error_feedback);
    every rank of ``mesh`` must call it, with the same tree structure.
    """
    if method == "none":
        return tree_map(lambda g: _psum_mean(g, axis_names, mesh),
                        grads), error_feedback

    if method == "bf16":
        def red(g):
            return _psum_mean(g.to(torch.bfloat16).float(), axis_names,
                              mesh).to(g.dtype)
        return tree_map(red, grads), error_feedback

    if method == "int8":
        if error_feedback is None:
            raise ValueError("int8 compression needs error feedback")
        eb = dict(flatten(error_feedback))
        new_eb: dict = {}

        def red(path, g):
            gf = g.float() + eb[path]
            scale = gf.abs().max() / 127.0 + 1e-12
            q = torch.clamp(torch.round(gf / scale), -127, 127)
            deq = q * scale
            new_eb[path] = gf - deq                   # local residual
            return _psum_mean(deq, axis_names, mesh).to(g.dtype)
        out = map_with_path(red, grads)
        return out, map_with_path(lambda p, _: new_eb[p], error_feedback)

    raise ValueError(f"unknown compression method {method!r}")

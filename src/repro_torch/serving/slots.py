"""Slot-layout module: row surgery on the engine's serve-state pools.

A pool is ``lm.init_serve_state(cfg, b=max_slots, per_slot=True)``: slot
i is batch row i of every leaf. ``state["layers"]`` leaves carry a
leading layer axis, so their slot axis is 1; ``state["pos"]`` has it at
0. Every engine mutation reduces to the primitives here. The scatters
write into the pool tensors in place; the gathers return copies.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.attention import AttnServeState


def tree_slot_map(fn, pool: dict, *others: dict) -> dict:
    """Map ``fn(pool_leaf, *other_leaves, axis=slot_axis)`` over serve
    states of the stacked layout."""
    layers = AttnServeState(*(
        fn(p, *o, axis=1)
        for p, *o in zip(pool["layers"], *[t["layers"] for t in others])))
    return {"layers": layers,
            "pos": fn(pool["pos"], *[t["pos"] for t in others], axis=0)}


def read_slots(pool: dict, idx: torch.Tensor) -> dict:
    """Gather slots ``idx`` ((P,) int) as a P-row serve state (a copy,
    slot axis kept, so it round-trips through write_slots)."""
    return tree_slot_map(lambda p, axis: p.index_select(axis, idx), pool)


def write_slots(pool: dict, new: dict, idx: torch.Tensor) -> dict:
    """Scatter a P-row serve state into slots ``idx`` of ``pool``, in
    place. Returns ``pool``."""
    def _write(p, n, axis):
        p.index_copy_(axis, idx, n.to(p.dtype))
    tree_slot_map(_write, pool, new)
    return pool


def fork_slots(pool: dict, row: dict, idx: torch.Tensor) -> dict:
    """Broadcast a ONE-row serve state into slots ``idx`` (the admission
    seed from the engine's fresh-row template), in place."""
    k = idx.shape[0]
    rows = tree_slot_map(
        lambda p, axis: p.repeat_interleave(k, dim=axis), row)
    return write_slots(pool, rows, idx)


def merge_slots(dst: dict, src: dict, idx: torch.Tensor) -> dict:
    """Copy rows ``idx`` of ``src`` into the same rows of ``dst`` (the
    commit of finished staging rows into the slot pool), in place."""
    def _merge(d, s, axis):
        d.index_copy_(axis, idx, s.index_select(axis, idx).to(d.dtype))
    tree_slot_map(_merge, dst, src)
    return dst


def freeze_inactive(pool: dict, active: np.ndarray,
                    advance: Callable[[dict], tuple]):
    """Advance only the active slots of ``pool``; inactive rows stay
    bit-frozen, ``pos`` included.

    ``advance(state)`` steps a per-slot state in place and returns
    (out, state) with ``out`` batched along dim 0. When every slot is
    active the pool itself is advanced; otherwise the active rows are
    gathered, advanced and scattered back (the in-place kernels leave no
    old copy to select inactive rows from afterwards). Returns the rows
    of ``out`` of the active slots, in slot order.
    """
    if active.all():
        out, _ = advance(pool)
        return out
    dev = pool["pos"].device
    idx = torch.as_tensor(np.nonzero(active)[0], device=dev)
    sub = read_slots(pool, idx)
    out, sub = advance(sub)
    write_slots(pool, sub, idx)
    return out

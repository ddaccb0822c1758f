"""Slot-layout module: row surgery on the engine's serve-state pools.

A pool is ``lm.init_serve_state(cfg, b=max_slots, per_slot=True)``, or
``lm.init_paged_serve_state`` for the exact kind over paged KV: slot i
is batch row i of every leaf. In the stacked layout ``state["layers"]``
leaves carry a leading layer axis, so their slot axis is 1 (the exact
cache's ``length`` and the paged state's ``table`` and ``length`` too);
in the unit/rem layout ``state["units"]`` leaves carry a leading unit
axis, so theirs is 1 too, while each ``state["rem"]`` block's leaves
have it at 0, as ``state["pos"]`` has. The paged layout's page pools carry no
slot axis and are not part of the tree, so every primitive here moves
page IDS, never pages. Every engine mutation reduces to the primitives
here. The scatters
write into the pool tensors in place; the gathers return copies. None
of them waits for the device: row indices arrive as device tensors.

``PackBuffer`` is the host side: the double-buffered token staging the
overlapped engine packs the next prefill chunk into while the current
one is in flight.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def _block_map(fn, axis: int, st, *others):
    return type(st)(*(fn(p, *o, axis=axis) for p, *o in zip(st, *others)))


def tree_slot_map(fn, pool: dict, *others: dict) -> dict:
    """Map ``fn(pool_leaf, *other_leaves, axis=slot_axis)`` over serve
    states of either layout whose blocks are of any kind
    (``AttnServeState``, ``KVCacheState``, ``PagedKVState``,
    ``RGLRUState``, ``RWKVBlockState``: flat named tuples of tensors)."""
    out = {}
    if "layers" in pool:
        out["layers"] = _block_map(fn, 1, pool["layers"],
                                   *[t["layers"] for t in others])
    if "units" in pool:
        out["units"] = {k: _block_map(fn, 1, st,
                                      *[t["units"][k] for t in others])
                        for k, st in pool["units"].items()}
    if "rem" in pool:
        out["rem"] = [_block_map(fn, 0, st, *[t["rem"][i] for t in others])
                      for i, st in enumerate(pool["rem"])]
    out["pos"] = fn(pool["pos"], *[t["pos"] for t in others], axis=0)
    return out


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


def fork_slots(pool: dict, row: dict, idx: torch.Tensor,
               tables: Optional[torch.Tensor] = None) -> dict:
    """Broadcast a ONE-row serve state into slots ``idx``, in place: the
    admission seed, from the engine's fresh-row template or a cached
    prefix snapshot (the prefix cache's fork). ``row`` is read, never
    written: it is expanded, and each slot gets a copy. For the PRF kinds
    the row is the fixed-size (S, z, c), so forking a prefix into P
    requests costs P rows whatever the prefix's length. A paged row gives
    each slot its own page table, ``tables`` ((P, max_pages) on the
    pool's device: shared prefix pages, then the slot's own)."""
    def _spread(p, axis):
        shape = list(p.shape)
        shape[axis] = idx.shape[0]
        return p.expand(shape)
    rows = tree_slot_map(_spread, row)
    if tables is not None:
        layers = rows["layers"]
        rows["layers"] = layers._replace(
            table=tables.expand(layers.table.shape[0], *tables.shape))
    return write_slots(pool, rows, idx)


def merge_slots(dst: dict, src: dict, idx: torch.Tensor) -> dict:
    """Copy rows ``idx`` of ``src`` into the same rows of ``dst`` (the
    commit of finished staging rows into the slot pool), in place."""
    def _merge(d, s, axis):
        d.index_copy_(axis, idx, s.index_select(axis, idx).to(d.dtype))
    tree_slot_map(_merge, dst, src)
    return dst


class PackBuffer:
    """Double-buffered host staging for packed prefill-chunk tokens.

    Two ``(max_rows, max_chunk)`` int64 buffers alternate: ``pack()``
    fills one and returns a contiguous ``(P, l_pad)`` view of it, so the
    view handed out for chunk N survives packing chunk N+1. On CUDA the
    buffers are pinned and ``to_device`` copies a view with
    ``non_blocking=True``: the copy reads the host buffer only when the
    stream reaches it, so each buffer carries the event recorded after
    its copy and ``pack()`` waits on it before writing that buffer
    again. (The chunk packed at step t+2 reuses the buffer whose copy
    was enqueued at step t+1 behind that step's decode, and nothing else
    has waited for that copy.) On the CPU the buffers are plain tensors,
    ``to_device`` returns the view itself and no event is needed.
    """

    def __init__(self, max_rows: int, max_chunk: int, device="cpu"):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self._bufs = [torch.zeros(max_rows * max_chunk, dtype=torch.int64,
                                  pin_memory=pin) for _ in range(2)]
        self._events: list = [None, None]
        self._flip = 0
        self.fence_waits = 0      # packs that found their copy unfinished

    def pack(self, rows: list, l_pad: int) -> torch.Tensor:
        """Fill the idle buffer with ``rows`` (sequences of ints, each
        <= l_pad) zero-padded to ``l_pad`` and return the (P, l_pad)
        view. Flips buffers on every call."""
        i = self._flip
        self._flip ^= 1
        ev = self._events[i]
        if ev is not None:
            if not ev.query():
                self.fence_waits += 1
                ev.synchronize()
            self._events[i] = None
        view = self._bufs[i][:len(rows) * l_pad].view(len(rows), l_pad)
        host = view.numpy()
        host[:] = 0
        for r, toks in enumerate(rows):
            host[r, :len(toks)] = toks
        return view

    def to_device(self, view: torch.Tensor) -> torch.Tensor:
        """``view`` (from ``pack``) on the buffers' device; on CUDA a
        non-blocking copy, fenced by the event its buffer now carries."""
        if self.device.type != "cuda":
            return view
        out = view.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        ptr = view.untyped_storage().data_ptr()
        for i, buf in enumerate(self._bufs):
            if buf.untyped_storage().data_ptr() == ptr:
                self._events[i] = ev
        return out


def freeze_inactive(pool: dict, idx: Optional[torch.Tensor],
                    advance: Callable[[dict], tuple],
                    n: Optional[int] = None):
    """Advance only the slots ``idx`` ((P,) int64 on the pool's device,
    ascending; None = every slot) of ``pool``; the other rows stay
    bit-frozen, ``pos`` included.

    ``advance(state)`` steps a per-slot state in place and returns
    (out, state) with ``out`` batched along dim 0. When every slot is
    active the pool itself is advanced; otherwise the rows ``idx`` are
    gathered, advanced and scattered back (the in-place kernels leave no
    old copy to select inactive rows from afterwards). With ``n``, only
    the first ``n`` rows of ``idx`` are slots to advance; the rest pad
    the call (repeats of a row, advanced on their copies and dropped),
    so that every call can run the same number of rows. Returns ``out``:
    one row per advanced slot, in slot order.
    """
    if idx is None:
        out, _ = advance(pool)
        return out
    sub = read_slots(pool, idx)
    out, sub = advance(sub)
    if n is not None and n < idx.shape[0]:
        keep = torch.arange(n, device=idx.device)
        sub, out, idx = read_slots(sub, keep), out[:n], idx[:n]
    write_slots(pool, sub, idx)
    return out

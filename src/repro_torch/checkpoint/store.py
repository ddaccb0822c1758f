"""Msgpack pytree checkpoints in the reference's on-disk layout.

Port of ``repro.checkpoint.store``. Layout: ``<dir>/step_<N>/state.msgpack``
plus a ``DONE`` marker; the file is one msgpack map from each leaf's key
path (the reference's ``keystr``, e.g. ``"['params']['units']['b0']
['attn']['wq']"``) to ``{"dtype", "shape", "data"}``, data being the raw
little-endian bytes (bf16 as its 16-bit words under the dtype name
"bfloat16"). A checkpoint written by either package loads in the other.

Guarantees, as the reference's: written to ``step_<N>.tmp-<pid>``,
fsync'd, then renamed, so a crash never corrupts the latest checkpoint;
keep-last-k garbage collection. Sharded leaves (DTensors) are saved as
their full value, gathered on every rank; under a process group of more
than one rank only rank 0 writes. Restore follows the template: a
DTensor leaf comes back with its mesh and placements, and
``restore_to_shardings`` places every leaf by a sharding tree on any
mesh (the elastic path: a checkpoint written on one mesh reloads onto
another).
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import msgpack_subset
from repro_torch.tree import flatten, map_with_path


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (a collective: every rank calls it); a
    plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _pack_leaf(t: torch.Tensor) -> dict:
    t = t.detach().cpu().contiguous()
    return {"dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape),
            "data": t.reshape(-1).view(torch.uint8).numpy().tobytes()}


def _unpack_leaf(rec: dict) -> torch.Tensor:
    dtype = getattr(torch, rec["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown leaf dtype {rec['dtype']!r}")
    raw = torch.from_numpy(np.frombuffer(rec["data"], np.uint8).copy())
    return raw.view(dtype).reshape(rec["shape"])


def save_checkpoint(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Write the step's checkpoint atomically; keep the newest ``keep``.
    Under a process group every rank calls it (a DTensor leaf is gathered
    by all); rank 0 writes, the others return the path at once."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    if not _writer():
        for _, v in flatten(tree):
            _full(v)
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    chunks: list = []
    msgpack_subset.pack({k: _pack_leaf(_full(v)) for k, v in flatten(tree)},
                        chunks)
    with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
        f.writelines(chunks)
        f.flush()
        os.fsync(f.fileno())
    open(os.path.join(tmp, "DONE"), "w").close()
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in all_steps(ckpt_dir)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    """Steps with a complete (DONE) checkpoint, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and "tmp" not in name and \
                os.path.exists(os.path.join(ckpt_dir, name, "DONE")):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _restore(ckpt_dir: str, target, step: Optional[int], make):
    """Each leaf of ``target`` read from the checkpoint on the host (its
    shape checked) and built by ``make(key, host array, target leaf)``,
    one leaf at a time. Returns (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with open(os.path.join(ckpt_dir, f"step_{step}", "state.msgpack"),
              "rb") as f:
        payload = msgpack_subset.unpackb(f.read())

    def leaf(key, t):
        if key not in payload:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = _unpack_leaf(payload.pop(key))
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(arr.shape)} vs target "
                             f"{tuple(t.shape)}")
        return make(key, arr, t)
    return map_with_path(leaf, target), step


def restore_checkpoint(ckpt_dir: str, target, step: Optional[int] = None):
    """Restore into the structure of ``target`` (a nested dict of
    tensors), each leaf cast to the target leaf's dtype and device; a
    DTensor target leaf gives a DTensor with its mesh and placements
    (each rank moving only its shard to the device). Returns (tree,
    step)."""
    from torch.distributed.tensor import DTensor

    def make(key, arr, t):
        if isinstance(t, DTensor):
            from repro_torch.parallel.sharding import place
            return place(arr.to(t.dtype), t.device_mesh, t.placements)
        return arr.to(device=t.device, dtype=t.dtype)
    return _restore(ckpt_dir, target, step, make)


def restore_to_shardings(ckpt_dir: str, target, shardings,
                         step: Optional[int] = None):
    """Elastic restore: each leaf restored as ``target``'s (its shape
    and dtype checked against the checkpoint) and placed with its
    sharding from ``shardings``, a tree mirroring ``target`` of
    ``parallel.sharding.NamedSharding`` on any ``DeviceMesh``, straight
    from the host: each rank moves only its shard to the device, so a
    checkpoint written on one mesh reloads onto another without a whole
    copy on any device. Returns (tree of DTensors, step)."""
    from repro_torch.parallel.sharding import place
    flat = dict(flatten(shardings))

    def make(key, arr, t):
        return place(arr.to(t.dtype), flat[key].mesh, flat[key].placements)
    return _restore(ckpt_dir, target, step, make)

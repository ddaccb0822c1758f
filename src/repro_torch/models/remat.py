"""Remat "dots" in the training forward: the outputs of the products
without a batch dimension (x @ W) are kept, everything else is
recomputed.

``torch.utils.checkpoint`` runs a unit's forward again in the backward.
Under "dots" its ``context_fn`` is :func:`dots_contexts`: in the
forward each :func:`dot` keeps its product's output (one ``aten.mm`` of
x folded to (rows, d), as ``x @ W`` computes it), and in the recompute
it hands that output back instead of multiplying again. Autograd still
records the product's own node there, so the gradients are bitwise
those of "none". Only that one ``aten.mm`` of the recompute runs under a
dispatch mode: a mode over the whole unit
(``create_selective_checkpoint_contexts``) runs Python on every op, and
on a host-bound step that costs more than the recompute itself.
Products that do not go through :func:`dot` (the batched einsums: MoE's
experts, the attention scores, the feature maps over the KV groups) are
recomputed.
"""
from __future__ import annotations

import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_local = threading.local()      # .kept: the running unit's _Kept, or None


class _Kept:
    """One unit call's product outputs, in forward order."""

    def __init__(self):
        self.outs: list = []
        self.replay = False
        self.next = 0

    def keep(self, out: torch.Tensor) -> None:
        self.outs.append((out.detach(), out._version))

    def take(self) -> torch.Tensor:
        kept = self.outs[self.next]
        if kept is None:
            raise RuntimeError('a "dots" unit recomputed twice (a second '
                               'backward through the same graph)')
        self.outs[self.next] = None         # freed once handed back
        self.next += 1
        out, version = kept
        if out._version != version:
            raise RuntimeError('a kept product was changed in place')
        return out


class _Replay(TorchDispatchMode):
    """Hands back the kept output for the one aten.mm run under it."""

    def __init__(self, kept: _Kept):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            return self.kept.take()
        return func(*args, **(kwargs or {}))


class _Scope:
    """Makes ``kept`` the running unit's, in this thread (the recompute
    runs on autograd's thread for the device)."""

    def __init__(self, kept: _Kept, replay: bool):
        self.kept, self.replay = kept, replay

    def __enter__(self):
        self.prev = getattr(_local, "kept", None)
        self.kept.replay = self.replay
        _local.kept = self.kept

    def __exit__(self, *exc):
        _local.kept = self.prev


def dots_contexts():
    """The (forward, recompute) context pair of one checkpointed unit
    call: ``torch.utils.checkpoint``'s ``context_fn`` under "dots"."""
    kept = _Kept()
    return _Scope(kept, False), _Scope(kept, True)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; inside a "dots" unit its output is kept for the
    recompute (module docstring). There ``x @ w`` folds x to (rows, d)
    for one aten.mm whenever w takes a gradient or x is contiguous; a
    product it would batch instead is recomputed."""
    kept = getattr(_local, "kept", None)
    if kept is None or not (w.requires_grad or x.is_contiguous()):
        return x @ w
    x2 = x if x.dim() == 2 else x.reshape(-1, x.shape[-1])
    if kept.replay:
        with _Replay(kept):
            y = torch.mm(x2, w)
    else:
        y = torch.mm(x2, w)
        kept.keep(y)
    return y if x.dim() == 2 else y.view(*x.shape[:-1], w.shape[-1])

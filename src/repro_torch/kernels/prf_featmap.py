"""Fused PRF feature map: the Hopper kernel's wrapper, its plain PyTorch
version and its autograd Function.

Replaces ``repro.kernels.prf_featmap.prf_featmap_fwd`` (a Pallas TPU
kernel, bodies ``_kernel_dark`` and ``_kernel_iso``). The CUDA kernel is
``csrc/prf_featmap.cu``; per row x it computes

    x̃ = M x   (x̃ = x when ``m_mat`` is None: the isotropic kinds)
    φ(x) = exp(W x̃ − ‖x̃‖²/2 − c) / √m

with both products on the tensor cores in 3xTF32 (the logits on wgmma
up to r = 64), W and M in shared memory (resident where they fit a
block, else streamed in slabs) and x̃ kept in registers, out of device
memory. The kernel takes r (d for the
isotropic map) up to :data:`MAX_RANK` and any d and m. Backward:
autograd of :func:`prf_featmap_plain` (port of
``repro.kernels.ops._featmap_bwd``; the reference has no backward
kernel). No model path calls it, in the reference or in the port: the
attention computes its features inline (``core.attention``).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(or raises). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from repro_torch.core.feature_maps import inv_sqrt
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (F, I, INPUT_DTYPES, P, check_cuda,
                                         expect, ptr, stream)

F32 = (torch.float32,)
MAX_RANK = 256      # columns of x̃ (r, or d when isotropic) a warp holds
launches = 0


def prf_featmap_plain(x: torch.Tensor, m_mat: Optional[torch.Tensor],
                      w: torch.Tensor, c) -> torch.Tensor:
    """Plain PyTorch version (port of ``repro.kernels.ref.prf_featmap_ref``).
    x: (..., d); m_mat: (r, d) or None; w: (m, r); c: scalar. Returns
    (..., m) f32."""
    x = x.float()
    if m_mat is not None:
        x = x @ m_mat.float().T
    logits = x @ w.float().T
    sq = 0.5 * torch.sum(x * x, dim=-1, keepdim=True)
    return torch.exp(logits - sq - c) * inv_sqrt(w.shape[0])


@functools.cache
def _lib():
    lib = _build.load("prf_featmap")
    lib.prf_featmap.argtypes = [P] * 5 + [I] * 5 + [F, P]
    lib.prf_featmap.restype = I
    return lib


def _check(x, m_mat, w, c):
    dev = x.device
    d = x.shape[-1]
    m, r = w.shape
    expect("x", x, tuple(x.shape), INPUT_DTYPES, dev)
    if m_mat is not None:
        expect("m_mat", m_mat, (r, d), F32, dev)
    elif r != d:
        raise ValueError(f"w is (m, {r}) but the isotropic map needs r = "
                         f"d = {d}")
    expect("w", w, (m, r), F32, dev)
    expect("c", c, (), F32, dev)
    return d, r, m


def _launch(x, m_mat, w, c, d, r, m):
    global launches
    if r > MAX_RANK:
        raise ValueError(f"prf_featmap's kernel holds x̃ in registers: r="
                         f"{r} ({'dark' if m_mat is not None else 'isotropic'}"
                         f", d={d}, m={m}) is above its {MAX_RANK}")
    lib = _lib()
    n = x.numel() // d
    out = torch.empty((*x.shape[:-1], m), dtype=torch.float32,
                      device=x.device)
    err = lib.prf_featmap(ptr(x), ptr(m_mat), ptr(w), ptr(c), ptr(out), n,
                          d, r, m, int(x.dtype == torch.bfloat16),
                          inv_sqrt(m), stream(x.device))
    check_cuda(err, "prf_featmap")
    launches += 1
    return out


class _PrfFeatmap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m_mat, w, c):
        dims = _check(x, m_mat, w, c)
        ctx.save_for_backward(x, m_mat, w, c)
        if x.device.type == "cpu":
            return prf_featmap_plain(x, m_mat, w, c)
        if x.device.type != "cuda":
            raise ValueError(f"prf_featmap runs on cuda or cpu, not "
                             f"{x.device}")
        return _launch(x, m_mat, w, c, *dims)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = [n and t is not None
                for t, n in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(saved, need)]
            out = prf_featmap_plain(*ins)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, need) if n], g))
        return tuple(next(grads) if n else None for n in need)


def prf_featmap(x: torch.Tensor, m_mat: Optional[torch.Tensor],
                w: torch.Tensor,
                c: Union[torch.Tensor, float] = 0.0) -> torch.Tensor:
    """φ(x) = exp(W M x − ‖M x‖²/2 − c)/√m, fused and differentiable.

    x: (..., d) f32 or bf16; m_mat: (r, d) f32 or None (isotropic, r =
    d); w: (m, r) f32; c: a float or a 0-d f32 tensor. x, m_mat and w
    must be contiguous. Returns (..., m) f32."""
    c = torch.as_tensor(c, dtype=torch.float32, device=x.device)
    return _PrfFeatmap.apply(x, m_mat, w, c)

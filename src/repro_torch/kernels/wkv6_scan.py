"""RWKV-6 WKV recurrence: the Hopper kernel's wrapper, its plain PyTorch
version and its autograd Function.

Replaces ``repro.kernels.wkv6_scan.wkv6_fwd`` (a Pallas TPU kernel),
reached through ``ops.wkv6``. The CUDA kernel is ``csrc/wkv6_scan.cu``;
per (batch·head) row, with a dh × dh f32 state from zero, it computes

    o_t = r_tᵀ (S_{t−1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t−1} + k_t v_tᵀ

Backward: autograd of :func:`wkv6_plain` (the oracle's token loop),
recomputed under ``torch.enable_grad()`` — the port of
``repro.kernels.ops._wkv6_vjp_bwd``; the reference has no backward
kernel. No model path calls it, in the reference or in the port: the
reference's rwkv6 block runs its own jnp scan
(``repro.models.recurrent._wkv_scan``).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(or raises: the kernel takes dh from 1 to ``MAX_DH``). ``launches``
counts kernel launches.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import I, INPUT_DTYPES, P, check_cuda, \
    expect, ptr, stream

MAX_DH = 128                  # kMaxDh in the .cu (the state in registers)
launches = 0


def wkv6_plain(r, k, v, w, u):
    """Plain PyTorch version: the token loop of
    ``repro.kernels.ref.wkv6_ref`` from a zero state, as ``ops.wkv6``'s
    backward runs it. r, k, v, w: (..., L, dh); u: (dh,). Returns o
    (..., L, dh) in v.dtype."""
    r, k, w = r.float(), k.float(), w.float()
    vf, u = v.float(), u.float()
    s = torch.zeros((*r.shape[:-2], r.shape[-1], r.shape[-1]),
                    dtype=torch.float32, device=r.device)
    outs = []
    for t in range(r.shape[-2]):
        kv = k[..., t, :, None] * vf[..., t, None, :]
        outs.append(torch.einsum("...d,...de->...e", r[..., t, :],
                                 s + u[:, None] * kv))
        s = w[..., t, :, None] * s + kv
    return torch.stack(outs, dim=-2).to(v.dtype)


@functools.cache
def _c_fn():
    fn = _build.load("wkv6_scan").wkv6_fwd
    fn.argtypes = [P] * 6 + [I] * 4 + [P]
    fn.restype = I
    return fn


def _check(r, k, v, w, u):
    if r.ndim < 2:
        raise ValueError(f"r must be (..., L, dh), got {tuple(r.shape)}")
    dev = r.device
    expect("r", r, tuple(r.shape), INPUT_DTYPES, dev)
    for name, t in (("k", k), ("v", v), ("w", w)):
        expect(name, t, tuple(r.shape), (r.dtype,), dev)
    dh = r.shape[-1]
    expect("u", u, (dh,), (torch.float32,), dev)


def _launch(r, k, v, w, u):
    global launches
    *lead, l, dh = r.shape
    if dh > MAX_DH:
        raise ValueError(f"wkv6 takes dh up to {MAX_DH} on the GPU, "
                         f"got {dh}")
    o = torch.empty_like(v)
    if o.numel() == 0:                # nothing to launch, nothing counted
        return o
    err = _c_fn()(ptr(r), ptr(k), ptr(v), ptr(w), ptr(u), ptr(o),
                  math.prod(lead), l, dh, int(r.dtype == torch.bfloat16),
                  stream(r.device))
    check_cuda(err, "wkv6_fwd")
    launches += 1
    return o


class _Wkv6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u):
        _check(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        if r.device.type == "cpu":
            return wkv6_plain(r, k, v, w, u)
        if r.device.type != "cuda":
            raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
        return _launch(r, k, v, w, u)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = wkv6_plain(*ins)
            # w of the last token reaches no output (all of w when L = 1)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, need) if n], g,
                allow_unused=True, materialize_grads=True))
        return tuple(next(grads) if n else None for n in need)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """RWKV-6 WKV from a zero state, differentiable.

    r, k, v, w: (..., L, dh), one type, f32 or bf16, w in [0, 1]; u:
    (dh,) f32, shared by every row. Every tensor must be contiguous; on
    the GPU dh is at most ``MAX_DH``. The function does not depend on a
    chunk length (the reference's ``chunk`` tiles its TPU grid). Returns
    o (..., L, dh) in v.dtype."""
    return _Wkv6.apply(r, k, v, w, u)

"""Causal linear attention from a zero state: the Hopper kernel's wrapper,
its plain PyTorch version and its autograd Function.

Replaces ``repro.kernels.linear_attn_scan.linear_attention_causal_fwd``
(a Pallas TPU kernel). The CUDA kernel is ``csrc/linear_attn_scan.cu``;
per query row it computes

    out_i = qf_i · Σ_{j≤i} kf_j v_jᵀ / (qf_i · Σ_{j≤i} kf_j + ε)

chunk-parallel, with kf and v read once per KV row: the Hk rows of kf and
v serve the H query rows of qf, query head h reading KV head h·Hk/H, so a
GQA group's heads need no broadcast copy (Hk is 1 or H).

Backward: autograd of :func:`linear_attention_causal_plain`, the O(L²)
oracle, recomputed under ``torch.enable_grad()`` — the port of
``repro.kernels.ops._lin_attn_bwd``. The reference has no backward
kernel, so neither has the port (ROADMAP.md Queue B, "B5 backward").

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(or raises). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.linear_attention import linear_attention_causal_naive
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (F, I, INPUT_DTYPES, P, check_cuda,
                                         expect, ptr, stream)

F32 = (torch.float32,)
CHUNK = 256                   # keys per state chunk (kChunk in the .cu)
MAX_ROWS = 65535              # query rows: the launch grid's y extent
launches = 0


# The plain version: the O(L²) masked oracle (port of
# ``repro.kernels.ref.linear_attention_causal_ref``); its einsums broadcast
# the Hk = 1 heads of kf and v over the H heads of qf.
linear_attention_causal_plain = linear_attention_causal_naive


@functools.cache
def _c_fn():
    fn = _build.load("linear_attn_scan").linear_attn_causal
    fn.argtypes = [P] * 6 + [I] * 6 + [F, P]
    fn.restype = I
    return fn


def _check(qf, kf, v):
    if qf.ndim < 3:
        raise ValueError(f"qf must be (..., H, L, m), got {tuple(qf.shape)}")
    *lead, h, l, m = qf.shape
    hk, dv = kf.shape[-3], v.shape[-1]
    if hk not in (1, h):
        raise ValueError(f"kf has {hk} heads for {h} query heads: expected "
                         f"1 or {h}")
    dev = qf.device
    expect("qf", qf, (*lead, h, l, m), F32, dev)
    expect("kf", kf, (*lead, hk, l, m), F32, dev)
    expect("v", v, (*lead, hk, l, dv), INPUT_DTYPES, dev)
    return qf.numel() // (l * m), kf.numel() // (l * m), l, m, dv


def _launch(qf, kf, v, eps, n, nk, l, m, dv):
    global launches
    if n > MAX_ROWS:
        raise ValueError(f"linear_attention_causal takes at most {MAX_ROWS} "
                         f"query rows, got {n}")
    nc1 = max(-(-l // CHUNK) - 1, 1)
    dev = qf.device
    ds = torch.empty((nk, nc1, m, dv), dtype=torch.float32, device=dev)
    dz = torch.empty((nk, nc1, m), dtype=torch.float32, device=dev)
    out = torch.empty((*qf.shape[:-1], dv), dtype=v.dtype, device=dev)
    err = _c_fn()(ptr(qf), ptr(kf), ptr(v), ptr(ds), ptr(dz), ptr(out),
                  n, nk, l, m, dv, int(v.dtype == torch.bfloat16), eps,
                  stream(dev))
    check_cuda(err, "linear_attn_causal")
    launches += 1
    return out


class _LinAttnCausal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qf, kf, v, eps):
        dims = _check(qf, kf, v)
        ctx.save_for_backward(qf, kf, v)
        ctx.eps = eps
        if qf.device.type == "cpu":
            return linear_attention_causal_plain(qf, kf, v, eps)
        if qf.device.type != "cuda":
            raise ValueError("linear_attention_causal runs on cuda or cpu, "
                             f"not {qf.device}")
        return _launch(qf, kf, v, eps, *dims)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = linear_attention_causal_plain(*ins, ctx.eps)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, need) if n], g))
        return (*(next(grads) if n else None for n in need), None)


def linear_attention_causal(qf: torch.Tensor, kf: torch.Tensor,
                            v: torch.Tensor, *,
                            eps: float = 1e-6) -> torch.Tensor:
    """Causal PRF attention from a zero state, differentiable.

    qf: (..., H, L, m) f32; kf: (..., Hk, L, m) f32; v: (..., Hk, L, dv)
    f32 or bf16, with Hk = 1 (one KV head shared by the H query heads)
    or Hk = H. Every tensor must be contiguous. Returns (..., H, L, dv)
    in v.dtype; gradients come back in the shapes given."""
    return _LinAttnCausal.apply(qf, kf, v, eps)

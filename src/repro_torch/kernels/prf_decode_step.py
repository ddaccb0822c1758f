"""Two-stage one-token PRF decode step: the Hopper kernel's wrapper and
its plain PyTorch version.

Replaces ``repro.kernels.prf_decode_step.prf_decode_step_fwd`` (a Pallas
TPU kernel), reached through ``ops.linear_attention_decode_step``. The
CUDA kernel is ``csrc/prf_decode_step.cu``; over features computed
beforehand (``core.attention._resume_qk_features``) it computes per query
row

    S' = ρ S + kf vᵀ        z' = ρ z + kf
    out = (qf · S') / (qf · z' + ε)

and writes S' and z' in place. kf, v and ρ are read once per KV row: the
Hk rows serve the H query rows, query head h reading KV head h·Hk/H, so a
GQA group's heads need no broadcast copy (Hk is 1 or H). v is f32 or
bf16 (the model's type), cast inside, as the reference's kernel casts it.

A CPU tensor runs :func:`prf_decode_step_plain`; a CUDA tensor launches
the kernel (or raises): one launch a call, B1's stream of S
(``prf_common.cuh``) with each query row's tiles in a thread block
cluster, so that one tile writes z' in place once all have read z. No
copy of z is made and nothing is allocated but the output. ``launches``
counts the wrapper's calls that launched it.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (F, FEATURE_COUNTS, I, INPUT_DTYPES,
                                         P, check_cuda, expect,
                                         expect_aligned, ptr, stream)

F32 = (torch.float32,)
MAX_ROWS = 65535              # query rows: the launch grid's y extent
MAX_DV = 256                  # a row's tiles form a cluster of at most 8
launches = 0


def prf_decode_step_plain(qf, kf, v, s, z, rescale, *, eps: float = 1e-6):
    """Plain PyTorch version of the kernel (port of
    ``repro.kernels.ref.prf_decode_step_ref``), updating s and z in place
    like the kernel. Shapes as :func:`linear_attention_decode_step`, whose
    Hk rows broadcast over the H query rows. Returns (out (..., H, dv)
    f32, s, z)."""
    rho = rescale.float()[..., None]                      # (..., Hk, 1)
    kf = kf.float()
    s_new = s * rho[..., None] + kf[..., :, None] * v.float()[..., None, :]
    z_new = z * rho + kf
    num = torch.einsum("...hm,...hmd->...hd", qf.float(), s_new)
    den = torch.einsum("...hm,...hm->...h", qf.float(), z_new)[..., None]
    s.copy_(s_new)
    z.copy_(z_new)
    return num / (den + eps), s, z


@functools.cache
def _c_fn():
    fn = _build.load("prf_decode_step").prf_decode_step
    fn.argtypes = [P] * 7 + [I] * 5 + [F, P]
    fn.restype = I
    return fn


def linear_attention_decode_step(qf: torch.Tensor, kf: torch.Tensor,
                                 v: torch.Tensor, s: torch.Tensor,
                                 z: torch.Tensor, rescale: torch.Tensor, *,
                                 eps: float = 1e-6):
    """Advance a PRF serving state by one token over precomputed
    features, in place.

    qf: (..., H, m); kf: (..., Hk, m); v: (..., Hk, dv) f32 or bf16;
    rescale: (..., Hk), the stabilizer's ρ = exp(c_old − c_new); s: (...,
    H, m, dv) and z: (..., H, m), updated in place; Hk is 1 or H. All f32
    but v, and contiguous. On CUDA the kernel also takes m in
    ``FEATURE_COUNTS``, dv a multiple of 4 up to ``MAX_DV`` and qf, kf, s
    and z on 16-byte boundaries. Returns (out (..., H, dv) f32, s, z)."""
    if qf.ndim < 2:
        raise ValueError(f"qf must be (..., H, m), got {tuple(qf.shape)}")
    *lead, h, m = qf.shape
    hk, dv = kf.shape[-2], v.shape[-1]
    if hk not in (1, h):
        raise ValueError(f"kf has {hk} heads for {h} query heads: expected "
                         f"1 or {h}")
    dev = qf.device
    expect("qf", qf, (*lead, h, m), F32, dev)
    expect("kf", kf, (*lead, hk, m), F32, dev)
    expect("v", v, (*lead, hk, dv), INPUT_DTYPES, dev)
    expect("s", s, (*lead, h, m, dv), F32, dev)
    expect("z", z, (*lead, h, m), F32, dev)
    expect("rescale", rescale, (*lead, hk), F32, dev)
    if dev.type == "cpu":
        return prf_decode_step_plain(qf, kf, v, s, z, rescale, eps=eps)
    if dev.type != "cuda":
        raise ValueError("linear_attention_decode_step runs on cuda or cpu, "
                         f"not {dev}")
    n, nk = qf.numel() // m, kf.numel() // m
    if n > MAX_ROWS:
        raise ValueError(f"linear_attention_decode_step takes at most "
                         f"{MAX_ROWS} query rows, got {n}")
    if m not in FEATURE_COUNTS or dv % 4 or dv > MAX_DV:
        raise ValueError(f"prf_decode_step is built for m in "
                         f"{FEATURE_COUNTS} and dv a multiple of 4 up to "
                         f"{MAX_DV}, got m={m}, dv={dv}")
    expect_aligned("prf_decode_step", qf=qf, kf=kf, s=s, z=z)
    global launches
    out = torch.empty((*lead, h, dv), dtype=torch.float32, device=dev)
    err = _c_fn()(ptr(qf), ptr(kf), ptr(v), ptr(rescale), ptr(s), ptr(z),
                  ptr(out), n, nk, m, dv, int(v.dtype == torch.bfloat16),
                  eps, stream(dev))
    check_cuda(err, "prf_decode_step")
    launches += 1
    return out, s, z

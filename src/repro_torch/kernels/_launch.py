"""Argument checks and ctypes plumbing shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

INPUT_DTYPES = (torch.float32, torch.bfloat16)
FEATURE_COUNTS = (16, 32, 64, 128, 256)   # m the fused kernels are built for
P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def expect(name: str, t: torch.Tensor, shape: tuple, dtypes,
           device: torch.device) -> None:
    """Raise unless ``t`` has ``shape``, a dtype in ``dtypes``, lies on
    ``device`` and is contiguous (the kernels take flat arrays)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous: make it contiguous "
                         "before the call")


def check_cuda(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch "
                           f"({torch.cuda.get_device_name()})")


def expect_aligned(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (``kernel``
    copies it in 16-byte pieces)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte "
                             "boundary (the kernel copies it in 16-byte "
                             "pieces)")

"""Hand-written Hopper kernels of the serving path, each with its plain
PyTorch version (what a CPU tensor runs) and a launch count.

  prf_fused_decode   — one-token fused PRF decode (csrc/prf_fused_decode.cu)
  prf_fused_prefill  — resumable fused PRF prefill chunk
                       (csrc/prf_fused_prefill.cu)

The CUDA sources build with nvcc at first use (``_build``); importing
this package needs neither nvcc nor a GPU.
"""
from repro_torch.kernels.prf_fused_decode import fused_prf_decode
from repro_torch.kernels.prf_fused_prefill import fused_prf_prefill

__all__ = ["fused_prf_decode", "fused_prf_prefill"]

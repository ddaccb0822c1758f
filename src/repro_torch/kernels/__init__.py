"""Hand-written Hopper kernels, each with its plain PyTorch version (what
a CPU tensor runs) and a launch count.

  prf_fused_decode        — one-token fused PRF decode
                            (csrc/prf_fused_decode.cu)
  prf_fused_prefill       — resumable fused PRF prefill chunk
                            (csrc/prf_fused_prefill.cu)
  linear_attention_causal — causal linear attention from a zero state,
                            the training path (csrc/linear_attn_scan.cu)
  prf_featmap             — fused PRF feature map, on no model path
                            (module ``prf_featmap``, csrc/prf_featmap.cu)

The CUDA sources build with nvcc at first use (``_build``); importing
this package needs neither nvcc nor a GPU.
"""
from repro_torch.kernels.linear_attn_scan import linear_attention_causal
from repro_torch.kernels.prf_fused_decode import fused_prf_decode
from repro_torch.kernels.prf_fused_prefill import fused_prf_prefill

__all__ = ["fused_prf_decode", "fused_prf_prefill", "linear_attention_causal"]

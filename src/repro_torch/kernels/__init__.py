"""Hand-written Hopper kernels, each with its plain PyTorch version (what
a CPU tensor runs) and a launch count. Seven, one for each Pallas TPU
kernel of the reference:

  prf_fused_decode        — one-token fused PRF decode
                            (csrc/prf_fused_decode.cu)
  prf_fused_prefill       — resumable fused PRF prefill chunk
                            (csrc/prf_fused_prefill.cu)
  linear_attention_decode_step
                          — two-stage one-token decode over precomputed
                            features (module ``prf_decode_step``,
                            csrc/prf_decode_step.cu)
  linear_attention_prefill_chunk
                          — two-stage prefill chunk: causal linear
                            attention resumed from a carried state
                            (csrc/linear_attn_scan.cu)
  linear_attention_causal — causal linear attention from a zero state,
                            training and whole-prompt prefill
                            (csrc/linear_attn_scan.cu)
  prf_featmap             — fused PRF feature map, on no model path
                            (module ``prf_featmap``, csrc/prf_featmap.cu)
  wkv6                    — RWKV-6 WKV recurrence, on no model path
                            (module ``wkv6_scan``, csrc/wkv6_scan.cu)

The two-stage kernels (``prf_decode_step`` and the carried scan) and
``wkv6`` are the three added last. The CUDA sources build with nvcc at
first use (``_build``); importing this package needs neither nvcc nor a
GPU.
"""
from repro_torch.kernels.linear_attn_scan import (
    linear_attention_causal, linear_attention_prefill_chunk)
from repro_torch.kernels.prf_decode_step import linear_attention_decode_step
from repro_torch.kernels.prf_fused_decode import fused_prf_decode
from repro_torch.kernels.prf_fused_prefill import fused_prf_prefill
from repro_torch.kernels.wkv6_scan import wkv6

__all__ = ["fused_prf_decode", "fused_prf_prefill", "linear_attention_causal",
           "linear_attention_decode_step", "linear_attention_prefill_chunk",
           "wkv6"]

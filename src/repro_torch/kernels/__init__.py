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
from repro_torch.kernels import (linear_attn_scan, prf_decode_step,
                                 prf_featmap, prf_fused_decode,
                                 prf_fused_prefill, wkv6_scan)
from repro_torch.kernels.linear_attn_scan import (
    linear_attention_causal, linear_attention_prefill_chunk)
from repro_torch.kernels.prf_decode_step import linear_attention_decode_step
from repro_torch.kernels.prf_fused_decode import fused_prf_decode
from repro_torch.kernels.prf_fused_prefill import fused_prf_prefill
from repro_torch.kernels.wkv6_scan import wkv6

# each kernel's launch counter: (module, attribute), which its wrapper
# adds one to where it launches the kernel (never on a CPU tensor)
COUNTERS = {
    "prf_fused_decode": (prf_fused_decode, "launches"),
    "prf_fused_prefill": (prf_fused_prefill, "launches"),
    "prf_decode_step": (prf_decode_step, "launches"),
    "linear_attention_carry": (linear_attn_scan, "carry_launches"),
    "linear_attention_causal": (linear_attn_scan, "launches"),
    "prf_featmap": (prf_featmap, "launches"),
    "wkv6": (wkv6_scan, "launches"),
}


def launch_counts() -> dict:
    """{kernel: launches} of the seven kernels since their last reset."""
    return {n: getattr(mod, attr) for n, (mod, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


__all__ = ["COUNTERS", "fused_prf_decode", "fused_prf_prefill",
           "launch_counts", "linear_attention_causal",
           "linear_attention_decode_step", "linear_attention_prefill_chunk",
           "reset_launch_counts", "wkv6"]

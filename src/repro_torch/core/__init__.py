"""Core: the paper's contribution, data-aware random-feature attention
(the public names of ``repro.core``)."""
from repro_torch.core import calibration, variance
from repro_torch.core.attention import (AttnServeState,
                                        init_linear_serve_state,
                                        rf_attention, rf_attention_decode,
                                        rf_attention_prefill)
from repro_torch.core.feature_maps import (FEATURE_KINDS, FeatureConfig,
                                           draw_projection,
                                           gaussian_projection,
                                           init_feature_params,
                                           orthogonal_projection,
                                           whitening_init)
from repro_torch.core.linear_attention import (
    LinearState, exact_attention, linear_attention_causal_chunked,
    linear_attention_causal_naive, linear_attention_decode,
    linear_attention_noncausal, linear_attention_prefill,
    sequence_parallel_state_combine)

__all__ = ["AttnServeState", "FEATURE_KINDS", "FeatureConfig",
           "LinearState", "calibration", "draw_projection",
           "exact_attention", "gaussian_projection", "init_feature_params",
           "init_linear_serve_state", "linear_attention_causal_chunked",
           "linear_attention_causal_naive", "linear_attention_decode",
           "linear_attention_noncausal", "linear_attention_prefill",
           "orthogonal_projection", "rf_attention", "rf_attention_decode",
           "rf_attention_prefill", "sequence_parallel_state_combine",
           "variance", "whitening_init"]

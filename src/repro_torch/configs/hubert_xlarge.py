"""hubert-xlarge — encoder-only audio transformer (w2v2 arch).

[arXiv:2106.07447] 48L d_model=1280 16H (MHA kv=16, d_head=80) d_ff=5120
vocab=504 (masked-frame cluster prediction). The conv waveform frontend is
a stub: the inputs are precomputed frame embeddings (B, L, d_model).
Encoder-only: its PRF attention is the noncausal two-matmul form, which
runs no kernel.

Field for field the reference's ``repro.configs.hubert_xlarge``, less
``remat``, which the port's ``ModelConfig`` does not carry (ROADMAP
A13).
"""
from repro_torch.configs.base import DEFAULT_ATTN
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.lm import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", n_layers=48, d_model=1280, n_heads=16,
        n_kv=16, d_head=80, d_ff=5120, vocab=504, attn=DEFAULT_ATTN,
        causal=False, modality="audio", norm_kind="layernorm",
        mlp_kind="gelu", tie_embeddings=False, dtype="bfloat16")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv=4, d_head=16, d_ff=128, vocab=64, causal=False,
        modality="audio", norm_kind="layernorm", mlp_kind="gelu",
        attn=FeatureConfig(kind="darkformer", num_features=32),
        tie_embeddings=False)

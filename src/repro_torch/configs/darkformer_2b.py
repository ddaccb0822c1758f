"""darkformer-2b — the paper's own model: Gemma-2B with PRF attention.

Gemma-2B geometry [arXiv:2403.08295]: 18L d_model=2048 8H (MQA kv=1,
d_head=256) d_ff=16384 (GeGLU) vocab=256000, with the softmax kernel
replaced by the DARKFormer data-aware PRF.
"""
from repro_torch.configs.base import DEFAULT_ATTN
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.lm import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="darkformer-2b", n_layers=18, d_model=2048, n_heads=8,
        n_kv=1, d_head=256, d_ff=16_384, vocab=256_000, attn=DEFAULT_ATTN,
        mlp_kind="geglu", embed_scale=True, tie_embeddings=True,
        dtype="bfloat16")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="darkformer-2b-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv=1, d_head=16, d_ff=128, vocab=256, mlp_kind="geglu",
        attn=FeatureConfig(kind="darkformer", num_features=32),
        embed_scale=True, tie_embeddings=True, remat="none")

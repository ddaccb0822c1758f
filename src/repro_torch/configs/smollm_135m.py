"""smollm-135m — llama-arch small dense GQA.

[hf:HuggingFaceTB/SmolLM-135M] 30L d_model=576 9H (GQA kv=3, d_head=64)
d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import DEFAULT_ATTN
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.lm import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", n_layers=30, d_model=576, n_heads=9, n_kv=3,
        d_head=64, d_ff=1536, vocab=49_152, attn=DEFAULT_ATTN,
        mlp_kind="swiglu", tie_embeddings=True, dtype="bfloat16")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-smoke", n_layers=3, d_model=48, n_heads=3,
        n_kv=3, d_head=16, d_ff=96, vocab=256,
        attn=FeatureConfig(kind="darkformer", num_features=32),
        tie_embeddings=True)

"""qwen3-32b — dense GQA with qk-norm.

[hf:Qwen/Qwen3-8B family] 64L d_model=5120 64H (GQA kv=8, d_head=128)
d_ff=25600 vocab=151936, qk_norm, RoPE theta 1e6, untied head.

Field for field the reference's ``repro.configs.qwen3_32b``.
"""
from repro_torch.configs.base import DEFAULT_ATTN
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.lm import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", n_layers=64, d_model=5120, n_heads=64, n_kv=8,
        d_head=128, d_ff=25_600, vocab=151_936, attn=DEFAULT_ATTN,
        qk_norm=True, rope_theta=1e6, mlp_kind="swiglu",
        tie_embeddings=False, dtype="bfloat16")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=256, qk_norm=True,
        attn=FeatureConfig(kind="darkformer", num_features=32),
        tie_embeddings=False, remat="none")

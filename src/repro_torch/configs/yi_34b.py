"""yi-34b — llama-arch dense GQA.

[arXiv:2403.04652; hf] 60L d_model=7168 56H (GQA kv=8, d_head=128)
d_ff=20480 vocab=64000, RoPE theta 5e6, untied head.

Field for field the reference's ``repro.configs.yi_34b``.
"""
from repro_torch.configs.base import DEFAULT_ATTN
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.lm import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv=8,
        d_head=128, d_ff=20_480, vocab=64_000, attn=DEFAULT_ATTN,
        rope_theta=5e6, mlp_kind="swiglu", tie_embeddings=False,
        dtype="bfloat16")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke", n_layers=2, d_model=56, n_heads=7, n_kv=1,
        d_head=16, d_ff=112, vocab=256,
        attn=FeatureConfig(kind="darkformer", num_features=32),
        tie_embeddings=False, remat="none")

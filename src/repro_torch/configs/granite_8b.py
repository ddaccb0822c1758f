"""granite-8b — llama-arch dense GQA, code model.

[arXiv:2405.04324; hf] 36L d_model=4096 32H (GQA kv=8, d_head=128)
d_ff=14336 vocab=49152, untied head.

Field for field the reference's ``repro.configs.granite_8b``.
"""
from repro_torch.configs.base import DEFAULT_ATTN
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.lm import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", n_layers=36, d_model=4096, n_heads=32, n_kv=8,
        d_head=128, d_ff=14_336, vocab=49_152, attn=DEFAULT_ATTN,
        mlp_kind="swiglu", tie_embeddings=False, dtype="bfloat16")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=256,
        attn=FeatureConfig(kind="darkformer", num_features=32),
        tie_embeddings=False, remat="none")

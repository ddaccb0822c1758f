"""internvl2-76b — VLM: InternViT frontend (stub) + LM backbone.

[arXiv:2404.16821] backbone 80L d_model=8192 64H (GQA kv=8, d_head=128)
d_ff=28672 vocab=128256. The vision frontend is a stub: the inputs are
precomputed patch embeddings (B, 256, d_model) before the text tokens.

Field for field the reference's ``repro.configs.internvl2_76b``.
"""
from repro_torch.configs.base import DEFAULT_ATTN
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.lm import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", n_layers=80, d_model=8192, n_heads=64,
        n_kv=8, d_head=128, d_ff=28_672, vocab=128_256, attn=DEFAULT_ATTN,
        modality="vlm", num_patches=256, mlp_kind="swiglu",
        tie_embeddings=False, dtype="bfloat16")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv=2, d_head=16, d_ff=128, vocab=256, modality="vlm",
        num_patches=8,
        attn=FeatureConfig(kind="darkformer", num_features=32),
        tie_embeddings=False, remat="none")

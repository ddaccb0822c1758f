"""rwkv6-7b — "Finch", attention-free data-dependent-decay recurrence.

[arXiv:2404.05892; hf] 32L d_model=4096 (64 heads of 64) d_ff=14336
vocab=65536, untied head.

Field for field the reference's ``repro.configs.rwkv6_7b``, less
``remat``, which the port's ``ModelConfig`` does not carry. Every layer
is an ``rwkv`` block, so the stack is homogeneous (layer-stacked) and
has no attention layer: ``attn`` is carried as the reference carries it
and no path reads it.
"""
from repro_torch.configs.base import DEFAULT_ATTN
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.lm import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", n_layers=32, d_model=4096, n_heads=64, n_kv=64,
        d_head=64, d_ff=14_336, vocab=65_536,
        block_pattern=("rwkv",), attn=DEFAULT_ATTN,
        tie_embeddings=False, dtype="bfloat16")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_head=16, d_ff=128, vocab=256, block_pattern=("rwkv",),
        attn=FeatureConfig(kind="darkformer", num_features=32),
        tie_embeddings=False)

"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8.

[hf:ibm-granite family] 32L d_model=1536 24H (GQA kv=8, d_head=64)
per-expert d_ff=512, vocab=49155.

Field for field the reference's ``repro.configs.granite_moe_3b_a800m``,
less ``remat`` and ``sharding_overrides``, which the port's
``ModelConfig`` does not carry: remat and the per-arch sharding rules
wait with ROADMAP A13.
"""
from repro_torch.configs.base import DEFAULT_ATTN
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.layers import MoEConfig
from repro_torch.models.lm import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv=8, d_head=64, d_ff=512, vocab=49_155, attn=DEFAULT_ATTN,
        moe=MoEConfig(num_experts=40, top_k=8, d_ff=512),
        tie_embeddings=True, dtype="bfloat16")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=32, vocab=256,
        attn=FeatureConfig(kind="darkformer", num_features=32),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=32),
        tie_embeddings=True)

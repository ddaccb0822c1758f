"""qwen3-moe-235b-a22b — 128-expert top-8 MoE with qk-norm.

[hf:Qwen/Qwen3-30B-A3B family] 94L d_model=4096 64H (GQA kv=4,
d_head=128) per-expert d_ff=1536, vocab=151936, RoPE theta 1e6,
untied head.

Field for field the reference's ``repro.configs.qwen3_moe_235b_a22b``,
less ``remat``, which the port's ``ModelConfig`` does not carry
(ROADMAP A13).
"""
from repro_torch.configs.base import DEFAULT_ATTN
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.layers import MoEConfig
from repro_torch.models.lm import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
        n_kv=4, d_head=128, d_ff=1536, vocab=151_936, attn=DEFAULT_ATTN,
        qk_norm=True, rope_theta=1e6,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff=1536),
        tie_embeddings=False, dtype="bfloat16")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=32, vocab=256, qk_norm=True,
        attn=FeatureConfig(kind="darkformer", num_features=32),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=32),
        tie_embeddings=False)

"""recurrentgemma-2b — hybrid RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427; hf] 26L d_model=2560 10H (MQA kv=1, d_head=256)
d_ff=7680 (GeGLU) vocab=256000, local-attention window 2048.

Field for field the reference's ``repro.configs.recurrentgemma_2b``,
less ``remat``, which the port's ``ModelConfig`` does not carry. The
pattern leaves 8 units and 2 remainder layers, both ``rec``. With the
paper's attention (a PRF kind) the "local" blocks attend over their
whole prefix, as the reference's do: only exact attention applies the
window.
"""
from repro_torch.configs.base import DEFAULT_ATTN
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.lm import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", n_layers=26, d_model=2560, n_heads=10,
        n_kv=1, d_head=256, d_ff=7680, vocab=256_000,
        block_pattern=("rec", "rec", "local"), window=2048,
        mlp_kind="geglu", attn=DEFAULT_ATTN, rope_theta=10_000.0,
        d_rnn=2560, embed_scale=True, tie_embeddings=True,
        logit_softcap=30.0, dtype="bfloat16")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv=1, d_head=16, d_ff=128, vocab=256,
        block_pattern=("rec", "rec", "local"), window=16,
        mlp_kind="geglu",
        attn=FeatureConfig(kind="darkformer", num_features=32),
        d_rnn=64, embed_scale=True, tie_embeddings=True)

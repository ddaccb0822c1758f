"""Shared config helpers: the default PRF attention, ``darkify`` and the
reference's table of input-shape cells."""
from __future__ import annotations

import dataclasses

from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.lm import ModelConfig

# the four assigned input-shape cells (LM family), the reference's
SHAPES = {
    "train_4k":    dict(seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524_288, global_batch=1,   kind="decode"),
}

DEFAULT_ATTN = FeatureConfig(kind="darkformer", num_features=256,
                             orthogonal=True)


def darkify(cfg: ModelConfig, kind: str = "darkformer",
            num_features: int = 256) -> ModelConfig:
    """Switch a config's attention kernel: exact <-> the PRF kinds, and
    the random and constant baselines."""
    return dataclasses.replace(
        cfg, attn=dataclasses.replace(cfg.attn, kind=kind,
                                      num_features=num_features))

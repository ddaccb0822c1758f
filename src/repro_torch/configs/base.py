"""Shared config helpers: the default PRF attention and ``darkify``."""
from __future__ import annotations

import dataclasses

from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.models.lm import ModelConfig

DEFAULT_ATTN = FeatureConfig(kind="darkformer", num_features=256,
                             orthogonal=True)


def darkify(cfg: ModelConfig, kind: str = "darkformer",
            num_features: int = 256) -> ModelConfig:
    """Switch a config's attention kernel: exact <-> the PRF kinds, and
    the random and constant baselines."""
    return dataclasses.replace(
        cfg, attn=dataclasses.replace(cfg.attn, kind=kind,
                                      num_features=num_features))

"""Architecture registry: every arch of the reference's."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import DEFAULT_ATTN, darkify
from repro_torch.models.lm import ModelConfig

# in the reference's order
ARCHS = ["recurrentgemma-2b", "smollm-135m", "granite-8b", "qwen3-32b",
         "yi-34b", "rwkv6-7b", "granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
         "internvl2-76b", "hubert-xlarge", "darkformer-2b"]

__all__ = ["ARCHS", "DEFAULT_ATTN", "ModelConfig", "darkify",
           "get_config"]


def get_config(name: str, reduced: bool = False, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r} (known: "
                         f"{', '.join(ARCHS)})")
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_"))
    cfg = mod.reduced() if reduced else mod.config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg

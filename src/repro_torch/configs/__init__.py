"""Architecture registry: the archs the port serves so far."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import DEFAULT_ATTN, darkify
from repro_torch.models.lm import ModelConfig

ARCHS = ["smollm-135m", "darkformer-2b"]

__all__ = ["ARCHS", "DEFAULT_ATTN", "ModelConfig", "darkify",
           "get_config"]


def get_config(name: str, reduced: bool = False, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {', '.join(ARCHS)}; "
            "the rest is ROADMAP item A12)")
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_"))
    cfg = mod.reduced() if reduced else mod.config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg

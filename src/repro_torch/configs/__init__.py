"""Architecture registry: every arch of the reference's, and the
per-(arch x shape) cells of the dry-run (``launch.dryrun``)."""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Optional

import torch

from repro_torch.configs.base import DEFAULT_ATTN, SHAPES, darkify
from repro_torch.models.lm import ModelConfig

# in the reference's order
ARCHS = ["recurrentgemma-2b", "smollm-135m", "granite-8b", "qwen3-32b",
         "yi-34b", "rwkv6-7b", "granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
         "internvl2-76b", "hubert-xlarge", "darkformer-2b"]
# the assigned cells' archs (the paper's own darkformer-2b is not one)
ASSIGNED = ARCHS[:10]

__all__ = ["ARCHS", "ASSIGNED", "DEFAULT_ATTN", "ModelConfig", "SHAPES",
           "cell_supported", "cut_depth", "darkify", "get_config",
           "input_specs"]

_depth: Optional[int] = None      # set by cut_depth


@contextlib.contextmanager
def cut_depth(n_layers: int):
    """Within, :func:`get_config` gives every config ``n_layers`` layers
    unless its caller overrides ``n_layers`` itself: the launchers take
    no depth flag, as the reference's take none, so a run that drives
    them at a cut depth sets it here."""
    global _depth
    outer, _depth = _depth, n_layers
    try:
        yield
    finally:
        _depth = outer


def get_config(name: str, reduced: bool = False, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r} (known: "
                         f"{', '.join(ARCHS)})")
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_"))
    cfg = mod.reduced() if reduced else mod.config()
    if _depth is not None:
        overrides = {"n_layers": _depth, **overrides}
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Whether an (arch x shape) cell applies, and why not if skipped
    (the reference's reasons, word for word)."""
    kind = SHAPES[shape_name]["kind"]
    if not cfg.causal and kind == "decode":
        return False, "encoder-only arch: no decode step"
    if shape_name == "long_500k" and cfg.attn.kind == "exact" and \
            any(k in ("attn", "local") for k in cfg.block_pattern):
        return False, ("500k decode with exact full attention skipped; "
                       "run with a PRF kernel (the paper's point)")
    return True, ""


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Every model input of the cell as a ``meta`` tensor: shape and type,
    no storage. The types are the reference's stand-ins' (int32 ids,
    frames and patches in ``cfg.dtype``), as the data streams hand them
    over; ``launch.train.to_device`` widens ids to int64 and keeps frames
    and patches f32 on the device. A decode cell's input is {"token"};
    its serving state is built beside it (``lm.init_serve_state``)."""
    sh = SHAPES[shape_name]
    b = sh["global_batch"]
    l = sh["seq_len"]
    kind = sh["kind"]

    def spec(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    f = cfg.param_dtype
    if kind == "decode":
        return {"token": spec((b,))}
    if cfg.modality == "audio":
        d = {"frames": spec((b, l, cfg.d_model), f),
             "mask": spec((b, l), torch.bool)}
        if kind == "train":
            d["labels"] = spec((b, l))
        return d
    if cfg.modality == "vlm":
        lt = l - cfg.num_patches
        d = {"tokens": spec((b, lt)),
             "patch_embeds": spec((b, cfg.num_patches, cfg.d_model), f)}
        if kind == "train":
            d["labels"] = spec((b, lt))
        return d
    d = {"tokens": spec((b, l))}
    if kind == "train":
        d["labels"] = spec((b, l))
    return d

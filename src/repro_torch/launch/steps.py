"""Step builders for the training launcher (port of the training half of
``repro.launch.steps``)."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.tree import flatten, map_with_path


def make_train_step(cfg: lm.ModelConfig, opt_cfg: AdamWConfig,
                    schedule: Callable, freeze: Optional[Callable] = None):
    """Returns train_step(params, opt_state, batch, step, gen=None) ->
    (params, opt_state, metrics).

    ``batch``: {"tokens", "labels"} (B, L) int64 tensors on the params'
    device, with the modality's inputs ("frames" and "mask" for audio,
    "patch_embeds" for vlm: ``launch.train.to_device``). ``gen`` feeds the random-attention baseline's draws; when
    None, a generator seeded with ``step`` (the reference folds the step
    into its key there). The other kinds read none.
    ``freeze`` is a predicate over a leaf's key path (the reference's
    ``keystr``): True zeroes the leaf's gradient, as the reference does.
    The decoupled weight decay still shrinks a frozen leaf by
    lr * weight_decay * p (visible in f32, lost to rounding in bf16).
    """

    def train_step(params, opt_state, batch, step,
                   gen: Optional[torch.Generator] = None):
        inputs = map_with_path(lambda p, t: t.detach().requires_grad_(
            not (freeze and freeze(p))), params)
        if gen is None and cfg.attn.kind == "random":
            gen = torch.Generator().manual_seed(int(step))
        loss, metrics = lm.loss_fn(inputs, cfg, batch, gen)
        diff = [(p, t) for p, t in flatten(inputs) if t.requires_grad]
        grads = dict(zip((p for p, _ in diff), torch.autograd.grad(
            loss, [t for _, t in diff], allow_unused=True)))

        def grad(path, t):
            g = grads.get(path)     # None: frozen, or no path to the loss
            return torch.zeros_like(t) if g is None else g
        new, opt_state, om = adamw_update(
            params, map_with_path(grad, inputs), opt_state, opt_cfg,
            schedule(step))
        return new, opt_state, {**metrics, **om}

    return train_step


def make_eval_step(cfg: lm.ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = lm.loss_fn(params, cfg, batch)
        return metrics
    return eval_step


def qkv_only_freeze(path: str) -> bool:
    """The paper's limited-attention finetuning (Fig. 4): train only the
    q/k/v projections and the DARKFormer covariance M."""
    keep = ("['wq']", "['wk']", "['wv']", "['m_mat']")
    return not any(k in path for k in keep)


def transplant(src: dict, dst: dict) -> dict:
    """Checkpoint surgery for the paper's scenario, pretrained exact
    attention finetuned under the darkformer kernel: ``dst`` (e.g. fresh
    darkformer params) with every leaf whose key path ``src`` (e.g. the
    exact model's params) shares taken from ``src``. The rest, the
    feature params ``w`` and ``m_mat``, stay as ``dst`` drew them."""
    shared = dict(flatten(src))

    def take(path, t):
        s = shared.get(path)
        if s is None:
            return t
        if s.shape != t.shape:
            raise ValueError(f"{path}: shape {tuple(s.shape)} in the "
                             f"source, {tuple(t.shape)} in the target")
        return s.to(t.device, t.dtype)
    return map_with_path(take, dst)

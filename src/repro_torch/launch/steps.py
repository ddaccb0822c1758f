"""Step builders for the launchers (port of ``repro.launch.steps``):
the train, eval, prefill and decode steps, and the sharded train step
over a mesh.

:func:`make_sharded_train_step` runs the reference's "2d" rules, FSDP
over the DP axes and tensor parallelism over ``model``: params,
gradients and AdamW's μ and ν stay this rank's shards (DTensors placed
by ``parallel.sharding.param_specs`` and ``opt_state_specs``) between
steps and during one. Under ``parallel.tensor_parallel.over_model``
each layer computes this rank's share over ``model``: attention its KV
groups (B5 on (B, G/M·Hg, L, ·)), the MLP its hidden columns, MoE its
experts or their hidden columns, the head its vocab slice with a
vocab-parallel cross-entropy (the (B, L, V) logits never gathered).
Such a leaf keeps its ``model`` shard and is gathered over the DP axes
only where the layer uses it (``parallel.sharding.LocalShard.block``:
a layer's leaves inside its remat unit, so under "full" and "dots" the
recompute gathers them again); a leaf of a block without a tensor
parallel form (the RG-LRU, RWKV-6, attention whose n_kv the axis does
not divide, ``mask_embed``) is gathered whole, as in ZeRO-3. Each
gather's backward reduce-scatters the gradient back to the shard over
the DP axes, averaged with each rank's loss weighted by its share of
the batch; replicated leaves keep the DP all-reduce, and those a rank
uses on its own heads or groups only (qk-norm's scales, the feature
params) are first summed over ``model`` by the forward's
``copy_to_model``. AdamW updates the shards, its clip norm and factored
ν made global. Kernels see plain tensors. Every ``model`` rank of a DP
group runs the same batch rows. The step returns what the unsharded
step returns on the whole batch: MoE's load-balancing term too, from
the router's statistics all-reduced over the DP axes in every MoE layer
(under remat once more in the recompute).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch

from repro_torch.models import layers as ll
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.tree import flatten, map_with_path, tree_map


def _plain_input(t: torch.Tensor, requires_grad: bool):
    t = t.detach().requires_grad_(requires_grad)
    return t, t


def make_grad_fn(cfg: lm.ModelConfig, freeze: Optional[Callable] = None,
                 leaf_input: Callable = _plain_input):
    """Returns grad_fn(params, batch, step, gen=None, loss_scale=None) ->
    (grads, metrics): the loss's gradient at every leaf (zeros where
    ``freeze`` holds or no path reaches the loss), the loss multiplied
    by ``loss_scale`` (a 0-d tensor) when given. Arguments as
    :func:`make_train_step`'s. ``leaf_input(leaf, requires_grad)`` gives
    (what the model reads in the leaf's place, the tensor differentiated):
    the leaf itself, detached, by default."""

    def grad_fn(params, batch, step, gen: Optional[torch.Generator] = None,
                loss_scale: Optional[torch.Tensor] = None):
        pairs = map_with_path(lambda p, t: leaf_input(
            t, not (freeze and freeze(p))), params)
        inputs = tree_map(lambda pr: pr[1], pairs)
        if gen is None and cfg.attn.kind == "random":
            gen = torch.Generator().manual_seed(int(step))
        loss, metrics = lm.loss_fn(tree_map(lambda pr: pr[0], pairs), cfg,
                                   batch, gen)
        if loss_scale is not None:
            loss = loss * loss_scale
        diff = [(p, t) for p, t in flatten(inputs) if t.requires_grad]
        grads = dict(zip((p for p, _ in diff), torch.autograd.grad(
            loss, [t for _, t in diff], allow_unused=True)))

        def grad(path, t):
            g = grads.get(path)     # None: frozen, or no path to the loss
            return torch.zeros_like(t) if g is None else g
        return map_with_path(grad, inputs), metrics

    return grad_fn


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
    grad_fn = make_grad_fn(cfg, freeze)

    def train_step(params, opt_state, batch, step,
                   gen: Optional[torch.Generator] = None):
        grads, metrics = grad_fn(params, batch, step, gen)
        new, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg,
                                          schedule(step))
        return new, opt_state, {**metrics, **om}

    return train_step


def _shard_input(t: torch.Tensor, requires_grad: bool):
    """A DTensor leaf split along some dim as its local shard, which the
    model gathers where it uses it; any other leaf (replicated, or a
    plain full tensor) as itself."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import LocalShard, shard_dims
    local = (t.to_local() if isinstance(t, DTensor) else t).detach()
    local.requires_grad_(requires_grad)
    dims = shard_dims(t)
    return (LocalShard(local, t.device_mesh, dims) if any(dims)
            else local), local


def make_sharded_grad_fn(cfg: lm.ModelConfig, mesh,
                         freeze: Optional[Callable] = None):
    """Returns grad_fn(params, batch, step, gen=None) -> (grads, metrics)
    on every rank of ``mesh``: ``batch`` this rank's shard
    (``parallel.sharding.local_batch``), ``params`` DTensors placed on
    ``mesh`` or full plain tensors. Each rank's loss is weighted by its
    share of the loss denominator summed over the DP axes (the masked
    positions: ``lm.loss_weights``). A leaf that some dim's placement
    splits enters the model as its local shard, gathered where it is
    used, and its gradient comes back as the shard's, reduce-scattered
    and averaged over the DP axes by the gather's backward
    (``parallel.sharding.grad_to_shard``); the other leaves' gradients
    are averaged over the DP axes (``compressed_psum_mean``). So grads
    are this rank's shards of the whole batch's gradients (the whole
    gradient for a replicated or plain leaf), and metrics the whole
    batch's, equal on every rank. MoE's load-balancing term takes the
    router's per-expert means (me, ce) over the whole batch: each MoE
    layer all-reduces them over the DP axes (the ranks hold equal row
    counts), and me keeps this rank's own gradient path, divided by the
    loss scale, so the DP mean of the gradients is the whole batch's."""
    import torch.distributed as dist

    from repro_torch.parallel.compression import compressed_psum_mean
    from repro_torch.parallel.sharding import dp_axes, shard_dims
    from repro_torch.parallel.tensor_parallel import over_model

    local = make_grad_fn(cfg, freeze, leaf_input=_shard_input)
    dp = dp_axes(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_dp = math.prod(sizes[a] for a in dp)

    def grad_fn(params, batch, step, gen: Optional[torch.Generator] = None):
        raw = lm.loss_weights(cfg, batch).sum()
        total = raw.clone()
        for a in dp:
            dist.all_reduce(total, group=mesh.get_group(a))
        # n_dp x this rank's share: the DP mean of the scaled losses is
        # the whole batch's loss
        scale = n_dp * raw.clamp(min=1.0) / total.clamp(min=1.0)

        def whole_batch(me, ce):
            st = torch.stack([me.detach(), ce])
            for a in dp:
                dist.all_reduce(st, group=mesh.get_group(a))
            st = st / n_dp
            return st[0] + (me - me.detach()) / scale, st[1]
        with (ll.moe_balance_over(whole_batch) if cfg.moe is not None
              else contextlib.nullcontext()), over_model(mesh):
            grads, metrics = local(params, batch, step, gen,
                                   loss_scale=scale)
        split = {p for p, t in flatten(params) if any(shard_dims(t))}
        whole = {p: g for p, g in flatten(grads) if p not in split}
        whole, _ = compressed_psum_mean(whole, dp, "none", mesh=mesh)
        grads = map_with_path(lambda p, g: whole.get(p, g), grads)
        metrics, _ = compressed_psum_mean(
            {k: v * scale for k, v in metrics.items()}, dp, "none",
            mesh=mesh)
        return grads, metrics

    return grad_fn


def make_sharded_train_step(cfg: lm.ModelConfig, opt_cfg: AdamWConfig,
                            schedule: Callable, mesh,
                            freeze: Optional[Callable] = None):
    """Returns train_step(params, opt_state, batch, step, gen=None) ->
    (params, opt_state, metrics) over ``mesh`` (a ``DeviceMesh``; every
    rank calls it). ``params`` and ``opt_state`` are DTensor trees
    (``parallel.sharding.place_tree``), ``batch`` this rank's shard.
    :func:`make_sharded_grad_fn` gives this rank's shards of the whole
    batch's gradients, AdamW updates the local shards (its clip norm
    and factored ν global over the mesh), and each new shard goes back
    as a DTensor with its leaf's placements, with no communication: no
    rank holds a whole leaf between steps, and one only while the model
    uses it (module docstring)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import shard_dims

    grad_fn = make_sharded_grad_fn(cfg, mesh, freeze)

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def back(new, old):
        return DTensor.from_local(new, old.device_mesh, old.placements,
                                  run_check=False, shape=old.shape,
                                  stride=old.stride())

    def train_step(params, opt_state, batch, step,
                   gen: Optional[torch.Generator] = None):
        grads, metrics = grad_fn(params, batch, step, gen)
        new_p, new_o, om = adamw_update(
            tree_map(local, params), grads, tree_map(local, opt_state),
            opt_cfg, schedule(step), mesh=mesh,
            dims=tree_map(shard_dims, params))
        return (tree_map(back, new_p, params),
                tree_map(back, new_o, opt_state), {**metrics, **om})

    return train_step


def make_eval_step(cfg: lm.ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = lm.loss_fn(params, cfg, batch)
        return metrics
    return eval_step


def make_prefill_step(cfg: lm.ModelConfig, max_len: int):
    """Returns prefill_step(params, batch) -> (logits, state): the
    whole prompt ``batch["tokens"]`` (B, L) prefilled into a fresh serve
    state of ``max_len`` positions (``lm.prefill``)."""
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch, max_len)
    return prefill_step


def make_decode_step(cfg: lm.ModelConfig):
    """Returns serve_step(params, token, state) -> (logits, state): one
    token (B,) a row (``lm.decode_step``, which advances ``state`` in
    place and returns it)."""
    def serve_step(params, token, state):
        return lm.decode_step(params, cfg, token, state)
    return serve_step


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

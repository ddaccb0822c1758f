"""Training launcher: a thin CLI over the port's train step, data streams
and checkpoint store.

Runs on the GPU through the hand-written kernels by default
(``--use-kernel``, ``--device cuda``); ``--no-use-kernel`` selects the
plain PyTorch path and ``--device cpu`` runs on the CPU. ``--kernel``
switches the attention: the PRF kinds (the kernel path), or exact
softmax attention and the random and constant baselines, which have no
kernel and run plain PyTorch (the random one draws its logits from a
generator seeded with the step). Checkpoints are
``{"params", "opt"}`` in the reference's layout, so either package can
finetune from the other's. The data follow the config's modality:
masked audio frames (hubert-xlarge), or patch embeddings before
``--seq`` text tokens (internvl2-76b). Each unit of layers runs under
the config's remat (``dots`` at full size).

With ``--ckpt-dir`` the loop runs under ``runtime.TrainSupervisor``:
it resumes from the directory's latest checkpoint, checkpoints every
``--ckpt-every`` steps and at the end, restarts from the last
checkpoint when a step fails (``--simulate-failure-at N`` injects one
failure before step N), stops after checkpointing on SIGTERM/SIGINT,
and reports the steps its ``StragglerMonitor`` flagged. A
``--mesh-data`` x ``--mesh-model`` mesh above 1 x 1 runs the ZeRO-3
step of ``launch.steps.make_sharded_train_step`` over the process group
that ``torchrun`` describes (NCCL for ``--device cuda``, gloo for
``cpu``), each rank on its shard of the batch: params are drawn on the
host and placed leaf by leaf, each rank moving only its shard to its
device, and AdamW's state is made as shards, so a device holds its
shards of params, gradients and state by the sharding rules and a
leaf whole only while the model uses it. At 1 x 1 nothing is placed
and no group is made.

Examples:
  # smollm-135m at full width on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 200 --batch 8 --seq 512 --ckpt-dir /tmp/ck

  # the paper's qkv-only finetune from that checkpoint
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --finetune-from /tmp/ck --qkv-only

  # exact softmax attention, the paper's pretraining baseline
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --kernel exact --steps 200 --batch 8 --seq 512 --ckpt-dir /tmp/ex

  # the reduced config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --reduced --device cpu --steps 20 --batch 4 --seq 64

  # hubert-xlarge's masked-frame prediction (512 frames a row)
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
      --steps 4 --batch 8 --seq 512

  # a failure injected at step 6, recovered from step 3's checkpoint
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --reduced --device cpu --steps 12 --ckpt-dir /tmp/ft \
      --ckpt-every 4 --simulate-failure-at 6

  # a (2, 2) mesh of four gloo ranks on the CPU
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch smollm-135m --reduced --device cpu --steps 4 --batch 8 \
      --mesh-data 2 --mesh-model 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt_lib
from repro_torch import configs as cfgs
from repro_torch.data import (C4Mock, SyntheticAudio, SyntheticLM,
                              SyntheticVLM)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.parallel import sharding
from repro_torch.runtime import (PreemptionHandler, StragglerMonitor,
                                 TrainSupervisor)
from repro_torch.tree import tree_map

KINDS = ("exact", "performer", "darkformer", "lfk", "random", "constant")


def make_data(cfg: lm.ModelConfig, args):
    """The batch stream for ``cfg``'s modality: audio frames, or patches
    and ``args.seq`` text tokens a row (num_patches + seq positions),
    or text from ``args.data``."""
    if cfg.modality == "audio":
        return SyntheticAudio(cfg.d_model, args.seq, args.batch,
                              vocab=cfg.vocab, seed=args.seed)
    if cfg.modality == "vlm":
        return SyntheticVLM(cfg.d_model, cfg.num_patches, args.seq,
                            args.batch, cfg.vocab, seed=args.seed)
    if args.data == "c4mock":
        return C4Mock(cfg.vocab, args.seq, args.batch, seed=args.seed)
    return SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: integer arrays (tokens,
    labels) as int64, frames and patches f32, the audio mask bool."""
    def one(a):
        t = torch.from_numpy(a)
        if not (t.is_floating_point() or t.dtype == torch.bool):
            t = t.long()
        return t.to(device)
    return {k: one(v) for k, v in batch.items()}


def make_mesh(data: int, model: int, device: str):
    """The (data, model) mesh over the process group ``torchrun``
    describes (its RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT), or
    over the group the caller made: NCCL for a cuda device, gloo for the
    CPU. Raises when the world size is not data x model."""
    dev = torch.device(device)
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise ValueError(
                f"a {data} x {model} mesh needs {data * model} ranks: run "
                f"under torchrun, or make the process group first")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return mesh_lib.make_local_mesh(data, model, device_type=dev.type)


def main(argv=None, on_step: Optional[Callable[[int], None]] = None) -> dict:
    """Train and print a line per logged step. Returns {"params", "opt",
    "metrics" (the logged steps' metrics, each with its "step" and "ms",
    a step run twice across a restart logged twice), "config",
    "stragglers" (None without ``--ckpt-dir``)}; on a mesh "params" and
    "opt" are DTensor trees. ``on_step`` is called with the step's index
    after each step that ran (a profiler's step hook)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(cfgs.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--kernel", default=None, choices=KINDS,
                    help=f"override the attention kernel "
                         f"({'|'.join(KINDS)})")
    ap.add_argument("--features", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "c4mock"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--finetune-from", default=None,
                    help="checkpoint dir with pretrained params")
    ap.add_argument("--qkv-only", action="store_true",
                    help="paper Fig. 4: train only q/k/v + PRF covariance")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--use-kernel", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="run causal attention through the CUDA kernel "
                         "(on a CPU device its plain version); "
                         "--no-use-kernel selects the plain PyTorch path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = cfgs.get_config(args.arch, reduced=args.reduced)
    if args.kernel:
        cfg = cfgs.darkify(cfg, args.kernel,
                           args.features or cfg.attn.num_features)
    cfg = dataclasses.replace(cfg, use_kernel=args.use_kernel)
    mesh = (make_mesh(args.mesh_data, args.mesh_model, args.device)
            if args.mesh_data * args.mesh_model > 1 else None)
    rank0 = mesh is None or dist.get_rank() == 0

    # under a mesh drawn on the host: no device holds the whole tree
    params = lm.init_params(cfg, seed=args.seed, device=args.device
                            if mesh is None else "cpu")
    if args.finetune_from:
        # checkpoints hold {"params", "opt"}: restore the params only, the
        # finetune starts a fresh optimizer
        wrapped, step0 = ckpt_lib.restore_checkpoint(args.finetune_from,
                                                     {"params": params})
        params = wrapped["params"]
        if rank0:
            print(f"finetuning from {args.finetune_from} @ step {step0}")
    opt_cfg = AdamWConfig(lr=args.lr)
    schedule = cosine_warmup(args.lr, args.warmup, args.steps)
    freeze = steps_lib.qkv_only_freeze if args.qkv_only else None
    if mesh is None:
        opt_state = adamw_init(params, opt_cfg)
        train_step = steps_lib.make_train_step(cfg, opt_cfg, schedule,
                                               freeze)
    else:
        pspecs = sharding.param_specs(params, mesh, moe=cfg.moe is not None,
                                      overrides=cfg.sharding_overrides)
        opt_shapes = adamw_init(tree_map(
            lambda t: t.to("meta"), params), opt_cfg)
        params = sharding.place_tree(params, sharding.make_shardings(
            pspecs, mesh))
        opt_state = sharding.zeros_placed(opt_shapes, sharding.make_shardings(
            sharding.opt_state_specs(opt_shapes, pspecs, mesh), mesh))
        train_step = steps_lib.make_sharded_train_step(
            cfg, opt_cfg, schedule, mesh, freeze)
    data = make_data(cfg, args)

    metrics_log = []

    def step_fn(state, step):
        batch = data.batch(step)
        if mesh is not None:
            batch = sharding.local_batch(batch, mesh)
        batch = to_device(batch, args.device)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(state["params"],
                                                state["opt"], batch, step)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}   # synchronises
            m["step"] = step
            m["ms"] = (time.perf_counter() - t0) * 1e3
            metrics_log.append(m)
            if rank0:
                print(f"step {step:5d} loss {m['loss']:.4f} "
                      f"acc {m['accuracy']:.4f} gnorm "
                      f"{m['grad_norm']:.3f} {m['ms']:.1f} ms", flush=True)
        if on_step is not None:
            on_step(step)
        return {"params": params, "opt": opt_state}

    # held in a list the runs pop from, so that no name here keeps the
    # first state once a step has replaced it (a second copy of params
    # and AdamW state does not fit the card at full size)
    first = [{"params": params, "opt": opt_state}]
    del params, opt_state
    stragglers = None
    t_start = time.perf_counter()
    if args.ckpt_dir:
        sup = TrainSupervisor(args.ckpt_dir, ckpt_every=args.ckpt_every,
                              monitor=StragglerMonitor(),
                              preemption=PreemptionHandler())
        try:
            state = sup.run(first.pop(), step_fn, args.steps,
                            fail_at=args.simulate_failure_at)
        finally:
            sup.preemption.restore()
        stragglers = sup.monitor.straggler_steps
        if stragglers and rank0:
            print(f"stragglers flagged: {stragglers}")
    else:
        state = first.pop()
        for step in range(args.steps):
            state = step_fn(state, step)
    dt = time.perf_counter() - t_start
    if rank0:
        print(f"done: {args.steps} steps in {dt:.1f}s "
              f"({args.steps / dt:.2f} steps/s)")
    if args.metrics_out and rank0:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_log, f, indent=1)
    return {"params": state["params"], "opt": state["opt"],
            "metrics": metrics_log, "config": cfg,
            "stragglers": stragglers}


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the ZeRO-3 train step's extra time goes on one rank, beside the
plain step.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_zero_profile.py
    python3 scripts/torch_zero_profile.py --device cpu --reduced  # rehearsal

Makes a single-rank process group (NCCL on the card, gloo on the CPU)
and ``make_local_mesh(1, 1)``, then runs smollm-135m at full width
(random weights from seed 0, kernel on, remat "dots", SyntheticLM
batches of 8 x 512, lr 3e-4) through ``launch.steps.make_train_step``
and through ``make_sharded_train_step`` on DTensor params and AdamW
state: WARM steps each, then ACTIVE steps each under ``torch.profiler``.
Prints the card's name and power limit and one JSON line a side: the
host-clock ms a step, the device's busy ms a step (the union of the
kernels' device intervals) and idle share, the kernel launches a step,
and, for the sharded side, the host ms and calls a step inside the
gather (``LocalShard.full``), its all-gathers, the gradient's way back
(``grad_to_shard``) and its reduce-scatters, and the top host ops by
self time. Imports neither JAX nor the reference.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WARM, ACTIVE, TOP = 2, 2, 20
# (profiler range, object, attribute) wrapped on the sharded side
RANGES = (("zero.gather", "LocalShard", "full"),
          ("zero.all_gather", None, "_all_gather"),
          ("zero.grad_to_shard", None, "grad_to_shard"),
          ("zero.reduce_scatter", None, "_reduce_scatter"))


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


@contextlib.contextmanager
def ranged():
    """Each of ``RANGES``' functions in ``parallel.sharding`` wrapped in a
    profiler range of its name (``grad_to_shard`` is looked up at call
    time by the gather's backward, the others by their callers)."""
    import torch
    from repro_torch.parallel import sharding

    saved = []
    for name, owner, attr in RANGES:
        obj = getattr(sharding, owner) if owner else sharding
        plain = getattr(obj, attr)

        def wrap(*args, _plain=plain, _name=name):
            with torch.profiler.record_function(_name):
                return _plain(*args)
        saved.append((obj, attr, plain))
        setattr(obj, attr, wrap)
    try:
        yield
    finally:
        for obj, attr, plain in saved:
            setattr(obj, attr, plain)


def profile_side(torch, step, params, opt, batches, cuda: bool,
                 wrap: bool) -> dict:
    """WARM steps, then ACTIVE profiled ones: the JSON fields."""
    from torch.profiler import ProfilerActivity, profile

    p, o = params, opt
    for i in range(WARM):
        p, o, m = step(p, o, batches[i], i)
        float(m["loss"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with (ranged() if wrap else contextlib.nullcontext()), \
            profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(WARM, WARM + ACTIVE):
            p, o, m = step(p, o, batches[i], i)
            float(m["loss"])                     # synchronises
        wall = (time.perf_counter() - t0) * 1e3 / ACTIVE
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in kernels]) / 1e3 / ACTIVE
    out = {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
           "device_idle_share": (1 - busy / wall) if kernels else None,
           "kernel_launches_per_step": len(kernels) / ACTIVE,
           "loss": float(m["loss"])}
    if wrap:
        # the host's ranges only: a range that launched kernels has a
        # device-side annotation of the same name too
        host = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CPU]
        out["ranges_per_step"] = {
            name: {"host_ms": sum(e.cpu_time_total for e in host
                                  if e.name == name) / 1e3 / ACTIVE,
                   "calls": sum(e.name == name for e in host) / ACTIVE}
            for name, _, _ in RANGES}
    top = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    out["top_host_ops_self_ms_per_step"] = [
        [a.key, a.self_cpu_time_total / 1e3 / ACTIVE, a.count / ACTIVE]
        for a in top[:TOP]]
    return out


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel import (local_batch, make_shardings,
                                      opt_state_specs, param_specs,
                                      place_tree)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)
    cuda = args.device != "cpu"
    if cuda:
        if not torch.cuda.is_available():
            print("torch_zero_profile: no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device(args.device)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        dist.init_process_group("nccl" if cuda else "gloo",
                                store=dist.FileStore(f"{tmp}/store", 1),
                                rank=0, world_size=1)
        try:
            mesh = make_local_mesh(1, 1, device_type=dev.type)
            cfg = configs.get_config("smollm-135m", reduced=args.reduced,
                                     use_kernel=True, remat="dots")
            params = lm.init_params(cfg, seed=0, device=dev)
            opt_cfg = AdamWConfig(lr=3e-4)
            opt = adamw_init(params, opt_cfg)
            data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
            batches = [to_device(local_batch(data.batch(i), mesh), dev)
                       for i in range(WARM + ACTIVE)]
            res = {"config": cfg.name, "remat": cfg.remat,
                   "batch": args.batch, "seq": args.seq,
                   "warm": WARM, "profiled_steps": ACTIVE}
            res["plain"] = profile_side(
                torch, steps.make_train_step(cfg, opt_cfg, constant(3e-4)),
                params, opt, batches, cuda, False)
            pspecs = param_specs(params, mesh,
                                 overrides=cfg.sharding_overrides)
            sp = place_tree(params, make_shardings(pspecs, mesh))
            so = place_tree(opt, make_shardings(
                opt_state_specs(opt, pspecs, mesh), mesh))
            res["sharded"] = profile_side(
                torch, steps.make_sharded_train_step(
                    cfg, opt_cfg, constant(3e-4), mesh),
                sp, so, batches, cuda, True)
        finally:
            dist.destroy_process_group()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

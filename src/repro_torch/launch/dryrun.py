"""Multi-pod dry-run as a spec-and-bytes report: for every (arch x shape x
mesh) cell, what each rank of the deployment mesh would hold.

The reference's dry-run (``repro.launch.dryrun``) lowers and compiles
each cell ahead of time with XLA on 512 placeholder devices and reads
the compiler's memory, cost and collective analyses. PyTorch has no
ahead-of-time compile of a sharded step, so this report compiles
nothing. Instead, for each cell on the pod (16, 16) and the multi-pod
(2, 16, 16) mesh (``launch.mesh.AbstractMesh``: names and sizes, no
process group):

  * every leaf is a ``meta`` tensor (shape and type, no storage): the
    params from :func:`param_shapes` (``lm.init_params`` walked on the
    ``meta`` device), the AdamW state from ``adamw_init`` of those
    (factored second moment above 1e11 params, as the reference's), the
    batch from ``configs.input_specs`` and, for decode cells, the serve
    state from ``lm.init_serve_state`` in the reference's unit/rem
    layout;
  * each leaf's partition spec comes from the port's rules
    (``parallel.param_specs``/``opt_state_specs``/``batch_specs``/
    ``serve_state_specs``), and each rank's bytes are its shard's;
  * a cell ``configs.cell_supported`` rejects is written as skipped,
    with the reason.

It reports the parameter count and the per-rank bytes of params,
optimizer state (train cells), batch and serve state (decode cells):
what the port's sharded train step (``launch.steps.
make_sharded_train_step``) and mesh engine (``ServingEngine(mesh=)``)
hold on each rank between steps (tests/test_torch_zero.py holds both
to it), not what a step gathers while it runs.
The reference's flops, bytes-accessed, collective and compile fields
come from XLA's analyses: they are absent here, not zero, and
``--probe`` (the reference's unrolled cost probe) is refused. One JSON a
cell goes under ``--outdir`` (``experiments/dryrun_torch/``, never the
reference's ``experiments/dryrun/``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as cfgs
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import sharding
from repro_torch.tree import flatten

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
# the reference's fields from XLA's analyses, which this report lacks
ABSENT = ("flops", "bytes_accessed", "cost", "memory", "collectives",
          "hlo_bytes", "lower_s", "compile_s")
_META = torch.device("meta")


class _OnMeta(TorchDispatchMode):
    """Every op that takes a ``device`` makes its tensor on ``meta``, so
    draws and factories allocate nothing (``trunc_normal_`` and the other
    samplers return a ``meta`` tensor as it is)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = _META
        return func(*args, **kwargs)


def param_shapes(cfg: lm.ModelConfig) -> dict:
    """``lm.init_params(cfg)``'s tree with ``meta`` leaves: every shape
    and type, nothing allocated or drawn."""
    with _OnMeta():
        return lm.init_params(cfg, device=_META)


def rank_bytes(tree, specs, mesh) -> int:
    """The bytes one rank holds of ``tree`` placed by ``specs``: each
    leaf's shard (every spec divides its dims: ``param_specs`` and the
    others drop a split that does not)."""
    sizes = sharding._sizes(mesh)
    spec_of = dict(sharding._leaves_with_path(specs))
    total = 0
    for path, t in sharding._leaves_with_path(tree):
        spec = tuple(spec_of[path]) + (None,) * t.ndim
        n = 1
        for dim, ax in zip(t.shape, spec):
            axes = () if ax is None else ax if isinstance(ax, tuple) \
                else (ax,)
            n *= dim // math.prod(sizes[a] for a in axes)
        total += n * t.element_size()
    return total


def cell_config(arch: str, kernel: str, remat: str = "dots",
                pin_moe: bool = False, mesh=None) -> lm.ModelConfig:
    """The full config of ``arch`` under ``kernel`` and ``remat``; with
    ``pin_moe`` its MoE ``dispatch_spec`` on ``mesh``'s axes."""
    cfg = cfgs.get_config(arch)
    if kernel:
        cfg = cfgs.darkify(cfg, kernel, cfg.attn.num_features)
    cfg = dataclasses.replace(cfg, remat=remat)
    if pin_moe and cfg.moe is not None:
        eax = ("model" if cfg.moe.num_experts % mesh.shape["model"] == 0
               else None)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_spec=(sharding.dp_axes(mesh), eax)))
    return cfg


def build_cell(arch: str, shape_name: str, mesh, kernel: str,
               remat: str = "dots", preset: str = "2d",
               shard_features: bool = False, pin_moe: bool = False,
               params=None) -> dict:
    """The cell's report (without its status): the reference's meta
    fields, the parameter count and ``bytes_per_rank``; {"skipped":
    reason} where ``cell_supported`` says no. ``params``: the arch's
    :func:`param_shapes` when the caller has them."""
    cfg = cell_config(arch, kernel, remat, pin_moe, mesh)
    ok, why = cfgs.cell_supported(cfg, shape_name)
    if not ok:
        return {"skipped": why}
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    pshape = param_shapes(cfg) if params is None else params
    n_params = sum(t.numel() for _, t in flatten(pshape))
    pspecs = sharding.param_specs(pshape, mesh, moe=cfg.moe is not None,
                                  preset=preset,
                                  shard_features=shard_features,
                                  overrides=cfg.sharding_overrides)
    batch = cfgs.input_specs(cfg, shape_name)
    out = {"params": rank_bytes(pshape, pspecs, mesh),
           "batch": rank_bytes(batch, sharding.batch_specs(
               batch, mesh, preset=preset), mesh)}
    factored = None
    if kind == "train":
        factored = n_params > 1e11
        oshape = adamw_init(pshape, AdamWConfig(
            factored_second_moment=factored))
        out["opt_state"] = rank_bytes(
            oshape, sharding.opt_state_specs(oshape, pspecs, mesh), mesh)
    if kind == "decode":
        sshape = lm.init_serve_state(cfg, sh["global_batch"], sh["seq_len"],
                                     stacked=False, device=_META)
        out["serve_state"] = rank_bytes(
            sshape, sharding.serve_state_specs(sshape, mesh), mesh)
    out["total"] = sum(out.values())
    return {"arch": arch, "shape": shape_name, "kind": kind,
            "kernel": cfg.attn.kind, "remat": cfg.remat, "preset": preset,
            "shard_features": shard_features,
            "dispatch_spec": (None if cfg.moe is None
                              else cfg.moe.dispatch_spec),
            "mesh": mesh.shape, "param_count": n_params,
            "seq_len": sh["seq_len"], "global_batch": sh["global_batch"],
            "factored_second_moment": factored, "bytes_per_rank": out}


def run_cell(arch: str, shape_name: str, mesh_name: str, kernel: str,
             outdir: str, remat: str = "dots", tag: str = "",
             preset: str = "2d", shard_features: bool = False,
             pin_moe: bool = False, params=None) -> dict:
    """Build the cell's report and write it as JSON under ``outdir``."""
    os.makedirs(outdir, exist_ok=True)
    fname = os.path.join(outdir, f"{arch}__{shape_name}__{mesh_name}"
                         + (f"__{tag}" if tag else "") + ".json")
    mesh = AbstractMesh(*MESHES[mesh_name])
    rec: dict = {}
    try:
        t0 = time.perf_counter()
        rec.update(build_cell(arch, shape_name, mesh, kernel, remat,
                              preset, shard_features, pin_moe, params))
        rec["status"] = "skipped" if "skipped" in rec else "ok"
        rec["report_s"] = time.perf_counter() - t0
        rec["absent"] = list(ABSENT)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=cfgs.ARCHS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--kernel", default="darkformer")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="refused: the reference's cost probe reads XLA's "
                         "cost analysis of compiled unrolled stacks, which "
                         "PyTorch has no counterpart of")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--preset", default="2d", choices=["2d", "fsdp"])
    ap.add_argument("--shard-features", action="store_true")
    ap.add_argument("--pin-moe", action="store_true",
                    help="set MoE's dispatch_spec on the mesh's axes "
                         "(recorded; it moves no byte of this report)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    if args.probe:
        raise SystemExit(
            "--probe is refused: the reference's probe extrapolates flops, "
            "bytes accessed and collective bytes from XLA's cost analysis "
            "of compiled unrolled stacks; this report compiles nothing "
            "and writes those fields as absent")

    archs = cfgs.ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    counts = {"ok": 0, "skipped": 0, "error": 0}
    for arch in archs:
        params = None
        for shape in shapes:
            for mesh_name in meshes:
                t0 = time.perf_counter()
                if params is None:
                    params = param_shapes(cell_config(arch, args.kernel,
                                                      args.remat))
                rec = run_cell(arch, shape, mesh_name, args.kernel,
                               args.outdir, args.remat, args.tag,
                               args.preset, args.shard_features,
                               args.pin_moe, params)
                status = rec.get("status")
                counts[status] = counts.get(status, 0) + 1
                line = (f"[{arch} x {shape} x {mesh_name}] {status} "
                        f"({time.perf_counter() - t0:.1f}s)")
                if status == "ok":
                    b = rec["bytes_per_rank"]
                    line += (f" params={rec['param_count']:.3e}"
                             f" per-rank GB: " + " ".join(
                                 f"{k}={v / 1e9:.3f}" for k, v in b.items()))
                elif status == "skipped":
                    line += f" :: {rec['skipped']}"
                else:
                    line += " :: " + rec.get("error", "")[:200]
                print(line, flush=True)
    print(f"dryrun summary: ok={counts['ok']} "
          f"skipped={counts['skipped']} errors={counts['error']}")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Gloo ranks for the port's multi-rank tests (not collected): spawned
processes on a ``FileStore`` under the test's tmp_path, each running one
worker function of this module, which imports torch and the port only
(the reference runs in the test process).

:func:`run_ranks` starts ``world`` ranks, joins them within a time limit
of its own and kills them on expiry (a dead gloo rank would otherwise
hang its peers until the suite's clock runs out), then returns each
rank's result. Workers return a picklable tree of tensors and numbers.
"""
import os
import time
import traceback
import uuid

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_S = 120


def _entry(fn, rank, world, store, out, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        res = fn(rank, world, *args)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_ranks(fn, world, tmp_path, *args, timeout=JOIN_S):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns
    the list of their results, by rank."""
    out = tmp_path / f"ranks-{uuid.uuid4().hex[:8]}"
    out.mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(
        fn, r, world, str(out / "store"), str(out), args))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = {r: (out / f"rank{r}.err").read_text() for r in range(world)
            if (out / f"rank{r}.err").exists()}
    assert not errs, "\n".join(f"rank {r}:\n{e}" for r, e in errs.items())
    assert not hung, f"ranks {hung} still running after {timeout} s: killed"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def rank_grads(rank):
    """Rank ``rank``'s gradient tree for the compression checks."""
    rng = np.random.default_rng(100 + rank)
    return {"a": torch.from_numpy(rng.standard_normal(4).astype(np.float32)),
            "b": {"c": torch.from_numpy(
                rng.standard_normal((3, 5)).astype(np.float32))}}


def rank_feedback(rank):
    rng = np.random.default_rng(200 + rank)
    return {"a": torch.from_numpy(
        (0.01 * rng.standard_normal(4)).astype(np.float32)),
            "b": {"c": torch.from_numpy(
                (0.01 * rng.standard_normal((3, 5))).astype(np.float32))}}


def sp_inputs(l=64, m=8, dv=4):
    rng = np.random.default_rng(7)
    kf = np.exp(rng.standard_normal((l, m)).astype(np.float32) * 0.3)
    v = rng.standard_normal((l, dv)).astype(np.float32)
    return torch.from_numpy(kf), torch.from_numpy(v)


def w_collectives(rank, world, shape):
    """Compression (each method), int8 error feedback over 64 steps, the
    sequence-parallel combine over the data axis, and a mesh whose size
    is not the world's."""
    from repro_torch.core.linear_attention import (
        LinearState, sequence_parallel_state_combine)
    from repro_torch.launch.mesh import make_local_mesh, make_mesh_for_shape
    from repro_torch.parallel import compressed_psum_mean

    mesh = make_local_mesh(*shape, device_type="cpu")
    g = rank_grads(rank)
    res = {"coord": (mesh.get_local_rank(0), mesh.get_local_rank(1))}
    for method in ("none", "bf16"):
        res[method], _ = compressed_psum_mean(g, ("data",), method,
                                              mesh=mesh)
    res["int8"] = compressed_psum_mean(g, ("data",), "int8",
                                       rank_feedback(rank), mesh=mesh)
    g_const = {"g": torch.linspace(-1.0, 1.0, 4)}
    eb = {"g": torch.zeros(4)}
    tot = torch.zeros(4)
    for _ in range(64):
        o, eb = compressed_psum_mean(g_const, ("data",), "int8", eb,
                                     mesh=mesh)
        tot = tot + o["g"]
    res["ef_mean"] = tot / 64
    kf, v = sp_inputs()
    n, i = shape[0], mesh.get_local_rank(0)
    rows = kf.shape[0] // n
    kb, vb = kf[i * rows:(i + 1) * rows], v[i * rows:(i + 1) * rows]
    part = LinearState(kb.T @ vb, kb.sum(0))
    res["sp"] = sequence_parallel_state_combine(part,
                                                mesh.get_group("data"))
    try:
        make_mesh_for_shape((world - 1, 1), ("data", "model"),
                            device_type="cpu")
        res["mesh_raise"] = None
    except ValueError as e:
        res["mesh_raise"] = str(e)
    return res


def step_batch(cfg, b=8, seq=16):
    """The whole numpy batch of the sharded-step checks: the port's
    stream for ``cfg``'s modality, text labels partly masked (-1) so the
    ranks' loss denominators differ."""
    from repro_torch.launch import train

    class Args:
        batch, data, seed = b, "synthetic", 1
    Args.seq = seq
    batch = dict(train.make_data(cfg, Args).batch(0))
    if cfg.modality == "text":
        labels = batch["labels"].copy()
        labels[:3, :5] = -1
        labels[5, :11] = -1
        batch["labels"] = labels
    return batch


def spec_local_shape(shape, spec, sizes):
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = 1
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            n *= sizes[a]
        out.append(dim // n)
    return tuple(out)


def w_sharded_step(rank, world, shape, arch, steps=2):
    """The data-parallel step of ``arch`` (reduced) over a ``shape``
    mesh: the first step's gradients and metrics, the params and
    optimizer state after ``steps`` steps (full values), and each leaf's
    local shape beside the one its spec gives."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten

    cfg = configs.get_config(arch, reduced=True)
    mesh = make_local_mesh(*shape, device_type="cpu")
    params = lm.init_params(cfg, seed=0, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(params, opt_cfg)
    batch = to_device(sharding.local_batch(step_batch(cfg), mesh), "cpu")
    grads, metrics = steps_lib.make_sharded_grad_fn(cfg, mesh)(
        params, batch, 0)
    pspecs = sharding.param_specs(params, mesh, moe=cfg.moe is not None,
                                  overrides=cfg.sharding_overrides)
    ospecs = sharding.opt_state_specs(opt, pspecs, mesh)
    state = {"params": sharding.place_tree(
        params, sharding.make_shardings(pspecs, mesh)),
        "opt": sharding.place_tree(opt, sharding.make_shardings(ospecs,
                                                                mesh))}
    step = steps_lib.make_sharded_train_step(cfg, opt_cfg, constant(1e-3),
                                             mesh)
    for i in range(steps):
        p, o, m = step(state["params"], state["opt"], batch, i)
        state = {"params": p, "opt": o}
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    specs = dict(flatten({"params": pspecs, "opt": ospecs}))
    shapes = {}
    for path, t in flatten(state):
        assert isinstance(t, DTensor), path
        shapes[path] = (tuple(t.to_local().shape),
                        spec_local_shape(tuple(t.shape), specs[path], sizes))
    return {"grads": grads, "metrics": metrics, "last_metrics": m,
            "state": {k: t.full_tensor() for k, t in flatten(state)},
            "shapes": shapes, "batch_rows": int(batch["labels"].shape[0])}


def w_elastic_save(rank, world, ckdir):
    """Reduced smollm-135m's params and AdamW state placed on a (2, 2)
    mesh, saved by every rank (rank 0 writes)."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding

    cfg = configs.get_config("smollm-135m", reduced=True)
    mesh = make_local_mesh(2, 2, device_type="cpu")
    params = lm.init_params(cfg, seed=4, device="cpu")
    opt = adamw_init(params, AdamWConfig(factored_second_moment=True))
    pspecs = sharding.param_specs(params, mesh)
    state = {"params": sharding.place_tree(
        params, sharding.make_shardings(pspecs, mesh)),
        "opt": sharding.place_tree(opt, sharding.make_shardings(
            sharding.opt_state_specs(opt, pspecs, mesh), mesh))}
    ckpt.save_checkpoint(ckdir, 5, state)
    return {"writes": sorted(os.listdir(ckdir)) if os.path.isdir(ckdir)
            else []}


def w_elastic_restore(rank, world, ckdir):
    """The (2, 2) checkpoint restored onto a (2, 1) mesh: full values and
    each leaf's placements."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh_for_shape
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten

    cfg = configs.get_config("smollm-135m", reduced=True)
    mesh = make_mesh_for_shape((2, 1), ("data", "model"),
                               device_type="cpu")
    params = lm.init_params(cfg, seed=9, device="cpu")   # the template
    opt = adamw_init(params, AdamWConfig(factored_second_moment=True))
    target = {"params": params, "opt": opt}
    pspecs = sharding.param_specs(params, mesh)
    shardings = {"params": sharding.make_shardings(pspecs, mesh),
                 "opt": sharding.make_shardings(
                     sharding.opt_state_specs(opt, pspecs, mesh), mesh)}
    placed, step = ckpt.restore_to_shardings(ckdir, target, shardings)
    flat_sh = dict(flatten(shardings))
    return {"step": step,
            "values": {k: t.full_tensor() for k, t in flatten(placed)},
            "placements_ok": all(
                tuple(t.placements) == flat_sh[k].placements
                and t.device_mesh.shape == (2, 1)
                for k, t in flatten(placed))}


def w_preempt_one_rank(rank, world, ckdir, signal_rank, at):
    """The supervisor on every rank, each step an all-reduce of the
    state, with SIGTERM raised on ``signal_rank`` alone inside step
    ``at``: the steps each rank ran, its final state and the checkpoint
    steps on disk."""
    import signal

    from repro_torch import checkpoint as ckpt
    from repro_torch.runtime import PreemptionHandler, TrainSupervisor

    pre = PreemptionHandler()
    ran = []

    def step_fn(state, step):
        ran.append(step)
        if rank == signal_rank and step == at:
            os.kill(os.getpid(), signal.SIGTERM)
        x = state["x"] + 1.0
        dist.all_reduce(x)                  # the step's collective
        return {"x": x / world}
    try:
        out = TrainSupervisor(ckdir, ckpt_every=100, preemption=pre).run(
            {"x": torch.zeros(3)}, step_fn, 20)
    finally:
        pre.restore()
    dist.barrier()                          # rank 0's write is done
    return {"ran": ran, "x": out["x"], "steps": ckpt.all_steps(ckdir),
            "preempted": pre.preempted}


def w_launcher(rank, world, argv):
    """The training launcher on this group's mesh; returns its logged
    metrics and the final state's full values."""
    from repro_torch.launch import train
    from repro_torch.tree import flatten

    out = train.main(argv)
    return {"metrics": out["metrics"],
            "state": {k: t.full_tensor() for k, t in
                      flatten({"params": out["params"],
                               "opt": out["opt"]})}}


# -- the serving half (ServingEngine(mesh=), serve --mesh-*) ---------------

# (arch, kind, overlap) of the engine runs on a mesh; granite-moe's MoE
# layers run with dispatch_spec set on the mesh's axes
SERVE_RUNS = [("smollm-135m", "darkformer", False),
              ("smollm-135m", "darkformer", True),
              ("smollm-135m", "exact", False),
              ("smollm-135m", "exact", True),
              ("granite-moe-3b-a800m", None, True)]


def serve_cfg(arch, kind, mesh=None):
    """The reduced ``arch`` under ``kind`` (None: its own), kernels on
    (their plain versions on the CPU); with ``mesh``, MoE's
    ``dispatch_spec`` on its axes."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.parallel import dp_axes

    cfg = configs.get_config(arch, reduced=True, use_kernel=True)
    if kind:
        cfg = configs.darkify(cfg, kind, cfg.attn.num_features)
    if mesh is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_spec=(dp_axes(mesh), "model")))
    return cfg


def serve_requests(vocab, n=6, seed=0, prefix=(), gap=0.0):
    """``n`` greedy requests with pinned uids (6000 + i), prompts of 4-20
    tokens after ``prefix``, 3-8 new tokens, request i arriving at
    ``i * gap`` s."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    return [Request(prompt=list(prefix) + rng.integers(
        0, vocab, int(rng.integers(4, 21))).tolist(),
        max_new_tokens=int(rng.integers(3, 9)), uid=6000 + i,
        arrival_time=i * gap)
        for i in range(n)]


# timed arrivals: one every ARRIVAL_GAP s on a clock that reads CLOCK_DT
# s more at each reading; rank r of the mesh engine runs its clock
# 1 + r * CLOCK_DRIFT times as fast as the first rank's
ARRIVAL_GAP, CLOCK_DT, CLOCK_DRIFT = 0.3, 0.05, 0.5


def reading_clock(eng, rate=1.0):
    """Give ``eng`` a clock that reads ``rate * CLOCK_DT`` more at each
    reading: a deterministic stand-in for wall time, on which ranks with
    different rates disagree about the step a request arrives in."""
    import itertools

    n = itertools.count()
    eng._t0 = 0.0                  # run()'s clock jumps then change nothing
    eng._now = lambda: next(n) * CLOCK_DT * rate
    return eng


def serve_streams(params, cfg, *, overlap=False, mesh=None, cache=None,
                  reqs=None, slots=3, engine=None):
    """{uid: tokens} of ``reqs`` (default :func:`serve_requests`) through
    a ``ServingEngine`` on the CPU (or through ``engine``)."""
    from repro_torch.serving import ServingEngine

    eng = engine or ServingEngine(
        params, cfg, max_slots=slots, max_len=64, chunk_tokens=8, seed=0,
        overlap=overlap, mesh=mesh, prefix_cache=cache, device="cpu")
    for r in reqs or serve_requests(cfg.vocab):
        eng.submit(r)
    return {r.uid: list(r.tokens) for r in eng.run()}


def placement_report(tree, mesh):
    """[(path, placements as its serve_state_specs say, each local
    shape as its spec gives)] for each leaf of a DTensor serve-state
    tree: every entry should read (path, True, True)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import (make_shardings, serve_state_specs,
                                      sharding)
    want = dict(sharding._leaves_with_path(make_shardings(
        serve_state_specs(tree, mesh), mesh)))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for path, t in sharding._leaves_with_path(tree):
        ok = isinstance(t, DTensor) and \
            tuple(t.placements) == want[path].placements
        local = ok and tuple(t.to_local().shape) == spec_local_shape(
            tuple(t.shape), want[path].spec, sizes)
        out.append((path, ok, local))
    return out


def w_serve_mesh(rank, world, shape):
    """Every run of :data:`SERVE_RUNS` through an engine on a ``shape``
    mesh: its streams and both pools' placement reports after the run;
    then the snapshot round trip: a primed cache-on engine (darkformer,
    and exact on paged KV) whose entries are demoted to the host tier
    before the sharers run, so that the mesh-aware promotion serves
    their forks."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.serving import PrefixCacheConfig, Request
    from repro_torch.serving import prefix_cache as pcache
    from repro_torch.serving import ServingEngine

    mesh = make_local_mesh(*shape, device_type="cpu")
    out = {}
    for arch, kind, overlap in SERVE_RUNS:
        cfg = serve_cfg(arch, kind, mesh)
        params = lm.init_params(cfg, seed=0, device="cpu")
        eng = ServingEngine(params, cfg, max_slots=3, max_len=64,
                            chunk_tokens=8, seed=0, overlap=overlap,
                            mesh=mesh, device="cpu")
        out[(arch, kind, overlap)] = {
            "streams": serve_streams(params, cfg, engine=eng),
            "placements": placement_report(eng.pool, mesh)
            + placement_report(eng.staging, mesh)}
    # timed arrivals on clocks that disagree across ranks
    cfg = serve_cfg("smollm-135m", "darkformer")
    params = lm.init_params(cfg, seed=0, device="cpu")
    for overlap in (False, True):
        eng = reading_clock(ServingEngine(
            params, cfg, max_slots=3, max_len=64, chunk_tokens=8, seed=0,
            overlap=overlap, mesh=mesh, device="cpu"),
            1 + rank * CLOCK_DRIFT)
        reqs = serve_requests(cfg.vocab, gap=ARRIVAL_GAP)
        streams = serve_streams(params, cfg, engine=eng, reqs=reqs)
        out[("timed", overlap)] = {"streams": streams,
                                   "steps": eng.stats["decode_steps"]}
    # MoE's pin on DTensor (B, E, C, d) buffers: placements and values
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.models import layers
    moe = serve_cfg("granite-moe-3b-a800m", None, mesh).moe
    x = torch.arange(4 * 4 * 2 * 3, dtype=torch.float32).reshape(4, 4, 2, 3)
    xd = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)
    pins = [layers._pin(xd, moe, e) for e in (True, False)]
    out["pin"] = {"placements": [[str(p) for p in t.placements]
                                 for t in pins],
                  "equal": all(torch.equal(t.full_tensor(), x)
                               for t in pins),
                  "plain_is_identity": layers._pin(x, moe, True) is x}
    pc = PrefixCacheConfig(block_tokens=8, page_size=8)
    for kind in ("darkformer", "exact"):
        cfg = serve_cfg("smollm-135m", kind)
        params = lm.init_params(cfg, seed=0, device="cpu")
        prefix = np.random.default_rng(42).integers(0, cfg.vocab,
                                                    16).tolist()
        eng = ServingEngine(params, cfg, max_slots=4, max_len=64,
                            chunk_tokens=8, seed=0, mesh=mesh,
                            prefix_cache=pc, device="cpu")
        serve_streams(params, cfg, engine=eng, reqs=[Request(
            prompt=prefix + [1, 2, 3], max_new_tokens=2, uid=5999)])
        ents = list(eng.prefix_cache._entries.values())
        for ent in ents:
            ent.state = pcache.snapshot_to_host(ent.state)
            ent.on_host = True
        streams = serve_streams(params, cfg, engine=eng,
                                reqs=serve_requests(cfg.vocab, 6, 7,
                                                    prefix))
        promoted = [e.state for e in ents if not e.on_host]
        out[("snapshot", kind)] = {
            "streams": streams, "stats": eng.stats,
            "promoted": [placement_report(s, mesh) for s in promoted],
            "pages_replicated": eng._pages is None or all(
                all(p.is_replicate() for p in t.placements)
                for t in eng._pages.values())}
    return out


def w_serve_cli(rank, world, argv):
    """``serve.main(argv)`` on this group: each request's tokens, by
    uid order (the order the CLI submitted them)."""
    from repro_torch.launch import serve

    st = serve.main(argv)
    return {"tokens": [r.tokens for r in sorted(st["results"],
                                                key=lambda r: r.uid)],
            "paths": (st["prefill_path"], st["decode_path"])}

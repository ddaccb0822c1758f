"""Gloo-rank workers of tests/test_torch_tp.py (not collected): tensor
parallelism over ``model`` in the sharded train step and the mesh
engine, and the model-major placement of a dim split over ("model",
"data"). Workers import torch and the port only;
``_torch_dist.run_ranks`` spawns them.
"""
import dataclasses

import numpy as np
import torch

import _torch_dist as td
import _torch_zero_ranks as zr

LR = 1e-3
# name: (arch, config overrides; "moe" as MoEConfig keyword arguments),
# each held against the reference's step and the port's unsharded one
TRAIN_RUNS = {
    "granite-8b": ("granite-8b", {}),
    "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
    # 3 experts do not divide a 2-rank model axis: each expert's hidden
    # dim is split instead (the rule tables' fallback)
    "qwen3-moe-e3": ("qwen3-moe-235b-a22b",
                     {"moe": dict(num_experts=3, top_k=2, d_ff=32)}),
    "granite-moe": ("granite-moe-3b-a800m", {}),
}
# (arch, kind) of the engine runs
# (smollm-135m's 3 KV groups keep its attention whole at M = 2)
ENGINE_RUNS = [("granite-8b", "darkformer"), ("granite-8b", "exact"),
               ("qwen3-moe-235b-a22b", "darkformer"),
               ("smollm-135m", "darkformer")]
ROWS, PROMPT, DECODES = 2, 11, 3


def overrides(name, moe_cls):
    ov = dict(TRAIN_RUNS[name][1])
    if "moe" in ov:
        ov["moe"] = moe_cls(**ov["moe"])
    return ov


def train_cfg(name):
    """The port's reduced config of a train run: remat "dots" (the
    gathers inside the unit), the kernels on (B5's plain version on the
    CPU)."""
    from repro_torch import configs
    from repro_torch.models.layers import MoEConfig
    arch, _ = TRAIN_RUNS[name]
    return configs.get_config(arch, reduced=True, remat="dots",
                              use_kernel=True,
                              **overrides(name, MoEConfig))


class Recorder:
    """Wraps a kernel wrapper of ``repro_torch.kernels``: each call's
    group count (dim 1 of its first argument) before calling it."""

    def __init__(self, name):
        from repro_torch import kernels
        self.name, self.groups = name, []
        self._fn = getattr(kernels, name)
        setattr(kernels, name, self)

    def __call__(self, *args, **kw):
        self.groups.append(int(args[0].shape[1]))
        return self._fn(*args, **kw)

    def restore(self):
        from repro_torch import kernels
        setattr(kernels, self.name, self._fn)


def resident(tree) -> int:
    """The bytes this rank holds of a DTensor tree (its local shards),
    NamedTuple serve states included."""
    from repro_torch.parallel import sharding
    return sum(t.to_local().numel() * t.element_size()
               for _, t in sharding._leaves_with_path(tree))


def _grads_of(cfg, mesh, p, batch):
    from repro_torch.launch import steps as steps_lib
    from repro_torch.tree import flatten
    grads, metrics = steps_lib.make_sharded_grad_fn(cfg, mesh)(p, batch, 0)
    return dict(flatten(grads)), {k: float(v) for k, v in metrics.items()}


def train_run(mesh, name, params_np, whole):
    """One TP step of run ``name`` from the reference's params: this
    rank's gradient shards and metrics (the grad fn alone), its param
    shards and metrics after one train step, each leaf's split dims,
    B5's group counts and the gauge; for qk-norm configs also the
    q_norm gradients with the model sum dropped (the planted fault)."""
    from repro_torch import bridge
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import to_device
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel import sharding
    from repro_torch.parallel import tensor_parallel as tpl
    from repro_torch.tree import flatten

    cfg = train_cfg(name)
    params = bridge.params_from_jax(params_np, cfg, device="cpu")
    opt_cfg = AdamWConfig(lr=LR)
    p, o, _, _ = zr._place(params, adamw_init(params, opt_cfg), mesh, cfg)
    dims = {k: sharding.shard_dims(t) for k, t in flatten(p)}
    batch = to_device(sharding.local_batch(whole, mesh), "cpu")
    rec = Recorder("linear_attention_causal")
    try:
        sharding.GAUGE.reset()
        grads, metrics = _grads_of(cfg, mesh, p, batch)
        gauge = {"gathers": sharding.GAUGE.gathers,
                 "over_model": sharding.GAUGE.over_model,
                 "peak": sharding.GAUGE.peak}
        step = steps_lib.make_sharded_train_step(cfg, opt_cfg,
                                                 constant(LR), mesh)
        p1, _, m1 = step(p, o, batch, 0)
    finally:
        rec.restore()
    out = {"grads": grads, "metrics": metrics, "dims": dims,
           "coord": {a: mesh.get_local_rank(i)
                     for i, a in enumerate(mesh.mesh_dim_names)},
           "params": {k: t.to_local() for k, t in flatten(p1)},
           "step_metrics": {k: float(v) for k, v in m1.items()},
           "b5_groups": sorted(set(rec.groups)), "gauge": gauge}
    if cfg.qk_norm:
        right = tpl.shared
        tpl.shared = lambda leaf, ax: sharding.gathered(leaf)
        try:
            faulty, _ = _grads_of(cfg, mesh, p, batch)
        finally:
            tpl.shared = right
        out["q_norm_fault"] = {k: g for k, g in faulty.items()
                               if "q_norm" in k}
    return out


def engine_cfg(arch, kind):
    from repro_torch import configs
    cfg = configs.get_config(arch, reduced=True, use_kernel=True)
    return configs.darkify(cfg, kind, cfg.attn.num_features)


def engine_run(mesh, arch, kind, params_np, toks_np):
    """The mesh engine of ``arch`` under ``kind`` from the reference's
    params: greedy streams of ``_torch_dist.serve_requests``, B1's and
    B2's group counts, the gauge, the resident bytes of params and
    pools against ``dryrun.rank_bytes``; then the engine's params and
    projections through one prefill chunk of ``toks_np`` and
    ``DECODES`` decode steps from a fresh state placed as the pools
    are: each step's logits."""
    from repro_torch import bridge
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    from repro_torch.parallel.tensor_parallel import over_model
    from repro_torch.serving import ServingEngine

    cfg = engine_cfg(arch, kind)
    params = bridge.params_from_jax(params_np, cfg, device="cpu")
    recs = [Recorder("fused_prf_decode"), Recorder("fused_prf_prefill")]
    try:
        sharding.GAUGE.reset()
        eng = ServingEngine(params, cfg, max_slots=3, max_len=64,
                            chunk_tokens=8, seed=0, mesh=mesh,
                            device="cpu")
        streams = td.serve_streams(params, cfg, engine=eng)
        gauge = {"gathers": sharding.GAUGE.gathers,
                 "over_model": sharding.GAUGE.over_model}
        pspecs = sharding.param_specs(params, mesh, moe=cfg.moe is not None,
                                      overrides=cfg.sharding_overrides)
        pool = lm.init_serve_state(cfg, b=3, max_len=64, per_slot=True,
                                   device="meta")
        held = {"params": resident(eng.params),
                "serve_state": resident(eng.pool)}
        want = {"params": dryrun.rank_bytes(params, pspecs, mesh),
                "serve_state": dryrun.rank_bytes(
                    pool, sharding.serve_state_specs(pool, mesh), mesh)}
        state = lm.init_serve_state(cfg, b=ROWS, max_len=64, per_slot=True,
                                    device="cpu")
        state = sharding.model_local(state, sharding.make_shardings(
            sharding.serve_state_specs(state, mesh), mesh))
        logits = []
        with over_model(mesh):
            lg, state = lm.prefill_chunk(
                eng._step_params, cfg,
                {"tokens": torch.from_numpy(toks_np[:, :PROMPT]).long()},
                state, proj=eng._proj)
            logits.append(lg)
            for i in range(DECODES):
                lg, state = lm.decode_step(
                    eng._step_params, cfg,
                    torch.from_numpy(toks_np[:, PROMPT + i]).long(), state,
                    proj=eng._proj)
                logits.append(lg)
    finally:
        for r in recs:
            r.restore()
    return {"streams": streams, "logits": logits, "gauge": gauge,
            "held": held, "rank_bytes": want,
            "b1_groups": sorted(set(recs[0].groups)),
            "b2_groups": sorted(set(recs[1].groups)),
            "paths": (eng.stats["prefill_path"], eng.stats["decode_path"])}


def w_tp(rank, world, shape, train_np, engine_np, whole):
    """Every train run (``train_np``: {name: reference params as numpy})
    and every engine run (``engine_np``: {(arch, kind): (params,
    tokens)}) on a ``shape`` mesh."""
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(*shape, device_type="cpu")
    out = {}
    for name, params_np in train_np.items():
        out[name] = train_run(mesh, name, params_np, whole[name])
    for (arch, kind), (params_np, toks) in engine_np.items():
        out[(arch, kind)] = engine_run(mesh, arch, kind, params_np, toks)
    out["placement"] = w_placement(rank, world, shape, mesh)
    return out


def w_engine_bytes(rank, world, shape, arch, kind):
    """An engine of reduced ``arch`` under ``kind`` on a ``shape`` mesh
    from the port's seed-0 params, after a short run: its resident bytes
    of params and of the slot pool beside ``dryrun.rank_bytes`` of their
    specs, and the gauge's gathers over ``model``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    from repro_torch.serving import ServingEngine

    mesh = make_local_mesh(*shape, device_type="cpu")
    cfg = engine_cfg(arch, kind)
    params = lm.init_params(cfg, seed=0, device="cpu")
    sharding.GAUGE.reset()
    eng = ServingEngine(params, cfg, max_slots=4, max_len=64,
                        chunk_tokens=8, seed=0, mesh=mesh, device="cpu")
    td.serve_streams(params, cfg, engine=eng,
                     reqs=td.serve_requests(cfg.vocab, 3))
    pool = lm.init_serve_state(cfg, b=4, max_len=64, per_slot=True,
                               device="meta")
    pspecs = sharding.param_specs(params, mesh, moe=cfg.moe is not None,
                                  overrides=cfg.sharding_overrides)
    return {"held": {"params": resident(eng.params),
                     "serve_state": resident(eng.pool),
                     "staging": resident(eng.staging)},
            "rank_bytes": {
                "params": dryrun.rank_bytes(params, pspecs, mesh),
                "serve_state": dryrun.rank_bytes(
                    pool, sharding.serve_state_specs(pool, mesh), mesh)},
            "over_model": sharding.GAUGE.over_model}


def _watched_serve(argv):
    """``serve.main(argv)``, watching what it builds its engine from:
    the tokens by uid, the paths, whether every param handed to the
    engine is a DTensor, their local bytes beside ``dryrun.rank_bytes``,
    and, when the engine is built, how many leaves that ``lm.init_params``
    returned with storage (not ``meta``) are split by their spec, and how
    many of those are still alive (a whole copy beside the shards)."""
    import gc
    import weakref

    from torch.distributed.tensor import DTensor

    from repro_torch.launch import dryrun, serve
    from repro_torch.models import lm
    from repro_torch.tree import flatten

    drawn, seen = {}, {}
    init, engine_cls = lm.init_params, serve.ServingEngine

    def watched_init(*args, **kw):
        out = init(*args, **kw)
        drawn.update((p, weakref.ref(t)) for p, t in flatten(out)
                      if t.device.type != "meta")
        return out

    def watched_engine(params, cfg, **kw):
        from repro_torch.parallel import sharding
        gc.collect()
        mesh = kw["mesh"]
        shapes = dryrun.param_shapes(cfg)
        pspecs = sharding.param_specs(shapes, mesh, moe=cfg.moe is not None,
                                      overrides=cfg.sharding_overrides)
        specs = dict(flatten(pspecs))
        # the leaves a rank holds a part of
        split = [p for p, t in flatten(shapes) if dryrun.rank_bytes(
            {"x": t}, {"x": specs[p]}, mesh) < t.numel() * t.element_size()]
        placed = all(isinstance(t, DTensor) for _, t in flatten(params))
        seen.update(
            placed=placed, held=resident(params) if placed else None,
            rank_bytes=dryrun.rank_bytes(shapes, pspecs, mesh),
            drawn_split=sum(p in drawn for p in split),
            alive_split=sum(p in drawn and drawn[p]() is not None
                            for p in split))
        return engine_cls(params, cfg, **kw)
    lm.init_params, serve.ServingEngine = watched_init, watched_engine
    try:
        st = serve.main(argv)
    finally:
        lm.init_params, serve.ServingEngine = init, engine_cls
    return {"tokens": [r.tokens for r in sorted(st["results"],
                                                key=lambda r: r.uid)],
            "paths": (st["prefill_path"], st["decode_path"]), **seen}


def w_serve_cli_placed(rank, world, runs):
    """Each of ``runs`` ({name: argv}) through :func:`_watched_serve`
    on this group."""
    return {name: _watched_serve(argv) for name, argv in runs.items()}


def tuple_rules():
    """[(regex, spec)] of the param rules that split a dim over a tuple
    of axes."""
    from repro_torch.parallel import sharding
    return [(pat, spec) for pat, spec in sharding._PARAM_RULES
            if any(isinstance(a, tuple) for a in spec)]


def w_placement(rank, world, shape, mesh=None):
    """Every rule of :func:`tuple_rules` on a ``shape`` (data, model)
    mesh: a (6, 8·D·M) leaf placed by its spec's placements; whether
    the block this rank holds after the gather over ``data`` is the
    leaf's contiguous column block m of M, whether DTensor's own
    ``full_tensor`` and the port's gather give the leaf back; and
    reduced granite-8b's wk and wv on a (D, M) mesh through
    ``param_specs``: whether each rank's block is its whole KV groups."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten

    mesh = mesh or make_local_mesh(*shape, device_type="cpu")
    d, m = shape
    md, mm = mesh.get_local_rank(0), mesh.get_local_rank(1)
    out = {"coord": (md, mm)}
    for pat, spec in tuple_rules():
        col = next(i for i, a in enumerate(spec) if isinstance(a, tuple))
        full = torch.arange(6 * 8 * d * m, dtype=torch.float32).reshape(
            (6, 8 * d * m) if col == 1 else (8 * d * m, 6))
        pl = sharding.NamedSharding(mesh, spec).placements
        x = sharding.place(full, mesh, pl)
        shard = sharding.LocalShard(x.to_local(), mesh,
                                    sharding.shard_dims(x))
        n = full.shape[col] // m
        out[pat] = {
            "dims": shard.dims[col],
            "block": torch.equal(shard.block(), full.narrow(col, mm * n, n)),
            "full_tensor": torch.equal(x.full_tensor(), full),
            "gathered": torch.equal(shard.full(), full)}
    cfg = dataclasses.replace(configs.get_config("granite-8b", reduced=True),
                              n_heads=2 * m, n_kv=m)
    params = lm.init_params(cfg, seed=0, device="cpu")
    placed = sharding.place_tree(params, sharding.make_shardings(
        sharding.param_specs(params, mesh), mesh))
    flat, dh = dict(flatten(placed)), cfg.head_dim
    for leaf in ("wk", "wv"):
        path = f"['units']['b0']['attn']['{leaf}']"
        shard = sharding.LocalShard(flat[path].to_local(), mesh,
                                    sharding.shard_dims(flat[path]))
        whole = dict(flatten(params))[path]
        groups = whole.reshape(*whole.shape[:-1], cfg.n_kv, dh)
        mine = shard.block().reshape(*whole.shape[:-1], -1, dh)
        out[leaf] = {"dims": shard.dims[-1],
                     "groups": torch.equal(mine, groups[..., mm:mm + 1, :])}
    return out

"""Gloo-rank workers of tests/test_torch_zero.py (not collected): the
ZeRO-3 train step (``launch.steps.make_sharded_train_step``) on a mesh,
with what each rank holds and gathers. Workers import torch and the port
only; ``_torch_dist.run_ranks`` spawns them.
"""
import dataclasses

import numpy as np
import torch

ARCH_REMAT = "dots"     # the gathers' bound holds under "full" and "dots"


def zero_cfg(arch):
    """The reduced ``arch`` under remat "dots", f32."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(arch, reduced=True),
                               remat=ARCH_REMAT)


def local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import flatten
    return sum(t.to_local().numel() * t.element_size()
               for _, t in flatten(tree) if isinstance(t, DTensor))


def _place(params, opt, mesh, cfg):
    from repro_torch.parallel import sharding
    pspecs = sharding.param_specs(params, mesh, moe=cfg.moe is not None,
                                  overrides=cfg.sharding_overrides)
    ospecs = sharding.opt_state_specs(opt, pspecs, mesh)
    return (sharding.place_tree(params, sharding.make_shardings(pspecs,
                                                                mesh)),
            sharding.place_tree(opt, sharding.make_shardings(ospecs, mesh)),
            pspecs, ospecs)


def _loss_scale(cfg, whole, mesh):
    """This rank's loss scale in the sharded grad fn: n_dp x its share
    of the whole batch's loss denominator."""
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    raw = lm.loss_weights(cfg, to_device(sharding.local_batch(whole, mesh),
                                         "cpu")).sum()
    total = lm.loss_weights(cfg, to_device(whole, "cpu")).sum()
    n_dp = 1
    for a in sharding.dp_axes(mesh):
        n_dp *= mesh.size(mesh.mesh_dim_names.index(a))
    return float(n_dp * raw.clamp(min=1.0) / total.clamp(min=1.0))


def w_zero_step(rank, world, shape, arch, whole, params_np=None,
                opt_np=None, steps=2, lr=1e-3, fault=False):
    """Two ZeRO-3 steps of the reduced ``arch`` (remat "dots") on a
    ``shape`` mesh from ``params_np``/``opt_np`` (numpy trees, e.g. the
    reference's) or from seed 0, on this rank's rows of ``whole``. With
    ``fault`` the gather's backward drops the DP loss weighting (each
    rank's gradient divided by its loss scale before the reduction).
    Returns the full state after the steps, each step's metrics, the
    gathers' gauge a step (peak bytes, gathers), each rank's resident
    bytes of params and AdamW state and ``dryrun.rank_bytes`` of both."""
    from repro_torch import bridge
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten

    cfg = zero_cfg(arch)
    mesh = make_local_mesh(*shape, device_type="cpu")
    params = (bridge.params_from_jax(params_np, cfg, device="cpu")
              if params_np is not None else
              lm.init_params(cfg, seed=0, device="cpu"))
    opt_cfg = AdamWConfig(lr=lr)
    opt = (bridge.tree_from_jax(opt_np, device="cpu") if opt_np is not None
           else adamw_init(params, opt_cfg))
    p, o, pspecs, ospecs = _place(params, opt, mesh, cfg)
    want = {"params": dryrun.rank_bytes(params, pspecs, mesh),
            "opt": dryrun.rank_bytes(opt, ospecs, mesh)}
    del params, opt
    batch = to_device(sharding.local_batch(whole, mesh), "cpu")
    if fault:
        scale = _loss_scale(cfg, whole, mesh)
        right = sharding.grad_to_shard
        sharding.grad_to_shard = lambda g, sh: right(g / scale, sh)
    step = steps_lib.make_sharded_train_step(cfg, opt_cfg, constant(lr),
                                             mesh)
    metrics, gauge, held = [], [], []
    for i in range(steps):
        sharding.GAUGE.reset()
        p, o, m = step(p, o, batch, i)
        metrics.append({k: float(v) for k, v in m.items()})
        gauge.append({"peak": sharding.GAUGE.peak,
                      "gathers": sharding.GAUGE.gathers,
                      "live_after": sharding.GAUGE.live})
        held.append({"params": local_bytes(p), "opt": local_bytes(o)})
    return {"state": {k: t.full_tensor() for k, t in
                      flatten({"params": p, "opt": o})},
            "metrics": metrics, "gauge": gauge, "held": held,
            "rank_bytes": want}


def w_factored_nu(rank, world, shape):
    """AdamW with ``factored_second_moment`` on two leaves placed on a
    ``shape`` mesh, one split along its rows and one along its columns
    over ``data``, two updates from seeded gradients: the full values of
    params and state after each, and the plain update's on the whole
    leaves."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten, tree_map

    mesh = make_local_mesh(*shape, device_type="cpu")
    rng = np.random.default_rng(5)
    cfg = AdamWConfig(lr=1e-2, factored_second_moment=True)
    params = {"rows": torch.from_numpy(
        rng.standard_normal((3, 8, 6)).astype(np.float32)),
        "cols": torch.from_numpy(
            rng.standard_normal((6, 8)).astype(np.float32))}
    grads = [tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(t.shape).astype(np.float32)), params)
        for _ in range(2)]
    opt = adamw_init(params, cfg)
    pl = {"rows": (Shard(1), Replicate()), "cols": (Shard(1), Replicate())}
    row_pl = {"rows": (Shard(1), Replicate()), "cols": (Replicate(),) * 2}
    col_pl = {"rows": (Replicate(),) * 2, "cols": (Shard(0), Replicate())}

    def placed_nu(nu):
        return {k: {"row": sharding.place(v["row"], mesh, row_pl[k]),
                    "col": sharding.place(v["col"], mesh, col_pl[k])}
                for k, v in nu.items()}
    sp = {k: sharding.place(v, mesh, pl[k]) for k, v in params.items()}
    so = {"mu": {k: sharding.place(v, mesh, pl[k])
                 for k, v in opt["mu"].items()},
          "nu": placed_nu(opt["nu"]),
          "count": sharding.place(opt["count"], mesh, (Replicate(),) * 2)}
    dims = tree_map(sharding.shard_dims, sp)
    local = lambda tree: tree_map(lambda t: t.to_local(), tree)  # noqa
    out = []
    p_plain, o_plain = params, opt
    for g in grads:
        sg = {k: sharding.local_slice(v, mesh, pl[k]).contiguous()
              for k, v in g.items()}
        new_p, new_o, m = adamw_update(local(sp), sg, local(so), cfg, 1e-2,
                                       mesh=mesh, dims=dims)
        sp = {k: _from_local(new_p[k], sp[k]) for k in new_p}
        so = tree_map(lambda n, old: _from_local(n, old), new_o, so)
        p_plain, o_plain, m_plain = adamw_update(p_plain, g, o_plain, cfg,
                                                 1e-2)
        out.append({"sharded": {k: t for k, t in flatten(
            sharding.full_tensors({"params": sp, "opt": so}))},
            "plain": dict(flatten({"params": p_plain, "opt": o_plain})),
            "norm": (float(m["grad_norm"]), float(m_plain["grad_norm"])),
            "dims": dims})
    return out


def _from_local(new, old):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(new, old.device_mesh, old.placements,
                              run_check=False, shape=old.shape,
                              stride=old.stride())

"""The port's ZeRO-3 train step (``launch.steps.make_sharded_train_step``)
on gloo ranks (CPU): params, gradients and AdamW's μ and ν held as this
rank's shards, each leaf gathered whole only where the model uses it.

Reduced configs under remat "dots" (f32), two steps on each mesh:
smollm-135m (labels partly masked, so the ranks' loss denominators
differ) on (2, 1), (1, 2) and (2, 2) from the reference's drawn params,
against the reference's jitted plain ``make_train_step`` on the whole
batch and against the port's plain step; granite-moe-3b-a800m (experts
on ``model``) on (2, 2) and recurrentgemma-2b (unit/rem, stacked
leaves) on (2, 1) against the port's plain step. On every rank after
each step: the resident bytes of params and of AdamW state equal
``launch.dryrun.rank_bytes`` of their specs, the gathers' gauge
(``parallel.sharding.GAUGE``: bytes of gathered full tensors alive)
peaks at no more than the larger of one unit's gathered leaves and
embed plus head, plus the remainder layers' (which run outside remat),
and counts the gathers the layout predicts (under tensor parallelism a
leaf a layer splits over ``model`` is gathered over ``data`` only);
the mesh engine's params and pools each rank holds are its
``rank_bytes`` too. AdamW's factored ν on two leaves split along rows
and along columns equals the plain update; a reduce-scatter that drops
the DP loss weighting fails the comparison.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim.schedules import constant as jconstant
from repro_torch import bridge
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.train import to_device
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.schedules import constant
from repro_torch.parallel import sharding
from repro_torch.tree import flatten

import _torch_arch_parity as par
import _torch_dist as td
import _torch_zero_ranks as zr

torch.set_num_threads(1)
LR = 1e-3
SMOLLM = "smollm-135m"
RUNS = [(SMOLLM, (2, 1)), (SMOLLM, (1, 2)), (SMOLLM, (2, 2)),
        ("granite-moe-3b-a800m", (2, 2)), ("recurrentgemma-2b", (2, 1))]
RUN_IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in RUNS]
_RANKS: dict = {}
_PLAIN: dict = {}
_REF: dict = {}


def _whole(arch):
    return td.step_batch(zr.zero_cfg(arch))


def _ref_start():
    """The reference's params and AdamW state for smollm-135m (PRNGKey 0),
    as numpy trees."""
    if "start" not in _REF:
        jcfg = jcfgs.get_config(SMOLLM, reduced=True)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        jo = jadamw_init(jp, JAdamWConfig(lr=LR))
        _REF["start"] = jax.tree_util.tree_map(np.asarray, (jp, jo))
    return _REF["start"]


def _start(arch):
    """(params, opt) the ranks and the plain step start from: the
    reference's for smollm-135m, the port's seed 0 otherwise."""
    if arch == SMOLLM:
        jp, jo = _ref_start()
        cfg = zr.zero_cfg(arch)
        return (bridge.params_from_jax(jp, cfg, device="cpu"),
                bridge.tree_from_jax(jo, device="cpu"))
    params = tlm.init_params(zr.zero_cfg(arch), seed=0, device="cpu")
    return params, adamw_init(params, AdamWConfig(lr=LR))


def _ranks(arch, shape, tmp_path):
    if (arch, shape) not in _RANKS:
        start = _ref_start() if arch == SMOLLM else (None, None)
        _RANKS[arch, shape] = td.run_ranks(
            zr.w_zero_step, math.prod(shape), tmp_path, shape, arch,
            _whole(arch), *start, 2, LR)
    return _RANKS[arch, shape]


def _plain(arch):
    """The port's plain step, two steps on the whole batch: (state,
    metrics of each step)."""
    if arch not in _PLAIN:
        cfg = zr.zero_cfg(arch)
        p, o = _start(arch)
        step = tsteps.make_train_step(cfg, AdamWConfig(lr=LR), constant(LR))
        batch = to_device(_whole(arch), "cpu")
        ms = []
        for i in range(2):
            p, o, m = step(p, o, batch, i)
            ms.append({k: float(v) for k, v in m.items()})
        _PLAIN[arch] = (dict(flatten({"params": p, "opt": o})), ms)
    return _PLAIN[arch]


def _reference():
    """The reference's jitted plain step, two steps on the whole batch
    from its own params: (state as {path: numpy}, metrics of each
    step)."""
    if "steps" not in _REF:
        jcfg = jcfgs.get_config(SMOLLM, reduced=True)
        jp, jo = _ref_start()
        step = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(lr=LR),
                                              jconstant(LR)))
        batch = {k: jnp.asarray(v) for k, v in _whole(SMOLLM).items()}
        ms = []
        for i in range(2):
            jp, jo, m = step(jp, jo, batch, jnp.int32(i))
            ms.append({k: float(v) for k, v in m.items()})
        _REF["steps"] = (par.flat_np({"params": jp, "opt": jo}), ms)
    return _REF["steps"]


def _assert_state(got: dict, exp: dict, what: str):
    assert got.keys() == exp.keys()
    for path, e in exp.items():
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(e),
                                   err_msg=f"{what}: {path}",
                                   **par.GRAD_TOL)


def _assert_metrics(got: list, exp: list):
    for g, e in zip(got, exp):
        for k in ("loss", "ce", "z_loss", "aux", "accuracy", "grad_norm",
                  "lr"):
            np.testing.assert_allclose(g[k], e[k], err_msg=k,
                                       **par.OUT_TOL)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)],
                         ids=["2x1", "1x2", "2x2"])
def test_zero_step_matches_reference(shape, tmp_path):
    """smollm-135m from the reference's drawn params: loss and metrics
    of both steps, every param and every μ and ν after them, against
    the reference's jitted plain step on the whole batch."""
    exp_state, exp_m = _reference()
    for x in _ranks(SMOLLM, shape, tmp_path):
        _assert_metrics(x["metrics"], exp_m)
        _assert_state({k: t.numpy() for k, t in x["state"].items()},
                      exp_state, "vs the reference")


@pytest.mark.parametrize("arch,shape", RUNS, ids=RUN_IDS)
def test_zero_step_matches_plain_step(arch, shape, tmp_path):
    exp_state, exp_m = _plain(arch)
    for x in _ranks(arch, shape, tmp_path):
        _assert_metrics(x["metrics"], exp_m)
        _assert_state(x["state"], exp_state, "vs the plain step")


@pytest.mark.parametrize("arch,shape", RUNS, ids=RUN_IDS)
def test_resident_bytes_equal_rank_bytes(arch, shape, tmp_path):
    """What each rank holds of params and AdamW state after each step is
    its shards, as many bytes as ``dryrun.rank_bytes`` gives; on (2, 2)
    less than a whole copy."""
    res = _ranks(arch, shape, tmp_path)
    p, o = _start(arch)
    whole = {"params": sum(t.numel() * t.element_size()
                           for _, t in flatten(p)),
             "opt": sum(t.numel() * t.element_size()
                        for _, t in flatten(o))}
    for x in res:
        for held in x["held"]:
            assert held == x["rank_bytes"], (held, x["rank_bytes"])
        if shape == (2, 2):
            assert x["rank_bytes"]["params"] < whole["params"] / 2
            assert x["rank_bytes"]["opt"] < whole["opt"] / 2


ENGINE_BYTES = [("granite-8b", "darkformer", (1, 2)),
                ("smollm-135m", "exact", (2, 2))]


@pytest.mark.parametrize("arch,kind,shape", ENGINE_BYTES,
                         ids=[f"{a}-{k}-{s[0]}x{s[1]}"
                              for a, k, s in ENGINE_BYTES])
def test_engine_resident_bytes_equal_rank_bytes(arch, kind, shape,
                                                tmp_path):
    """The mesh engine after a short run: the params and the slot and
    staging pools each rank holds are the bytes ``dryrun.rank_bytes``
    gives for ``params`` and ``serve_state`` (granite-8b's 2 KV groups
    computed one a rank, with nothing gathered over ``model``;
    smollm-135m's 3 gathered whole at M = 2, its exact KV cache's groups
    not split)."""
    import _torch_tp_ranks as tr
    for x in td.run_ranks(tr.w_engine_bytes, math.prod(shape), tmp_path,
                          shape, arch, kind):
        held, want = x["held"], x["rank_bytes"]
        assert held["params"] == want["params"], (held, want)
        assert held["serve_state"] == held["staging"] == \
            want["serve_state"], (held, want)
        assert (x["over_model"] == 0) == (arch == "granite-8b"), x


def _tp_dim(path, spec, cfg, m):
    """The dim of a leaf that its layer computes its share of over a
    ``model`` axis of ``m`` ranks (``models.lm._apply_block``), or None
    where the layer uses the leaf whole."""
    if m == 1:
        return None
    leaf = path[path.rindex("['") + 2:-2]
    if "['attn']" in path and cfg.n_kv % m == 0:
        return {"wq": -1, "wk": -1, "wv": -1, "wo": -2}.get(leaf)
    if "['ffn']" in path and cfg.moe is not None:
        if leaf not in ("w_gate", "w_up", "w_out"):
            return None
        experts = spec[-3] == "model"       # else each expert's hidden dim
        return -3 if experts else -1 if leaf != "w_out" else -2
    if "['ffn']" in path and cfg.d_ff % m == 0:
        return {"w_gate": -1, "w_up": -1, "w_out": -2}.get(leaf)
    if path in ("['embed']", "['lm_head']") and cfg.vocab % m == 0:
        return 0 if path == "['embed']" else 1
    return None


def _gathered_leaves(arch, shape):
    """{path: bytes of what a step gathers of it} of the leaves a step
    gathers on a ``shape`` mesh: those whose spec splits some dim, whole,
    except a leaf that its layer computes its share of over ``model``
    and that ``model`` splits (major) along that dim alone: it is
    gathered over the other axes only, to 1/M of it, and not at all
    when no other axis splits it."""
    cfg = zr.zero_cfg(arch)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    m = shape[1]
    specs = dict(flatten(sharding.param_specs(
        params, AbstractMesh(shape, ("data", "model")),
        moe=cfg.moe is not None, overrides=cfg.sharding_overrides),
        ))
    out = {}
    for p, t in flatten(params):
        spec = tuple(specs[p]) + (None,) * t.ndim
        axes = [() if a is None else a if isinstance(a, tuple) else (a,)
                for a in spec[:t.ndim]]
        if not any(axes):
            continue
        full = t.numel() * t.element_size()
        dim = _tp_dim(p, spec[:t.ndim], cfg, m)
        if dim is not None:
            dim %= t.ndim
        block = (dim is not None and axes[dim][:1] == ("model",)
                 and all("model" not in a for i, a in enumerate(axes)
                         if i != dim))
        if not block:
            out[p] = full
        elif any(x != "model" for a in axes for x in a):
            out[p] = full // m
    return cfg, out


@pytest.mark.parametrize("arch,shape", RUNS, ids=RUN_IDS)
def test_gathered_bytes_stay_within_one_unit(arch, shape, tmp_path):
    """The gauge's peak during a step is at most the larger of one
    unit's gathered leaves and embed plus head (tied: the embedding,
    gathered at the input and again at the head, never alive twice), plus
    the remainder layers' leaves, which run outside remat and so stay
    alive from their forward to their backward (slack 0). Nothing
    gathered outlives the step. Gathers a step: each unit's leaves in
    its forward and again in its recompute, the remainder layers' once,
    the embedding at the input and the head at the output. On a
    ``model`` axis above 1 a leaf that tensor parallelism splits is
    gathered over ``data`` only, to its block, or not at all
    (:func:`_gathered_leaves`)."""
    cfg, leaves = _gathered_leaves(arch, shape)
    unit = sum(b for p, b in leaves.items()
               if p.startswith("['units']")) // cfg.n_units
    unit_leaves = sum(p.startswith("['units']") for p in leaves)
    rem = sum(b for p, b in leaves.items() if p.startswith("['rem']"))
    rem_leaves = sum(p.startswith("['rem']") for p in leaves)
    head = leaves.get("['embed']", 0) + leaves.get("['lm_head']", 0)
    head_gathers = ((2 if cfg.tie_embeddings else 1)
                    * ("['embed']" in leaves) + ("['lm_head']" in leaves))
    bound = max(unit, head) + rem
    for x in _ranks(arch, shape, tmp_path):
        for g in x["gauge"]:
            assert 0 < g["peak"] <= bound, (g, unit, head, rem)
            assert g["live_after"] == 0
            assert g["gathers"] == (2 * unit_leaves * cfg.n_units
                                    + rem_leaves + head_gathers), g


def test_planted_fault_fails_the_comparison(tmp_path):
    """A reduce-scatter that drops the DP loss weighting (each rank's
    gradient divided by its loss scale: the mean of the ranks' means,
    not the whole batch's mean) moves the state off the plain step's."""
    res = td.run_ranks(zr.w_zero_step, 2, tmp_path, (2, 1), SMOLLM,
                       _whole(SMOLLM), *_ref_start(), 2, LR, True)
    exp_state, _ = _plain(SMOLLM)
    for x in res:
        with pytest.raises(AssertionError):
            _assert_state(x["state"], exp_state, "planted fault")


def test_factored_nu_matches_plain_update(tmp_path):
    """AdamW with ``factored_second_moment`` on (2, 1): a leaf split
    along its rows (the column means and the row factor's mean
    all-reduced) and one along its columns (the row means all-reduced),
    two updates, equal to the plain update on the whole leaves, with the
    same clip norm."""
    res = td.run_ranks(zr.w_factored_nu, 2, tmp_path, (2, 1))
    for x in res:
        assert x[0]["dims"] == {"rows": ((), ("data",), ()),
                                "cols": ((), ("data",))}
        for upd in x:
            np.testing.assert_allclose(*upd["norm"], rtol=1e-6)
            assert upd["sharded"].keys() == upd["plain"].keys()
            for path, e in upd["plain"].items():
                np.testing.assert_allclose(upd["sharded"][path].numpy(),
                                           e.numpy(), err_msg=path,
                                           rtol=1e-6, atol=1e-7)


def test_step_without_a_mesh_is_unchanged():
    """The plain step still runs on plain tensors (no collective) and
    the gauge stays untouched: the gathers are the mesh's alone."""
    before = (sharding.GAUGE.gathers, sharding.GAUGE.live)
    state, _ = _plain(SMOLLM)
    assert (sharding.GAUGE.gathers, sharding.GAUGE.live) == before
    assert all(not hasattr(t, "placements") for t in state.values())
    p, _ = _start(SMOLLM)
    assert all(a is b for (_, a), (_, b) in zip(
        flatten(sharding.gathered(p)), flatten(p)))

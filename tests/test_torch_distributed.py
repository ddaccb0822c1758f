"""The port's multi-rank path on gloo ranks (CPU), against the
reference and against the port's own unsharded step.

Ranks are spawned processes on a ``FileStore`` in tmp_path
(``_torch_dist.run_ranks``: joined within a time limit of their own,
killed on expiry). World 4 as (2, 2) and as (4, 1) meshes:
``compressed_psum_mean`` with each method against the reference's under
``jax.vmap(axis_name="data")`` over each data group's inputs, int8 with
error feedback converging over 64 steps, ``sequence_parallel_state_
combine`` against the reference's and the whole sequence's state, a mesh
whose size is not the world's raising; the data-parallel step of
reduced smollm-135m (labels partly masked), hubert-xlarge (masked
frames) and granite-moe-3b-a800m (the load-balancing term over the
whole batch) against the unsharded step on the whole batch (gradients,
metrics, two steps' params and AdamW state) with every local shard's
shape as its spec says; the launcher on a (2, 2) mesh with a failure
injected against the unsharded launcher; SIGTERM on one rank alone
stopping every rank at that step. World 4 writes a (2, 2)
checkpoint (rank 0 writes) that ``restore_to_shardings`` reloads onto
(2, 1) at world 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.linear_attention import LinearState as JLinearState
from repro.core.linear_attention import \
    sequence_parallel_state_combine as jsp_combine
from repro.parallel import compressed_psum_mean as jcompressed
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tcfgs
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import to_device
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.schedules import constant
from repro_torch.tree import flatten

import _torch_arch_parity as par
import _torch_dist as td

torch.set_num_threads(1)
SHAPES = [(2, 2), (4, 1)]
SHAPE_IDS = ["2x2", "4x1"]
_RUNS: dict = {}


def _collectives(shape, tmp_path):
    if shape not in _RUNS:
        _RUNS[shape] = td.run_ranks(td.w_collectives, 4, tmp_path, shape)
    return _RUNS[shape]


def _groups(res):
    """{model coordinate: [rank, ...] in data order}."""
    out: dict = {}
    for r, x in enumerate(res):
        out.setdefault(x["coord"][1], []).append(r)
    return out


def _np(tree):
    return jax.tree_util.tree_map(lambda t: np.asarray(t), tree)


def _ref_compressed(method, ranks, with_eb):
    g = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
        _np(td.rank_grads(r)) for r in ranks])
    if not with_eb:
        return jax.vmap(lambda x: jcompressed(x, "data", method)[0],
                        axis_name="data")(g)
    eb = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
        _np(td.rank_feedback(r)) for r in ranks])
    return jax.vmap(lambda x, e: jcompressed(x, "data", "int8", e),
                    axis_name="data")(g, eb)


def _port_tree(t):
    return {"a": np.asarray(t["a"]), "b": {"c": np.asarray(t["b"]["c"])}}


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compressed_psum_mean_matches_reference(shape, method, tmp_path):
    res = _collectives(shape, tmp_path)
    tol = dict(rtol=1e-6, atol=1e-6)
    for ranks in _groups(res).values():
        if method == "int8":
            exp, eb = _ref_compressed(method, ranks, True)
        else:
            exp = _ref_compressed(method, ranks, False)
        for i, r in enumerate(ranks):
            got = res[r][method]
            if method == "int8":
                got, got_eb = got
                for k, e in (("a", eb["a"][i]), ("c", eb["b"]["c"][i])):
                    g = got_eb["a"] if k == "a" else got_eb["b"]["c"]
                    np.testing.assert_allclose(g.numpy(), np.asarray(e),
                                               **tol)
            got = _port_tree(got)
            np.testing.assert_allclose(got["a"], np.asarray(exp["a"][i]),
                                       **tol)
            np.testing.assert_allclose(got["b"]["c"],
                                       np.asarray(exp["b"]["c"][i]), **tol)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_int8_error_feedback_converges(shape, tmp_path):
    for x in _collectives(shape, tmp_path):
        np.testing.assert_allclose(x["ef_mean"].numpy(),
                                   np.linspace(-1.0, 1.0, 4), atol=1e-3)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sequence_parallel_state_combine(shape, tmp_path):
    """Each data group's partial (S, z), combined by one all-reduce,
    equals the whole sequence's state and the reference's psum."""
    res = _collectives(shape, tmp_path)
    kf, v = td.sp_inputs()
    n = shape[0]
    rows = kf.shape[0] // n
    parts = [(kf[i * rows:(i + 1) * rows], v[i * rows:(i + 1) * rows])
             for i in range(n)]
    exp = jax.vmap(lambda s, z: jsp_combine(JLinearState(s, z), "data"),
                   axis_name="data")(
        jnp.stack([np.asarray(k.T @ vb) for k, vb in parts]),
        jnp.stack([np.asarray(k.sum(0)) for k, _ in parts]))
    for x in res:
        np.testing.assert_allclose(x["sp"].s.numpy(), np.asarray(exp.s[0]),
                                   rtol=1e-6)
        np.testing.assert_allclose(x["sp"].z.numpy(), np.asarray(exp.z[0]),
                                   rtol=1e-6)
        np.testing.assert_allclose(x["sp"].s.numpy(), (kf.T @ v).numpy(),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mesh_of_another_size_raises(shape, tmp_path):
    for x in _collectives(shape, tmp_path):
        assert x["mesh_raise"] == \
            "need 3 ranks for mesh {'data': 3, 'model': 1}, have 4"


def test_mesh_without_a_group_raises():
    from repro_torch.launch.mesh import make_local_mesh
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        make_local_mesh(2, 2, device_type="cpu")


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("arch", ["smollm-135m", "hubert-xlarge",
                                  "granite-moe-3b-a800m"])
def test_sharded_step_matches_unsharded(arch, shape, tmp_path):
    res = td.run_ranks(td.w_sharded_step, 4, tmp_path, shape, arch)
    cfg = tcfgs.get_config(arch, reduced=True)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    batch = to_device(td.step_batch(cfg), "cpu")
    grads, metrics = tsteps.make_grad_fn(cfg)(params, batch, 0)
    opt_cfg = AdamWConfig(lr=1e-3)
    step = tsteps.make_train_step(cfg, opt_cfg, constant(1e-3))
    p, o = params, adamw_init(params, opt_cfg)
    for i in range(2):
        p, o, m = step(p, o, batch, i)
    state = dict(flatten({"params": p, "opt": o}))
    for x in res:
        assert x["batch_rows"] == 8 // shape[0]
        for k in ("loss", "ce", "z_loss", "aux", "accuracy"):
            np.testing.assert_allclose(float(x["metrics"][k]),
                                       float(metrics[k]), err_msg=k,
                                       **par.OUT_TOL)
            np.testing.assert_allclose(float(x["last_metrics"][k]),
                                       float(m[k]), err_msg=k,
                                       **par.OUT_TOL)
        for (path, g), (_, e) in zip(flatten(x["grads"]), flatten(grads)):
            np.testing.assert_allclose(g.numpy(), e.numpy(), err_msg=path,
                                       **par.GRAD_TOL)
        assert x["state"].keys() == state.keys()
        for path, e in state.items():
            np.testing.assert_allclose(x["state"][path].numpy(), e.numpy(),
                                       err_msg=path, **par.GRAD_TOL)
        wrong = {p: s for p, s in x["shapes"].items() if s[0] != s[1]}
        assert not wrong, wrong
    if shape == (2, 2):     # something is sharded over both axes
        assert any(s[0] != tuple(state[p].shape)
                   for p, s in res[0]["shapes"].items())


def test_elastic_restore_onto_a_smaller_mesh(tmp_path):
    ck = tmp_path / "ck"
    saved = td.run_ranks(td.w_elastic_save, 4, tmp_path, str(ck))
    assert saved[0]["writes"] == ["step_5"]
    assert tckpt.all_steps(str(ck)) == [5]
    res = td.run_ranks(td.w_elastic_restore, 2, tmp_path, str(ck))
    cfg = tcfgs.get_config("smollm-135m", reduced=True)
    params = tlm.init_params(cfg, seed=4, device="cpu")
    exp = dict(flatten({"params": params, "opt": adamw_init(
        params, AdamWConfig(factored_second_moment=True))}))
    for x in res:
        assert x["step"] == 5 and x["placements_ok"]
        assert x["values"].keys() == exp.keys()
        for k, e in exp.items():
            assert torch.equal(x["values"][k], e), k


def test_sigterm_on_one_rank_stops_every_rank_at_that_step(tmp_path):
    """SIGTERM reaches rank 2 alone, inside step 3: every rank
    checkpoints step 3 (rank 0 writes) and stops, with its collectives
    matched."""
    ck = tmp_path / "ck"
    res = td.run_ranks(td.w_preempt_one_rank, 4, tmp_path, str(ck), 2, 3,
                       timeout=60)
    for r, x in enumerate(res):
        assert x["ran"] == [0, 1, 2, 3], r
        assert x["steps"] == [3], r
        assert x["preempted"] == (r == 2), r
        assert torch.equal(x["x"], torch.full((3,), 4.0)), r


def test_launcher_on_a_mesh_with_failure_injection(tmp_path):
    """``train.main --mesh-data 2 --mesh-model 2`` on four ranks, a
    failure injected at step 3 (restored from step 1's checkpoint, which
    rank 0 wrote), against the unsharded launcher on the whole batch."""
    from repro_torch.launch import train
    common = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
              "--batch", "4", "--seq", "16", "--lr", "3e-3", "--warmup",
              "2", "--log-every", "1", "--steps", "6", "--ckpt-every", "2"]
    ck = tmp_path / "mesh"
    res = td.run_ranks(td.w_launcher, 4, tmp_path, common + [
        "--mesh-data", "2", "--mesh-model", "2", "--ckpt-dir", str(ck),
        "--simulate-failure-at", "3"])
    plain = train.main(common + ["--ckpt-dir", str(tmp_path / "plain")])
    assert tckpt.all_steps(str(ck)) == [1, 3, 5]
    exp = {m["step"]: m["loss"] for m in plain["metrics"]}
    state = dict(flatten({"params": plain["params"], "opt": plain["opt"]}))
    for x in res:
        assert [m["step"] for m in x["metrics"]] == [0, 1, 2, 2, 3, 4, 5]
        for m in x["metrics"]:
            np.testing.assert_allclose(m["loss"], exp[m["step"]],
                                       **par.OUT_TOL)
        for path, e in state.items():
            np.testing.assert_allclose(x["state"][path].numpy(), e.numpy(),
                                       err_msg=path, rtol=1e-4, atol=1e-5)

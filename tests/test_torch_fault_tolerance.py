"""The port's fault tolerance (``repro_torch.runtime``) against the
reference's classes on the CPU.

Every case of tests/test_fault_tolerance.py, run through both packages:
the same final state and the same checkpoint steps on disk; the
straggler monitor's flags; ``elastic_shrink_plan`` equal to the
reference's over a grid of meshes, failures and ``devices_per_host``,
its ``ValueError`` included. Beyond them: a SIGTERM raised inside a
step (the supervisor checkpoints that step and stops; a new run resumes
to the clean state), the handlers put back, and the reduced launcher
under ``--simulate-failure-at`` bitwise equal to a clean launcher run,
its losses within ``OUT_TOL`` of the reference's train step (not its
CLI) on the same params and batches.
"""
import itertools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import runtime as jrt
from repro.data import SyntheticLM
from repro.launch import steps as jsteps
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim.schedules import cosine_warmup as jcosine_warmup
from repro_torch import checkpoint as tckpt
from repro_torch import runtime as trt
from repro_torch.launch import train
from repro_torch.tree import flatten

import _torch_arch_parity as par

torch.set_num_threads(1)


def _jstep(state, step):
    return {"x": state["x"] + (step + 1),
            "steps_seen": state["steps_seen"] + 1}


def _tstep(state, step):
    return {"x": state["x"] + (step + 1),
            "steps_seen": state["steps_seen"] + 1}


def _jbase():
    return {"x": jnp.zeros(()), "steps_seen": jnp.zeros((), jnp.int32)}


def _tbase():
    return {"x": torch.zeros(()),
            "steps_seen": torch.zeros((), dtype=torch.int32)}


def _same_state(t, j):
    assert float(t["x"]) == float(j["x"])
    assert int(t["steps_seen"]) == int(j["steps_seen"])


@pytest.mark.parametrize("fail_at", [None, 0, 3, 4, 5, 12, 19])
def test_supervisor_recovers_to_same_state(tmp_path, fail_at):
    """A run with an injected failure ends where the reference's does,
    with the same checkpoints kept; once a checkpoint exists (step 4),
    where an uninterrupted run does. A failure before it restarts at
    step 0 from the state reached, in both packages, so the steps
    already applied count twice (x over by 1 + ... + fail_at)."""
    n = 20
    t = trt.TrainSupervisor(str(tmp_path / "t"), ckpt_every=5).run(
        _tbase(), _tstep, n, fail_at=fail_at)
    j = jrt.TrainSupervisor(str(tmp_path / "j"), ckpt_every=5).run(
        _jbase(), _jstep, n, fail_at=fail_at)
    _same_state(t, j)
    twice = sum(range(1, fail_at + 1)) if fail_at is not None and \
        fail_at < 5 else 0
    assert float(t["x"]) == sum(range(1, n + 1)) + twice
    assert tckpt.all_steps(str(tmp_path / "t")) == \
        jckpt.all_steps(str(tmp_path / "j")) == [9, 14, 19]


def test_supervisor_resumes_across_runs(tmp_path):
    runs = {}
    for name, sup_cls, base, step in (
            ("t", trt.TrainSupervisor, _tbase, _tstep),
            ("j", jrt.TrainSupervisor, _jbase, _jstep)):
        d = str(tmp_path / name)
        sup_cls(d, ckpt_every=5).run(base(), step, 10)  # ckpts at 4, 9
        calls = []

        def counting(state, s, step=step, calls=calls):
            calls.append(s)
            return step(state, s)
        out = sup_cls(d, ckpt_every=5).run(base(), counting, 20)
        runs[name] = (out, calls, tckpt.all_steps(d))
    _same_state(runs["t"][0], runs["j"][0])
    assert float(runs["t"][0]["x"]) == sum(range(1, 21))
    assert runs["t"][1] == runs["j"][1] == list(range(10, 20))
    assert runs["t"][2] == runs["j"][2] == [9, 14, 19]


@pytest.mark.parametrize("max_restarts", [0, 2])
def test_supervisor_gives_up_after_budget(tmp_path, max_restarts):
    calls = {"t": 0, "j": 0}

    def always_fail(key, exc):
        def fn(state, step):
            calls[key] += 1
            raise exc("flaky host")
        return fn
    with pytest.raises(trt.SimulatedFailure):
        trt.TrainSupervisor(str(tmp_path / "t"),
                            max_restarts=max_restarts).run(
            {"x": torch.zeros(())}, always_fail("t", trt.SimulatedFailure),
            5)
    with pytest.raises(jrt.SimulatedFailure):
        jrt.TrainSupervisor(str(tmp_path / "j"),
                            max_restarts=max_restarts).run(
            {"x": jnp.zeros(())}, always_fail("j", jrt.SimulatedFailure), 5)
    assert calls["t"] == calls["j"] == max_restarts + 1
    assert tckpt.all_steps(str(tmp_path / "t")) == []


def test_straggler_monitor():
    mon = trt.StragglerMonitor(threshold=3.0, warmup_steps=3)
    flags = [mon.record(i, 1.0) for i in range(10)]
    assert not any(flags)
    assert mon.record(10, 10.0)
    assert mon.straggler_steps == 1
    # EMA not polluted by the outlier
    assert not mon.record(11, 1.2)


@pytest.mark.parametrize("threshold,warmup", [(3.0, 5), (1.5, 2), (2.0, 0)])
def test_straggler_monitor_matches_reference(threshold, warmup):
    """Flags, counts and callbacks over a sequence of latencies with
    outliers, step for step as the reference's."""
    rng = np.random.default_rng(int(threshold * 10) + warmup)
    dts = rng.lognormal(0.0, 0.6, 200)
    dts[rng.integers(0, 200, 12)] *= 8.0
    got, exp = [], []
    t = trt.StragglerMonitor(threshold=threshold, warmup_steps=warmup,
                             on_straggler=lambda *a: got.append(a))
    j = jrt.StragglerMonitor(threshold=threshold, warmup_steps=warmup,
                             on_straggler=lambda *a: exp.append(a))
    assert [t.record(i, float(d)) for i, d in enumerate(dts)] == \
        [j.record(i, float(d)) for i, d in enumerate(dts)]
    assert t.straggler_steps == j.straggler_steps > 0
    assert got == exp


_MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data",
                                                         "model")),
           ((8, 4), ("data", "model")), ((4, 2), ("data", "model")),
           ((2, 2), ("data", "model")), ((12, 1), ("data", "model")),
           ((2, 3, 2), ("pod", "data", "model"))]


@pytest.mark.parametrize("mesh,axes", _MESHES)
def test_elastic_shrink_plan_matches_reference(mesh, axes):
    """Every (failed hosts, devices per host) of a grid, the reference's
    ValueError where the cluster is too small included."""
    for failed, per_host in itertools.product(range(0, 40, 3), (1, 2, 4, 8)):
        try:
            exp = jrt.elastic_shrink_plan(mesh, axes, failed, per_host)
        except ValueError:
            with pytest.raises(ValueError, match="too small"):
                trt.elastic_shrink_plan(mesh, axes, failed, per_host)
            continue
        assert trt.elastic_shrink_plan(mesh, axes, failed,
                                       per_host) == exp, (failed, per_host)


@pytest.mark.parametrize("mesh,axes,failed,expect", [
    ((16, 16), ("data", "model"), 1, (8, 16)),
    ((16, 16), ("data", "model"), 17, (8, 16)),
    ((2, 16, 16), ("pod", "data", "model"), 1, (2, 8, 16)),
])
def test_elastic_shrink_plan(mesh, axes, failed, expect):
    assert trt.elastic_shrink_plan(mesh, axes, failed) == expect


def test_elastic_shrink_too_small():
    with pytest.raises(ValueError):
        trt.elastic_shrink_plan((2, 2), ("data", "model"), 2,
                                devices_per_host=2)


@pytest.fixture
def own_signals():
    """Put back SIGTERM's and SIGINT's handlers after the test."""
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in old.items():
        signal.signal(s, h)


def test_preemption_handler_installs_and_restores(own_signals):
    before = signal.getsignal(signal.SIGTERM)
    h = trt.PreemptionHandler()
    assert signal.getsignal(signal.SIGTERM) == h._handler
    assert signal.getsignal(signal.SIGINT) == h._handler
    os.kill(os.getpid(), signal.SIGINT)
    assert h.preempted
    h.restore()
    assert signal.getsignal(signal.SIGTERM) == before
    assert not trt.PreemptionHandler(install=False)._previous


def test_sigterm_inside_a_step_checkpoints_and_resumes(tmp_path,
                                                       own_signals):
    """SIGTERM during step 7: the step completes, is checkpointed, the
    run stops; a new run resumes at step 8 and ends on the clean state."""
    n = 20
    clean = trt.TrainSupervisor(str(tmp_path / "clean"), ckpt_every=5).run(
        _tbase(), _tstep, n)
    ran = []

    def step_fn(state, step):
        ran.append(step)
        if step == 7:
            os.kill(os.getpid(), signal.SIGTERM)
        return _tstep(state, step)
    d = str(tmp_path / "pre")
    pre = trt.PreemptionHandler()
    out = trt.TrainSupervisor(d, ckpt_every=5, preemption=pre).run(
        _tbase(), step_fn, n)
    pre.restore()
    assert pre.preempted and ran == list(range(8))
    assert tckpt.all_steps(d) == [4, 7]
    assert float(out["x"]) == sum(range(1, 9))
    ran.clear()
    resumed = trt.TrainSupervisor(d, ckpt_every=5).run(_tbase(), step_fn, n)
    assert ran == list(range(8, n))
    _same_state(resumed, {"x": clean["x"],
                          "steps_seen": clean["steps_seen"]})
    assert torch.equal(resumed["x"], clean["x"])


LAUNCH = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
          "--batch", "2", "--seq", "32", "--lr", "3e-3", "--warmup", "2",
          "--log-every", "1", "--ckpt-every", "4"]


def test_launcher_failure_injection_equals_clean_run_and_reference(
        tmp_path, own_signals, capsys):
    """The reduced launcher from the reference's params (``--finetune-
    from``), 12 steps: clean, then with a failure injected at step 6
    (restored from step 3's checkpoint, steps 4 and 5 rerun: 14 steps
    run). Final params and optimizer state bitwise equal, every logged
    metric after the restart equal, the checkpoints on disk the same,
    the losses within OUT_TOL of the reference's train step; then
    ``--steps 16`` on the clean directory resumes at step 12."""
    jcfg, tcfg, jparams, _ = par.setup("smollm-135m", seed=2)
    src = tmp_path / "ref"
    jckpt.save_checkpoint(str(src), 0, {"params": jparams})
    common = LAUNCH + ["--finetune-from", str(src)]
    seen = {"clean": [], "faulty": []}
    clean = train.main(common + ["--steps", "12", "--ckpt-dir",
                                 str(tmp_path / "clean")],
                       on_step=seen["clean"].append)
    faulty = train.main(common + ["--steps", "12", "--ckpt-dir",
                                  str(tmp_path / "faulty"),
                                  "--simulate-failure-at", "6"],
                        on_step=seen["faulty"].append)
    assert seen["clean"] == list(range(12))
    assert seen["faulty"] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9, 10, 11]
    for (p, a), (_, b) in zip(
            flatten({"params": clean["params"], "opt": clean["opt"]}),
            flatten({"params": faulty["params"], "opt": faulty["opt"]})):
        assert par.bits(a.numpy()) == par.bits(b.numpy()), p
    by_step = {m["step"]: m for m in clean["metrics"]}
    assert [m["step"] for m in faulty["metrics"]] == seen["faulty"]
    for m in faulty["metrics"]:
        assert {k: v for k, v in m.items() if k != "ms"} == \
            {k: v for k, v in by_step[m["step"]].items() if k != "ms"}, m
    assert tckpt.all_steps(str(tmp_path / "clean")) == \
        tckpt.all_steps(str(tmp_path / "faulty")) == [3, 7, 11]

    jopt_cfg = JAdamWConfig(lr=3e-3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg,
                                           jcosine_warmup(3e-3, 2, 12)))
    jopt = jadamw_init(jparams, jopt_cfg)
    data = SyntheticLM(jcfg.vocab, 32, 2, seed=0)
    losses = []
    for s in range(12):
        jparams, jopt, m = jstep(jparams, jopt, dict(data.batch(s)),
                                 jnp.int32(s))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose([by_step[s]["loss"] for s in range(12)],
                               losses, **par.OUT_TOL)

    resumed = []
    more = train.main(LAUNCH + ["--steps", "16", "--ckpt-dir",
                                str(tmp_path / "clean")],
                      on_step=resumed.append)
    assert resumed == [12, 13, 14, 15]
    assert [m["step"] for m in more["metrics"]] == resumed
    assert tckpt.all_steps(str(tmp_path / "clean")) == [7, 11, 15]
    printed = capsys.readouterr().out
    for run in (clean, faulty, more):
        assert run["stragglers"] is not None
        if run["stragglers"]:
            assert f"stragglers flagged: {run['stragglers']}" in printed


def test_fault_tolerant_training_example_runs_on_cpu(capsys):
    """examples/torch_fault_tolerant_training.py on the CPU: the run with
    a failure at step 25 ends on the uninterrupted run's state (the
    example checks it bitwise), the step-20 log line twice (steps 20 to
    24 rerun from step 19's checkpoint), and the reference's elastic
    plan."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "torch_fault_tolerant_training.py")
    spec = importlib.util.spec_from_file_location(
        "torch_fault_tolerant_training", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = ex.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "final state equal to the uninterrupted run's: True" in printed
    assert printed.count("step  20 loss") == 3     # twice faulty, once clean
    assert out["plan"] == jrt.elastic_shrink_plan((16, 16),
                                                  ("data", "model"), 3)


@pytest.mark.parametrize("ckpt", [False, True])
def test_launcher_releases_each_replaced_state(tmp_path, monkeypatch, ckpt,
                                               own_signals):
    """Once step 0 has run, nothing holds the initial params: a full-size
    run cannot afford two copies of params and AdamW state on the card."""
    import gc
    import weakref
    from repro_torch.models import lm as tlm
    refs = []
    init = tlm.init_params

    def recording(*a, **k):
        p = init(*a, **k)
        refs.append(weakref.ref(p["embed"]))
        return p
    monkeypatch.setattr(tlm, "init_params", recording)
    alive = []

    def after(step):
        gc.collect()
        alive.append(refs[0]() is not None)
    argv = LAUNCH + ["--steps", "3"]
    if ckpt:
        argv += ["--ckpt-dir", str(tmp_path / "ck")]
    train.main(argv, on_step=after)
    assert alive == [True, False, False]

"""The port's training path against the reference's.

Feature maps, training-time attention, the LM loss with every gradient,
and whole train steps go through both packages on the same inputs (numpy
seeds) and the same params and optimizer state (the reference's, brought
across by ``repro_torch.bridge``), at the reduced smollm-135m and
darkformer-2b configs in f32. The reference's ``use_kernel`` path runs
its Pallas scan in interpret mode, as tests/test_kernels.py does; the
port's runs the plain version of its CUDA kernel on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import attention as jatt
from repro.core import feature_maps as jfm
from repro.data import SyntheticLM
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim.schedules import constant as jconstant
from repro.optim.schedules import cosine_warmup as jcosine
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.core import attention as tatt
from repro_torch.core import feature_maps as tfm
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.schedules import constant, cosine_warmup
from repro_torch.tree import flatten

torch.set_num_threads(1)
# f32 in another summation order: elementwise maps to 1e-6, attention
# outputs (sums over L <= 24 positions) and the loss to 1e-5
MAP_TOL = dict(atol=1e-6, rtol=1e-5)
OUT_TOL = dict(atol=1e-5, rtol=1e-4)


def _t(a):
    return torch.tensor(np.asarray(a))


def _setup(arch, use_kernel=False, kind=None, seed=0):
    jcfg = jcfgs.get_config(arch, reduced=True)
    tcfg = tcfgs.get_config(arch, reduced=True)
    if kind is not None:
        m = jcfg.attn.num_features
        jcfg, tcfg = jcfgs.darkify(jcfg, kind, m), tcfgs.darkify(tcfg, kind, m)
    jcfg = dataclasses.replace(jcfg, use_kernel=use_kernel)
    tcfg = dataclasses.replace(tcfg, use_kernel=use_kernel)
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(vocab, b=2, l=16, step=0):
    data = SyntheticLM(vocab, l, b, seed=1).batch(step)
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.tensor(v).long() for k, v in data.items()})


def _flat_np(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("stabilize", [True, False])
def test_feature_maps_match_reference(stabilize):
    rng = np.random.default_rng(0)
    d, r, m = 8, 6, 16
    q = (0.5 * rng.standard_normal((2, 3, 5, d))).astype(np.float32)
    k = (0.5 * rng.standard_normal((2, 3, 5, d))).astype(np.float32)
    w = rng.standard_normal((m, r)).astype(np.float32)
    wi = rng.standard_normal((m, d)).astype(np.float32)
    mm = (np.eye(r, d) + 0.2 * rng.standard_normal((r, d))).astype(
        np.float32)
    pairs = [
        (jfm.prf_features(q, wi, stabilize=stabilize),
         tfm.prf_features(_t(q), _t(wi), stabilize=stabilize)),
        (jfm.dark_features(q, w, mm, stabilize=stabilize),
         tfm.dark_features(_t(q), _t(w), _t(mm), stabilize=stabilize)),
        (jfm.qk_features(q, k, w, "darkformer", mm, stabilize=stabilize),
         tfm.qk_features(_t(q), _t(k), _t(w), "darkformer", _t(mm),
                         stabilize=stabilize)),
        (jfm.qk_features(q, k, wi, "performer", stabilize=stabilize),
         tfm.qk_features(_t(q), _t(k), _t(wi), "performer",
                         stabilize=stabilize)),
    ]
    for i, (exp, got) in enumerate(pairs):
        for e, g in zip(exp, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(e),
                                       err_msg=str(i), **MAP_TOL)


@pytest.mark.parametrize("kind", ["darkformer", "performer", "lfk"])
@pytest.mark.parametrize("causal", [True, False])
def test_rf_attention_matches_reference(kind, causal):
    """The port's plain path (chunked scan, 8-token chunks over L = 20)
    and its kernel path (the kernel's plain version) against the
    reference's ``rf_attention(use_kernel=True)`` (Pallas in interpret
    mode when causal)."""
    _, tcfg, jparams, tparams = _setup("smollm-135m", kind=kind)
    fj = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["units"]["b0"]["attn"]["feat"])
    ft = {k: v[0] for k, v in tparams["units"]["b0"]["attn"]["feat"].items()}
    rng = np.random.default_rng(1)
    b, g, hg, l, d = 2, 3, 1, 20, 16
    q = rng.standard_normal((b, g, hg, l, d)).astype(np.float32)
    k = rng.standard_normal((b, g, 1, l, d)).astype(np.float32)
    v = rng.standard_normal((b, g, 1, l, d)).astype(np.float32)
    exp = np.asarray(jatt.rf_attention(q, k, v, fj, tcfg.attn, causal=causal,
                                       use_kernel=True))
    for use_kernel in (False, True):
        got = tatt.rf_attention(_t(q), _t(k), _t(v), ft, tcfg.attn,
                                causal=causal, chunk=8,
                                use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), exp, err_msg=str(use_kernel),
                                   **OUT_TOL)


# every gradient leaf: f32 through 3 layers and a 256-way softmax, in
# another summation order
GRAD_TOL = dict(atol=2e-6, rtol=2e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_loss_and_every_gradient_match_jax_grad(arch, use_kernel):
    jcfg, tcfg, jparams, tparams = _setup(arch, use_kernel)
    jb, tb = _batch(jcfg.vocab)
    (jloss, jm), jgrads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jparams, jcfg, jb)
    leaves = dict(flatten(tparams))
    for t in leaves.values():
        t.requires_grad_(True)
    tloss, tm = tlm.loss_fn(tparams, tcfg, tb)
    tgrads = torch.autograd.grad(tloss, list(leaves.values()),
                                 allow_unused=True)
    for name in ("loss", "ce", "z_loss", "accuracy"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   err_msg=name, **OUT_TOL)
    exp = _flat_np(jgrads)
    assert exp.keys() == leaves.keys()
    for (path, t), g in zip(leaves.items(), tgrads):
        g = torch.zeros_like(t) if g is None else g
        np.testing.assert_allclose(g.numpy(), exp[path], err_msg=path,
                                   **GRAD_TOL)


def test_three_train_steps_match_reference():
    """From one shared state (the reference's params and AdamW state after
    two of its own steps), three more steps in each package: the loss
    trajectory and every param and moment after them."""
    jcfg, tcfg, jparams, _ = _setup("smollm-135m")
    sched_args = (3e-3, 2, 5)
    jopt_cfg = JAdamWConfig(lr=3e-3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg,
                                           jcosine(*sched_args)))
    jopt = jadamw_init(jparams, jopt_cfg)
    data = SyntheticLM(jcfg.vocab, 16, 4, seed=2)
    for s in range(2):
        jparams, jopt, _ = jstep(jparams, jopt, dict(data.batch(s)),
                                 jnp.int32(s))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    tparams = bridge.params_from_jax(to_np(jparams), tcfg, device="cpu")
    topt = bridge.tree_from_jax(to_np(jopt), device="cpu")
    tstep = tsteps.make_train_step(tcfg, AdamWConfig(lr=3e-3),
                                   cosine_warmup(*sched_args))
    for s in range(2, 5):
        b = data.batch(s)
        jparams, jopt, jm = jstep(jparams, jopt, dict(b), jnp.int32(s))
        tparams, topt, tm = tstep(
            tparams, topt, {k: torch.tensor(v).long() for k, v in b.items()},
            s)
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       err_msg=f"{name} step {s}", **OUT_TOL)
    assert int(topt["count"]) == int(jopt["count"]) == 5
    got = dict(flatten({"params": tparams, "opt": topt}))
    exp = _flat_np({"params": jparams, "opt": jopt})
    assert got.keys() == exp.keys()
    for path, e in exp.items():
        # Adam's normalized steps: three updates of at most ~lr each
        np.testing.assert_allclose(got[path].numpy(), e, err_msg=path,
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_qkv_only_freeze_semantics(weight_decay):
    """As tests/test_integration.py::test_qkv_only_freeze_semantics, in
    both packages from one shared state (the reference's after two of its
    own qkv-only steps, so that Adam's first, sign-like step is behind
    it): a qkv-only step moves the wq/wk/wv/m_mat leaves, and a frozen
    leaf, whose gradient is zeroed, moves by the decoupled weight decay
    only: bitwise unchanged at weight_decay 0, p·(1 − lr·wd) otherwise
    (f32). Every leaf agrees with the reference's jitted step."""
    jcfg, tcfg, jparams, _ = _setup("smollm-135m")
    lr = 1e-2
    jopt_cfg = JAdamWConfig(lr=lr, weight_decay=weight_decay)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg, jconstant(lr),
                                           freeze=jsteps.qkv_only_freeze))
    jopt = jadamw_init(jparams, jopt_cfg)
    data = SyntheticLM(jcfg.vocab, 32, 4, seed=1)
    for s in range(2):
        jparams, jopt, _ = jstep(jparams, jopt, dict(data.batch(s)),
                                 jnp.int32(s))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    tparams = bridge.params_from_jax(to_np(jparams), tcfg, device="cpu")
    topt = bridge.tree_from_jax(to_np(jopt), device="cpu")
    step = tsteps.make_train_step(
        tcfg, AdamWConfig(lr=lr, weight_decay=weight_decay), constant(lr),
        freeze=tsteps.qkv_only_freeze)
    b = data.batch(2)
    jp2, _, _ = jstep(jparams, jopt, dict(b), jnp.int32(2))
    tp2, _, _ = step(tparams, topt,
                     {k: torch.tensor(v).long() for k, v in b.items()}, 2)
    exp = _flat_np(jp2)
    for (path, a), (_, b) in zip(flatten(tparams), flatten(tp2)):
        # an Adam step of at most ~lr, in another summation order
        np.testing.assert_allclose(b.numpy(), exp[path], err_msg=path,
                                   atol=1e-5, rtol=1e-4)
        if not tsteps.qkv_only_freeze(path):
            assert not torch.equal(a, b), path
        elif weight_decay == 0.0:
            assert torch.equal(a, b), path
        else:
            np.testing.assert_allclose(
                b.numpy(), a.numpy() * (1 - lr * weight_decay),
                err_msg=path, atol=0, rtol=1e-6)


def test_qkv_only_freeze_keeps_bf16_leaves_bitwise():
    """In bf16 (the full-size configs' type) the decay of a frozen leaf,
    lr·wd = 3e-6 of it here, is below half a bf16 ulp: a qkv-only step
    leaves every frozen bf16 leaf bitwise, in both packages, and moves
    the others. The f32 feature draw feat.w, frozen too, moves by that
    decay alone."""
    jcfg = dataclasses.replace(jcfgs.get_config("smollm-135m", reduced=True),
                               dtype="bfloat16")
    tcfg = tcfgs.get_config("smollm-135m", reduced=True, dtype="bfloat16")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    jb, tb = _batch(jcfg.vocab)
    jopt_cfg = JAdamWConfig(lr=3e-4)
    jp2, _, _ = jax.jit(jsteps.make_train_step(
        jcfg, jopt_cfg, jconstant(3e-4), freeze=jsteps.qkv_only_freeze))(
        jparams, jadamw_init(jparams, jopt_cfg), jb, jnp.int32(0))
    opt_cfg = AdamWConfig(lr=3e-4)
    tp2, _, _ = tsteps.make_train_step(
        tcfg, opt_cfg, constant(3e-4), freeze=tsteps.qkv_only_freeze)(
        tparams, adamw_init(tparams, opt_cfg), tb, 0)
    jbefore, jafter = _flat_np(jparams), _flat_np(jp2)
    for (path, a), (_, b) in zip(flatten(tparams), flatten(tp2)):
        assert a.dtype == b.dtype, path
        frozen = tsteps.qkv_only_freeze(path)
        if frozen and a.dtype == torch.float32:
            for x, y in ((a.numpy(), b.numpy()),
                         (jbefore[path], jafter[path])):
                np.testing.assert_allclose(y, x * (1 - 3e-4 * 0.01),
                                           err_msg=path, atol=0, rtol=1e-6)
                assert not np.array_equal(x, y), path
            continue
        assert torch.equal(a, b) == frozen, path
        assert np.array_equal(jbefore[path], jafter[path]) == frozen, path


@pytest.mark.parametrize("kind,w_trained", [("darkformer", False),
                                            ("performer", False),
                                            ("lfk", True)])
def test_feature_projection_trains_for_lfk_only(kind, w_trained):
    """The trainability contract, in both packages: the gradient of the
    loss w.r.t. feat.w is exactly zero for darkformer and performer and
    non-zero for lfk; M (darkformer) always gets one."""
    jcfg, tcfg, jparams, tparams = _setup("smollm-135m", kind=kind)
    jb, tb = _batch(jcfg.vocab)
    jg = jax.grad(lambda p: jlm.loss_fn(p, jcfg, jb)[0])(jparams)
    jfeat = jg["units"]["b0"]["attn"]["feat"]
    leaves = dict(flatten(tparams))
    for t in leaves.values():
        t.requires_grad_(True)
    tg = dict(zip(leaves, torch.autograd.grad(
        tlm.loss_fn(tparams, tcfg, tb)[0], list(leaves.values()),
        allow_unused=True)))
    feat = "['units']['b0']['attn']['feat']"
    tw = tg[feat + "['w']"]
    assert bool(np.any(np.asarray(jfeat["w"]) != 0)) == w_trained
    assert (tw is not None and bool(tw.abs().max() > 0)) == w_trained
    if kind == "darkformer":
        assert float(np.abs(np.asarray(jfeat["m_mat"])).max()) > 0
        assert float(tg[feat + "['m_mat']"].abs().max()) > 0


def test_stabilizers_carry_no_gradient():
    """The stabilizer maxes (training and serving) are constants to
    autograd, as the reference's stop-gradients make them."""
    raw = torch.randn(2, 3, 4, 5, requires_grad=True)
    assert not tatt._stab_max(raw, True).requires_grad
    assert not tfm._stabilizer(raw, True).requires_grad
    _, c = tfm.prf_features(raw, torch.randn(6, 5))
    assert not c.requires_grad

"""recurrentgemma-2b trained, checkpointed and calibrated over the unit/rem
layout, in the port against the reference, on the CPU.

The reduced config has one unit of ("rec", "rec", "local") and one
remainder ``rec`` layer, so its ``rem`` holds no attention block; the
variant with ``block_pattern=("local", "rec", "rec")`` puts a ``local``
block in ``rem``, and both are held here. Both packages get the same
params (the reference's, brought across by ``repro_torch.bridge``) and
the same inputs (numpy seeds). Tolerances: the taps within ``TAP_TOL``
(f32 through up to 4 layers, as tests/test_torch_calibration.py), Sigma
= M^T M of every (attention layer, group) within ``SIGMA_TOL`` of the
reference's and M Lambda M^T = I within ``WHITE_TOL``; the homogeneous
configs' M bitwise the batched ``eigh`` it was before unit/rem; the
launcher's losses within ``tests/_torch_arch_parity.py``'s ``OUT_TOL``
(its params within ``STEP_ATOL_PER_UPDATE`` lr an update); checkpoints
bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch_parity as par
from repro import checkpoint as jckpt
from repro import configs as jcfgs
from repro.data import SyntheticLM
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim.schedules import cosine_warmup as jcosine_warmup
from repro_torch import checkpoint as tckpt
from repro_torch.core import calibration as tcal
from repro_torch.core import feature_maps as tfm
from repro_torch.launch import serve, train
from repro_torch.models import lm as tlm
from repro_torch.serving import ServingEngine, synthetic_requests
from repro_torch.tree import flatten

torch.set_num_threads(1)
ARCH = "recurrentgemma-2b"
TAP_TOL = 1e-4
SIGMA_TOL = 1e-4
WHITE_TOL = 1e-3
# params after the launcher's updates: AdamW moves an element by about
# lr m/sqrt(v) a step, and where a gradient is as small as GRAD_TOL's
# atol that ratio is as far apart as the gradients' signs, so an element
# may part by up to 2 lr an update (one embedding element did, by 1% of
# lr); the losses are what the steps are held to
STEP_ATOL_PER_UPDATE = 2.0
# the reduced config as it is (rem = [rec]) and with a local block in rem
PATTERNS = {"rem_rec": None, "rem_local": ("local", "rec", "rec")}


def _setup(pattern, seed=0):
    kw = {} if PATTERNS[pattern] is None else {
        "block_pattern": PATTERNS[pattern]}
    return par.setup(ARCH, seed=seed, **kw)


def _batch(vocab, b=2, l=24):
    data = SyntheticLM(vocab, l, b, seed=1).batch(0)
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.tensor(v).long() for k, v in data.items()})


def _sigma(m):
    m = np.asarray(m, np.float64)
    return np.einsum("...rd,...re->...de", m, m)


def _lam64(q, k, scale, shrink=0.05):
    d = q.shape[-1]
    x = np.concatenate([np.asarray(q, np.float64).reshape(-1, d),
                        np.asarray(k, np.float64).reshape(-1, d)]) * scale
    x = x - x.mean(0)
    cov = x.T @ x / len(x)
    return (1 - shrink) * cov + shrink * np.trace(cov) / d * np.eye(d)


def _m_leaves(params, cfg):
    """{tap name: (G, r, d) M} of every attention block, as numpy."""
    plen = len(cfg.block_pattern)
    out = {}
    for li, kind in enumerate(cfg.layer_kinds()):
        if kind not in ("attn", "local"):
            continue
        u, i = divmod(li, plen)
        if u < cfg.n_units:
            m = params["units"][f"b{i}"]["attn"]["feat"]["m_mat"][u]
        else:
            m = params["rem"][li - cfg.n_units * plen]["attn"]["feat"][
                "m_mat"]
        out[f"unit{u}/b{i}"] = np.asarray(m, np.float32)
    return out


# ---------------------------------------------------------------------------
# collect_qk and whitening_calibrate over unit/rem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_collect_qk_taps_unit_and_rem_blocks(pattern):
    """The reference's keys (``unit<u>/b<i>``, a remainder block's u =
    n_units) in layer order, shapes, and every tap within TAP_TOL; the
    RG-LRU layers advance x and yield none."""
    jcfg, tcfg, jparams, tparams = _setup(pattern)
    jb, tb = _batch(jcfg.vocab)
    exp = jlm.collect_qk(jparams, jcfg, jb)
    got = tlm.collect_qk(tparams, tcfg, tb)
    want = {"rem_rec": ["unit0/b2"],
            "rem_local": ["unit0/b0", "unit1/b0"]}[pattern]
    assert list(got) == sorted(exp) == want
    for name, (q, k) in got.items():
        assert q.shape == (2, tcfg.n_kv, tcfg.n_heads // tcfg.n_kv, 24,
                           tcfg.head_dim)
        assert k.shape == (2, tcfg.n_kv, 1, 24, tcfg.head_dim)
        for t, e, what in ((q, exp[name][0], "q"), (k, exp[name][1], "k")):
            np.testing.assert_allclose(t.numpy(), np.asarray(e),
                                       atol=TAP_TOL, rtol=0,
                                       err_msg=f"{name} {what}")


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_whitening_calibrate_writes_units_and_rem(pattern):
    """Each attention block's Sigma = M^T M within SIGMA_TOL of the
    reference's and M Lambda M^T = I within WHITE_TOL (Lambda in f64
    from the reference's taps), written into the unit's slice or the
    remainder block's own leaf; every other leaf is the input's own
    tensor, and the input tree is unchanged."""
    jcfg, tcfg, jparams, tparams = _setup(pattern)
    jb, tb = _batch(jcfg.vocab)
    before = {p: t.clone() for p, t in flatten(tparams)}
    exp = _m_leaves(jlm.whitening_calibrate(jparams, jcfg, jb), tcfg)
    new = tlm.whitening_calibrate(tparams, tcfg, tb)
    got = _m_leaves(new, tcfg)
    assert got.keys() == exp.keys()
    taps = jlm.collect_qk(jparams, jcfg, jb)
    for name, m in got.items():
        q, k = taps[name]
        for gi in range(tcfg.n_kv):
            e = exp[name][gi]
            gap = (np.abs(_sigma(m[gi]) - _sigma(e)).max()
                   / np.abs(_sigma(e)).max())
            assert gap <= SIGMA_TOL, (name, gi, gap)
            lam = _lam64(q[:, gi], k[:, gi], tcfg.head_dim ** -0.25)
            np.testing.assert_allclose(m[gi] @ lam @ m[gi].T,
                                       np.eye(tcfg.head_dim),
                                       atol=WHITE_TOL, rtol=0,
                                       err_msg=f"{name} group {gi}")
    for p, t in flatten(tparams):
        assert torch.equal(t, before[p]), p
    old, fresh = dict(flatten(tparams)), dict(flatten(new))
    assert old.keys() == fresh.keys()
    for p, t in fresh.items():
        assert t.dtype == old[p].dtype and t.shape == old[p].shape, p
        moved = p.endswith("['m_mat']") and not torch.equal(t, old[p])
        assert (t is not old[p]) == moved, p
    if pattern == "rem_local":
        assert "['rem'][0]['attn']['feat']['m_mat']" in fresh


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-8b"])
def test_homogeneous_m_is_one_batched_eigh(arch):
    """On a layer-stacked config the unit/rem write-back changes nothing:
    M is bitwise ``whitening_init`` of every layer's shrunk covariance in
    one batched ``eigh``, as it was before."""
    _, tcfg, _, tparams = par.setup(arch)
    _, tb = _batch(tcfg.vocab)
    got = tlm.whitening_calibrate(tparams, tcfg, tb)[
        "units"]["b0"]["attn"]["feat"]["m_mat"]
    taps = tlm.collect_qk(tparams, tcfg, tb)
    scale, d = tcfg.head_dim ** -0.25, tcfg.head_dim
    lams = torch.stack([torch.stack([tcal.shrinkage_covariance(torch.cat(
        [(q[:, gi].float() * scale).reshape(-1, d),
         (k[:, gi].float() * scale).reshape(-1, d)]), 0.05)
        for gi in range(q.shape[1])])
        for q, k in (taps[f"unit{li}/b0"] for li in range(tcfg.n_layers))])
    m_old = tparams["units"]["b0"]["attn"]["feat"]["m_mat"]
    want = tfm.whitening_init(lams, m_old.shape[-2]).to(m_old.dtype)
    assert torch.equal(got, want)


def test_calibrated_rem_local_serves_as_the_reference():
    """The calibrated params of the variant with a local block in rem,
    bridged from the reference's calibration, give the reference's
    loss: the rem block's M is read where it was written."""
    jcfg, tcfg, jparams, _ = _setup("rem_local")
    jb, _ = _batch(jcfg.vocab)
    cal = jlm.whitening_calibrate(jparams, jcfg, jb)
    tparams = par.bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, cal), tcfg, device="cpu")
    data = SyntheticLM(jcfg.vocab, 16, 2, seed=4).batch(0)
    jl, _ = jlm.loss_fn(cal, jcfg, {k: jnp.asarray(v)
                                    for k, v in data.items()})
    tl, _ = tlm.loss_fn(tparams, tcfg, par.tokens(data))
    np.testing.assert_allclose(float(tl), float(jl), **par.OUT_TOL)


# ---------------------------------------------------------------------------
# checkpoints with the rem list
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_with_rem_cross_between_packages(tmp_path, dtype):
    """{"params", "opt"} with AdamW's factored second moment, port ->
    reference and reference -> port, every leaf bitwise: the ``rem``
    list's params and its {"row", "col"} factors among them."""
    keys = par.check_checkpoints_cross(ARCH, tmp_path, dtype,
                                       factored_second_moment=True)
    for k in ("['params']['rem'][0]['rec']['wx']",
              "['opt']['mu']['rem'][0]['rec']['lam']",
              "['opt']['nu']['rem'][0]['rec']['wa']['row']",
              "['opt']['nu']['rem'][0]['ffn']['w_out']['col']",
              "['opt']['nu']['units']['b2']['attn']['feat']['m_mat']['row']"):
        assert k in keys, k


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_train_launcher_matches_reference_and_serves_its_checkpoint(
        tmp_path, capsys):
    """``launch/train.py --arch recurrentgemma-2b --reduced`` finetuning
    from the reference's params (a checkpoint the reference wrote)
    against the reference's train step with the launcher's AdamW and
    cosine schedule: the loss at each of 3 steps (2 updates) within
    OUT_TOL, the params after them within 2 lr an update. Then ``serve --load``
    of the checkpoint the launcher wrote serves the greedy streams of an
    engine on the params restored from it, and not the seed's."""
    jcfg, tcfg, jparams, _ = _setup("rem_rec")
    src = tmp_path / "ref"
    jckpt.save_checkpoint(str(src), 0, {"params": jparams})
    steps, lr, warmup, b, l = 3, 3e-3, 2, 2, 32
    ck = tmp_path / "port"
    out = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", str(steps), "--batch", str(b), "--seq",
                      str(l), "--lr", str(lr), "--warmup", str(warmup),
                      "--log-every", "1", "--finetune-from", str(src),
                      "--ckpt-dir", str(ck)])
    jopt_cfg = JAdamWConfig(lr=lr)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt_cfg, jcosine_warmup(lr, warmup, steps)))
    jopt = jadamw_init(jparams, jopt_cfg)
    data = SyntheticLM(jcfg.vocab, l, b, seed=0)
    losses = []
    for s in range(steps):
        jparams, jopt, m = jstep(jparams, jopt, dict(data.batch(s)),
                                 jnp.int32(s))
        losses.append(float(m["loss"]))
    got = [m["loss"] for m in out["metrics"]]
    np.testing.assert_allclose(got, losses, **par.OUT_TOL)
    exp = par.flat_np(jparams)
    for path, t in flatten(out["params"]):
        np.testing.assert_allclose(
            t.numpy(), exp[path], err_msg=path, rtol=0,
            atol=STEP_ATOL_PER_UPDATE * lr * (steps - 1))
    assert tckpt.all_steps(str(ck)) == [steps - 1]

    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--slots", "2", "--max-len", "48", "--prompt-len", "4-20",
            "--gen", "3-5", "--chunk-tokens", "8"]
    st = serve.main(args + ["--load", str(ck)])
    assert "loaded params from" in capsys.readouterr().out
    assert st["decode_path"] == "fused_plain"
    got = [r.tokens for r in sorted(st["results"], key=lambda r: r.uid)]
    restored, _ = tckpt.restore_checkpoint(str(ck), {
        "params": tlm.init_params(tcfg, seed=1, device="cpu")})
    eng = ServingEngine(restored["params"],
                        dataclasses.replace(tcfg, use_kernel=True),
                        max_slots=2, max_len=48, chunk_tokens=8,
                        overlap=True, device="cpu")
    uids = [eng.submit(r) for r in synthetic_requests(
        3, tcfg.vocab, prompt_range=(4, 20), gen_range=(3, 5))]
    by_uid = {r.uid: r.tokens for r in eng.run()}
    assert got == [by_uid[u] for u in uids]
    fresh = serve.main(args)
    assert [r.tokens for r in sorted(fresh["results"],
                                     key=lambda r: r.uid)] != got
    assert jcfgs.get_config(ARCH, reduced=True).n_rem == 1

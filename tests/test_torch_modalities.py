"""The non-text modalities of the port against the reference's, reduced, on
the CPU: hubert-xlarge (audio frames, a learned ``mask_embed`` at the
masked frames, the loss on those frames only, noncausal attention) and
internvl2-76b (a prefix of patch embeddings before the text tokens, the
loss on the text positions, decode positions after the prefix).

Both packages get the same params (the reference's, brought across by
``repro_torch.bridge``) and the same inputs (numpy seeds, the port's
``SyntheticAudio`` and ``SyntheticVLM`` bitwise the reference's).
Tolerances are ``tests/_torch_arch_parity.py``'s: logits and every
serve-state leaf within ``ATOL``, the loss within ``OUT_TOL``, every
gradient within ``GRAD_TOL``; the calibration taps within ``TAP_TOL``
and Sigma = M^T M within ``SIGMA_TOL`` (as
tests/test_torch_recurrent_train.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch_parity as par
from repro import checkpoint as jckpt
from repro import data as jdata
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim.schedules import cosine_warmup as jcosine_warmup
from repro.serving import ServingEngine as JEngine
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tcfgs
from repro_torch import data as tdata
from repro_torch.launch import serve, train
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving import ServingEngine
from repro_torch.tree import flatten

torch.set_num_threads(1)
HUBERT, VLM = "hubert-xlarge", "internvl2-76b"
ARCHS = [HUBERT, VLM]
TAP_TOL = 1e-4
SIGMA_TOL = 1e-4
# the launcher's params after its updates: AdamW moves an element by
# about lr m/sqrt(v) a step, as tests/test_torch_recurrent_train.py
STEP_ATOL_PER_UPDATE = 2.0
# the reference's test_vlm_prefill_decode_positions: decode logits
# against the training forward's at the same positions (the serving
# path's running stabilizer against the forward's whole-row one)
SERVE_VS_TRAIN_TOL = 0.08


def _jbatch(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _stacked(jstate):
    """The reference's fresh unit-layout serve state of a homogeneous
    stack (one unit a layer) under the port's stacked key."""
    return {"layers": jstate["units"]["b0"], "pos": jstate["pos"]}


# ---------------------------------------------------------------------------
# configs, init, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch):
    par.assert_config_fields_match(arch)
    cfg = tcfgs.get_config(arch)
    assert not cfg.tie_embeddings and cfg.attn.num_features == 256
    if arch == HUBERT:
        assert (cfg.modality, cfg.causal, cfg.head_dim) == ("audio", False,
                                                            80)
    else:
        assert (cfg.modality, cfg.num_patches, cfg.head_dim) == ("vlm", 256,
                                                                 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_reference_tree(arch):
    """The reference's tree, path for path, shape and dtype:
    ``mask_embed`` (d_model,) for audio only, the untied ``lm_head``."""
    par.assert_init_tree_matches(arch)
    cfg = tcfgs.get_config(arch, reduced=True)
    got = dict(flatten(tlm.init_params(cfg, seed=0, device="cpu")))
    assert got["['lm_head']"].shape == (cfg.d_model, cfg.vocab)
    assert ("['mask_embed']" in got) == (arch == HUBERT)
    if arch == HUBERT:
        assert got["['mask_embed']"].shape == (cfg.d_model,)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5)])
def test_synthetic_audio_and_vlm_batches_are_bitwise_the_reference(seed,
                                                                   step):
    for port, ref in (
            (tdata.SyntheticAudio(48, 20, 3, vocab=31, seed=seed),
             jdata.SyntheticAudio(48, 20, 3, vocab=31, seed=seed)),
            (tdata.SyntheticVLM(48, 8, 12, 3, 97, seed=seed),
             jdata.SyntheticVLM(48, 8, 12, 3, 97, seed=seed))):
        got, exp = port.batch(step), ref.batch(step)
        assert got.keys() == exp.keys()
        for k, e in exp.items():
            assert got[k].dtype == e.dtype and got[k].shape == e.shape, k
            assert par.bits(got[k]) == par.bits(e), k


@pytest.mark.parametrize("arch", ARCHS)
def test_make_data_picks_the_modality(arch):
    """``launch.train.make_data`` gives the reference launcher's stream
    (``--seq`` the text length for vlm) and ``to_device`` keeps its
    types: frames and patches f32, the mask bool, tokens int64."""
    cfg = tcfgs.get_config(arch, reduced=True)
    args = type("Args", (), dict(seq=10, batch=2, seed=4,
                                 data="synthetic"))()
    data = train.make_data(cfg, args)
    if arch == HUBERT:
        assert isinstance(data, tdata.SyntheticAudio)
        ref = jdata.SyntheticAudio(cfg.d_model, 10, 2, vocab=cfg.vocab,
                                   seed=4)
    else:
        assert isinstance(data, tdata.SyntheticVLM)
        ref = jdata.SyntheticVLM(cfg.d_model, cfg.num_patches, 10, 2,
                                 cfg.vocab, seed=4)
    got, exp = data.batch(1), ref.batch(1)
    for k, e in exp.items():
        assert par.bits(got[k]) == par.bits(e), k
    t = train.to_device(got, "cpu")
    for k, v in t.items():
        want = (torch.float32 if k in ("frames", "patch_embeds") else
                torch.bool if k == "mask" else torch.int64)
        assert v.dtype == want, k


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,use_kernel,drop_mask", [
    (HUBERT, False, False), (HUBERT, False, True), (VLM, False, False),
    (VLM, True, False)])
def test_loss_and_grads_match_reference(arch, use_kernel, drop_mask):
    """The loss, ce, z-loss, aux and accuracy and every gradient against
    ``jax.grad``: hubert over its masked frames (without a mask, over
    every label, as the reference weights it), internvl2 over its text
    positions, through B5's plain version under ``use_kernel``. hubert's
    ``embed`` has no path to the loss: its gradient is zero on both
    sides, and the mask's ``mask_embed`` gets one only with a mask."""
    cfg = tcfgs.get_config(arch, reduced=True)
    data = par.make_batch(cfg, seq=16)
    if drop_mask:
        data.pop("mask")
    grads = {}
    tm = par.check_loss_and_grads(arch, use_kernel=use_kernel, data=data,
                                  grads_out=grads)
    assert float(tm["aux"]) == 0.0
    if arch == HUBERT:
        assert not grads["['embed']"].any()
        assert bool(grads["['mask_embed']"].any()) == (not drop_mask)
    else:
        assert grads["['embed']"].any() and grads["['lm_head']"].any()


def test_vlm_loss_reads_the_text_positions_only():
    """The logits at the patch positions do not enter internvl2's loss:
    ``forward_train`` gives num_patches + L rows, and ``loss_fn``'s ce is
    the cross-entropy computed by hand over the last L of them."""
    _, tcfg, _, tparams = par.setup(VLM)
    data = par.tokens(par.make_batch(tcfg, seq=12))
    loss, m = tlm.loss_fn(tparams, tcfg, data)
    logits, _ = tlm.forward_train(tparams, tcfg, data)
    assert logits.shape[1] == tcfg.num_patches + 12
    text = logits[:, -12:]
    logz = torch.logsumexp(text, -1)
    ce = -(torch.gather(text, -1, data["labels"][..., None])[..., 0]
           - logz).mean()
    np.testing.assert_allclose(float(m["ce"]), float(ce), rtol=1e-6)


def test_train_step_decays_hubert_embed_as_the_reference():
    """One train step from a shared state in both packages (AdamW, weight
    decay 0.1): the loss within OUT_TOL, every leaf within 2 lr (AdamW's
    first update is about lr sign(g), which parts where a gradient is
    near zero, as the launcher test allows), and hubert's ``embed``,
    which gets a zero gradient, moved by the decoupled decay alone, p (1
    - lr wd), on both sides."""
    lr, wd = 1e-2, 0.1
    jcfg, tcfg, jparams, tparams = par.setup(HUBERT)
    jopt_cfg = JAdamWConfig(lr=lr, weight_decay=wd)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg,
                                           lambda s: jnp.float32(lr)))
    opt_cfg = AdamWConfig(lr=lr, weight_decay=wd)
    tstep = tsteps.make_train_step(tcfg, opt_cfg, lambda s: lr)
    data = par.make_batch(tcfg, seq=16)
    jp, _, jm = jstep(jparams, jadamw_init(jparams, jopt_cfg),
                      _jbatch(data), jnp.int32(0))
    tp, _, tm = tstep(tparams, adamw_init(tparams, opt_cfg),
                      par.tokens(data), 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **par.OUT_TOL)
    exp = par.flat_np(jp)
    for path, t in flatten(tp):
        np.testing.assert_allclose(t.numpy(), exp[path], err_msg=path,
                                   atol=STEP_ATOL_PER_UPDATE * lr, rtol=0)
    decayed = tparams["embed"].numpy() * (1 - lr * wd)
    for got in (tp["embed"].numpy(), exp["['embed']"]):
        np.testing.assert_allclose(got, decayed, atol=0, rtol=1e-6)


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_vlm_prefill_and_decode_match_reference(use_kernel):
    """The reference's ``test_vlm_prefill_decode_positions`` case in both
    packages: ``lm.prefill`` of the patches and 3 prompt tokens, then a
    decode step for each further token. ``pos`` is num_patches + 3 after
    the prefill; the logits and every state leaf (S, z, c) match the
    reference's after each call (fused plain kernels under
    ``use_kernel``); and the decode logits match the port's training
    forward at the same positions, which an off-by-``num_patches``
    position would break."""
    jcfg, tcfg, jparams, tparams = par.setup(VLM, use_kernel=use_kernel)
    rng = np.random.default_rng(1)
    lt = 6
    toks = rng.integers(0, jcfg.vocab, (1, lt)).astype(np.int32)
    patches = (0.02 * rng.standard_normal(
        (1, jcfg.num_patches, jcfg.d_model))).astype(np.float32)
    full, _ = tlm.forward_train(tparams, tcfg, {
        "tokens": torch.tensor(toks).long(),
        "patch_embeds": torch.tensor(patches)})
    max_len = jcfg.num_patches + lt + 2
    jlog, jst = jlm.prefill(jparams, jcfg, {
        "tokens": jnp.asarray(toks[:, :3]),
        "patch_embeds": jnp.asarray(patches)}, max_len=max_len)
    tlog, tst = tlm.prefill(tparams, tcfg, {
        "tokens": torch.tensor(toks[:, :3]).long(),
        "patch_embeds": torch.tensor(patches)}, max_len=max_len)
    assert int(tst["pos"]) == int(jst["pos"]) == jcfg.num_patches + 3
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=par.ATOL, rtol=0, err_msg="prefill")
    par.assert_states_close(tst, _stacked(jst), "after prefill")
    jst = _stacked(jst)        # the reference's stacked decode from here
    for t in range(3, lt):
        jlog, jst = jlm.decode_step(jparams, jcfg, jnp.asarray(toks[:, t]),
                                    jst)
        tlog, tst = tlm.decode_step(tparams, tcfg,
                                    torch.tensor(toks[:, t]).long(), tst)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=par.ATOL, rtol=0,
                                   err_msg=f"decode {t}")
        par.assert_states_close(tst, jst, f"after decode {t}")
        gap = float((tlog - full[:, jcfg.num_patches + t]).abs().max())
        assert gap < SERVE_VS_TRAIN_TOL, (t, gap)
    assert int(tst["pos"]) == jcfg.num_patches + lt


@pytest.mark.parametrize("use_kernel", [False, True])
def test_hubert_prefill_matches_reference(use_kernel):
    """``lm.prefill`` on hubert takes its batch size from the frames and
    runs the causal serving path in both packages (the reference's
    ``attn_prefill`` takes no ``causal``): the last logits and every
    layer's state within ATOL, ``pos`` the frame count."""
    jcfg, tcfg, jparams, tparams = par.setup(HUBERT, use_kernel=use_kernel)
    data = par.make_batch(tcfg, seq=10, b=3)
    jlog, jst = jlm.prefill(jparams, jcfg, _jbatch(data), max_len=16)
    tlog, tst = tlm.prefill(tparams, tcfg, par.tokens(data), max_len=16)
    assert tlog.shape == jlog.shape == (3, 1, jcfg.vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=par.ATOL, rtol=0)
    par.assert_states_close(tst, _stacked(jst), "hubert prefill")
    assert int(tst["pos"]) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_serve_cli_refuse_non_text(arch, capsys):
    """Both packages' engines refuse a non-text config with the
    reference's message, and the port's serve CLI exits with it."""
    jcfg, tcfg, jparams, tparams = par.setup(arch)
    msg = "serving engine drives text decode only"
    with pytest.raises(ValueError, match=msg):
        JEngine(jparams, jcfg)
    with pytest.raises(ValueError, match=msg):
        ServingEngine(tparams, tcfg, device="cpu")
    with pytest.raises(SystemExit, match=msg):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu"])


# ---------------------------------------------------------------------------
# calibration taps
# ---------------------------------------------------------------------------

def _sigma(m):
    m = np.asarray(m, np.float64)
    return np.einsum("...rd,...re->...de", m, m)


@pytest.mark.parametrize("arch", ARCHS)
def test_collect_qk_and_whitening_calibrate_match_reference(arch):
    """``lm.collect_qk`` over the modality's batch (hubert's noncausal
    forward, internvl2's patches and text: num_patches + L positions)
    tap by tap within TAP_TOL, and ``whitening_calibrate``'s Sigma = M^T
    M per (layer, group) within SIGMA_TOL of the reference's."""
    jcfg, tcfg, jparams, tparams = par.setup(arch)
    data = par.make_batch(tcfg, seq=12)
    exp = jlm.collect_qk(jparams, jcfg, _jbatch(data))
    got = tlm.collect_qk(tparams, tcfg, par.tokens(data))
    l = 12 + (tcfg.num_patches if arch == VLM else 0)
    assert list(got) == sorted(exp) == [f"unit{i}/b0"
                                        for i in range(tcfg.n_layers)]
    for name, (q, k) in got.items():
        assert q.shape == (2, tcfg.n_kv, tcfg.n_heads // tcfg.n_kv, l,
                           tcfg.head_dim)
        for t, e, what in ((q, exp[name][0], "q"), (k, exp[name][1], "k")):
            np.testing.assert_allclose(t.numpy(), np.asarray(e),
                                       atol=TAP_TOL, rtol=0,
                                       err_msg=f"{name} {what}")
    jm = jlm.whitening_calibrate(jparams, jcfg, _jbatch(data))[
        "units"]["b0"]["attn"]["feat"]["m_mat"]
    tm = tlm.whitening_calibrate(tparams, tcfg, par.tokens(data))[
        "units"]["b0"]["attn"]["feat"]["m_mat"]
    for li in range(tcfg.n_layers):
        for gi in range(tcfg.n_kv):
            e = _sigma(np.asarray(jm[li, gi]))
            gap = np.abs(_sigma(tm[li, gi].numpy()) - e).max() / np.abs(
                e).max()
            assert gap <= SIGMA_TOL, (li, gi, gap)


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [(HUBERT, "float32"),
                                        (HUBERT, "bfloat16"),
                                        (VLM, "bfloat16")])
def test_checkpoints_cross_between_packages(arch, dtype, tmp_path):
    """{"params", "opt"} both ways, every leaf bitwise: ``mask_embed``
    and the untied ``lm_head`` with their AdamW moments among them."""
    keys = par.check_checkpoints_cross(arch, tmp_path, dtype)
    want = ["['params']['lm_head']", "['opt']['nu']['lm_head']"]
    if arch == HUBERT:
        want += ["['params']['mask_embed']", "['opt']['mu']['mask_embed']"]
    for k in want:
        assert k in keys, k


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_matches_reference(arch, tmp_path):
    """``launch/train.py --arch <arch> --reduced --device cpu``
    finetuning from the reference's params (a checkpoint the reference
    wrote) on the modality's stream against the reference's train step
    on the reference launcher's stream (``make_data``), with the
    launcher's AdamW and cosine schedule: the loss at each of 3 steps
    within OUT_TOL, the params after them within 2 lr an update, and the
    checkpoint written."""
    jcfg, tcfg, jparams, _ = par.setup(arch)
    src = tmp_path / "ref"
    jckpt.save_checkpoint(str(src), 0, {"params": jparams})
    steps, lr, warmup, b, l = 3, 3e-3, 2, 2, 16
    ck = tmp_path / "port"
    out = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", str(steps), "--batch", str(b), "--seq",
                      str(l), "--lr", str(lr), "--warmup", str(warmup),
                      "--log-every", "1", "--finetune-from", str(src),
                      "--ckpt-dir", str(ck)])
    assert out["config"].modality == jcfg.modality
    jopt_cfg = JAdamWConfig(lr=lr)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt_cfg, jcosine_warmup(lr, warmup, steps)))
    jopt = jadamw_init(jparams, jopt_cfg)
    data = (jdata.SyntheticAudio(jcfg.d_model, l, b, vocab=jcfg.vocab)
            if arch == HUBERT else
            jdata.SyntheticVLM(jcfg.d_model, jcfg.num_patches, l, b,
                               jcfg.vocab))
    losses = []
    for s in range(steps):
        jparams, jopt, m = jstep(jparams, jopt, _jbatch(data.batch(s)),
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
    assert dataclasses.replace(out["config"], use_kernel=False) == tcfg

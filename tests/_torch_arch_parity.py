"""Checks shared by tests/test_torch_archs.py and tests/test_torch_moe.py:
one reduced arch of the port held against the reference's on the CPU.

Both packages get the same params (the reference's, brought across by
``repro_torch.bridge``) and the same inputs (numpy seeds). Reduced
configs are f32. Tolerances: the LM's logits and every serve-state leaf
within ``ATOL`` (f32 in other reduction orders across 2-4 layers, as
tests/test_torch_model.py), the loss within ``OUT_TOL`` and every
gradient within ``GRAD_TOL`` (as tests/test_torch_training.py).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import checkpoint as jckpt
from repro import configs as jcfgs
from repro.data import SyntheticAudio, SyntheticLM, SyntheticVLM
from repro.launch import steps as jsteps
from repro.models import ModelConfig as JModelConfig
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim.schedules import constant as jconstant
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tcfgs
from repro_torch.launch import serve, steps as tsteps, train
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.schedules import constant
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import flatten

ATOL = 1e-4
OUT_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=2e-6, rtol=2e-4)
# reference fields the port's ModelConfig leaves out; the one it lacks
# (scan_layers) must hold the reference's default
LEFT_OUT = ()
# (L, valid_len) of each resumed chunk; no row is empty, as in serving
CHUNKS = [(6, (6, 2, 3)), (5, None), (7, (3, 7, 1))]
# the engines' traffic: prompts up to 21 tokens in chunks of 16, so the
# long ones resume over two chunks
LENGTHS, GENS = (5, 21, 9, 7), (6, 3, 8, 4)
CHUNK_TOKENS = 16


def setup(arch, seed=0, dtype="float32", **kw):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = dataclasses.replace(jcfgs.get_config(arch, reduced=True),
                               dtype=dtype, **kw)
    tcfg = tcfgs.get_config(arch, reduced=True, dtype=dtype, **kw)
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def flat_np(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def bits(a) -> bytes:
    a = np.asarray(a)
    return a.view(np.uint8).tobytes() if a.ndim else a.tobytes()


def tokens(batch):
    """A numpy batch as the port's CPU tensors (``train.to_device``):
    integer arrays int64, frames and patches f32, the mask bool."""
    return train.to_device(batch, "cpu")


def make_batch(cfg, seq=16, b=2, seed=1, step=0):
    """One numpy batch of the reference's stream for ``cfg``'s modality:
    SyntheticLM tokens, SyntheticAudio frames of ``seq`` positions, or
    SyntheticVLM patches then ``seq`` text tokens."""
    if cfg.modality == "audio":
        data = SyntheticAudio(cfg.d_model, seq, b, vocab=cfg.vocab,
                              seed=seed)
    elif cfg.modality == "vlm":
        data = SyntheticVLM(cfg.d_model, cfg.num_patches, seq, b, cfg.vocab,
                            seed=seed)
    else:
        data = SyntheticLM(cfg.vocab, seq, b, seed=seed)
    return data.batch(step)


def assert_config_fields_match(arch):
    """Every field of the port's config() and reduced() equal to the
    reference's, the nested FeatureConfig and MoEConfig field by field;
    a reference field the port lacks is in ``LEFT_OUT`` or holds the
    reference's default."""
    defaults = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    for reduced in (False, True):
        j = jcfgs.get_config(arch, reduced=reduced)
        t = tcfgs.get_config(arch, reduced=reduced)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        for name, value in td.items():
            exp = jd[name]
            if name == "moe" and exp is not None:
                exp = {k: v for k, v in exp.items() if k != "dispatch_spec"}
                assert jd["moe"]["dispatch_spec"] is None
            assert value == exp, (arch, reduced, name)
        for name in jd.keys() - td.keys():
            assert name in LEFT_OUT or jd[name] == defaults[name], (
                arch, reduced, name)


def assert_init_tree_matches(arch):
    """The port's own init draws the reference's tree: the same paths,
    shapes and dtypes (untied ``lm_head``, ``q_norm``/``k_norm``, the
    expert leaves with their leading layer axis)."""
    jcfg = jcfgs.get_config(arch, reduced=True)
    tcfg = tcfgs.get_config(arch, reduced=True)
    exp = {k: (v.shape, str(v.dtype)) for k, v in flat_np(
        jlm.init_params(jax.random.PRNGKey(0), jcfg)).items()}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in flatten(tlm.init_params(tcfg, seed=0, device="cpu"))}
    assert got == exp


def check_loss_and_grads(arch, use_kernel=False, data=None, grads_out=None,
                         **kw):
    """The loss (with ce, z_loss, aux and accuracy) and every gradient
    leaf against ``jax.grad`` on ``data`` (a numpy batch; by default
    :func:`make_batch`'s 2 x 16 of the arch's modality); ``kw``
    overrides config fields in both. Returns the port's metrics; the
    port's gradients go into ``grads_out`` by path when it is a dict."""
    jcfg, tcfg, jparams, tparams = setup(arch, use_kernel=use_kernel, **kw)
    if data is None:
        data = make_batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    (_, jm), jgrads = jax.jit(jax.value_and_grad(
        jlm.loss_fn, has_aux=True), static_argnums=1)(jparams, jcfg, jb)
    leaves = dict(flatten(tparams))
    for t in leaves.values():
        t.requires_grad_(True)
    tloss, tm = tlm.loss_fn(tparams, tcfg, tokens(data))
    tgrads = torch.autograd.grad(tloss, list(leaves.values()),
                                 allow_unused=True)
    for name in ("loss", "ce", "z_loss", "aux", "accuracy"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   err_msg=name, **OUT_TOL)
    exp = flat_np(jgrads)
    assert exp.keys() == leaves.keys()
    for (path, t), g in zip(leaves.items(), tgrads):
        g = torch.zeros_like(t) if g is None else g
        np.testing.assert_allclose(g.numpy(), exp[path], err_msg=path,
                                   **GRAD_TOL)
        if grads_out is not None:
            grads_out[path] = g
    return tm


def port_state_np(state) -> dict:
    """Every leaf of a port serve state, in either layout, as a numpy copy
    under the reference's ``keystr`` path (a block state's field as
    ``.s``)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif isinstance(node, tuple):
            for name, v in node._asdict().items():
                walk(v, f"{path}.{name}")
        else:
            t = node.detach().cpu()
            out[path] = (t.float() if t.is_floating_point() else
                         t).numpy().copy()
    walk(state, "")
    return out


def ref_state_path(path: str) -> str:
    """A reference serve-state path in the port's naming: an rwkv block's
    state is the reference's nested ``(RWKVState(s, shift), cshift)``
    and the port's flat ``RWKVBlockState(s, shift, cshift)``."""
    path = re.sub(r"\[0\]\.(s|shift)$", r".\1", path)
    return re.sub(r"\[1\]$", ".cshift", path)


def assert_states_close(tstate, jstate, msg, atol=ATOL):
    """The same leaves in both packages' serve states (the reference's
    None leaves dropped), each within ``atol``; ``pos`` equal."""
    exp = {ref_state_path(p): v for p, v in flat_np(jstate).items()}
    got = port_state_np(tstate)
    assert got.keys() == exp.keys(), msg
    for path, e in exp.items():
        if path == "['pos']":
            np.testing.assert_array_equal(got[path], e, err_msg=msg)
        else:
            np.testing.assert_allclose(got[path], e.astype(np.float32),
                                       atol=atol, rtol=0,
                                       err_msg=f"{path} {msg}")


def check_prefill_and_decode(arch, use_kernel, fused=True, chunks=CHUNKS,
                             **kw):
    """Resumed ragged packed chunks (three by default), then two decode
    steps, in both packages, in the serve-state layout the config takes
    (stacked, or unit/rem): logits and every serve-state leaf (S, z, c;
    h, conv; kv_k, kv_v, length; pos) after each. ``kw`` overrides
    config fields in both."""
    jcfg, tcfg, jparams, tparams = setup(arch, use_kernel=use_kernel, **kw)
    b = 3
    jstate = jlm.init_serve_state(jcfg, b=b, max_len=64, per_slot=True,
                                  stacked=tlm.can_stack_layers(tcfg))
    tstate = tlm.init_serve_state(tcfg, b=b, max_len=64, per_slot=True,
                                  device="cpu")
    rng = np.random.default_rng(3)
    for step, (l, vl) in enumerate(chunks):
        toks = rng.integers(0, jcfg.vocab, (b, l)).astype(np.int32)
        vl_np = None if vl is None else np.asarray(vl, np.int32)
        jlog, jstate = jlm.prefill_chunk(
            jparams, jcfg, {"tokens": jnp.asarray(toks)}, jstate,
            valid_len=None if vl is None else jnp.asarray(vl_np),
            fused=fused)
        tlog, tstate = tlm.prefill_chunk(
            tparams, tcfg, {"tokens": torch.tensor(toks).long()}, tstate,
            valid_len=None if vl is None else torch.tensor(vl_np),
            fused=fused)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=0,
                                   err_msg=f"prefill logits, chunk {step}")
        assert_states_close(tstate, jstate, f"after chunk {step}")
    for step in range(2):
        tok = rng.integers(0, jcfg.vocab, (b,)).astype(np.int32)
        jlog, jstate = jlm.decode_step(jparams, jcfg, jnp.asarray(tok),
                                       jstate, fused=fused)
        tlog, tstate = tlm.decode_step(tparams, tcfg,
                                       torch.tensor(tok).long(), tstate,
                                       fused=fused)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=0,
                                   err_msg=f"decode logits, step {step}")
        assert_states_close(tstate, jstate, f"after decode {step}")
    return tstate


def check_engine_streams(arch, overlap, use_kernel=True, **kw):
    """The same bridged params, requests and chunk schedule through both
    packages' engines under one scheduler: greedy streams equal token for
    token. ``kw`` overrides config fields in both."""
    jcfg, tcfg, jparams, tparams = setup(arch, use_kernel=use_kernel, **kw)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, n).tolist() for n in LENGTHS]
    streams = []
    for eng, req in (
            (JEngine(jparams, jcfg, max_slots=2, max_len=48,
                     chunk_tokens=CHUNK_TOKENS, overlap=overlap), JRequest),
            (ServingEngine(tparams, tcfg, max_slots=2, max_len=48,
                           chunk_tokens=CHUNK_TOKENS, overlap=overlap,
                           device="cpu"), Request)):
        uids = [eng.submit(req(prompt=p, max_new_tokens=n))
                for p, n in zip(prompts, GENS)]
        got = {r.uid: r.tokens for r in eng.run()}
        streams.append([got[u] for u in uids])
        assert eng.stats["finished"] == len(prompts)
    assert streams[0] == streams[1]
    assert [len(s) for s in streams[1]] == list(GENS)
    assert eng.stats["decode_path"] == (
        "none" if not tlm.has_attention(tcfg) else
        "exact" if tcfg.attn.kind == "exact" else
        "fused_plain" if use_kernel else "torch")


def check_checkpoints_cross(arch, tmp_path, dtype, **opt_kw):
    """{"params", "opt"} of the arch, port -> reference and reference ->
    port, every leaf bitwise (the untied lm_head and the expert leaves
    among them); ``opt_kw`` configures AdamW in both (e.g. its factored
    second moment). Returns the paths."""
    tcfg = tcfgs.get_config(arch, reduced=True, dtype=dtype)
    jcfg = dataclasses.replace(jcfgs.get_config(arch, reduced=True),
                               dtype=dtype)

    def port_state(seed):
        p = tlm.init_params(tcfg, seed=seed, device="cpu")
        return {"params": p, "opt": adamw_init(p, AdamWConfig(**opt_kw))}

    def jax_state(seed):
        p = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
        return {"params": p, "opt": jadamw_init(p, JAdamWConfig(**opt_kw))}

    port = port_state(3)
    port["opt"]["count"] += 7
    tckpt.save_checkpoint(str(tmp_path / "port"), 7, port)
    got, step = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                         jax_state(0))
    assert step == 7
    exp = {p: bridge.params_to_numpy({"x": t})["x"] for p, t in
           flatten(port)}
    flat = flat_np(got)
    assert flat.keys() == exp.keys()
    for k, e in exp.items():
        assert flat[k].dtype == e.dtype, k
        assert bits(flat[k]) == bits(e), k

    ref = jax_state(5)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 2, ref)
    got, step = tckpt.restore_checkpoint(str(tmp_path / "ref"),
                                         port_state(0))
    assert step == 2
    for (k, t), (jp, e) in zip(flatten(got),
                               jax.tree_util.tree_flatten_with_path(ref)[0]):
        assert k == jax.tree_util.keystr(jp)
        assert bits(bridge.params_to_numpy({"x": t})["x"]) == bits(e), k
    return exp.keys()


def check_qkv_only_freeze(arch, lr=1e-2, weight_decay=0.01):
    """From one shared state (the reference's after two of its own
    qkv-only steps), one more step in each package: every leaf agrees;
    wq/wk/wv/m_mat move; every other leaf (the norms, the feed-forward
    or experts and router, the head) moves by the decoupled weight decay
    alone, p·(1 − lr·wd) in f32. Returns the frozen paths."""
    jcfg, tcfg, jparams, _ = setup(arch)
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
    tp2, _, _ = step(tparams, topt, tokens(b), 2)
    exp = flat_np(jp2)
    frozen = []
    for (path, a), (_, b) in zip(flatten(tparams), flatten(tp2)):
        assert tsteps.qkv_only_freeze(path) == jsteps.qkv_only_freeze(path)
        np.testing.assert_allclose(b.numpy(), exp[path], err_msg=path,
                                   atol=1e-5, rtol=1e-4)
        if tsteps.qkv_only_freeze(path):
            frozen.append(path)
            np.testing.assert_allclose(
                b.numpy(), a.numpy() * (1 - lr * weight_decay),
                err_msg=path, atol=0, rtol=1e-6)
        else:
            assert not torch.equal(a, b), path
    return frozen


def run_clis(arch, capsys):
    """Both CLIs on the reduced arch with ``--device cpu``: the serve CLI
    (overlapped scheduler, fused plain path) finishes every request, the
    trainer's losses are finite."""
    st = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--requests", "3", "--slots", "2", "--max-len", "48",
                     "--prompt-len", "4-12", "--gen", "3-5",
                     "--chunk-tokens", "8"])
    assert st["finished"] == 3 and len(st["results"]) == 3
    assert st["prefill_path"] == st["decode_path"] == "fused_plain"
    assert "throughput:" in capsys.readouterr().out
    out = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--log-every", "1"])
    assert out["config"].name == tcfgs.get_config(arch, reduced=True).name
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    return out

"""rwkv6-7b in the port against the reference, on the CPU: RWKV-6's time
and channel mixes (``repro_torch.models.recurrent``) and the
attention-free layer-stacked stack they make (32 ``rwkv`` layers at full
size, 2 reduced), served on the engine's ``none`` path.

Both packages get the same params (the reference's, brought across by
``repro_torch.bridge``) and the same inputs (numpy seeds). The block
runs the reference's own sequential scan (``_wkv_scan``), not the wkv6
kernel, as the reference's block does. Tolerances:

  * ``rwkv6_apply`` and ``rwkv6_channel_mix`` alone, f32: outputs and
    carries within ``F32_TOL`` (the products and the scan's einsum round
    in other orders; the time mix's LayerNorm divides by a row's spread);
    bf16: outputs within ``BF16_TOL`` of their largest value (both
    packages round f32 values to bf16, and a bf16 product can differ by
    an ulp, which the LayerNorm carries on), the f32 carries within
    ``BF16_STATE_TOL`` of theirs; a chunked stream against the whole
    sequence within ``F32_TOL`` (f32);
  * the LM (loss and every gradient, logits and every serve-state leaf:
    S, shift, cshift, pos; greedy engine streams) at
    ``tests/_torch_arch_parity.py``'s tolerances;
  * inside the port, streams across schedulers and prefix-cache forks
    token for token;
  * the train launcher resumed from the reference's {"params", "opt"}
    checkpoint: its losses within ``OUT_TOL`` of the reference's train
    step, each leaf's update within ``UPDATE_RTOL`` of the reference's
    and every param within ``PARAM_ATOL_LR`` lr.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch_parity as par
from repro import checkpoint as jckpt
from repro.data import SyntheticLM
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import recurrent as jrec
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim.schedules import cosine_warmup as jcosine_warmup
from repro_torch import checkpoint as tckpt
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.launch import serve, train
from repro_torch.models import layers as tll
from repro_torch.models import lm as tlm
from repro_torch.models import recurrent as trec
from repro_torch.serving import PrefixCacheConfig, Request, ServingEngine
from repro_torch.tree import flatten, tree_map

torch.set_num_threads(1)
ARCH = "rwkv6-7b"
F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = 2 ** -7
BF16_STATE_TOL = 1e-2
D, H = 64, 4                   # the reduced config's width and heads
# the launcher's three updates from the reference's checkpoint, set from
# this test's readings: ||port update - reference update|| over
# ||reference update|| per leaf read 4.4e-5 at most (embed), where a
# launcher that never updates reads 1 and one with the sign flipped 2;
# the largest element gap read 0.005 lr, where a launcher that never
# updates reads 2.34 lr or more on every leaf
UPDATE_RTOL = 1e-3
PARAM_ATOL_LR = 0.05


def test_config_fields_match_reference():
    par.assert_config_fields_match(ARCH)
    cfg = tcfgs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim) == (
        32, 4096, 64, 64)
    assert (cfg.d_ff, cfg.vocab, cfg.dtype) == (14_336, 65_536, "bfloat16")
    assert not cfg.tie_embeddings and cfg.block_pattern == ("rwkv",)
    assert tlm.can_stack_layers(cfg) and not tlm.has_attention(cfg)


def test_port_init_matches_reference_tree():
    """Paths, shapes and dtypes (``tmix``, ``cmix``, the f32 ``decay_a``,
    ``decay_b``, ``ln_x`` and ``u`` of a bf16 model, the untied head),
    and the constants' values."""
    par.assert_init_tree_matches(ARCH)
    cfg = tcfgs.get_config(ARCH, reduced=True, dtype="bfloat16")
    got = dict(flatten(tlm.init_params(cfg, seed=0, device="cpu")))
    for name, dt in (("decay_a", torch.float32), ("wr", torch.bfloat16),
                     ("u", torch.float32)):
        assert got[f"['units']['b0']['tmix']['{name}']"].dtype == dt
    assert torch.equal(got["['units']['b0']['tmix']['mu']"],
                       torch.full((2, 5, D), 0.5))
    assert torch.equal(got["['units']['b0']['cmix']['mu']"],
                       torch.full((2, 2, D), 0.5))
    assert not got["['units']['b0']['tmix']['lam_w']"].any()
    assert torch.equal(got["['units']['b0']['tmix']['ln_x']['scale']"],
                       torch.ones((2, D)))


def test_init_params_draws_layer_by_layer():
    """Embed, then layer by layer the time mix (wr, wk, wv, wg, decay_a,
    decay_b, wo) and the channel mix (wk, wv, wr), then the head, each
    layer written into its slot of the stacked tensors as drawn."""
    cfg = tcfgs.get_config(ARCH, reduced=True)
    gen = torch.Generator().manual_seed(7)
    embed = tll.trunc_normal(gen, (cfg.vocab, cfg.d_model), 1.0)
    blocks = []
    for _ in range(cfg.n_layers):
        norms = {"ln1": tll.norm_init("rmsnorm", D),
                 "ln2": tll.norm_init("rmsnorm", D)}
        tmix = trec.rwkv6_init(gen, D, H)
        blocks.append({**norms, "tmix": tmix,
                       "cmix": trec.rwkv6_channel_mix_init(gen, D,
                                                           cfg.d_ff)})
    exp = {"embed": embed, "final_norm": tll.norm_init("rmsnorm", D),
           "units": {"b0": tree_map(lambda *ts: torch.stack(ts),
                                    *blocks)},
           "lm_head": tll.trunc_normal(gen, (D, cfg.vocab), 1.0)}
    got = dict(flatten(tlm.init_params(cfg, seed=7, device="cpu")))
    assert got.keys() == dict(flatten(exp)).keys()
    for path, t in flatten(exp):
        assert torch.equal(got[path], t), path


# ---------------------------------------------------------------------------
# the time and channel mixes alone
# ---------------------------------------------------------------------------

def _mix_params(seed, dtype):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    jt = jrec.rwkv6_init(k1, D, H, dtype=getattr(jnp, dtype))
    jc = jrec.rwkv6_channel_mix_init(k2, D, 2 * D, getattr(jnp, dtype))
    # the reference draws u and lam_w as constants; give them values
    rng = np.random.default_rng(seed)
    jt = {**jt, "u": jnp.asarray(rng.standard_normal((H, D // H)),
                                 jnp.float32),
          "lam_w": jnp.asarray(rng.uniform(-1.0, 1.0, D), jnp.float32)}
    tt, tc = (bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                   device="cpu") for p in (jt, jc))
    return (jt, jc), (tt, tc)


def _inputs(seed, dtype, b=3, l=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, D)).astype(np.float32)
    s = (0.5 * rng.standard_normal((b, H, D // H, D // H))).astype(
        np.float32)
    shift = np.asarray(jnp.asarray(rng.standard_normal((b, D)),
                                   getattr(jnp, dtype)).astype(jnp.float32))
    cshift = np.asarray(jnp.asarray(rng.standard_normal((b, D)),
                                    getattr(jnp, dtype)).astype(jnp.float32))
    return x, s, shift, cshift


def _run_ref(jp, x, s, shift, cshift, vl, dtype):
    jt, jc = jp
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jst = None if s is None else jrec.RWKVState(s=jnp.asarray(s),
                                                shift=jnp.asarray(shift))
    jvl = None if vl is None else jnp.asarray(vl)
    out, st = jrec.rwkv6_apply(jt, jx, H, jst, valid_len=jvl)
    cout, csh = jrec.rwkv6_channel_mix(
        jc, jx, None if cshift is None else jnp.asarray(cshift),
        valid_len=jvl)
    return [np.asarray(t.astype(jnp.float32)) for t in
            (out, st.s, st.shift, cout, csh)]


def _run_port(tp, x, s, shift, cshift, vl, dtype):
    tt, tc = tp
    tx = torch.tensor(x).to(getattr(torch, dtype))
    tst = None if s is None else trec.RWKVState(torch.tensor(s),
                                                torch.tensor(shift))
    tvl = None if vl is None else torch.tensor(vl)
    out, st = trec.rwkv6_apply(tt, tx, H, tst, valid_len=tvl)
    cout, csh = trec.rwkv6_channel_mix(
        tc, tx, None if cshift is None else torch.tensor(cshift),
        valid_len=tvl)
    assert out.dtype == cout.dtype == tx.dtype
    assert st.s.dtype == st.shift.dtype == csh.dtype == torch.float32
    return [t.float().numpy() for t in (out, st.s, st.shift, cout, csh)]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_and_channel_mix_match_reference(dtype, with_state, ragged):
    """Outputs (at the valid positions), S, the time mix's shift and the
    channel mix's against the reference's, from zero or from a carried
    state, full or ragged rows (9, 4 and 1 valid tokens)."""
    jp, tp = _mix_params(0, dtype)
    x, s, shift, cshift = _inputs(1, dtype)
    if not with_state:
        s = shift = cshift = None
    vl = np.array([9, 4, 1], np.int32) if ragged else None
    exp = _run_ref(jp, x, s, shift, cshift, vl, dtype)
    got = _run_port(tp, x, s, shift, cshift, vl, dtype)
    valid = (np.ones(x.shape[:2], bool) if vl is None else
             np.arange(x.shape[1])[None] < vl[:, None])
    for i, (g, e) in enumerate(zip(got, exp)):
        if i in (0, 3):
            g, e = g[valid], e[valid]
        if dtype == "float32":
            np.testing.assert_allclose(g, e, err_msg=str(i), **F32_TOL)
        else:
            tol = BF16_TOL if i in (0, 3) else BF16_STATE_TOL
            gap = np.abs(g - e).max() / np.abs(e).max()
            assert gap <= tol, (i, gap)


def test_streamed_chunks_match_the_whole_sequence():
    """The same 12 tokens whole, and in chunks of 5, 1, 6 carrying S and
    both shifts: outputs and the final carries within F32_TOL; and a
    padded row's carries are the ones its unpadded run gives."""
    _, (tt, tc) = _mix_params(2, "float32")
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 12, D)).astype(np.float32))
    whole, st = trec.rwkv6_apply(tt, x, H)
    cwhole, csh = trec.rwkv6_channel_mix(tc, x)
    outs, couts, tst, cst = [], [], None, None
    for a, b in ((0, 5), (5, 6), (6, 12)):
        o, tst = trec.rwkv6_apply(tt, x[:, a:b], H, tst)
        c, cst = trec.rwkv6_channel_mix(tc, x[:, a:b], cst)
        outs.append(o)
        couts.append(c)
    for g, e in ((torch.cat(outs, 1), whole), (tst.s, st.s),
                 (tst.shift, st.shift), (torch.cat(couts, 1), cwhole),
                 (cst, csh)):
        np.testing.assert_allclose(g.numpy(), e.numpy(), **F32_TOL)
    pad = torch.cat([x[:1, :7], torch.randn(1, 5, D)], 1)
    o, pst = trec.rwkv6_apply(tt, pad, H,
                              valid_len=torch.tensor([7], dtype=torch.int32))
    o7, st7 = trec.rwkv6_apply(tt, x[:1, :7], H)
    _, pc = trec.rwkv6_channel_mix(
        tc, pad, valid_len=torch.tensor([7], dtype=torch.int32))
    assert torch.equal(pc, x[:1, 6])
    np.testing.assert_allclose(o[:, :7].numpy(), o7.numpy(), **F32_TOL)
    np.testing.assert_allclose(pst.s.numpy(), st7.s.numpy(), **F32_TOL)
    assert torch.equal(pst.shift, st7.shift)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_reference():
    tm = par.check_loss_and_grads(ARCH)
    assert float(tm["aux"]) == 0.0


@pytest.mark.parametrize("use_kernel", [True, False])
def test_prefill_and_decode_match_reference(use_kernel):
    """Ragged packed chunks and decode steps over the stacked state:
    logits and every leaf (S, shift, cshift, pos) against the
    reference's ``(RWKVState(s, shift), cshift)``; ``use_kernel`` changes
    nothing (no attention layer, no kernel)."""
    st = par.check_prefill_and_decode(ARCH, use_kernel)
    assert set(st) == {"layers", "pos"}
    assert isinstance(st["layers"], trec.RWKVBlockState)
    assert st["layers"].s.shape == (2, 3, H, D // H, D // H)
    assert st["layers"].cshift.shape == (2, 3, D)
    _, tcfg, _, tparams = par.setup(ARCH, use_kernel=True)
    assert tlm.build_decode_proj(tparams, tcfg) is None


def test_engine_streams_match_reference_stream():
    """The port's counterpart of the reference's
    ``test_engine_streams_match_reference_for_recurrent_archs``: the
    reference's single-sequence stream (a prefill, then argmax decode
    steps) equals the port's stacked engine's on the same params."""
    jcfg, tcfg, jparams, tparams = par.setup(ARCH)
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab, 9).tolist()
    lg, st = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray([prompt])},
                         max_len=32)
    ref = [int(jnp.argmax(lg[0, -1]))]
    for _ in range(4):
        lg, st = jlm.decode_step(jparams, jcfg, jnp.asarray(ref[-1:]), st)
        ref.append(int(jnp.argmax(lg[0])))
    eng = ServingEngine(tparams, tcfg, max_slots=2, max_len=32,
                        device="cpu")
    assert eng._stacked
    uid = eng.submit(Request(prompt=prompt, max_new_tokens=5))
    got = {r.uid: r.tokens for r in eng.run()}
    assert got[uid] == ref
    assert eng.stats["decode_path"] == eng.stats["prefill_path"] == "none"


@pytest.mark.parametrize("overlap", [False, True])
def test_greedy_streams_match_reference_engine(overlap):
    par.check_engine_streams(ARCH, overlap)


@pytest.fixture(scope="module")
def model():
    cfg = tcfgs.get_config(ARCH, reduced=True, use_kernel=True)
    return cfg, tlm.init_params(cfg, seed=0, device="cpu")


def _requests(vocab, *, prefix=(), n=6, seed=0, temperature=0.0):
    rng = random.Random(seed)
    return [Request(prompt=list(prefix) + [rng.randrange(vocab) for _ in
                                           range(rng.randint(4, 26))],
                    max_new_tokens=rng.randint(3, 8), uid=6000 + i,
                    temperature=temperature,
                    **({"top_k": 7, "top_p": 0.9} if i % 3 == 1 else {}))
            for i in range(n)]


def _drain(model, reqs, **kw):
    cfg, params = model
    eng = ServingEngine(params, cfg, max_slots=3, max_len=64,
                        chunk_tokens=8, seed=0, device="cpu", **kw)
    for r in reqs:
        eng.submit(r)
    return {r.uid: list(r.tokens) for r in eng.run()}, eng


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_schedulers_agree_at_one_row_per_call(model, temperature):
    """Sequential and overlapped engines with one staged row per prefill
    call give the same streams, greedy and sampled, on the ``none``
    path."""
    runs = [_drain(model, _requests(model[0].vocab, seed=1,
                                    temperature=temperature),
                   overlap=overlap, prefill_rows=1)
            for overlap in (False, True)]
    assert runs[0][0] == runs[1][0]
    assert runs[1][1].stats["decode_path"] == "none"
    if temperature:
        assert any(len(set(t)) > 1 for t in runs[0][0].values())


@pytest.mark.parametrize("overlap", [False, True])
def test_prefix_cache_forks_equal_cold_starts(model, overlap):
    """Requests sharing a 16-token prefix, forked from the cached (S,
    shift, cshift) snapshots, give the streams of a cache-less engine,
    under both schedulers; no paged KV (no attention layer), as in the
    reference."""
    cfg, params = model
    rng = random.Random(42)
    prefix = [rng.randrange(cfg.vocab) for _ in range(16)]
    reqs = lambda: _requests(cfg.vocab, prefix=prefix, seed=3,  # noqa: E731
                             temperature=0.8)
    cold, _ = _drain(model, reqs(), overlap=overlap)
    pc = PrefixCacheConfig(block_tokens=8, page_size=8)
    _, eng = _drain(model, [Request(prompt=prefix + [1, 2],
                                    max_new_tokens=2, uid=5999)],
                    prefix_cache=pc, overlap=overlap)
    assert eng.prefix_cache.has(prefix)
    for r in reqs():
        eng.submit(r)
    got = {r.uid: list(r.tokens) for r in eng.run()}
    st = eng.stats
    assert st["forked_requests"] >= 5 and st["forked_tokens"] > 0
    assert not st["paged_kv"]
    assert got == cold


def test_exact_kind_serves_none_without_paged_kv(model):
    """With the attention kind switched to exact the stack still has no
    attention layer: the prefix cache keeps the contiguous layout (no
    page pools), the path is ``none`` and the streams are the PRF
    config's."""
    cfg, params = model
    exact = tcfgs.darkify(cfg, "exact", cfg.attn.num_features)
    got, eng = _drain((exact, params), _requests(cfg.vocab, seed=5),
                      prefix_cache=PrefixCacheConfig(block_tokens=8))
    assert not eng.stats["paged_kv"] and eng.stats["decode_path"] == "none"
    assert got == _drain(model, _requests(cfg.vocab, seed=5))[0]


def test_checkpoints_cross_between_packages(tmp_path):
    keys = par.check_checkpoints_cross(ARCH, tmp_path, "bfloat16")
    assert "['params']['units']['b0']['tmix']['decay_b']" in keys
    assert "['opt']['nu']['units']['b0']['cmix']['wv']" in keys
    assert "['params']['lm_head']" in keys


def test_clis_run_rwkv(capsys):
    """Both CLIs on the reduced config: the serve CLI on the ``none``
    path (its header says so), the trainer's losses finite and a
    calibration pass a no-op (no attention layer to tap)."""
    st = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--requests", "3", "--slots", "2", "--max-len", "48",
                     "--prompt-len", "4-12", "--gen", "3-5",
                     "--chunk-tokens", "8"])
    assert st["finished"] == 3 and len(st["results"]) == 3
    assert st["prefill_path"] == st["decode_path"] == "none"
    assert "path=none" in capsys.readouterr().out
    out = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--log-every", "1"])
    assert all(np.isfinite([m["loss"] for m in out["metrics"]]))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    assert tlm.collect_qk(out["params"], out["config"], batch) == {}
    assert tlm.whitening_calibrate(out["params"], out["config"],
                                   batch) is out["params"]


def test_train_launcher_resumes_reference_state(tmp_path):
    """The reference trains reduced rwkv6-7b one step and writes its
    params and AdamW state ({"params", "opt"}, step 0). ``launch/train.py
    --ckpt-dir`` resumes from that checkpoint and runs steps 1-3 under
    the launcher's AdamW and cosine schedule, beside the reference's
    train step on the same batches: each loss within ``OUT_TOL``, each
    leaf's update (params less the loaded params) within ``UPDATE_RTOL``
    of the reference's in norm, every param within ``PARAM_ATOL_LR`` lr,
    and the launcher's final checkpoint at step 3."""
    jcfg, _, jparams, _ = par.setup(ARCH)
    steps, lr, warmup, b, l = 4, 3e-3, 2, 2, 24
    jopt_cfg = JAdamWConfig(lr=lr)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt_cfg, jcosine_warmup(lr, warmup, steps)))
    jopt = jadamw_init(jparams, jopt_cfg)
    data = SyntheticLM(jcfg.vocab, l, b, seed=0)
    jparams, jopt, _ = jstep(jparams, jopt, dict(data.batch(0)),
                             jnp.int32(0))
    loaded = par.flat_np(jparams)
    ck = tmp_path / "ck"
    jckpt.save_checkpoint(str(ck), 0, {"params": jparams, "opt": jopt})
    out = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", str(steps), "--batch", str(b), "--seq",
                      str(l), "--lr", str(lr), "--warmup", str(warmup),
                      "--log-every", "1", "--ckpt-dir", str(ck),
                      "--ckpt-every", str(steps)])
    losses = []
    for s in range(1, steps):
        jparams, jopt, m = jstep(jparams, jopt, dict(data.batch(s)),
                                 jnp.int32(s))
        losses.append(float(m["loss"]))
    assert [m["step"] for m in out["metrics"]] == [1, 2, 3]
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]],
                               losses, **par.OUT_TOL)
    exp = par.flat_np(jparams)
    for path, t in flatten(out["params"]):
        got, want = t.numpy(), exp[path]
        ref_update = want - loaded[path]
        gap = np.linalg.norm(got - want) / np.linalg.norm(ref_update)
        assert gap <= UPDATE_RTOL, (path, gap)
        np.testing.assert_allclose(got, want, err_msg=path, rtol=0,
                                   atol=PARAM_ATOL_LR * lr)
    assert int(out["opt"]["count"]) == int(jopt["count"]) == steps
    assert tckpt.all_steps(str(ck)) == [0, steps - 1]

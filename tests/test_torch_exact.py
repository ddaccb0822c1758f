"""Exact softmax attention and the paper's baselines in the port, against
the reference, on the CPU.

The reference computes exact attention, the constant and the random
baselines in plain ``jnp``, outside any Pallas kernel; the port computes
them in plain torch. Held here, each at its stated tolerance:

  * the functions of ``core/linear_attention.py`` and the exact branches
    of ``core/attention.py``, with the random baseline fed the
    reference's draw and the cache writes (() length, (B,) length,
    ragged ``valid_len``, a padded chunk at the cache's end) bitwise
    outside the positions they write;
  * the LM's exact ``prefill_chunk`` and ``decode_step`` (logits and
    every serve-state leaf), chunked against whole-prompt prefill, a
    ragged padded chunk against serial rows, decode against the full
    causal pass, and a cancelled and re-admitted stream;
  * the exact, constant and random losses with every gradient against
    ``jax.grad``, and the exact -> darkformer transplant with three
    finetune steps against the reference's;
  * the engine serving exact under both schedulers, and both CLIs.

Reduced configs, f32 unless a case says bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import attention as jatt
from repro.core import linear_attention as jla
from repro.data import SyntheticLM
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim.schedules import constant as jconstant
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.core import attention as tatt
from repro_torch.core import feature_maps as tfm
from repro_torch.core import linear_attention as tla
from repro_torch.launch import serve, steps as tsteps, train
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.schedules import constant
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import slots as tslots
from repro_torch.tree import flatten

torch.set_num_threads(1)
# f32 in another summation order (sums over L <= 24 positions)
F32_TOL = dict(atol=1e-5, rtol=0)
# two bf16 ulps on a bf16 output, as kernels/check.py's BF16_OUT_TOL
BF16_TOL = dict(atol=1e-4, rtol=2.0 ** -6)
# the LM's logits and state through 3 layers, as tests/test_torch_model.py
ATOL = 1e-4
# the loss and every gradient leaf, as tests/test_torch_training.py
OUT_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=2e-6, rtol=2e-4)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.tensor(a).to(getattr(torch, dtype)))


def _cfgs(kind, arch="smollm-135m", **kw):
    jcfg = jcfgs.get_config(arch, reduced=True)
    tcfg = tcfgs.get_config(arch, reduced=True)
    m = jcfg.attn.num_features
    jcfg = dataclasses.replace(jcfgs.darkify(jcfg, kind, m), **kw)
    tcfg = dataclasses.replace(tcfgs.darkify(tcfg, kind, m), **kw)
    return jcfg, tcfg


def _setup(kind, arch="smollm-135m", seed=0, **kw):
    jcfg, tcfg = _cfgs(kind, arch, **kw)
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _assert_state_close(jstate, tstate, msg, atol=ATOL):
    """The port's ``KVCacheState`` holds exactly the leaves the
    reference's layer state does not leave None, each within ``atol``;
    ``length`` and ``pos`` exactly."""
    jl, tl = jstate["layers"], tstate["layers"]
    assert isinstance(tl, tatt.KVCacheState)
    assert set(tl._fields) == {n for n in jl._fields
                               if getattr(jl, n) is not None}
    for name in tl._fields:
        j, t = getattr(jl, name), getattr(tl, name)
        if name == "length":
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"{name} {msg}")
        else:
            np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                                       atol=atol, rtol=0,
                                       err_msg=f"{name} {msg}")
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,l_q", [
    (True, None, 12), (False, None, 12), (True, 4, 12), (False, 5, 12),
    (True, None, 5), (True, 3, 5)])
def test_exact_attention_matches_reference(dtype, causal, window, l_q):
    """Causal, bidirectional and sliding-window softmax attention, with
    queries at the end of a longer key sequence too (l_q < l_k). bf16
    logits are rounded to bf16 before the f32 softmax in both."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 3, l_q, 8)).astype(np.float32)
    k = rng.standard_normal((2, 3, 12, 8)).astype(np.float32)
    v = rng.standard_normal((2, 3, 12, 8)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    exp = jla.exact_attention(jq, jk, jv, causal=causal, window=window)
    got = tla.exact_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tv.dtype
    np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32),
                               **(F32_TOL if dtype == "float32" else
                                  BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_constant_attention_matches_reference(dtype, causal):
    v = np.random.default_rng(1).standard_normal((2, 3, 10, 8)).astype(
        np.float32)
    jv, tv = _pair(v, dtype)
    exp = jla.constant_attention(jv, causal=causal)
    got = tla.constant_attention(tv, causal=causal)
    assert got.dtype == tv.dtype and got.shape == tv.shape
    np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32),
                               **(F32_TOL if dtype == "float32" else
                                  BF16_TOL))


@pytest.mark.parametrize("causal", [True, False])
def test_random_attention_on_the_reference_draw(causal):
    """The port takes the (L, L) draw as a tensor: fed the reference's
    ``jax.random`` draw, it gives the reference's output."""
    l = 9
    key = jax.random.PRNGKey(4)
    v = np.random.default_rng(2).standard_normal((2, 3, l, 8)).astype(
        np.float32)
    exp = jla.random_attention(key, jnp.asarray(v), causal=causal)
    draw = torch.tensor(np.asarray(jax.random.normal(key, (l, l),
                                                     jnp.float32)))
    got = tla.random_attention(draw, torch.tensor(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32_TOL)
    # the port's own draw: seeded, f32 normal, any device
    a = tla.random_draw(l, torch.Generator().manual_seed(3))
    b = tla.random_draw(l, torch.Generator().manual_seed(3))
    assert a.shape == (l, l) and a.dtype == torch.float32
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind,window", [
    ("exact", None), ("exact", 4), ("constant", None), ("random", None)])
@pytest.mark.parametrize("causal", [True, False])
def test_rf_attention_baselines_match_reference(kind, window, causal):
    """``rf_attention`` of the three kinds without features, GQA layout
    (k and v one head per group): exact scales q and k by d^-1/4 and
    broadcasts k over the group; the baselines broadcast their output."""
    cfg = tfm.FeatureConfig(kind=kind)
    rng = np.random.default_rng(3)
    b, g, hg, l, d = 2, 2, 3, 11, 8
    q = rng.standard_normal((b, g, hg, l, d)).astype(np.float32)
    k = rng.standard_normal((b, g, 1, l, d)).astype(np.float32)
    v = rng.standard_normal((b, g, 1, l, d)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    exp = jatt.rf_attention(q, k, v, None, cfg, causal=causal,
                            window=window, baseline_key=key)
    draw = torch.tensor(np.asarray(jax.random.normal(key, (l, l))))
    got = tatt.rf_attention(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), None, cfg, causal=causal,
                            window=window, baseline_draw=draw)
    assert got.shape == (b, g, hg, l, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32_TOL)
    if kind == "random":
        with pytest.raises(ValueError, match="draw"):
            tatt.rf_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), None, cfg)


def test_linear_state_prefill_and_decode_match_reference():
    rng = np.random.default_rng(4)
    qf, kf = (np.exp(0.3 * rng.standard_normal((2, 3, 10, 16))).astype(
        np.float32) for _ in range(2))
    v = rng.standard_normal((2, 3, 10, 8)).astype(np.float32)
    z0 = tla.LinearState.zeros((2, 3), 16, 8)
    assert z0.s.shape == (2, 3, 16, 8) and z0.z.shape == (2, 3, 16)
    assert z0.s.dtype == torch.float32 and not z0.s.any() and not z0.z.any()
    jout, jst = jla.linear_attention_prefill(qf, kf, v, chunk=4)
    tout, tst = tla.linear_attention_prefill(
        torch.tensor(qf), torch.tensor(kf), torch.tensor(v), chunk=4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    for name in ("s", "z"):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   atol=1e-4, rtol=1e-6, err_msg=name)
    q1, k1 = (np.exp(0.3 * rng.standard_normal((2, 3, 16))).astype(
        np.float32) for _ in range(2))
    v1 = rng.standard_normal((2, 3, 8)).astype(np.float32)
    jout, jst = jla.linear_attention_decode(q1, k1, v1, jst)
    tout, tst = tla.linear_attention_decode(
        torch.tensor(q1), torch.tensor(k1), torch.tensor(v1), tst)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    for name in ("s", "z"):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   atol=1e-4, rtol=1e-6, err_msg=name)


# (length, chunk length, valid_len) of each case of the cache write; the
# cache holds 16 positions
RESUME_CASES = {
    "scalar": (3, 5, None),
    "scalar_clamped": (14, 4, None),          # start clamps to 12
    "per_row": ((0, 4, 9), 5, None),
    "ragged": ((0, 4, 9), 5, (5, 2, 0)),
    "ragged_at_cache_end": ((12, 13, 8), 8, (3, 2, 8)),   # 12 + 8 > 16
}


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_exact_prefill_resume_matches_reference(case, window):
    """``_exact_prefill_resume`` from a cache of random contents: the
    output and the advanced cache against the reference's, and every
    position outside the rows' writes bitwise as it was."""
    length, l, vl = RESUME_CASES[case]
    b, g, hg, d, lmax = 3, 2, 2, 8, 16
    rng = np.random.default_rng(5)
    qs = rng.standard_normal((b, g, hg, l, d)).astype(np.float32)
    ks = rng.standard_normal((b, g, 1, l, d)).astype(np.float32)
    v = rng.standard_normal((b, g, 1, l, d)).astype(np.float32)
    kc = rng.standard_normal((b, g, lmax, d)).astype(np.float32)
    vc = rng.standard_normal((b, g, lmax, d)).astype(np.float32)
    ln = np.asarray(length, np.int32)
    vl_np = None if vl is None else np.asarray(vl, np.int32)
    jst = jatt.AttnServeState(kv_k=jnp.asarray(kc), kv_v=jnp.asarray(vc),
                              length=jnp.asarray(ln))
    jout, jst = jatt._exact_prefill_resume(
        jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(v), jst, window,
        jnp.float32, valid_len=None if vl is None else jnp.asarray(vl_np))
    tst = tatt.KVCacheState(kv_k=torch.tensor(kc), kv_v=torch.tensor(vc),
                            length=torch.tensor(ln))
    cache_k, cache_v = tst.kv_k, tst.kv_v
    tout, tst2 = tatt._exact_prefill_resume(
        torch.tensor(qs), torch.tensor(ks), torch.tensor(v), tst, window,
        torch.float32, valid_len=None if vl is None else torch.tensor(vl_np))
    # in place: the same tensors, advanced
    assert tst2.kv_k is cache_k and tst2.kv_v is cache_v
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    np.testing.assert_array_equal(tst.length.numpy(), np.asarray(jst.length))
    np.testing.assert_array_equal(tst.kv_k.numpy(), np.asarray(jst.kv_k))
    np.testing.assert_array_equal(tst.kv_v.numpy(), np.asarray(jst.kv_v))
    # the positions each row writes, and nothing else
    written = np.zeros((b, lmax), bool)
    for r in range(b):
        start = int(np.broadcast_to(ln, (b,))[r])
        n = l if vl is None else int(vl_np[r])
        if vl is None:
            start = min(max(start, 0), lmax - l)
        written[r, start:start + n] = True
    keep = ~written[:, None, :, None]
    for new, old, src in ((tst.kv_k, kc, ks), (tst.kv_v, vc, v)):
        new = new.numpy()
        assert np.array_equal(np.where(keep, new, 0), np.where(keep, old, 0))
        for r in range(b):
            pos = np.nonzero(written[r])[0]
            np.testing.assert_array_equal(new[r][:, pos],
                                          src[r, :, 0, :len(pos)])


def test_exact_whole_prompt_prefill_and_decode_match_reference():
    """``rf_attention_prefill`` without a state (a cache of ``max_len``
    positions, a () length) and then two ``rf_attention_decode`` steps,
    against the reference's."""
    cfg = tfm.FeatureConfig(kind="exact")
    rng = np.random.default_rng(6)
    b, g, hg, l, d = 2, 2, 3, 7, 8

    def qkv(n):
        return (rng.standard_normal((b, g, hg, n, d)).astype(np.float32),
                rng.standard_normal((b, g, 1, n, d)).astype(np.float32),
                rng.standard_normal((b, g, 1, n, d)).astype(np.float32))
    q, k, v = qkv(l)
    jout, jst = jatt.rf_attention_prefill(q, k, v, None, cfg, max_len=12)
    tout, tst = tatt.rf_attention_prefill(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), None, cfg,
        max_len=12)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    for _ in range(2):
        q, k, v = qkv(1)
        jout, jst = jatt.rf_attention_decode(q, k, v, jst, None, cfg)
        tout, tst = tatt.rf_attention_decode(
            torch.tensor(q), torch.tensor(k), torch.tensor(v), tst, None,
            cfg)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   **F32_TOL)
    assert tst.length.shape == () and int(tst.length) == l + 2
    for name in ("kv_k", "kv_v", "length"):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   **F32_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

# (L, valid_len) of each resumed chunk; no row is empty, as in serving
CHUNKS = [(6, (6, 2, 3)), (5, None), (7, (3, 7, 1))]


@pytest.mark.parametrize("per_slot", [True, False])
def test_exact_prefill_and_decode_match_reference(per_slot):
    """Resumed chunks (ragged with per-slot lengths), then two decode
    steps: logits and every serve-state leaf, the exact cache
    ``kv_k``/``kv_v`` and its ``length`` leaf for leaf."""
    jcfg, tcfg, jparams, tparams = _setup("exact")
    b = 3
    jstate = jlm.init_serve_state(jcfg, b=b, max_len=32, per_slot=per_slot,
                                  stacked=True)
    tstate = tlm.init_serve_state(tcfg, b=b, max_len=32, per_slot=per_slot,
                                  device="cpu")
    assert tstate["layers"].kv_k.shape == (3, b, 3, 32, 16)
    assert tstate["layers"].length.shape == ((3, b) if per_slot else (3,))
    _assert_state_close(jstate, tstate, "fresh")
    rng = np.random.default_rng(3)
    for step, (l, vl) in enumerate(CHUNKS):
        if not per_slot:
            vl = None
        toks = rng.integers(0, jcfg.vocab, (b, l)).astype(np.int32)
        vl_np = None if vl is None else np.asarray(vl, np.int32)
        jlog, jstate = jlm.prefill_chunk(
            jparams, jcfg, {"tokens": jnp.asarray(toks)}, jstate,
            valid_len=None if vl is None else jnp.asarray(vl_np))
        tlog, tstate = tlm.prefill_chunk(
            tparams, tcfg, {"tokens": torch.tensor(toks).long()}, tstate,
            valid_len=None if vl is None else torch.tensor(vl_np))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=0,
                                   err_msg=f"prefill logits, chunk {step}")
        _assert_state_close(jstate, tstate, f"after chunk {step}")
    for step in range(2):
        tok = rng.integers(0, jcfg.vocab, (b,)).astype(np.int32)
        jlog, jstate = jlm.decode_step(jparams, jcfg, jnp.asarray(tok),
                                       jstate)
        tlog, tstate = tlm.decode_step(tparams, tcfg,
                                       torch.tensor(tok).long(), tstate)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=0,
                                   err_msg=f"decode logits, step {step}")
        _assert_state_close(jstate, tstate, f"after decode {step}")


def _chained(params, cfg, toks, schedule, max_len=32):
    st = tlm.init_serve_state(cfg, b=toks.shape[0], max_len=max_len,
                              device="cpu")
    lo = 0
    for t in schedule:
        lg, st = tlm.prefill_chunk(params, cfg,
                                   {"tokens": toks[:, lo:lo + t]}, st)
        lo += t
    assert lo == toks.shape[1]
    return lg, st


def _leaves(state):
    return [("pos", state["pos"]), *state["layers"]._asdict().items()]


@pytest.mark.parametrize("kind", ["exact", "performer"])
def test_chunked_prefill_matches_whole_prompt(kind):
    """As tests/test_chunked_prefill.py:67 in the port: an uneven chunk
    schedule against whole-prompt ``lm.prefill`` within 1e-4 on the last
    logits and every state leaf; one whole-prompt chunk bitwise."""
    _, tcfg, _, params = _setup(kind)
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, tcfg.vocab, (1, 13))).long()
    lg_full, st_full = tlm.prefill(params, tcfg, {"tokens": toks},
                                   max_len=32)
    lg, st = _chained(params, tcfg, toks, (5, 4, 3, 1))
    np.testing.assert_allclose(lg.numpy(), lg_full[:, -1].numpy(),
                               atol=ATOL, rtol=0)
    for (name, a), (_, b) in zip(_leaves(st), _leaves(st_full)):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL, rtol=0,
                                   err_msg=name)
    lg1, st1 = _chained(params, tcfg, toks, (13,))
    assert torch.equal(lg1, lg_full[:, -1])
    for (name, a), (_, b) in zip(_leaves(st1), _leaves(st_full)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("at_cache_end", [False, True])
def test_ragged_padded_chunk_matches_serial_rows(at_cache_end):
    """Two rows advanced together by one padded chunk with per-row
    ``valid_len`` equal each row advanced alone (tests/
    test_chunked_prefill.py:257 and :323 in the port): at the cache's
    end the padded chunk runs past it (12 + 8 > 16), and every valid key
    must still land at [idx, idx + valid_len)."""
    _, tcfg, _, params = _setup("exact")
    rng = np.random.default_rng(130)
    if at_cache_end:
        max_len, head, lens, l_pad = 16, 12, (3, 2), 8
    else:
        max_len, head, lens, l_pad = 32, 0, (7, 4), 7
    prompts = [rng.integers(0, tcfg.vocab, head + n).tolist() for n in lens]

    def fresh(b):
        return tlm.init_serve_state(tcfg, b=b, max_len=max_len,
                                    per_slot=True, device="cpu")
    serial = []
    for p in prompts:
        st = fresh(1)
        if head:
            tlm.prefill_chunk(params, tcfg, {"tokens": torch.tensor(
                [p[:head]])}, st)
        lg, st = tlm.prefill_chunk(params, tcfg, {"tokens": torch.tensor(
            [p[head:]])}, st)
        serial.append((lg, st))
    st = fresh(2)
    if head:
        tlm.prefill_chunk(params, tcfg, {"tokens": torch.tensor(
            [p[:head] for p in prompts])}, st)
    tails = torch.zeros((2, l_pad), dtype=torch.long)
    for r, p in enumerate(prompts):
        tails[r, :lens[r]] = torch.tensor(p[head:])
    lg, st = tlm.prefill_chunk(params, tcfg, {"tokens": tails}, st,
                               valid_len=torch.tensor(lens,
                                                      dtype=torch.int32))
    for r in range(2):
        np.testing.assert_allclose(lg[r].numpy(), serial[r][0][0].numpy(),
                                   atol=ATOL, rtol=0)
        row = tslots.read_slots(st, torch.tensor([r]))
        for (name, a), (_, b) in zip(_leaves(row), _leaves(serial[r][1])):
            np.testing.assert_allclose(_np(a), _np(b), atol=ATOL, rtol=0,
                                       err_msg=f"row {r} {name}")
        # positions past the row's valid tokens were never written
        end = head + lens[r]
        assert not st["layers"].kv_k[:, r, :, end:].any()
        assert not st["layers"].kv_v[:, r, :, end:].any()


@pytest.mark.parametrize("kind", ["exact", "darkformer", "performer"])
def test_stepwise_decode_tracks_full_pass(kind):
    """As tests/test_decode_parity.py in the port: decode steps over
    positions 4..11 after a 4-token prefill give the full causal pass's
    logits there, within the reference's 1e-3 (the PRF kinds swap the
    whole-prompt k-stabilizer for a running max; exact only reorders
    f32 sums)."""
    _, tcfg, _, params = _setup(kind)
    l, prefix = 12, 4
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, tcfg.vocab, (1, l))).long()
    full, _ = tlm.forward_train(params, tcfg, {"tokens": toks,
                                               "labels": toks})
    _, st = tlm.prefill(params, tcfg, {"tokens": toks[:, :prefix]},
                        max_len=l + 4)
    err = 0.0
    for t in range(prefix, l):
        lg, st = tlm.decode_step(params, tcfg, toks[:, t], st)
        err = max(err, float((lg - full[:, t]).abs().max()))
    assert err < 1e-3, (kind, err)


@pytest.mark.parametrize("kind", ["exact", "darkformer"])
def test_evict_readmit_matches_uninterrupted_decode(kind):
    """As tests/test_decode_parity.py in the port: decode a while,
    cancel, re-admit with prompt + history into another slot, finish;
    the combined greedy stream equals one uninterrupted decode."""
    _, tcfg, _, params = _setup(kind)
    prompt = np.random.default_rng(2).integers(0, tcfg.vocab, 8).tolist()
    n_total = 10
    lg, st = tlm.prefill(params, tcfg, {"tokens": torch.tensor([prompt])},
                         max_len=48)
    ref = [int(lg[0, -1].argmax())]
    for _ in range(n_total - 1):
        lg, st = tlm.decode_step(params, tcfg, torch.tensor(ref[-1:]), st)
        ref.append(int(lg[0].argmax()))
    eng = ServingEngine(params, tcfg, max_slots=2, max_len=48, device="cpu")
    eng.submit(Request(prompt=prompt[:5], max_new_tokens=n_total + 6))
    uid = eng.submit(Request(prompt=prompt, max_new_tokens=n_total))
    for _ in range(4):
        eng.step()
    part = eng.cancel(uid)
    assert part.cancelled and 0 < len(part.tokens) < n_total
    assert part.tokens == ref[:len(part.tokens)]
    uid2 = eng.submit(Request(prompt=prompt + part.tokens,
                              max_new_tokens=n_total - len(part.tokens)))
    rest = {r.uid: r.tokens for r in eng.run()}[uid2]
    assert part.tokens + rest == ref


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(vocab, b=2, l=16, step=0):
    data = SyntheticLM(vocab, l, b, seed=1).batch(step)
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.tensor(v).long() for k, v in data.items()})


def _flat_np(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference_draws(cfg, l, rng=jax.random.PRNGKey(0)):
    """The reference forward's random-baseline draws: layer u's key is
    fold_in(rng, u * 16 + 0) (repro/models/lm.py: forward_train)."""
    return torch.tensor(np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(rng, u * 16),
                                     (l, l), jnp.float32))
        for u in range(cfg.n_layers)]))


@pytest.mark.parametrize("kind", ["exact", "constant", "random"])
@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_baseline_loss_and_every_gradient_match_jax_grad(arch, kind,
                                                         monkeypatch):
    """The loss and every gradient leaf (zeros where the kind reads no
    q or k: constant and random) against ``jax.grad``; the random kind
    fed the reference's per-layer draws in place of its own."""
    jcfg, tcfg, jparams, tparams = _setup(kind, arch)
    monkeypatch.setattr(tlm, "baseline_draws",
                        lambda cfg, l, gen, device: _reference_draws(cfg, l))
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


def test_random_baseline_draws_follow_the_generator():
    """The random kind draws its per-layer logits from ``gen`` (seed 0
    when None); the train step seeds a generator with the step."""
    _, tcfg, _, params = _setup("random")
    _, tb = _batch(tcfg.vocab)
    loss = [float(tlm.loss_fn(params, tcfg, tb, gen=torch.Generator()
                              .manual_seed(s))[0]) for s in (1, 1, 2)]
    assert loss[0] == loss[1] != loss[2]
    assert float(tlm.loss_fn(params, tcfg, tb)[0]) == float(tlm.loss_fn(
        params, tcfg, tb, gen=torch.Generator().manual_seed(0))[0])
    draws = tlm.baseline_draws(tcfg, 16)
    assert draws.shape == (tcfg.n_layers, 16, 16)
    assert torch.equal(draws[1], tlm.baseline_draws(tcfg, 16)[1])
    step = tsteps.make_train_step(tcfg, AdamWConfig(lr=1e-3), constant(1e-3))
    opt = adamw_init(params, AdamWConfig(lr=1e-3))
    m = [step(params, opt, tb, s)[2]["loss"] for s in (5, 5, 6)]
    assert float(m[0]) == float(m[1]) != float(m[2])


def test_transplant_and_finetune_match_reference():
    """The reference's tests/test_integration.py:121 scenario: exact
    params transplanted into a darkformer (every shared leaf by path,
    fresh ``w`` and ``m_mat``), then three finetune steps; the port's
    transplant equals the reference's bitwise, and the losses agree."""
    jcfg_e, tcfg_e, jp_exact, tp_exact = _setup("exact")
    jcfg_d = jcfgs.darkify(jcfg_e, "darkformer", 32)
    tcfg_d = tcfgs.darkify(tcfg_e, "darkformer", 32)
    jp_dark = jlm.init_params(jax.random.PRNGKey(0), jcfg_d)
    tp_fresh = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp_dark), tcfg_d, device="cpu")
    flat_e = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(jp_exact)[0]}
    flat_d, tdef = jax.tree_util.tree_flatten_with_path(jp_dark)
    jp_dark = jax.tree_util.tree_unflatten(
        tdef, [flat_e.get(jax.tree_util.keystr(k), v) for k, v in flat_d])
    tp_dark = tsteps.transplant(tp_exact, tp_fresh)
    exp = _flat_np(jp_dark)
    got = dict(flatten(tp_dark))
    assert got.keys() == exp.keys()
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), exp[path], err_msg=path)
    assert "['units']['b0']['attn']['feat']['m_mat']" in got
    with pytest.raises(ValueError, match="shape"):
        tsteps.transplant(tp_exact, bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jlm.init_params(
                jax.random.PRNGKey(0), jcfgs.get_config(
                    "darkformer-2b", reduced=True))),
            tcfgs.get_config("darkformer-2b", reduced=True), device="cpu"))

    data = SyntheticLM(jcfg_d.vocab, 32, 8)
    jopt_cfg = JAdamWConfig(lr=3e-3)
    jstep = jax.jit(jsteps.make_train_step(jcfg_d, jopt_cfg,
                                           jconstant(3e-3)))
    jopt = jadamw_init(jp_dark, jopt_cfg)
    tstep = tsteps.make_train_step(tcfg_d, AdamWConfig(lr=3e-3),
                                   constant(3e-3))
    topt = adamw_init(tp_dark, AdamWConfig(lr=3e-3))
    for i in range(3):
        b = data.batch(i)
        jp_dark, jopt, jm = jstep(jp_dark, jopt, dict(b), jnp.int32(i))
        tp_dark, topt, tm = tstep(
            tp_dark, topt, {k: torch.tensor(v).long() for k, v in b.items()},
            i)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   err_msg=f"loss step {i}", **OUT_TOL)
        assert np.isfinite(float(tm["loss"]))


# ---------------------------------------------------------------------------
# the engine and the CLIs
# ---------------------------------------------------------------------------

LENGTHS, GENS = (5, 13, 9, 7), (6, 3, 8, 4)


@pytest.mark.parametrize("overlap", [False, True])
def test_exact_greedy_streams_match_reference_engine(overlap):
    """The tests/test_torch_serving.py:37 pattern for exact, under each
    scheduler: the same bridged params, requests and chunk schedule in
    both packages' engines give the same greedy streams."""
    jcfg, tcfg, jparams, tparams = _setup("exact")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, n).tolist() for n in LENGTHS]
    streams = []
    for eng, req in (
            (JEngine(jparams, jcfg, max_slots=2, max_len=48, chunk_tokens=8,
                     overlap=overlap), JRequest),
            (ServingEngine(tparams, tcfg, max_slots=2, max_len=48,
                           chunk_tokens=8, overlap=overlap, device="cpu"),
             Request)):
        uids = [eng.submit(req(prompt=p, max_new_tokens=n))
                for p, n in zip(prompts, GENS)]
        got = {r.uid: r.tokens for r in eng.run()}
        streams.append([got[u] for u in uids])
        st = eng.stats
        assert st["admitted"] == st["finished"] == len(prompts)
        assert st["prefill_path"] == st["decode_path"] == "exact"
    assert streams[0] == streams[1]


def _exact_parts(**kw):
    cfg = tcfgs.darkify(tcfgs.get_config("smollm-135m", reduced=True),
                        "exact")
    cfg = dataclasses.replace(cfg, **kw)
    return cfg, tlm.init_params(cfg, seed=0, device="cpu")


def test_exact_overlap_matches_sequential_at_one_row():
    """With one staged row per prefill call the chunk boundaries agree,
    so the overlapped engine's greedy streams equal the sequential
    one's token for token."""
    cfg, params = _exact_parts(use_kernel=True)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(6, 30, 7)]
    gens = rng.integers(3, 9, 7).tolist()
    streams = []
    for overlap in (False, True):
        eng = ServingEngine(params, cfg, max_slots=3, max_len=48,
                            chunk_tokens=16, prefill_rows=1, overlap=overlap,
                            device="cpu")
        uids = [eng.submit(Request(prompt=p, max_new_tokens=n))
                for p, n in zip(prompts, gens)]
        got = {r.uid: r.tokens for r in eng.run()}
        streams.append([got[u] for u in uids])
        assert eng.stats["decode_path"] == "exact"
    assert streams[0] == streams[1]
    assert [len(t) for t in streams[0]] == gens


def test_inactive_exact_slot_is_bitwise_frozen():
    """A decode over a pool with a free slot leaves that slot's cache,
    length and pos bitwise unchanged, and writes the active slots' keys
    at their own lengths."""
    cfg, params = _exact_parts()
    pool = tlm.init_serve_state(cfg, b=3, max_len=16, per_slot=True,
                                device="cpu")
    toks = torch.randint(0, cfg.vocab, (3, 5),
                         generator=torch.Generator().manual_seed(0))
    tlm.prefill_chunk(params, cfg, {"tokens": toks}, pool)
    before = tslots.read_slots(pool, torch.tensor([0, 1, 2]))
    logits = tslots.freeze_inactive(
        pool, torch.tensor([0, 2]), lambda st: tlm.decode_step(
            params, cfg, torch.tensor([7, 9]), st))
    assert logits.shape == (2, cfg.vocab)
    for name in ("kv_k", "kv_v", "length"):
        old = getattr(before["layers"], name)
        new = getattr(pool["layers"], name)
        assert torch.equal(old[:, 1], new[:, 1]), name
        assert not torch.equal(old[:, 0], new[:, 0]), name
        assert not torch.equal(old[:, 2], new[:, 2]), name
    assert pool["layers"].length.tolist() == [[6, 5, 6]] * cfg.n_layers
    assert pool["pos"].tolist() == [6, 5, 6]
    assert pool["layers"].kv_k[:, [0, 2], :, 5].any()
    assert not pool["layers"].kv_k[:, 1, :, 5].any()


def test_exact_submit_and_budget_fit_the_cache():
    """The exact cache holds ``max_len`` positions: ``submit`` refuses a
    prompt that leaves no room for a generated token, and a request's
    decode budget is clipped to the room left."""
    cfg, params = _exact_parts()
    eng = ServingEngine(params, cfg, max_slots=2, max_len=16, chunk_tokens=8,
                        device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(prompt=list(range(16)), max_new_tokens=1))
    a = eng.submit(Request(prompt=list(range(13)), max_new_tokens=10))
    b = eng.submit(Request(prompt=list(range(15)), max_new_tokens=4))
    got = {r.uid: r.tokens for r in eng.run()}
    assert len(got[a]) == 3 and len(got[b]) == 1
    with pytest.raises(ValueError, match="no serving path"):
        ServingEngine(params, dataclasses.replace(
            cfg, attn=dataclasses.replace(cfg.attn, kind="constant")),
            device="cpu")


@pytest.mark.parametrize("overlap", ["--overlap", "--no-overlap"])
def test_serve_cli_exact_runs_in_process(overlap, capsys):
    st = serve.main(["--arch", "smollm-135m", "--reduced", "--device",
                     "cpu", "--kernel", "exact", overlap, "--requests", "3",
                     "--slots", "2", "--max-len", "48", "--prompt-len",
                     "4-12", "--gen", "3-5", "--chunk-tokens", "8"])
    assert st["finished"] == 3 and len(st["results"]) == 3
    assert st["prefill_path"] == st["decode_path"] == "exact"
    out = capsys.readouterr().out
    assert "kernel=exact, path=exact" in out and "throughput:" in out


@pytest.mark.parametrize("kind", ["exact", "random", "constant"])
def test_train_cli_baselines_run_in_process(kind):
    out = train.main(["--arch", "smollm-135m", "--reduced", "--device",
                      "cpu", "--kernel", kind, "--steps", "3", "--batch",
                      "2", "--seq", "16", "--log-every", "1"])
    assert out["config"].attn.kind == kind
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "feat" not in out["params"]["units"]["b0"]["attn"]
    with pytest.raises(SystemExit):
        train.main(["--kernel", "trig", "--device", "cpu", "--reduced"])

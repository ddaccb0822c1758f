"""recurrentgemma-2b in the port against the reference, on the CPU: the
RG-LRU (``repro_torch.models.recurrent``), "local" attention blocks and
the unit/rem layout (8 units of ("rec", "rec", "local") and 2 remainder
``rec`` layers at full size; 1 unit and 1 remainder layer reduced).

Both packages get the same params (the reference's, brought across by
``repro_torch.bridge``) and the same inputs (numpy seeds). Tolerances:

  * ``rglru_apply`` alone: f32 outputs and state within ``F32_TOL``
    (the gates' products and the scan's tree round in another order);
    bf16 outputs within one bf16 ulp of their size (``BF16_TOL``: both
    packages round the same f32 values to bf16, but the bf16 products
    u @ wx, u @ wg differ by an ulp here and there), the f32 h within
    ``BF16_H_TOL`` and the bf16-valued conv tail bitwise;
  * the log-step scan against the sequential oracles (the port's and
    the reference's ``rglru_ref``) within ``SCAN_TOL``; a padded
    sequence's prefix bitwise;
  * the LM (loss and every gradient, logits and every serve-state leaf,
    greedy engine streams) at ``tests/_torch_arch_parity.py``'s
    tolerances;
  * inside the port, streams across schedulers and prefix-cache forks
    token for token, and the slot primitives bitwise.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch_parity as par
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models import recurrent as jrec
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.core.feature_maps import FeatureConfig
from repro_torch.launch import serve
from repro_torch.models import layers as tll
from repro_torch.models import lm as tlm
from repro_torch.models import recurrent as trec
from repro_torch.serving import PrefixCacheConfig, Request, ServingEngine
from repro_torch.serving import slots as slot_ops
from repro_torch.tree import flatten, tree_map

torch.set_num_threads(1)
ARCH = "recurrentgemma-2b"
F32_TOL = dict(atol=2e-6, rtol=1e-5)
BF16_TOL = dict(atol=2e-3, rtol=2 ** -8)
BF16_H_TOL = dict(atol=2e-3, rtol=1e-2)
SCAN_TOL = dict(atol=1e-6, rtol=1e-5)
EXACT = FeatureConfig(kind="exact", num_features=32)
# resumed ragged chunks of one length (the reference's eager ops compile
# anew at each): rows of 19, 18 and 12 tokens; and for the window test
# rows of 32, 17 and 21 tokens, past the reduced config's window of 16
CHUNKS = [(8, (8, 2, 3)), (8, None), (8, (3, 8, 1))]
LONG_CHUNKS = [(11, (11, 5, 9)), (11, None), (11, (10, 1, 1))]


def test_config_fields_match_reference():
    par.assert_config_fields_match(ARCH)
    cfg = tcfgs.get_config(ARCH)
    assert (cfg.n_units, cfg.n_rem, cfg.rnn_width) == (8, 2, 2560)
    assert cfg.layer_kinds()[-3:] == ["local", "rec", "rec"]
    assert cfg.layer_kinds().count("local") == 8
    assert (cfg.n_kv, cfg.n_heads, cfg.head_dim) == (1, 10, 256)
    assert cfg.attn.num_features == 256 and cfg.window == 2048
    red = tcfgs.get_config(ARCH, reduced=True)
    assert (red.n_units, red.n_rem) == (1, 1)
    assert not tlm.can_stack_layers(cfg)


def test_port_init_matches_reference_tree():
    """Paths, shapes and dtypes, ``rem`` list included. The reference
    draws ``wo`` from ``wg``'s key, so with d_rnn == d_model the two are
    equal; so are the port's."""
    par.assert_init_tree_matches(ARCH)
    cfg = tcfgs.get_config(ARCH, reduced=True)
    params = tlm.init_params(cfg, seed=3, device="cpu")
    rec_blocks = [params["units"]["b0"]["rec"], params["units"]["b1"]["rec"],
                  params["rem"][0]["rec"]]
    for r in rec_blocks:
        assert torch.equal(r["wo"], r["wg"])
        assert not torch.equal(r["wx"], r["wg"])
        a = torch.exp(-trec.RGLRU_C * torch.nn.functional.softplus(r["lam"]))
        assert bool(((a > 0.9) & (a < 0.999)).all())


def test_init_params_draws_layer_by_layer_in_unit_order():
    """Embed, then unit by unit the pattern's blocks, then the remainder
    layers, each written into its slot of the unit tensors as drawn."""
    cfg = tcfgs.get_config(ARCH, reduced=True, n_layers=7)
    gen = torch.Generator().manual_seed(7)
    embed = tll.trunc_normal(gen, (cfg.vocab, cfg.d_model), 1.0)
    units = [{f"b{i}": tlm._block_init(gen, cfg, kind)
              for i, kind in enumerate(cfg.block_pattern)}
             for _ in range(cfg.n_units)]
    rem = [tlm._block_init(gen, cfg, "rec")]
    exp = {"embed": embed, "final_norm": tll.norm_init(
        cfg.norm_kind, cfg.d_model),
        "units": tree_map(lambda *ts: torch.stack(ts), *units), "rem": rem}
    got = dict(flatten(tlm.init_params(cfg, seed=7, device="cpu")))
    assert got.keys() == dict(flatten(exp)).keys()
    assert "['rem'][0]['rec']['wx']" in got
    for path, t in flatten(exp):
        assert torch.equal(got[path], t), path


def test_bridge_round_trips_the_rem_list():
    _, tcfg, jparams, tparams = par.setup(ARCH, dtype="bfloat16")
    back = bridge.params_to_numpy(tparams)
    exp = par.flat_np(jparams)
    got = {p: np.asarray(v) for p, v in flatten(back)}
    assert got.keys() == exp.keys()
    for k in exp:
        assert par.bits(got[k]) == par.bits(exp[k]), k


# ---------------------------------------------------------------------------
# the RG-LRU alone
# ---------------------------------------------------------------------------

def _rglru_case(dtype, with_state, ragged, seed=0, b=3, l=9, d=32):
    jp = jrec.rglru_init(jax.random.PRNGKey(seed), d, d, getattr(jnp, dtype))
    tp = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, l, d)).astype(np.float32)
    ju = jnp.asarray(u).astype(getattr(jnp, dtype))
    tu = torch.tensor(u).to(getattr(torch, dtype))
    jst = tst = None
    if with_state:
        h = rng.standard_normal((b, d)).astype(np.float32)
        conv = np.asarray(jnp.asarray(rng.standard_normal(
            (b, trec.CONV_K - 1, d)).astype(np.float32)).astype(
            getattr(jnp, dtype)).astype(jnp.float32))
        jst = jrec.RGLRUState(h=jnp.asarray(h), conv=jnp.asarray(conv))
        tst = trec.RGLRUState(h=torch.tensor(h), conv=torch.tensor(conv))
    vl = np.array([l, 4, 1][:b], np.int32) if ragged else None
    jout, jnew = jrec.rglru_apply(jp, ju, jst, None if vl is None
                                  else jnp.asarray(vl))
    tout, tnew = trec.rglru_apply(tp, tu, tst, None if vl is None
                                  else torch.tensor(vl))
    return (jout, jnew), (tout, tnew), vl


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_apply_matches_reference(dtype, with_state, ragged):
    """Output, h and the conv tail (gathered per row at its valid end
    under ``valid_len``) against the reference's ``rglru_apply``."""
    (jout, jnew), (tout, tnew), vl = _rglru_case(dtype, with_state, ragged)
    assert tout.dtype == getattr(torch, dtype)
    assert tnew.h.dtype == torch.float32
    f32 = dtype == "float32"
    vmask = np.ones(tout.shape[:2], bool) if vl is None else (
        np.arange(tout.shape[1])[None] < vl[:, None])
    np.testing.assert_allclose(
        tout.float().numpy()[vmask],
        np.asarray(jout.astype(jnp.float32))[vmask],
        **(F32_TOL if f32 else BF16_TOL))
    np.testing.assert_allclose(tnew.h.numpy(), np.asarray(jnew.h),
                               **(F32_TOL if f32 else BF16_H_TOL))
    np.testing.assert_array_equal(tnew.conv.float().numpy(),
                                  np.asarray(jnew.conv.astype(jnp.float32)))


def test_rglru_ragged_rows_match_unpadded_runs():
    """A padded row's carry (h, conv) is the one an unpadded run over its
    valid tokens gives; its valid outputs are the same too (within
    ``F32_TOL``: the CPU's matmuls round a (3, 9) batch and a (1, 4) one
    in other orders)."""
    (_, _), (tout, tnew), vl = _rglru_case("float32", True, True, seed=1)
    jp = jrec.rglru_init(jax.random.PRNGKey(1), 32, 32)
    tp = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    rng = np.random.default_rng(1)
    u = torch.tensor(rng.standard_normal((3, 9, 32)).astype(np.float32))
    h = torch.tensor(rng.standard_normal((3, 32)).astype(np.float32))
    conv = torch.tensor(rng.standard_normal((3, 3, 32)).astype(np.float32))
    for r, n in enumerate(vl):
        out, st = trec.rglru_apply(tp, u[r:r + 1, :n],
                                   trec.RGLRUState(h[r:r + 1],
                                                   conv[r:r + 1]))
        np.testing.assert_allclose(tout[r:r + 1, :n].numpy(), out.numpy(),
                                   **F32_TOL)
        np.testing.assert_allclose(tnew.h[r:r + 1].numpy(), st.h.numpy(),
                                   **F32_TOL)
        np.testing.assert_allclose(tnew.conv[r:r + 1].numpy(),
                                   st.conv.numpy(), **F32_TOL)


@pytest.mark.parametrize("l", [1, 2, 7, 64, 257])
def test_log_step_scan_matches_sequential_oracles(l):
    """``_rglru_scan`` against the port's ``rglru_ref`` and the
    reference's (``kernels/ref.py``), and each prefix of a longer
    sequence bitwise the shorter sequence's scan."""
    rng = np.random.default_rng(l)
    x, gate = (rng.standard_normal((2, l, 8)).astype(np.float32)
               for _ in range(2))
    a = rng.uniform(0.5, 0.9999, (2, l, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32)
    i_gate = 1 / (1 + np.exp(-gate))
    tx, ta, ti, th = (torch.tensor(t) for t in (x, a, i_gate, h0))
    hs, hl = trec._rglru_scan(tx, ta, ti, th)
    seq, seq_l = trec.rglru_ref(tx, ta, ti, th)
    jhs, jhl = jref.rglru_ref(*(jnp.asarray(t) for t in (x, a, i_gate,
                                                          h0)))
    for got, exp in ((hs, seq), (hl, seq_l), (hs, np.asarray(jhs)),
                     (hl, np.asarray(jhl))):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **SCAN_TOL)
    longer = [torch.cat([t, torch.rand(2, 5, 8)], 1) for t in (tx, ta, ti)]
    hs2, _ = trec._rglru_scan(*longer, th)
    assert torch.equal(hs2[:, :l], hs)


# ---------------------------------------------------------------------------
# the LM over unit/rem
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_reference():
    par.check_loss_and_grads(ARCH)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_prefill_and_decode_match_reference(use_kernel):
    """Ragged packed chunks and decode steps over the unit/rem state:
    logits and every leaf (h, conv; S, z, c) in ``units`` and ``rem``.
    With ``use_kernel`` the local layers go through the fused kernels'
    wrappers (their plain versions on the CPU)."""
    st = par.check_prefill_and_decode(ARCH, use_kernel, chunks=CHUNKS)
    assert set(st) == {"units", "rem", "pos"}
    assert st["units"]["b0"].conv.dtype == torch.float32
    assert st["units"]["b0"].h.shape == (1, 3, 64)
    assert st["rem"][0].conv.shape == (3, 3, 64)


def test_exact_local_window_bites_and_matches_reference():
    """The exact kind applies the local blocks' window (16, shorter than
    the 32-token row): chunks and decode steps, and the training
    forward, against the reference; the same steps without the window
    give other logits."""
    st = par.check_prefill_and_decode(ARCH, False, attn=EXACT,
                                      chunks=LONG_CHUNKS)
    assert st["units"]["b2"].length.tolist() == [[34, 19, 23]]
    jcfg, tcfg, jparams, tparams = par.setup(ARCH, attn=EXACT)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 24))
    jl, _ = jax.jit(jlm.forward_train, static_argnums=1)(
        jparams, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _ = tlm.forward_train(tparams, tcfg,
                              {"tokens": torch.tensor(toks).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=par.ATOL,
                               rtol=0)
    wide = dataclasses.replace(tcfg, window=None)
    tw, _ = tlm.forward_train(tparams, wide,
                              {"tokens": torch.tensor(toks).long()})
    assert torch.equal(tw[:, :16], tl[:, :16])
    assert float((tw[:, 16:] - tl[:, 16:]).abs().max()) > 1e-3


def test_ragged_chunk_matches_serial_rows():
    """The port's counterpart of the reference's
    ``test_ragged_chunk_recurrent_arch_matches_serial_rows``: a padded
    ragged chunk advances every carry (h, conv; S, z, c) as unpadded
    per-row chunks do."""
    cfg = tcfgs.get_config(ARCH, reduced=True, use_kernel=True)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(9)
    lens = (6, 2)
    prompts = [rng.integers(0, cfg.vocab, n) for n in lens]
    serial = [tlm.prefill_chunk(params, cfg,
                                {"tokens": torch.tensor(p[None]).long()},
                                tlm.init_serve_state(cfg, b=1, max_len=32,
                                                     per_slot=True,
                                                     device="cpu"))
              for p in prompts]
    toks = np.zeros((2, max(lens)), np.int64)
    for r, p in enumerate(prompts):
        toks[r, :len(p)] = p
    st = tlm.init_serve_state(cfg, b=2, max_len=32, per_slot=True,
                              device="cpu")
    lg, st = tlm.prefill_chunk(params, cfg, {"tokens": torch.tensor(toks)},
                               st, valid_len=torch.tensor(lens,
                                                          dtype=torch.int32))
    got = par.port_state_np(st)
    for r in range(2):
        np.testing.assert_allclose(lg[r].numpy(), serial[r][0][0].numpy(),
                                   atol=par.ATOL, rtol=0)
        exp = par.port_state_np(serial[r][1])
        for path, e in exp.items():
            axis = 1 if path.startswith("['units']") else 0
            np.testing.assert_allclose(np.take(got[path], [r], axis=axis), e,
                                       atol=par.ATOL, rtol=0, err_msg=path)


def test_full_valid_len_matches_unpadded():
    """valid_len == L on every row against the unmasked path: logits and
    every leaf within ``ATOL``, the RG-LRU's carries bitwise."""
    cfg = tcfgs.get_config(ARCH, reduced=True, use_kernel=True)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    toks = torch.tensor(np.random.default_rng(95).integers(
        0, cfg.vocab, (1, 7)))
    runs = [tlm.prefill_chunk(params, cfg, {"tokens": toks},
                              tlm.init_serve_state(cfg, b=1, max_len=32,
                                                   per_slot=True,
                                                   device="cpu"),
                              valid_len=vl)
            for vl in (None, torch.tensor([7], dtype=torch.int32))]
    np.testing.assert_allclose(runs[0][0].numpy(), runs[1][0].numpy(),
                               atol=par.ATOL, rtol=0)
    a, b = (par.port_state_np(r[1]) for r in runs)
    for path in a:
        np.testing.assert_allclose(a[path], b[path], atol=par.ATOL, rtol=0,
                                   err_msg=path)
    assert np.array_equal(a["['units']['b0'].conv"],
                          b["['units']['b0'].conv"])


def test_stacked_layout_refused():
    """The stacked layout is refused; the calibration taps run over
    unit/rem (A12b2) and match the reference's, the local layer's
    ``unit0/b2`` the only one (tests/test_torch_recurrent_train.py holds
    them further)."""
    jcfg, cfg, jparams, params = par.setup(ARCH)
    assert not tlm.can_stack_layers(cfg)
    with pytest.raises(ValueError, match="homogeneous"):
        tlm.init_serve_state(cfg, b=1, max_len=16, stacked=True,
                             device="cpu")
    with pytest.raises(ValueError, match="homogeneous"):
        tlm.stack_layer_params(params, cfg)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 6))
    exp = jlm.collect_qk(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got = tlm.collect_qk(params, cfg, {"tokens": torch.tensor(toks)})
    assert list(got) == list(exp) == ["unit0/b2"]
    for t, e in zip(got["unit0/b2"], exp["unit0/b2"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(e), atol=par.ATOL,
                                   rtol=0)
    new = tlm.whitening_calibrate(params, cfg, {"tokens": torch.tensor(toks)})
    assert all(a is b for (_, a), (_, b) in zip(flatten(new["rem"]),
                                                flatten(params["rem"])))
    assert not torch.equal(new["units"]["b2"]["attn"]["feat"]["m_mat"],
                           params["units"]["b2"]["attn"]["feat"]["m_mat"])
    proj = tlm.build_decode_proj(params, dataclasses.replace(
        cfg, use_kernel=True))
    assert proj["units"]["b0"] is None and proj["units"]["b1"] is None
    assert proj["units"]["b2"]["a"].shape == (1, 1, 16, 32)
    assert proj["rem"] == [None]


# ---------------------------------------------------------------------------
# slots and engines
# ---------------------------------------------------------------------------

def _filled_pool(cfg, b, seed):
    gen = torch.Generator().manual_seed(seed)
    pool = tlm.init_serve_state(cfg, b=b, max_len=16, per_slot=True,
                                device="cpu")
    return slot_ops.tree_slot_map(
        lambda t, axis: (torch.rand(t.shape, generator=gen) if
                         t.is_floating_point() else
                         torch.randint(0, 9, t.shape, generator=gen,
                                       dtype=t.dtype)), pool)


def test_slot_primitives_on_the_unit_rem_layout():
    """read, write, fork and merge move exactly their rows of every leaf
    (unit leaves at slot axis 1, rem leaves and pos at 0), bitwise."""
    cfg = tcfgs.get_config(ARCH, reduced=True)
    pool, other = _filled_pool(cfg, 4, 0), _filled_pool(cfg, 4, 1)
    before = par.port_state_np(pool)
    idx = torch.tensor([3, 1])
    rows = slot_ops.read_slots(other, idx)
    slot_ops.write_slots(pool, rows, idx)
    one = slot_ops.read_slots(other, torch.tensor([2]))
    fork = _filled_pool(cfg, 4, 0)
    slot_ops.fork_slots(fork, one, torch.tensor([0, 2]))
    merged = _filled_pool(cfg, 4, 0)
    slot_ops.merge_slots(merged, other, torch.tensor([0, 3]))
    src, after = par.port_state_np(other), par.port_state_np(pool)
    forked, mrg = par.port_state_np(fork), par.port_state_np(merged)
    assert any(p.startswith("['rem']") for p in src)
    for p in src:
        ax = 1 if p.startswith("['units']") else 0
        take = lambda a, r: np.take(a, r, axis=ax)  # noqa: E731
        assert np.array_equal(take(after[p], [3, 1]), take(src[p], [3, 1]))
        assert np.array_equal(take(after[p], [0, 2]),
                              take(before[p], [0, 2]))
        assert np.array_equal(take(forked[p], [0, 2]),
                              take(src[p], [2, 2]))
        assert np.array_equal(take(forked[p], [1, 3]),
                              take(before[p], [1, 3]))
        assert np.array_equal(take(mrg[p], [0, 3]), take(src[p], [0, 3]))
        assert np.array_equal(take(mrg[p], [1, 2]), take(before[p], [1, 2]))


def test_engine_streams_match_reference():
    """Greedy streams of the reference's per-unit engine and the port's
    unit/rem engine on the same bridged params, token for token (the
    plain path, as the reference's own
    ``test_engine_streams_match_reference_for_recurrent_archs``; the
    kernels' wrappers are held step by step above)."""
    par.check_engine_streams(ARCH, overlap=False, use_kernel=False)


@pytest.fixture(scope="module")
def model():
    cfg = tcfgs.get_config(ARCH, reduced=True, use_kernel=True)
    return cfg, tlm.init_params(cfg, seed=0, device="cpu")


def _requests(vocab, *, prefix=(), n=6, seed=0, temperature=0.0):
    rng = random.Random(seed)
    return [Request(prompt=list(prefix) + [rng.randrange(vocab) for _ in
                                           range(rng.randint(4, 26))],
                    max_new_tokens=rng.randint(3, 8), uid=5000 + i,
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
    call give the same streams, greedy and sampled."""
    runs = [_drain(model, _requests(model[0].vocab, seed=1,
                                    temperature=temperature),
                   overlap=overlap, prefill_rows=1)
            for overlap in (False, True)]
    assert runs[0][0] == runs[1][0]
    assert runs[1][1].stats["decode_path"] == "fused_plain"
    if temperature:
        assert any(len(set(t)) > 1 for t in runs[0][0].values())


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", ["darkformer", "exact"])
def test_prefix_cache_forks_equal_cold_starts(model, kind, overlap):
    """Requests sharing a 16-token prefix, forked from the cached h,
    conv and (S, z, c) or exact KV snapshots, give the streams of a
    cache-less engine, under both schedulers; the unit/rem layout keeps
    the contiguous exact cache (no paged KV, as in the reference)."""
    cfg, params = model
    if kind == "exact":
        cfg = tcfgs.darkify(cfg, "exact", cfg.attn.num_features)
    rng = random.Random(42)
    prefix = [rng.randrange(cfg.vocab) for _ in range(16)]
    reqs = lambda: _requests(cfg.vocab, prefix=prefix, seed=3,  # noqa: E731
                             temperature=0.8)
    cold, _ = _drain((cfg, params), reqs(), overlap=overlap)
    pc = PrefixCacheConfig(block_tokens=8, page_size=8)
    _, eng = _drain((cfg, params), [Request(prompt=prefix + [1, 2],
                                            max_new_tokens=2, uid=4999)],
                    prefix_cache=pc, overlap=overlap)
    assert eng.prefix_cache.has(prefix)
    for r in reqs():
        eng.submit(r)
    got = {r.uid: list(r.tokens) for r in eng.run()}
    st = eng.stats
    assert st["forked_requests"] >= 5 and st["forked_tokens"] > 0
    assert not st["paged_kv"]
    assert got == cold


@pytest.mark.parametrize("kernel", [None, "exact"])
def test_serve_cli_runs_recurrentgemma(capsys, kernel):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--slots", "2", "--max-len", "48", "--prompt-len", "4-20",
            "--gen", "3-5", "--chunk-tokens", "8"]
    st = serve.main(argv + (["--kernel", kernel] if kernel else []))
    assert st["finished"] == 3 and len(st["results"]) == 3
    assert st["decode_path"] == (kernel or "fused_plain")
    assert "throughput:" in capsys.readouterr().out


def test_decode_runs_every_slot_width(model):
    """Every engine decode runs ``max_slots`` rows, the active ones padded
    with repeats, so a row's products never see another row count (on
    the card cuBLAS picks an f32 GEMM's algorithm by it: the RG-LRU's
    gate products would give a forked row other bits than a cold one);
    the free slots stay bitwise as they were and each stream equals the
    one it gets served alone."""
    cfg, params = model
    widths = []
    decode = tlm.decode_step

    def counted(p, c, token, *a, **kw):
        widths.append(token.shape[0])
        return decode(p, c, token, *a, **kw)
    reqs = _requests(cfg.vocab, n=4, seed=7)
    try:
        tlm.decode_step = counted
        got, eng = _drain(model, reqs)
    finally:
        tlm.decode_step = decode
    assert widths and set(widths) == {3}
    assert eng.stats["decode_steps"] == len(widths)
    for r in _requests(cfg.vocab, n=4, seed=7):
        alone, _ = _drain(model, [r])
        assert alone[r.uid] == got[r.uid], r.uid
    pool = _filled_pool(cfg, 4, 0)
    before = par.port_state_np(pool)
    out = slot_ops.freeze_inactive(
        pool, torch.tensor([1, 3, 1, 1]), lambda st: tlm.decode_step(
            params, cfg, torch.tensor([5, 6, 5, 5]), st), n=2)
    assert out.shape == (2, cfg.vocab)
    after = par.port_state_np(pool)
    for p in after:
        ax = 1 if p.startswith("['units']") else 0
        assert np.array_equal(np.take(after[p], [0, 2], axis=ax),
                              np.take(before[p], [0, 2], axis=ax)), p
    assert pool["pos"].tolist() == (before["['pos']"]
                                    + np.array([0, 1, 0, 1])).tolist()

"""The port's overlapped serving scheduler and ``serve --load``, on the CPU.

``ServingEngine(overlap=True)`` runs the sequential engine's step
functions in the reference's pipelined order: retire the tokens sampled
last step, admit, merge, decode, prefill, pack. So wherever the chunk
schedule agrees (one staged row per prefill call), its streams, greedy
and sampled, equal the sequential engine's token for token, and its
greedy streams and step counts equal the reference's overlapped engine
on the same bridged params. These are the reference's
``tests/test_overlapped_serving.py`` cases that need no mesh, held
inside the port, plus one against the reference.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import lm as jlm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.launch import serve, train
from repro_torch.models import lm as tlm
from repro_torch.serving import Request, ServingEngine, synthetic_requests
from repro_torch.serving import slots as slot_ops

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def parts():
    cfg = tcfgs.get_config("smollm-135m", reduced=True, use_kernel=True)
    return cfg, tlm.init_params(cfg, seed=0, device="cpu")


def _storm(vocab, *, n=8, seed=0, rate=150.0, temperature=0.0,
           sampled_mix=False):
    """Poisson admission storm with pinned uids, so the per-row draws
    (and hence sampled streams) are comparable across engines."""
    rng = random.Random(seed)
    t, reqs = 0.0, []
    for i in range(n):
        t += rng.expovariate(rate)
        kw = {}
        if sampled_mix and i % 3 == 1:
            kw = {"top_k": 7, "top_p": 0.9}
        reqs.append(Request(
            prompt=[rng.randrange(vocab) for _ in range(rng.randint(6, 30))],
            max_new_tokens=rng.randint(3, 9), arrival_time=t,
            temperature=temperature, uid=5000 + i, **kw))
    return reqs


def _engine(parts, *, overlap, chunk=16, slots=3, max_len=48, **kw):
    cfg, params = parts
    return ServingEngine(params, cfg, max_slots=slots, max_len=max_len,
                         chunk_tokens=chunk, seed=0, overlap=overlap,
                         device="cpu", **kw)


def _run(parts, reqs, **kw):
    eng = _engine(parts, **kw)
    for r in reqs:
        eng.submit(r)
    return {r.uid: list(r.tokens) for r in eng.run()}, eng


# ---------------------------------------------------------------------------
# stream equality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,temperature,mix", [
    (16, 0.0, False), (None, 0.0, False), (16, 0.8, True)])
def test_overlap_matches_sequential(parts, chunk, temperature, mix):
    """With one staged row per prefill call every grant is
    min(remaining, chunk) under both schedulers, so the chunk boundaries
    agree and each request's stream, greedy or sampled (a third of the
    rows with top-k/top-p), is the same token for token."""
    cfg = parts[0]
    streams = []
    for overlap in (False, True):
        got, eng = _run(parts, _storm(cfg.vocab, seed=1,
                                      temperature=temperature,
                                      sampled_mix=mix),
                        overlap=overlap, chunk=chunk, prefill_rows=1)
        assert eng.stats["finished"] == 8
        streams.append(got)
    assert streams[0] == streams[1]
    if temperature:
        assert any(len(set(t)) > 1 for t in streams[0].values())


def test_overlap_matches_solo_reference(parts):
    """One request through the overlapped engine equals the solo
    whole-prompt ``lm.prefill`` plus ``lm.decode_step`` chain."""
    cfg, params = parts
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, 8).tolist()
    lg, st = tlm.prefill(params, cfg, {"tokens": torch.tensor([prompt])},
                         max_len=48)
    ref = [int(lg[0, -1].argmax())]
    for _ in range(5):
        lg, st = tlm.decode_step(params, cfg, torch.tensor(ref[-1:]), st)
        ref.append(int(lg[0].argmax()))
    got, _ = _run(parts, [Request(prompt=prompt, max_new_tokens=6, uid=77)],
                  overlap=True, chunk=None)
    assert got[77] == ref


@pytest.mark.parametrize("use_kernel", [False, True])
def test_overlap_matches_reference_overlapped_engine(use_kernel):
    """The port's and the reference's overlapped engines, same bridged
    params and requests, all arriving at 0: equal greedy streams and
    equal prefill calls, decode steps and emitted tokens."""
    jcfg = dataclasses.replace(jcfgs.get_config("smollm-135m", reduced=True),
                               use_kernel=use_kernel)
    tcfg = tcfgs.get_config("smollm-135m", reduced=True,
                            use_kernel=use_kernel)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, n).tolist()
               for n in (5, 13, 9, 7, 17)]
    gens = (6, 3, 8, 4, 5)
    streams, counts = [], []
    for eng, req in (
            (JEngine(jparams, jcfg, max_slots=2, max_len=48, chunk_tokens=8,
                     overlap=True), JRequest),
            (ServingEngine(tparams, tcfg, max_slots=2, max_len=48,
                           chunk_tokens=8, overlap=True, device="cpu"),
             Request)):
        uids = [eng.submit(req(prompt=p, max_new_tokens=n))
                for p, n in zip(prompts, gens)]
        got = {r.uid: r.tokens for r in eng.run()}
        streams.append([got[u] for u in uids])
        st = eng.stats
        assert st["overlap"] is True
        counts.append({k: st[k] for k in ("prefill_calls", "decode_steps",
                                          "emitted_tokens")})
    assert streams[0] == streams[1]
    assert counts[0] == counts[1]
    assert counts[1]["emitted_tokens"] == sum(gens)


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------

def _cancel_trace(parts, overlap):
    """Cancel a decoding request the moment its observed stream reaches
    3 tokens (from ``on_token``, at host readiness: under overlap more
    of its tokens are in flight and must be dropped), one request while
    still queued, and one mid-prefill."""
    cfg = parts[0]
    eng = _engine(parts, overlap=overlap, slots=2, max_len=96, chunk=8)
    reqs = _storm(cfg.vocab, n=4, seed=4)
    victim = reqs[0]
    seen = []

    def hook(tok, t):
        seen.append(tok)
        if len(seen) == 3:
            eng.cancel(victim.uid)
    victim.on_token = hook
    long = Request(prompt=[1] * 64, max_new_tokens=4, uid=6000)
    queued = Request(prompt=[2] * 8, max_new_tokens=4, arrival_time=1e6,
                     uid=6001)                     # never arrives
    for r in [long, queued] + reqs:
        eng.submit(r)
    eng.step()                                     # long is mid-prefill
    assert eng.num_prefilling >= 1
    res_long = eng.cancel(long.uid)
    res_q = eng.cancel(queued.uid)
    done = {r.uid: list(r.tokens) for r in eng.run()}
    done.update({r.uid: list(r.tokens) for r in eng.flush()})
    return seen, res_long, res_q, done


def test_cancel_drops_inflight_tokens(parts):
    (seen_a, long_a, q_a, done_a), (seen_b, long_b, q_b, done_b) = (
        _cancel_trace(parts, overlap) for overlap in (False, True))
    # the victim observed exactly 3 tokens in both modes: the overlapped
    # engine's in-flight tokens were dropped, not flushed
    assert len(seen_a) == len(seen_b) == 3
    assert seen_a == seen_b
    for res in (long_a, long_b):
        assert res.cancelled and res.tokens == []
    assert q_a.cancelled and q_b.cancelled
    assert done_a == done_b


def test_cancel_before_merge_frees_the_slot_cleanly(parts):
    """A request cancelled after its final chunk was dispatched but
    before the merge is never merged: the request admitted into its
    slot streams what it streams alone."""
    seen = []
    a = Request(prompt=[7] * 8, max_new_tokens=6, uid=7000)
    b = Request(prompt=[9] * 12, max_new_tokens=4, uid=7001,
                on_token=lambda tok, t: seen.append(tok))
    eng = _engine(parts, overlap=True, slots=1)
    for r in (a, b):
        eng.submit(r)
    while eng._pending_merge is None:
        eng.step()
    assert eng.cancel(a.uid).tokens == []
    got = {r.uid: r.tokens for r in eng.run()}
    alone, _ = _run(parts, [Request(prompt=b.prompt, max_new_tokens=4,
                                    uid=7001)], overlap=False, slots=1)
    assert got == alone
    assert seen == got[b.uid]             # no token of a reached b
    assert eng.stats["admitted"] == 1
    assert eng.stats["emitted_tokens"] == 4


# ---------------------------------------------------------------------------
# pipeline invariants, stats, drain
# ---------------------------------------------------------------------------

def test_overlap_stats_and_chunk_budget(parts):
    cfg = parts[0]
    _, eng = _run(parts, _storm(cfg.vocab, seed=5), overlap=True, chunk=16)
    st = eng.stats
    assert st["overlap"] is True
    assert st["max_prefill_tokens_per_step"] <= 16
    for key in ("decode_stall_ms_p50", "decode_stall_ms_p99",
                "decode_stall_ms_max", "dispatch_depth_mean",
                "dispatch_depth_max"):
        assert isinstance(st[key], (int, float)), key
    # the device queue ran ahead of the fetched tokens at least once
    assert st["dispatch_depth_max"] >= 1
    _, seq = _run(parts, _storm(cfg.vocab, seed=5), overlap=False, chunk=16)
    assert seq.stats["overlap"] is False


def test_on_token_readiness_order(parts):
    """``on_token`` fires once per token, in order, at non-decreasing
    times equal to the recorded ``token_times``."""
    calls = []
    req = Request(prompt=[3] * 8, max_new_tokens=5, uid=81,
                  on_token=lambda tok, t: calls.append((tok, t)))
    eng = _engine(parts, overlap=True)
    eng.submit(req)
    res = eng.run()[0]
    assert [tok for tok, _ in calls] == res.tokens
    times = [t for _, t in calls]
    assert times == sorted(times) == res.token_times


def test_flush_drains_inflight(parts):
    eng = _engine(parts, overlap=True, slots=2)
    uid = eng.submit(Request(prompt=[5] * 8, max_new_tokens=12, uid=91))
    for _ in range(4):
        eng.step()
    slot = next(s for s in eng._slots if s is not None)
    assert slot.emitted > len(slot.result.tokens)   # tokens in flight
    eng.flush()
    assert slot.emitted == len(slot.result.tokens)  # all retired
    assert eng.has_work                             # request unfinished
    res = eng.run()
    assert len({r.uid: r for r in res}[uid].tokens) == 12
    assert _engine(parts, overlap=False).flush() == []


# ---------------------------------------------------------------------------
# slots-level primitives
# ---------------------------------------------------------------------------

def test_merge_slots_matches_read_write_pair(parts):
    cfg = parts[0]
    src = tlm.init_serve_state(cfg, b=4, max_len=16, per_slot=True,
                               device="cpu")
    gen = torch.Generator().manual_seed(0)
    for t in (*src["layers"], src["pos"]):
        t.copy_(torch.randint(0, 9, t.shape, generator=gen))
    dst = slot_ops.tree_slot_map(lambda p, axis: p + 1, src)
    ref = slot_ops.tree_slot_map(lambda p, axis: p.clone(), dst)
    idx = torch.tensor([0, 2])
    slot_ops.merge_slots(dst, src, idx)
    slot_ops.write_slots(ref, slot_ops.read_slots(src, idx), idx)
    for a, b in zip((*dst["layers"], dst["pos"]), (*ref["layers"],
                                                   ref["pos"])):
        assert torch.equal(a, b)


def test_pack_buffer_double_buffers():
    """Consecutive packs land in different buffers (the view handed out
    for chunk N survives packing chunk N+1), rows are zero-padded to
    l_pad, and the third pack reuses the first buffer."""
    pb = slot_ops.PackBuffer(max_rows=3, max_chunk=8)
    a = pb.pack([[1, 2, 3], [4]], 4)
    b = pb.pack([[9, 9, 9, 9]], 4)
    assert a.tolist() == [[1, 2, 3, 0], [4, 0, 0, 0]]
    assert b.tolist() == [[9, 9, 9, 9]]
    assert a.is_contiguous() and b.is_contiguous()
    c = pb.pack([[7, 8]], 2)
    assert c.untyped_storage().data_ptr() == a.untyped_storage().data_ptr()
    assert b.tolist() == [[9, 9, 9, 9]]
    assert pb.to_device(c) is c                 # the CPU needs no copy


# ---------------------------------------------------------------------------
# serve --load
# ---------------------------------------------------------------------------

def test_serve_load_serves_the_trainers_checkpoint(tmp_path, capsys):
    """A checkpoint written by the port's trainer ({"params", "opt"})
    serves, through ``serve --load``, the greedy streams of an engine
    built on the params that training run returned."""
    ck = tmp_path / "ck"
    out = train.main(["--arch", "smollm-135m", "--reduced", "--device",
                      "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
                      "--lr", "3e-2", "--ckpt-dir", str(ck)])
    args = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--requests", "3", "--slots", "2", "--max-len", "48",
            "--prompt-len", "4-12", "--gen", "3-5", "--chunk-tokens", "8"]
    st = serve.main(args + ["--load", str(ck)])
    assert "loaded params from" in capsys.readouterr().out
    got = [r.tokens for r in sorted(st["results"], key=lambda r: r.uid)]

    eng = ServingEngine(out["params"], out["config"], max_slots=2,
                        max_len=48, chunk_tokens=8, overlap=True,
                        device="cpu")
    uids = [eng.submit(r) for r in synthetic_requests(
        3, out["config"].vocab, prompt_range=(4, 12), gen_range=(3, 5))]
    by_uid = {r.uid: r.tokens for r in eng.run()}
    assert got == [by_uid[u] for u in uids]
    # the seed's random params serve other streams: the load took effect
    fresh = serve.main(args)
    assert [r.tokens for r in sorted(fresh["results"],
                                     key=lambda r: r.uid)] != got

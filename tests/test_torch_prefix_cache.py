"""The port's prefix cache and paged exact KV cache, on the CPU.

A cache hit is a pure scheduling gain: a forked request resumes chunked
prefill from the cached cursor on the chunk grid a cold start would use,
so its stream must equal a cache-less engine's token for token, for the
PRF kinds (a snapshot fork of the (S, z, c) state) and for exact
attention (a copy-on-write fork of paged KV), under both schedulers.
These are the reference's ``tests/test_prefix_cache.py`` cases that need
no mesh, held inside the port, then the port against the reference: the
store's keys and bookkeeping, the paged attention function, the LM's
paged steps, the traffic generator and forked streams.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import attention as jatt
from repro.models import lm as jlm
from repro.serving import PageAllocator as JPageAllocator
from repro.serving import PrefixCache as JPrefixCache
from repro.serving import PrefixCacheConfig as JPrefixCacheConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import request as jrequest
from repro.serving.prefix_cache import prefix_key as jprefix_key
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.core import attention as tatt
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.serving import (NoFreePages, PageAllocator, PrefixCache,
                                 PrefixCacheConfig, Request, ServingEngine,
                                 shared_prefix_requests)
from repro_torch.serving import prefix_cache as pc_mod

torch.set_num_threads(1)
PC = PrefixCacheConfig(block_tokens=8, page_size=8)
# f32 in another summation order (sums over <= 32 positions), as
# tests/test_torch_exact.py's F32_TOL
F32_TOL = dict(atol=1e-5, rtol=0)
# the LM's logits and state through 3 layers, as tests/test_torch_model.py
ATOL = 1e-4


def _cfg(kind: str, **kw):
    cfg = tcfgs.get_config("smollm-135m", reduced=True, use_kernel=True)
    cfg = tcfgs.darkify(cfg, kind, cfg.attn.num_features)
    return dataclasses.replace(cfg, **kw) if kw else cfg


@pytest.fixture(scope="module")
def models():
    """(cfg, params) of the reduced smollm-135m, darkformer and exact."""
    out = {}
    for kind in ("darkformer", "exact"):
        cfg = _cfg(kind)
        out[kind] = (cfg, tlm.init_params(cfg, seed=0, device="cpu"))
    return out


def _prefix(vocab, n=16, seed=42):
    rng = random.Random(seed)
    return [rng.randrange(vocab) for _ in range(n)]


def _sharers(vocab, prefix, *, n=5, seed=0, temperature=0.0,
             sampled_mix=False, req=Request):
    """Prefix-sharing requests with pinned uids, so the per-row draws
    (and hence sampled streams) are comparable across engines."""
    rng = random.Random(seed)
    reqs = []
    for i in range(n):
        kw = {}
        if sampled_mix and i % 3 == 1:
            kw = {"top_k": 7, "top_p": 0.9}
        suffix = [rng.randrange(vocab)
                  for _ in range(rng.randint(4, 10))]
        reqs.append(req(prompt=list(prefix) + suffix,
                        max_new_tokens=rng.randint(3, 8),
                        temperature=temperature, uid=5000 + i, **kw))
    return reqs


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: list(r.tokens) for r in eng.run()}


def _engine(model, *, cache, overlap=False, slots=3, **kw):
    cfg, params = model
    return ServingEngine(params, cfg, max_slots=slots, max_len=64,
                         chunk_tokens=8, seed=0, overlap=overlap,
                         prefix_cache=cache, device="cpu", **kw)


def _primed_engine(model, prefix, **kw):
    """Cache-on engine whose store already holds the prefix: one primer
    request drained through it captures the block-aligned snapshots."""
    eng = _engine(model, cache=PC, **kw)
    _drain(eng, [Request(prompt=list(prefix) + [1, 2, 3],
                         max_new_tokens=2, uid=4999)])
    assert eng.prefix_cache.has(prefix)
    return eng


# ---------------------------------------------------------------------------
# fork parity: forked streams equal cold-start streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["darkformer", "exact"])
@pytest.mark.parametrize("overlap", [False, True])
def test_fork_parity_greedy(models, kind, overlap):
    """Greedy prefix-sharing batch: every stream from the primed
    cache-on engine (every sharer forks the cached prefix) equals the
    cache-less engine's, for PRF snapshot forks and exact paged
    copy-on-write forks, under both schedulers."""
    model = models[kind]
    cfg = model[0]
    prefix = _prefix(cfg.vocab)
    ref = _drain(_engine(model, cache=None, overlap=overlap),
                 _sharers(cfg.vocab, prefix, seed=1))
    eng = _primed_engine(model, prefix, overlap=overlap)
    got = _drain(eng, _sharers(cfg.vocab, prefix, seed=1))
    st = eng.stats
    assert st["forked_requests"] >= 5 and st["forked_tokens"] > 0
    assert st["paged_kv"] == (kind == "exact")
    assert st["prefill_path"] == ("exact_paged" if kind == "exact"
                                  else "fused_plain")
    assert set(got) == set(ref)
    for uid in ref:
        assert got[uid] == ref[uid], uid


@pytest.mark.parametrize("overlap", [False, True])
def test_fork_parity_sampled(models, overlap):
    """Sampled storm (temperature 0.8, a third of the rows top-k/top-p):
    the per-row (uid, token index) draws do not depend on the fork, so
    even sampled forked streams equal cold-start ones."""
    model = models["darkformer"]
    cfg = model[0]
    prefix = _prefix(cfg.vocab)

    def mk():
        return _sharers(cfg.vocab, prefix, seed=2, temperature=0.8,
                        sampled_mix=True)
    ref = _drain(_engine(model, cache=None, overlap=overlap), mk())
    eng = _primed_engine(model, prefix, overlap=overlap)
    got = _drain(eng, mk())
    assert eng.stats["forked_requests"] >= 5
    for uid in ref:
        assert got[uid] == ref[uid], uid
    assert any(len(set(t)) > 1 for t in got.values())


def test_partial_prefix_match_forks_longest_block(models):
    """A prompt sharing only the first block of a longer cached prefix
    forks from the longest block-aligned snapshot."""
    model = models["darkformer"]
    cfg = model[0]
    prefix = _prefix(cfg.vocab, n=16)
    eng = _primed_engine(model, prefix)
    half = prefix[:8]
    ref = _drain(_engine(model, cache=None),
                 _sharers(cfg.vocab, half, n=2, seed=3))
    hits0 = eng.stats["prefix_hits"]
    got = _drain(eng, _sharers(cfg.vocab, half, n=2, seed=3))
    assert eng.stats["prefix_hits"] == hits0 + 2
    for uid in ref:
        assert got[uid] == ref[uid], uid


@pytest.mark.parametrize("max_len", [64, 60])
def test_paged_exact_engine_matches_contiguous(models, max_len):
    """The paged exact engine (path exact_paged, every sharer forked)
    serves the contiguous exact engine's greedy streams: with max_len a
    multiple of the page size the gathered view has the cache's length
    and both run the same arithmetic; at 60 (8 pages of 8 = 64 gathered
    positions against a cache of 60) the streams still agree here."""
    model = models["exact"]
    cfg, params = model
    prefix = _prefix(cfg.vocab)
    streams = []
    for cache in (None, PC):
        eng = ServingEngine(params, cfg, max_slots=3, max_len=max_len,
                            chunk_tokens=8, prefix_cache=cache,
                            device="cpu")
        if cache is not None:
            _drain(eng, [Request(prompt=list(prefix) + [1, 2, 3],
                                 max_new_tokens=2, uid=4999)])
        streams.append(_drain(eng, _sharers(cfg.vocab, prefix, seed=8)))
        assert eng.stats["decode_path"] == ("exact_paged" if cache
                                            else "exact")
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# cancel after fork
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["darkformer", "exact"])
@pytest.mark.parametrize("overlap", [False, True])
def test_cancel_after_fork(models, kind, overlap):
    """Cancelling one forked request mid-decode leaves its sibling forks
    as they were (they share the entry, not mutable state), and the
    cached entry keeps serving later admissions."""
    model = models[kind]
    cfg = model[0]
    prefix = _prefix(cfg.vocab)
    ref = _drain(_engine(model, cache=None, overlap=overlap),
                 _sharers(cfg.vocab, prefix, seed=4))

    eng = _primed_engine(model, prefix, overlap=overlap)
    reqs = _sharers(cfg.vocab, prefix, seed=4)
    victim = reqs[0]
    seen = []

    def hook(tok, t):
        seen.append(tok)
        if len(seen) == 2:
            eng.cancel(victim.uid)
    victim.on_token = hook
    got = _drain(eng, reqs)
    assert len(seen) == 2                      # in-flight work dropped
    for uid in ref:
        if uid != victim.uid:
            assert got[uid] == ref[uid], uid
    hits0 = eng.stats["prefix_hits"]
    late = _drain(eng, _sharers(cfg.vocab, prefix, n=1, seed=5))
    assert eng.stats["prefix_hits"] == hits0 + 1
    assert late


def test_freed_pages_return_after_the_table_reset(models):
    """A freed paged row's pages go back to the allocator only at the
    head of the next step, after its pool and staging tables are reset
    to the garbage page; afterwards only the cached entries hold pages,
    each page once per owner."""
    eng = _primed_engine(models["exact"], _prefix(256))
    _drain(eng, _sharers(256, _prefix(256), n=4, seed=9))
    assert eng._pending_clear                  # the last rows freed
    eng._flush_freed()
    assert not eng._pending_clear
    assert all(p is None for p in eng._slot_pages)
    for pool in (eng.pool, eng.staging):
        assert not pool["layers"].table.any()
        assert not pool["layers"].length.any()
    held = [p for e in eng.prefix_cache._entries.values() for p in e.pages]
    ref = np.zeros(eng._alloc.n_pages, np.int32)
    np.add.at(ref, held, 1)
    np.testing.assert_array_equal(eng._alloc._ref, ref)
    assert eng._alloc.n_free == eng._alloc.n_pages - 1 - len(set(held))


# ---------------------------------------------------------------------------
# the store: LRU tiers, verification, allocator
# ---------------------------------------------------------------------------

def _state(fill, n=256):
    return {"s": torch.full((n,), fill)}


def _store(**kw):
    return PrefixCache(PrefixCacheConfig(block_tokens=4, **kw))


def test_lru_demote_then_evict_order():
    """Strict LRU across both tiers: device overflow demotes the least
    recently used entries to host (in tick order), host overflow evicts
    them, and a match() bump rescues an entry from demotion."""
    nbytes = _state(0.0)["s"].nbytes
    pc = _store(device_bytes=2 * nbytes, host_bytes=nbytes)
    a, b, c, d = ([10 + i] * 4 for i in range(4))
    pc.put(a, _state(1.0))
    pc.put(b, _state(2.0))
    assert pc.match(a + [0]) is not None       # bump a: b is now LRU
    pc.put(c, _state(3.0))                     # device full -> demote b
    st = pc.stats
    assert st["prefix_demotions"] == 1 and st["prefix_evictions"] == 0
    assert st["prefix_device_bytes"] == 2 * nbytes
    assert st["prefix_host_bytes"] == nbytes
    pc.put(d, _state(4.0))                     # demote a -> host full
    st = pc.stats                              # -> evict b (host LRU)
    assert st["prefix_demotions"] == 2 and st["prefix_evictions"] == 1
    assert not pc.has(b) and pc.has(a) and pc.has(c) and pc.has(d)
    # promoting the host-tier survivor rebalances the device tier
    ent = pc.match(a + [0])
    out = pc.device_state(ent)
    assert torch.equal(out["s"], _state(1.0)["s"])
    assert pc.stats["prefix_demotions"] == 3   # c or d made room
    assert pc.stats["prefix_promotions"] == 1


def test_match_verifies_tokens_and_respects_limit():
    """match() never returns a whole-prompt entry (>= 1 token must stay
    to prefill) and checks stored tokens, not just the hash."""
    pc = _store()
    toks = [1, 2, 3, 4]
    pc.put(toks, _state(1.0))
    assert pc.match(toks) is None              # nothing left to prefill
    assert pc.match(toks + [9]) is not None
    assert pc.match([1, 2, 3, 5, 6]) is None   # differing 4th token
    assert pc.stats["prefix_hits"] == 1
    assert pc.stats["prefix_misses"] == 2
    # a forged entry under the right key but other tokens never matches
    ent = pc._entries[pc_mod.prefix_key(toks)]
    ent.tokens = (1, 2, 3, 7)
    assert pc.match(toks + [9]) is None


def test_paged_entries_evict_not_demote():
    """A paged entry's KV pages stay on the device, so the rebalancer
    EVICTS it (releasing its pages) instead of demoting it."""
    released = []
    nbytes = _state(0.0)["s"].nbytes
    alloc = PageAllocator(8)

    def _release(ids):
        released.extend(ids)
        alloc.release(ids)

    pc = PrefixCache(PrefixCacheConfig(block_tokens=4,
                                       device_bytes=2 * nbytes),
                     release_pages=_release)
    pages = alloc.alloc(2)
    pc.put([1] * 4, _state(1.0), pages=pages, page_bytes=nbytes)
    pc.put([2] * 4, _state(2.0))
    pc.put([3] * 4, _state(3.0))               # overflow: paged LRU out
    st = pc.stats
    assert st["prefix_evictions"] == 1 and st["prefix_demotions"] == 0
    assert released == pages and alloc.n_free == 7
    assert not pc.has([1] * 4)


def test_page_allocator_refcounts():
    """retain/release move refcounts; pages free only at zero; page 0 is
    never handed out; exhaustion raises before mutating."""
    alloc = PageAllocator(4)
    ids = alloc.alloc(3)
    assert 0 not in ids and alloc.n_free == 0
    alloc.retain(ids[:1])
    alloc.release(ids)                         # ids[0] still retained
    assert alloc.n_free == 2
    with pytest.raises(NoFreePages):
        alloc.alloc(3)
    assert alloc.n_free == 2                   # alloc failed atomically
    alloc.release(ids[:1])
    assert alloc.n_free == 3


def test_match_unaligned_final_capture_length():
    """A capture_final entry at a length off the block grid is still a
    candidate: candidates are the lengths stored, and the longest wins."""
    pc = _store()
    pc.put([5, 6, 7, 8, 9, 10], _state(1.0))       # len 6: unaligned
    pc.put([5, 6, 7, 8], _state(2.0))
    ent = pc.match([5, 6, 7, 8, 9, 10, 11])
    assert ent is not None and len(ent.tokens) == 6


def test_match_hashes_in_one_rolling_pass(monkeypatch):
    """match() hashes the prompt ONCE (a rolling digest copied at each
    stored length), not once per candidate: a miss on a long prompt
    costs O(len) blake2b work."""
    pc = _store()
    for n in (4, 8, 16):
        pc.put(list(range(n)), _state(float(n)))
    calls = []
    real = pc_mod.hashlib.blake2b
    monkeypatch.setattr(
        pc_mod.hashlib, "blake2b",
        lambda *a, **k: calls.append(1) or real(*a, **k))
    ent = pc.match(list(range(16)) + [99] * 400)    # hit at length 16
    assert ent is not None and len(ent.tokens) == 16
    assert len(calls) == 1
    calls.clear()
    assert pc.match([77] * 400) is None             # long-prompt miss
    assert len(calls) == 1


def test_reclaim_pages_backpressure():
    """reclaim_pages evicts LRU paged entries until the pool can serve
    the request, and reports failure (the engine defers) when it
    cannot."""
    alloc = PageAllocator(6)
    pc = PrefixCache(PrefixCacheConfig(block_tokens=4),
                     release_pages=alloc.release)
    pc.put([1] * 4, _state(1.0), pages=alloc.alloc(3), page_bytes=1)
    pc.put([2] * 4, _state(2.0), pages=alloc.alloc(2), page_bytes=1)
    assert pc.reclaim_pages(alloc, 3)          # evicts the LRU entry
    assert alloc.n_free == 3 and not pc.has([1] * 4)
    assert not pc.reclaim_pages(alloc, 6)      # even empty can't serve
    assert len(pc) == 0


def test_reclaim_pages_excludes_pinned_entry():
    """reclaim_pages(exclude=) never evicts the pinned entry: even as
    the last paged entry left it reports failure instead of dropping the
    pages the caller is about to share."""
    alloc = PageAllocator(6)
    pc = PrefixCache(PrefixCacheConfig(block_tokens=4),
                     release_pages=alloc.release)
    a_pages = alloc.alloc(2)
    pc.put([1] * 4, _state(1.0), pages=a_pages, page_bytes=1)
    ent = pc.match([1] * 4 + [0])
    pc.put([2] * 4, _state(2.0), pages=alloc.alloc(2), page_bytes=1)
    assert not pc.reclaim_pages(alloc, 5, exclude=ent)
    assert pc.has([1] * 4) and not pc.has([2] * 4)
    assert alloc.n_free == 3                   # A's 2 pages resident
    assert all(alloc._ref[p] > 0 for p in a_pages)


def test_fork_admission_never_steals_matched_pages(models):
    """Exhausted page pool at fork admission: the reclaim never evicts
    the matched entry itself (else its shared prefix pages would go to
    the LIFO free list and come back as the same request's writable
    growth pages). The admission defers with refcounts unwound, the
    entry keeps serving, and the retried admission builds a table with
    no page twice."""
    model = models["exact"]
    prefix = _prefix(model[0].vocab)
    eng = _primed_engine(model, prefix)
    alloc = eng._alloc
    ent = eng.prefix_cache.match(list(prefix) + [0])
    assert ent is not None and len(ent.tokens) == len(prefix)
    hog = alloc.alloc(alloc.n_free)            # drain the free list
    req = Request(prompt=list(prefix) + [7] * 8, max_new_tokens=4,
                  uid=6001)
    with pytest.raises(NoFreePages):
        eng._paged_admit_pages(req, ent)
    assert eng.prefix_cache.has(prefix)
    assert all(alloc._ref[p] > 0 for p in ent.pages)
    alloc.release(hog)
    table, own, copies = eng._paged_admit_pages(req, ent)
    assert len(set(own)) == len(own)           # no page twice
    assert set(ent.pages).issubset(own)        # prefix pages shared
    assert all(alloc._ref[p] >= 2 for p in ent.pages)
    assert list(table[:len(own)]) == own and not table[len(own):].any()


def test_admission_waits_for_pages_and_unwinds_its_count(models):
    """With the page pool exhausted and nothing to reclaim, an arrived
    request stays queued, the failed match is not counted, and it is
    admitted once pages come back."""
    model = models["exact"]
    cfg = model[0]
    eng = _engine(model, cache=PC)
    hog = eng._alloc.alloc(eng._alloc.n_free)
    req = Request(prompt=[3] * 12, max_new_tokens=3, uid=6100)
    eng.submit(req)
    eng.step()
    assert eng._queue and eng.prefix_cache.stats["prefix_misses"] == 0
    eng._alloc.release(hog)
    res = eng.run()
    assert [len(r.tokens) for r in res] == [3]
    assert eng.prefix_cache.stats["prefix_misses"] == 1
    assert cfg.attn.kind == "exact"


def test_misaligned_block_tokens_rejected(models):
    """block_tokens must divide chunk_tokens (capture points fire only on
    block boundaries): checked when the engine is built."""
    cfg, params = models["darkformer"]
    with pytest.raises(ValueError, match="block_tokens"):
        ServingEngine(params, cfg, max_slots=2, max_len=64,
                      chunk_tokens=12, device="cpu",
                      prefix_cache=PrefixCacheConfig(block_tokens=8))


def test_engine_stats_surface(models):
    model = models["exact"]
    prefix = _prefix(model[0].vocab)
    eng = _primed_engine(model, prefix)
    _drain(eng, _sharers(model[0].vocab, prefix, n=2, seed=6))
    st = eng.stats
    assert st["paged_kv"] is True
    for key in ("prefix_hit_rate", "prefix_captures", "forked_tokens",
                "forked_requests", "prefix_device_bytes",
                "prefix_host_bytes", "prefix_demotions",
                "prefix_promotions", "prefix_evictions", "kv_page_size",
                "kv_pages_total", "kv_pages_free"):
        assert key in st, key
    assert 0 < st["kv_pages_free"] < st["kv_pages_total"]
    plain = _engine(models["darkformer"], cache=None).stats
    assert plain["paged_kv"] is False and "prefix_hits" not in plain


def test_serve_cli_prefix_cache_on_shared_prefix_traffic(capsys):
    """``serve --prefix-cache --shared-prefix N``: the requests come from
    ``shared_prefix_requests`` (suffixes of ``--prompt-len``), forks
    happen, and every request gets its tokens; exact serves paged."""
    base = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--requests", "6", "--slots", "2", "--max-len", "64",
            "--prompt-len", "4-8", "--gen", "3", "--chunk-tokens", "16",
            "--prefix-cache", "--prefix-block", "8", "--page-size", "8",
            "--shared-prefix", "16"]
    for extra, path in (([], "fused_plain"), (["--kernel", "exact"],
                                              "exact_paged")):
        st = serve.main(base + extra)
        assert st["decode_path"] == path
        assert st["forked_requests"] >= 1
        assert [len(r.tokens) for r in st["results"]] == [3] * 6
        assert all(16 + 4 <= len(r.prompt) <= 16 + 8
                   for r in st["results"])
        assert "prefix cache:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="block_tokens"):
        serve.main(base[:-7] + ["--prefix-cache", "--prefix-block", "12"])


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

def test_prefix_key_equals_reference():
    rng = np.random.default_rng(0)
    for toks in ([], [0], [1, 2, 3], rng.integers(0, 49152, 300).tolist()):
        assert pc_mod.prefix_key(toks) == jprefix_key(toks)


def test_store_bookkeeping_matches_reference():
    """The same random sequence of put (paged or not), match,
    device_state and reclaim_pages on both stores: the same hits,
    misses, captures, demotions, evictions and tier bytes, the same
    entries on each tier, and the same free pages, after every call."""
    rng = random.Random(0)
    tcfg = PrefixCacheConfig(block_tokens=4, device_bytes=4096,
                             host_bytes=6144)
    jcfg = JPrefixCacheConfig(block_tokens=4, device_bytes=4096,
                              host_bytes=6144)
    talloc, jalloc = PageAllocator(24), JPageAllocator(24)
    tpc = PrefixCache(tcfg, release_pages=talloc.release)
    jpc = JPrefixCache(jcfg, to_host=lambda t: t, to_device=lambda t: t,
                       release_pages=jalloc.release)
    keys = ("prefix_entries", "prefix_hits", "prefix_misses",
            "prefix_hit_rate", "prefix_captures", "prefix_demotions",
            "prefix_evictions", "prefix_device_bytes", "prefix_host_bytes")
    base = [rng.randrange(50) for _ in range(24)]
    last = (None, None)
    for step in range(300):
        op = rng.random()
        n = rng.choice((4, 8, 12, 16, 6))
        toks = base[:n] if rng.random() < 0.6 else [rng.randrange(50)
                                                   for _ in range(n)]
        if op < 0.4:
            size = rng.choice((128, 256, 512))
            paged = rng.random() < 0.3 and talloc.n_free >= 2
            pages = (talloc.alloc(2), jalloc.alloc(2)) if paged else (None,
                                                                      None)
            tpc.put(toks, {"s": torch.zeros(size // 4)}, pages=pages[0],
                    page_bytes=256 if paged else 0)
            jpc.put(toks, {"s": np.zeros(size // 4, np.float32)},
                    pages=pages[1], page_bytes=256 if paged else 0)
        elif op < 0.8:
            prompt = toks + [rng.randrange(50)]
            last = (tpc.match(prompt), jpc.match(prompt))
            assert (last[0] is None) == (last[1] is None)
            if last[0] is not None:
                assert last[0].key == last[1].key
                if rng.random() < 0.5:
                    tpc.device_state(last[0])
                    jpc.device_state(last[1])
        else:
            need = rng.randrange(1, 20)
            ex = last if rng.random() < 0.5 else (None, None)
            assert (tpc.reclaim_pages(talloc, need, exclude=ex[0])
                    == jpc.reclaim_pages(jalloc, need, exclude=ex[1]))
        ts, js = tpc.stats, jpc.stats
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}, step
        assert ({k: e.on_host for k, e in tpc._entries.items()}
                == {k: e.on_host for k, e in jpc._entries.items()}), step
        assert talloc._free == jalloc._free, step
        np.testing.assert_array_equal(talloc._ref, jalloc._ref)
    assert ts["prefix_demotions"] and ts["prefix_evictions"]
    assert ts["prefix_hits"] and ts["prefix_misses"]


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("valid_len", [None, (6, 3, 1)])
def test_exact_paged_append_attend_matches_reference(window, valid_len):
    """``_exact_paged_append_attend`` from random pools and random page
    tables (each row its own pages, the unused tail on page 0), lengths
    that cross page boundaries, ragged rows whose padding goes to page
    0, with and without a window: the output within F32_TOL, the
    lengths exactly, and every page but the garbage page 0 bitwise (the
    written keys and values are the inputs themselves); in place."""
    b, g, hg, l, d, ps, mp, npg = 3, 2, 2, 6, 8, 4, 5, 18
    rng = np.random.default_rng(7)
    qs = rng.standard_normal((b, g, hg, l, d)).astype(np.float32)
    ks = rng.standard_normal((b, g, 1, l, d)).astype(np.float32)
    v = rng.standard_normal((b, g, 1, l, d)).astype(np.float32)
    kp = rng.standard_normal((npg, ps, g, d)).astype(np.float32)
    vp = rng.standard_normal((npg, ps, g, d)).astype(np.float32)
    length = np.asarray([3, 9, 12], np.int32)
    perm = rng.permutation(np.arange(1, npg))
    table = np.zeros((b, mp), np.int32)
    for r in range(b):
        n_own = -(-(length[r] + l) // ps)
        table[r, :n_own] = perm[r * mp:r * mp + n_own]
    vl = None if valid_len is None else np.asarray(valid_len, np.int32)
    jst = jatt.AttnServeState(kv_k=jnp.asarray(kp), kv_v=jnp.asarray(vp),
                              length=jnp.asarray(length),
                              table=jnp.asarray(table))
    jout, jst = jatt._exact_paged_append_attend(
        jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(v), jst, window,
        jnp.float32, valid_len=None if vl is None else jnp.asarray(vl))
    tst = tatt.PagedKVState(table=torch.tensor(table).long(),
                            length=torch.tensor(length))
    pools = (torch.tensor(kp), torch.tensor(vp))
    tout, tst2 = tatt._exact_paged_append_attend(
        torch.tensor(qs), torch.tensor(ks), torch.tensor(v), tst, pools,
        window, torch.float32,
        valid_len=None if vl is None else torch.tensor(vl))
    assert tst2 is tst
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    np.testing.assert_array_equal(tst.length.numpy(), np.asarray(jst.length))
    for got, want in zip(pools, (jst.kv_k, jst.kv_v)):
        np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    # padding landed on page 0 only: every other page holds the inputs
    # at the written positions and its old contents elsewhere
    for r in range(b):
        n = l if vl is None else int(vl[r])
        for t in range(l):
            p = length[r] + t
            page, off = table[r, p // ps], p % ps
            if t < n:
                np.testing.assert_array_equal(pools[0][page, off].numpy(),
                                              ks[r, :, 0, t])
            else:
                assert page == 0 or np.array_equal(
                    pools[0][page, off].numpy(), kp[page, off])


def test_paged_lm_steps_match_reference():
    """A ragged paged prefill chunk from a fresh state, then a full one,
    then two decode steps through ``lm.prefill_chunk`` and
    ``lm.decode_step`` with ``pages=``, against the reference's ``lm`` on
    the same state with the pools attached: the logits within ATOL, each
    layer's table, length and pos exactly, and each layer's pages but
    the garbage page 0 within ATOL."""
    b, max_len, ps, n_pages = 3, 32, 4, 26
    jcfg = jcfgs.darkify(jcfgs.get_config("smollm-135m", reduced=True),
                         "exact", 32)
    tcfg = _cfg("exact", use_kernel=False)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    jstate = jlm.init_paged_serve_state(jcfg, b=b, max_len=max_len,
                                        page_size=ps)
    jpages = jlm.init_kv_pages(jcfg, n_pages, ps)
    tstate = tlm.init_paged_serve_state(tcfg, b, max_len, ps, device="cpu")
    tpages = tlm.init_kv_pages(tcfg, n_pages, ps, device="cpu")
    mp = max_len // ps
    assert tstate["layers"].table.shape == (tcfg.n_layers, b, mp)
    assert tpages["k"].shape == (tcfg.n_layers, n_pages, ps, tcfg.n_kv,
                                 tcfg.head_dim)
    rng = np.random.default_rng(11)
    perm = rng.permutation(np.arange(1, n_pages))[:b * mp]
    table = perm.reshape(b, mp).astype(np.int32)
    table[0, 5:] = 0                             # row 0 uses 5 pages
    jstate["layers"] = jstate["layers"]._replace(table=jnp.broadcast_to(
        jnp.asarray(table), (jcfg.n_layers, b, mp)))
    tstate["layers"].table.copy_(torch.tensor(table).long())

    def check(jlog, tlog, what):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=0, err_msg=what)
        jl, tl = jstate["layers"], tstate["layers"]
        np.testing.assert_array_equal(tl.table.numpy(), np.asarray(jl.table))
        np.testing.assert_array_equal(tl.length.numpy(),
                                      np.asarray(jl.length))
        np.testing.assert_array_equal(tstate["pos"].numpy(),
                                      np.asarray(jstate["pos"]))
        for n in ("k", "v"):
            np.testing.assert_allclose(
                tpages[n].numpy()[:, 1:], np.asarray(jpages[n])[:, 1:],
                atol=ATOL, rtol=0, err_msg=f"{n} pages, {what}")

    for step, (l, vl) in enumerate([(7, (7, 2, 5)), (5, None)]):
        toks = rng.integers(0, jcfg.vocab, (b, l)).astype(np.int32)
        vl_np = None if vl is None else np.asarray(vl, np.int32)
        jlog, st = jlm.prefill_chunk(
            jparams, jcfg, {"tokens": jnp.asarray(toks)},
            jlm.attach_kv_pages(jstate, jpages),
            valid_len=None if vl is None else jnp.asarray(vl_np))
        jstate, jpages = jlm.detach_kv_pages(st)
        tlog, tstate = tlm.prefill_chunk(
            tparams, tcfg, {"tokens": torch.tensor(toks).long()}, tstate,
            valid_len=None if vl is None else torch.tensor(vl_np),
            pages=tpages)
        check(jlog, tlog, f"prefill chunk {step}")
    for step in range(2):
        tok = rng.integers(0, jcfg.vocab, (b,)).astype(np.int32)
        jlog, st = jlm.decode_step(jparams, jcfg, jnp.asarray(tok),
                                   jlm.attach_kv_pages(jstate, jpages))
        jstate, jpages = jlm.detach_kv_pages(st)
        tlog, tstate = tlm.decode_step(tparams, tcfg,
                                       torch.tensor(tok).long(), tstate,
                                       pages=tpages)
        check(jlog, tlog, f"decode step {step}")


def test_init_paged_serve_state_refuses_prf_kinds():
    with pytest.raises(ValueError, match="exact-attention"):
        tlm.init_paged_serve_state(_cfg("darkformer"), 2, 32, 8,
                                   device="cpu")


@pytest.mark.parametrize("kw", [
    {}, dict(rate=5.0, prefix_len=256, n_prefixes=2, reuse=0.8,
             suffix_range=(16, 128), gen_range=(16, 32))])
def test_shared_prefix_requests_match_reference(kw):
    got = shared_prefix_requests(16, 49152, seed=3, **kw)
    want = jrequest.shared_prefix_requests(16, 49152, seed=3, **kw)
    assert [(list(r.prompt), r.max_new_tokens, r.arrival_time)
            for r in got] == [(list(r.prompt), r.max_new_tokens,
                               r.arrival_time) for r in want]


@pytest.mark.parametrize("kind", ["darkformer", "exact"])
def test_forked_streams_match_reference_engine(kind):
    """The port's and the reference's primed cache-on engines (sequential
    scheduler, the same bridged params, primer and sharers): the same
    greedy streams, forks and prefix hits."""
    jcfg = jcfgs.darkify(jcfgs.get_config("smollm-135m", reduced=True),
                         kind, 32)
    jcfg = dataclasses.replace(jcfg, use_kernel=kind != "exact")
    tcfg = _cfg(kind)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    prefix = _prefix(jcfg.vocab)
    jpc = JPrefixCacheConfig(block_tokens=8, page_size=8)
    out = []
    for eng, req in (
            (JEngine(jparams, jcfg, max_slots=3, max_len=64, chunk_tokens=8,
                     prefix_cache=jpc), JRequest),
            (ServingEngine(tparams, tcfg, max_slots=3, max_len=64,
                           chunk_tokens=8, prefix_cache=PC, device="cpu"),
             Request)):
        _drain(eng, [req(prompt=list(prefix) + [1, 2, 3], max_new_tokens=2,
                         uid=4999)])
        got = _drain(eng, _sharers(jcfg.vocab, prefix, seed=1, req=req))
        st = eng.stats
        out.append((got, st["forked_requests"], st["forked_tokens"],
                     st["prefix_hits"], st["paged_kv"]))
    assert out[0] == out[1]
    assert out[1][1] == 5

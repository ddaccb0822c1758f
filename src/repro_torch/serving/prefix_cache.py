"""Prefix cache: prefix-hash -> state-snapshot store with O(1) forking.

The counterpart of ``repro.serving.prefix_cache``. Traffic that shares
prefixes (system prompts, few-shot templates, multi-turn history) makes
reuse cheap for the PRF kinds: a prefix's whole attention state is the
fixed-size (S, z, c) per layer, so forking a cached prefix into N
requests is ONE broadcast scatter into the staging pool
(``slots.fork_slots``), whatever the prefix's length.

This module owns the store; the engine owns the fork
(``repro_torch.serving.engine``):

  * **Keys**: ``blake2b`` over the prefix's int32 little-endian token
    bytes (the reference's keys, hex for hex). Entries keep the token
    tuple and check it on lookup, so a hash collision never splices the
    wrong state into a request. The engine captures a snapshot when a
    request's prefill cursor lands on a ``block_tokens`` multiple (and,
    with ``capture_final``, when the prompt is done); a lookup tries the
    prefix lengths present in the store, longest first, hashing them in
    one rolling pass. A match leaves at least one prompt token to
    prefill, so the first output token is sampled from real logits.
  * **Tiers**: snapshots are born on the device (a gather out of the
    staging pool). Past ``device_bytes`` the least recently used ones
    demote to the host, past ``host_bytes`` they are evicted; a host hit
    is promoted back. The engine supplies both movers: on the card the
    demotion copies into pinned memory and the promotion back, both with
    ``non_blocking=True`` on the one stream the steps run on, so neither
    waits and stream order keeps every copy's data consistent.
  * **Eviction order**: strict LRU by last hit or capture tick, demote
    before evict. ``stats`` counts hits, misses, captures, demotions and
    evictions and each tier's bytes under ``prefix_*`` keys, which the
    engine folds into its own ``stats``.

For the exact kind the snapshot is not O(1): its KV grows with the
prefix. The engine therefore serves exact configs from block-granular
paged KV (``lm.init_paged_serve_state``): a cached prefix keeps its
physical pages (refcounted in :class:`PageAllocator`), and a fork
shares every fully covered prefix page and copies only the partial tail
page (copy on write). Rows only append at their own length, so a fully
covered page never changes and sharing it is exact.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving import slots as slot_ops


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    """Knobs for the prefix cache (engine: ``prefix_cache=``; CLI:
    ``--prefix-cache`` and the budget flags).

    ``block_tokens`` is the capture and match granularity: a snapshot is
    taken when a prefill cursor lands on a multiple of it. It must
    divide the engine's ``chunk_tokens`` (the engine refuses otherwise),
    so that capture points fall on chunk boundaries and a forked
    remainder resumes on the cold start's chunk grid: that is what makes
    forked streams bitwise equal to cold-start ones. ``capture_final``
    also snapshots completed prompts at unaligned lengths (multi-turn
    reuse). ``page_size`` and ``cache_pages`` apply to the exact kind's
    paged KV only: tokens a page, and how many pool pages beyond the
    slots' own keep cached prefixes alive (0: two slots' worth).
    """
    block_tokens: int = 16
    device_bytes: int = 64 << 20
    host_bytes: int = 256 << 20
    capture_final: bool = True
    page_size: int = 16
    cache_pages: int = 0          # 0 -> engine default (2 slots' worth)

    def __post_init__(self):
        if self.block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")


class NoFreePages(RuntimeError):
    """Page pool exhausted (after cache reclaim): the engine defers the
    admission instead of handing out a page that is still in use."""


class PageAllocator:
    """Host-side refcounted allocator over the shared device page pool.

    Page 0 is the garbage page (padded writes land there) and is never
    handed out. The free list is LIFO. ``retain`` and ``release`` move
    refcounts; a page returns to the free list when its count drops to
    zero, so cache entries and forked rows can share prefix pages and
    the pool takes a page back only when its last owner lets go.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("page pool needs >= 2 pages (page 0 is "
                             "the reserved garbage page)")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))
        self._ref = np.zeros(n_pages, np.int32)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise NoFreePages(
                f"need {n} pages, {len(self._free)} free "
                f"(pool has {self.n_pages})")
        ids = [self._free.pop() for _ in range(n)]
        self._ref[ids] = 1
        return ids

    def retain(self, ids: Sequence[int]) -> None:
        for i in ids:
            assert self._ref[i] > 0, f"retain of unowned page {i}"
            self._ref[i] += 1

    def release(self, ids: Sequence[int]) -> None:
        for i in ids:
            assert i != 0 and self._ref[i] > 0, f"bad release of page {i}"
            self._ref[i] -= 1
            if self._ref[i] == 0:
                self._free.append(i)


def prefix_key(tokens: Sequence[int]) -> str:
    """Stable content hash of a token prefix (int32 little-endian)."""
    return hashlib.blake2b(np.asarray(tokens, "<i4").tobytes(),
                           digest_size=16).hexdigest()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _tree_bytes(tree) -> int:
    return sum(leaf.nbytes for leaf in _leaves(tree))


def _identity(tree):
    return tree


class _Entry:
    __slots__ = ("key", "tokens", "state", "on_host", "state_bytes",
                 "page_bytes", "pages", "tick")

    def __init__(self, key, tokens, state, state_bytes, page_bytes,
                 pages, tick):
        self.key = key
        self.tokens = tokens            # tuple[int], len == prefix_len
        self.state = state              # 1-row serve state (a copy)
        self.on_host = False
        self.state_bytes = state_bytes
        self.page_bytes = page_bytes    # resident KV page bytes (paged)
        self.pages = pages              # retained physical ids, or None
        self.tick = tick


class PrefixCache:
    """Two-tier LRU store of prefix-state snapshots (module docstring).

    ``to_host`` and ``to_device`` are the tier movers the engine
    supplies; ``release_pages`` is called with an evicted entry's
    retained page ids (paged exact only), so that the
    :class:`PageAllocator` can take them back.
    """

    def __init__(self, cfg: PrefixCacheConfig, *,
                 to_host: Callable = _identity,
                 to_device: Callable = _identity,
                 release_pages: Optional[Callable] = None):
        self.cfg = cfg
        self._to_host = to_host
        self._to_device = to_device
        self._release_pages = release_pages
        self._entries: dict[str, _Entry] = {}
        self._lengths: dict[int, int] = {}   # prefix_len -> entry count
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.captures = 0
        self.demotions = 0
        self.evictions = 0
        self.promotions = 0

    # -- introspection ----------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def has(self, tokens: Sequence[int]) -> bool:
        return prefix_key(tokens) in self._entries

    @property
    def device_bytes_used(self) -> int:
        return sum(e.state_bytes + e.page_bytes
                   for e in self._entries.values() if not e.on_host)

    @property
    def host_bytes_used(self) -> int:
        return sum(e.state_bytes for e in self._entries.values()
                   if e.on_host)

    @property
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"prefix_entries": len(self._entries),
                "prefix_hits": self.hits,
                "prefix_misses": self.misses,
                "prefix_hit_rate": self.hits / total if total else 0.0,
                "prefix_captures": self.captures,
                "prefix_demotions": self.demotions,
                "prefix_promotions": self.promotions,
                "prefix_evictions": self.evictions,
                "prefix_device_bytes": self.device_bytes_used,
                "prefix_host_bytes": self.host_bytes_used}

    # -- lookup -----------------------------------------------------------

    def match(self, prompt: Sequence[int]) -> Optional[_Entry]:
        """Longest cached prefix of ``prompt`` that leaves >= 1 prompt
        token to prefill. Checks the tokens (not just the hash), bumps
        the entry's LRU tick, and counts a hit or a miss.

        The candidate lengths are the prefix lengths present in the
        store, and all their keys come out of ONE rolling blake2b pass
        over the prompt (a digest copied at each length)."""
        limit = len(prompt) - 1
        cands = sorted(n for n in self._lengths if n <= limit)
        if not cands:
            self.misses += 1
            return None
        buf = np.asarray(prompt[:cands[-1]], "<i4").tobytes()
        roll = hashlib.blake2b(digest_size=16)
        keys: dict[int, str] = {}
        prev = 0
        for n in cands:
            roll.update(buf[4 * prev:4 * n])
            prev = n
            keys[n] = roll.copy().hexdigest()
        for n in reversed(cands):
            ent = self._entries.get(keys[n])
            if ent is not None and ent.tokens == tuple(prompt[:n]):
                self._tick += 1
                ent.tick = self._tick
                self.hits += 1
                return ent
        self.misses += 1
        return None

    def device_state(self, ent: _Entry):
        """The entry's snapshot on the device, promoting a host-tier
        entry (and rebalancing the device budget) if needed."""
        state = ent.state
        if ent.on_host:
            state = self._to_device(state)
            ent.state = state
            ent.on_host = False
            self.promotions += 1
            self._rebalance()
        return state

    # -- insert / evict ---------------------------------------------------

    def put(self, tokens: Sequence[int], state, *,
            pages: Optional[list[int]] = None,
            page_bytes: int = 0) -> None:
        """Capture a snapshot for ``tokens``. ``state`` is a one-row
        serve state gathered (copied) out of the staging pool; ``pages``
        (exact paged only) are the physical page ids covering the
        prefix, already retained by the caller."""
        key = prefix_key(tokens)
        if key in self._entries:            # a duplicate capture
            if pages is not None and self._release_pages is not None:
                self._release_pages(pages)
            return
        self._tick += 1
        ent = _Entry(key, tuple(int(t) for t in tokens), state,
                     _tree_bytes(state), page_bytes, pages, self._tick)
        self._entries[key] = ent
        n = len(ent.tokens)
        self._lengths[n] = self._lengths.get(n, 0) + 1
        self.captures += 1
        self._rebalance()

    def _drop(self, ent: _Entry) -> None:
        del self._entries[ent.key]
        n = len(ent.tokens)
        self._lengths[n] -= 1
        if not self._lengths[n]:
            del self._lengths[n]
        if ent.pages is not None and self._release_pages is not None:
            self._release_pages(ent.pages)
        self.evictions += 1

    def _rebalance(self) -> None:
        """Demote LRU device entries past ``device_bytes``, then evict
        LRU host entries past ``host_bytes``. A paged entry's KV pages
        stay on the device either way, so it counts against the device
        budget until it is evicted, never demoted."""
        dev = [e for e in self._entries.values() if not e.on_host]
        dev.sort(key=lambda e: e.tick)
        used = sum(e.state_bytes + e.page_bytes for e in dev)
        for e in dev:
            if used <= self.cfg.device_bytes:
                break
            used -= e.state_bytes + e.page_bytes
            if e.page_bytes:
                # demoting cannot free resident pages: evict instead
                self._drop(e)
                continue
            e.state = self._to_host(e.state)
            e.on_host = True
            self.demotions += 1
        host = [e for e in self._entries.values() if e.on_host]
        host.sort(key=lambda e: e.tick)
        used = sum(e.state_bytes for e in host)
        for e in host:
            if used <= self.cfg.host_bytes:
                break
            used -= e.state_bytes
            self._drop(e)

    def reclaim_pages(self, allocator: PageAllocator, need: int, *,
                      exclude: Optional[_Entry] = None) -> bool:
        """Evict LRU paged entries until ``allocator`` has ``need`` free
        pages (or no evictable paged entry remains). ``exclude`` pins one
        entry, the prefix the caller is about to fork from, outside the
        scan, so a reclaim never drops the very pages the admission
        shares and hands them back out as writable growth pages. Returns
        success; False tells the engine to defer the admission."""
        while allocator.n_free < need:
            paged = [e for e in self._entries.values()
                     if e.pages is not None and e is not exclude]
            if not paged:
                return False
            self._drop(min(paged, key=lambda e: e.tick))
        return True

    def clear(self) -> None:
        for ent in list(self._entries.values()):
            self._drop(ent)


class HostSnapshot:
    """A demoted snapshot: the serve-state tree in pinned host memory,
    and the event recorded after its copies were enqueued. The copies
    run in stream order, so a promotion enqueued behind them reads whole
    data without waiting; only a reader on the host calls :meth:`wait`.
    The pinned blocks stay allocated while a copy into or out of them
    may be in flight: the caching host allocator holds a freed block
    until the copies recorded on it have run."""

    __slots__ = ("tree", "event")

    def __init__(self, tree, event):
        self.tree = tree
        self.event = event

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def snapshot_to_host(tree) -> HostSnapshot:
    """Demote a device snapshot: each CUDA leaf copied into a pinned
    host tensor with ``non_blocking=True`` on the current stream, then an
    event recorded. Nothing waits. A CPU snapshot (an engine on the CPU)
    is already in host memory and stays as it is. A snapshot promoted
    onto a mesh (DTensor leaves) is gathered over the DP axes first: it
    keeps this rank's KV groups (``parallel.sharding.dp_local``)."""
    from repro_torch.parallel.sharding import dp_local
    tree = dp_local(tree)
    event = None
    dev = tree["pos"].device
    if dev.type == "cuda":
        def _copy(t, axis):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t, non_blocking=True)
        tree = slot_ops.tree_slot_map(_copy, tree)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    return HostSnapshot(tree, event)


def snapshot_to_device(snap: HostSnapshot, device: torch.device,
                       shardings=None):
    """Promote a demoted snapshot back to ``device``: pinned to CUDA
    copies with ``non_blocking=True`` on the current stream, enqueued
    behind the demotion's copies. Nothing waits. With ``shardings`` (the
    mesh engine's: ``serve_state_specs`` of a one-row pool, as
    ``NamedSharding``) the snapshot, this rank's KV groups, comes back
    as DTensors with the pools' placements: the b = 1 slot dim
    replicates where the DP axes have more than one rank. Each rank
    keeps its own value; nothing is communicated."""
    tree = slot_ops.tree_slot_map(
        lambda t, axis: t.to(device, non_blocking=True), snap.tree)
    if shardings is None:
        return tree
    from repro_torch.parallel.sharding import place_dp_local
    return place_dp_local(tree, shardings)

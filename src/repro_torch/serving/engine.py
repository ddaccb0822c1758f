"""Continuous-batching serving engine over the O(1)-state PRF decode and
the exact-attention KV cache.

The counterpart of ``repro.serving.engine``, with both of its
schedulers. They share the pieces:

  * **admission** reserves a free slot FIFO for every arrived request
    and seeds its row of a same-shape **staging pool** from a fresh
    one-row template;
  * the **token-budget packer** splits at most ``chunk_tokens`` prompt
    tokens across the staged admissions (equal pow-2 grants under
    ``bucket_prefill``), advanced together in ONE padded (P, L)
    ``lm.prefill_chunk`` call with per-row ``valid_len``; admissions
    whose prompt is done are committed to the slot pool
    (``slots.merge_slots``) and sample their first token;
  * ONE batched ``lm.decode_step`` over the active slots samples a
    token for each of them.

With ``cfg.use_kernel`` and a PRF kind both calls run the hand-written
kernels (``prf_fused_prefill``, ``prf_fused_decode``, one launch per
layer per call) against projections precomposed once here. The exact
kind keeps a per-slot KV cache of ``max_len`` positions a layer and runs
no kernel, in the reference as here; ``submit`` refuses a prompt that
does not fit it and admission clips the decode budget to it. A stack
with no attention layer (rwkv6-7b) serves on the path ``none``: its
RWKV blocks run plain PyTorch, as the reference's run plain ``jnp``, and
launch no kernel whatever ``use_kernel`` says. Every path
updates the state in place, so a decode with free slots advances only
the active rows (``slots.freeze_inactive``): free rows stay bit-frozen.
Each decode runs ``max_slots`` rows all the same (the active rows
padded with repeats), so a row's logits do not depend on how many slots
are busy.

Every small host array of a step (indices, ``valid_len``, tokens,
sampling parameters, uniforms) reaches the device through ``to_device``:
on CUDA a pinned copy with ``non_blocking=True``, so no transfer stalls
the host; chunk tokens go through ``slots.PackBuffer``.

**Sequential** (``overlap=False``): one packed prefill chunk, then one
batched decode, each step ending in a blocking read of the sampled
tokens.

**Overlapped** (``overlap=True``, the serve CLI's default) runs the same
step functions in the reference's order:

  1. *retire*: wait on the event recorded after last step's sampled
     tokens were copied into pinned host memory, append them, call
     ``Request.on_token``, evict finished rows. The step's only wait;
     its time is ``decode_stall_ms``;
  2. *admit*, as above;
  3. *merge*: admissions whose final chunk was dispatched last step are
     committed into the slot pool, their first tokens sampled from the
     saved logits and scattered into the device-resident token feed;
  4. *decode*: the batched decode reads last step's tokens from the
     feed (no token passes through the host on its way to the next
     decode); its samples go back into the feed and, by a non-blocking
     copy, to the host for the next retire;
  5. *prefill*: the chunk packed last step is dispatched behind the
     decode (rows cancelled since packing are dropped); admissions that
     finish their prompt queue a merge for the next step;
  6. *pack*: the next chunk is packed on the host while the device
     works.

It pays a step on admission and a step on merge for a host that never
waits on packing or readback. ``flush()`` drains the in-flight tokens;
``cancel`` drops a request's in-flight tokens without a callback. On the
CPU every operation is synchronous, so there overlap is only the order.

Sampling: greedy rows take the argmax. Sampled rows (temperature > 0,
optional top-k / top-p) draw by inverse CDF with one uniform derived
from (seed, uid, token index) alone, so a row's draws do not depend on
the step count, the batch around it, the chunk boundaries or the
scheduler. The draws differ from the reference package's threefry draws.

``prefix_cache=`` (True, or a ``PrefixCacheConfig``) adds admission-time
prefix reuse (``repro_torch.serving.prefix_cache``). Chunked prefill
captures a snapshot of a staging row (a one-row gather) whenever its
cursor lands on a ``block_tokens`` multiple, and when its prompt is
done; a later request whose prompt opens with a cached prefix is
admitted by FORKING the snapshot: one broadcast scatter seeds its
staging row (``slots.fork_slots``) and its cursor starts at the cached
length, so only the rest of the prompt is prefilled, through the same
``prefill_chunk`` calls (B2 under the kernels) from the seeded state.
For the PRF kinds the fork costs the fixed-size (S, z, c) whatever the
prefix's length, and for the RG-LRU the fixed-size (h, conv). The exact
kind of a layer-stacked config (as in the reference, not the unit/rem
layout, which forks its contiguous caches) switches both pools to
block-granular PAGED KV (path ``exact_paged``): rows hold page tables over shared page
pools (``lm.init_kv_pages``), a fork shares the prefix's full pages
(refcounted, ``PageAllocator``) and copies only its partial tail page,
and an admission that finds no free page waits in the queue. The pages
of a freed row go back to the allocator only at the head of the next
step, after its table is reset to the garbage page 0 behind whatever
was already enqueued for it. Every copy, table write, seed and snapshot
gather is enqueued on the one stream the kernels launch on, and no page
id is read back on the host: stream order is what makes reusing a page
on the host safe. Both schedulers share the admission path, so forking
composes with overlap, cancel and flush; ``stats`` gains the
``prefix_*`` counters, ``forked_requests`` and ``forked_tokens``.

``mesh=`` (a ``DeviceMesh``; every rank builds the engine with the same
params, whole or already placed, and submits the same requests) places
the params by ``parallel.param_specs`` (the config's MoE and sharding
overrides), as the reference's serve launcher does; whole params are
sliced where they lie, so a model larger than one device is given on
the host or already placed (``launch.serve`` draws on the host or
restores onto the placements), and the caller drops its whole tree.
It places BOTH pools as
DTensors per ``parallel.serve_state_specs``: slots over the DP axes,
the KV cache's head groups over 'model' (the paged layout's page pools,
which carry no slot axis, and the linear state's (S, z, c), which the
rule names but never matches, replicated), as the reference's
``device_put`` does. Each rank then holds and
computes only its share over 'model' (``parallel.tensor_parallel``):
attention its KV groups (B1 and B2 launch once a layer a step on this
rank's (slots, G/M, ...) pools, against projections precomposed for
those groups), the MLP its hidden columns, MoE its experts or their
hidden columns, the head its vocab slice (the sampled rows' logits
gathered whole); a leaf split over 'data' too is gathered over 'data'
where a layer uses it, its 'model' shard never. Blocks without a tensor
parallel form (the RG-LRU, RWKV-6, attention whose group count the
axis does not divide) gather their leaves whole and compute all of it
on every rank. Each step gathers the pools over the DP axes only (every
rank steps every slot of its own groups) and places them back with
their placements unchanged; where a pool holds every group (the paged
pools, the linear state) each rank reads and writes its own
(``lm._apply_block``). Prefix snapshots hold a
rank's groups: demoted and promoted per rank, with the pools'
placements. The collectives need every rank to make the same schedule,
so admission reads one clock: whenever a request could be admitted, the
ranks take the first mesh rank's ``now`` (a broadcast along each mesh
dim), and timed arrivals (``rate``, ``run(realtime=True)``) are
admitted at the same step on every rank. On a mesh whose 'model' axis
has one rank every leaf is whole there and the streams are bitwise
those of the engine without a mesh under the same admission clock.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import feature_maps as fm
from repro_torch.models import lm
from repro_torch.parallel.tensor_parallel import over_model
from repro_torch.serving import prefix_cache as pcache
from repro_torch.serving import slots as slot_ops
from repro_torch.serving.prefix_cache import (NoFreePages, PageAllocator,
                                              PrefixCache,
                                              PrefixCacheConfig)
from repro_torch.serving.request import Request, RequestResult


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def row_uniform(seed: int, uid: int, count: int) -> float:
    """The uniform draw of token ``count`` of request ``uid``: a pure
    function of its arguments, hence schedule-invariant."""
    return float(np.random.default_rng([seed, uid, count]).random())


def to_device(arr, device: torch.device, dtype=None) -> torch.Tensor:
    """A copy of the small host array ``arr`` on ``device``. On CUDA it
    goes through its own pinned tensor with ``non_blocking=True``, so
    the host does not wait; the caching host allocator keeps that
    pinned block until the copy has run."""
    t = torch.from_numpy(np.array(arr, dtype=dtype))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def sample_tokens(logits: torch.Tensor, uniforms: np.ndarray,
                  temps: np.ndarray, top_ks: np.ndarray,
                  top_ps: np.ndarray) -> torch.Tensor:
    """Per-row sampling of (n, V) logits, on their device: argmax where
    temperature is 0, else an inverse-CDF draw at ``uniforms`` from the
    temperature-scaled softmax restricted to the top-k logits and the
    top-p nucleus. Returns the (n,) int64 ids without waiting for them."""
    greedy = logits.argmax(dim=-1)
    if not (temps > 0).any():
        return greedy
    dev = logits.device
    v = logits.shape[-1]
    t = to_device(temps, dev)
    scaled = logits / t.clamp(min=1e-6)[:, None]
    if (top_ks > 0).any() or (top_ps < 1.0).any():
        k = to_device(np.where(top_ks > 0, top_ks, v) - 1,
                      dev).clamp(0, v - 1)
        desc = scaled.sort(dim=-1, descending=True).values
        kth = desc.gather(1, k[:, None].long())
        scaled = torch.where(scaled >= kth, scaled, -torch.inf)
        probs = torch.softmax(scaled, dim=-1)
        sp = probs.sort(dim=-1, descending=True).values
        cum = sp.cumsum(dim=-1)
        p = to_device(top_ps, dev)[:, None]
        keep = ((cum - sp) < p) | (p >= 1.0)
        cutoff = torch.where(keep, sp, torch.inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(probs >= cutoff, scaled, -torch.inf)
    cdf = torch.softmax(scaled, dim=-1).cumsum(dim=-1)
    u = to_device(uniforms, dev).to(cdf.dtype)[:, None]
    drawn = torch.searchsorted(cdf, u * cdf[:, -1:], right=True)
    drawn = drawn[:, 0].clamp(max=v - 1)
    return torch.where(t > 0, drawn, greedy)


class _Fetch:
    """Sampled ids on their way to the host: a pinned copy and the event
    recorded after it on CUDA, the tensor itself on the CPU. ``rows``
    and ``uids`` name the slots they belong to; ``seq`` is the engine's
    dispatch count at the sample that produced them."""

    __slots__ = ("rows", "uids", "host", "event", "seq")

    def __init__(self, rows: list, uids: list, toks: torch.Tensor,
                 seq: int):
        self.rows, self.uids, self.seq = rows, uids, seq
        self.event = None
        if toks.device.type == "cuda":
            self.host = torch.empty(toks.shape, dtype=toks.dtype,
                                    pin_memory=True)
            self.host.copy_(toks, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(toks.device))
        else:
            self.host = toks

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def tokens(self) -> list[int]:
        return self.host.tolist()


class _Slot:
    """Host-side record of the sequence occupying one pool row; it is
    prefilling while ``cursor < len(req.prompt)``. ``emitted`` counts
    the tokens sampled for the row (under the overlapped loop one step
    ahead of ``result.tokens``, which holds retired tokens); it is the
    token index of the row's next draw."""

    __slots__ = ("req", "result", "budget", "cursor", "emitted")

    def __init__(self, req: Request, result: RequestResult, budget: int):
        self.req = req
        self.result = result
        self.budget = budget
        self.cursor = 0
        self.emitted = 0


class ServingEngine:
    """Continuous-batching generation over a fixed slot pool.

    Typical use::

        eng = ServingEngine(params, cfg, max_slots=8, max_len=1024,
                            chunk_tokens=256, overlap=True, device="cuda")
        eng.submit(Request(prompt=[...], max_new_tokens=64))
        results = eng.run()

    ``params`` lie on ``device`` already. ``prefill_rows`` caps how many
    staged admissions share the packed prefill call (None = all).
    ``bucket_prefill`` pads packed chunk lengths to powers of two.
    ``overlap`` selects the pipelined step loop (module docstring); the
    default, False, is the sequential scheduler. ``prefix_cache`` (True
    for the defaults, or a ``PrefixCacheConfig``) turns on snapshot
    capture and fork-on-admit, with paged KV for the exact kind.
    ``mesh`` (a ``DeviceMesh`` of ``device``'s type) places the params
    and the pools (module docstring); ``params``, ``pool`` and
    ``staging`` are then DTensor trees.
    """

    def __init__(self, params, cfg: lm.ModelConfig, *, max_slots: int = 4,
                 max_len: int = 256, chunk_tokens: Optional[int] = None,
                 seed: int = 0, prefill_rows: Optional[int] = None,
                 bucket_prefill: bool = True, overlap: bool = False,
                 prefix_cache: Union[bool, PrefixCacheConfig, None] = None,
                 mesh=None, device="cuda"):
        if cfg.modality != "text":
            raise ValueError("serving engine drives text decode only")
        if chunk_tokens is not None and chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        if prefill_rows is not None and prefill_rows < 1:
            raise ValueError("prefill_rows must be >= 1 (None = no cap)")
        if cfg.attn.kind not in ("exact", *fm.PRF_KINDS):
            raise ValueError(f"no serving path for kind {cfg.attn.kind!r}")
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.chunk_tokens = chunk_tokens
        self.prefill_rows = prefill_rows
        self.bucket_prefill = bucket_prefill
        self.overlap = overlap
        self.seed = seed
        self.device = torch.device(device)
        self.mesh = mesh
        if prefix_cache is True:
            prefix_cache = PrefixCacheConfig()
        self._pc_cfg: Optional[PrefixCacheConfig] = prefix_cache or None
        # a snapshot is captured only where a cursor lands exactly on a
        # block boundary: with a block_tokens that does not divide
        # chunk_tokens the grants can step over every boundary, and the
        # fork's parity with a cold start assumes the alignment
        if (self._pc_cfg is not None and chunk_tokens is not None
                and chunk_tokens % self._pc_cfg.block_tokens):
            raise ValueError(
                f"prefix-cache block_tokens={self._pc_cfg.block_tokens}"
                f" must divide chunk_tokens={chunk_tokens}: capture "
                "points fire only when a prefill cursor lands on a "
                "block boundary")
        # homogeneous configs stack every layer's state along one leading
        # axis; heterogeneous patterns keep the unit/rem layout. With a
        # prefix cache the exact kind of a stacked config serves from
        # paged KV: rows hold page tables over shared page pools, so a
        # cached prefix's pages can be shared by its forks
        self._stacked = lm.can_stack_layers(cfg)
        self._paged = (self._pc_cfg is not None and self._stacked
                       and cfg.attn.kind == "exact"
                       and lm.has_attention(cfg))
        if self._paged:
            ps = self._pc_cfg.page_size
            self._page_size = ps
            self._max_pages = -(-max_len // ps)
            # page 0 is the garbage page; beyond every slot's worst case,
            # cache_pages keep cached prefixes resident while all slots
            # are busy
            cache_pages = self._pc_cfg.cache_pages or 2 * self._max_pages
            n_pages = 1 + max_slots * self._max_pages + cache_pages
            self._pages = lm.init_kv_pages(cfg, n_pages, ps, self.device)
            self._alloc = PageAllocator(n_pages)
            self._page_bytes_each = (2 * cfg.n_layers * ps * cfg.n_kv
                                     * cfg.head_dim * 4)

            def pool(b):
                return lm.init_paged_serve_state(cfg, b, max_len, ps,
                                                 device=self.device)
        else:
            self._pages = self._alloc = None

            def pool(b):
                return lm.init_serve_state(cfg, b=b, max_len=max_len,
                                           per_slot=True,
                                           stacked=self._stacked,
                                           device=self.device)
        # the physical page ids each slot owns (refcounts in _alloc);
        # freed slots wait in _pending_clear until _flush_freed resets
        # their tables and releases their pages
        self._slot_pages: list[Optional[list[int]]] = [None] * max_slots
        self._pending_clear: list[int] = []
        self.pool = pool(max_slots)
        # row i holds the partial prefill state of the admission
        # reserved on slot i
        self.staging = pool(max_slots)
        self._fresh_row = pool(1)
        # on a mesh: this rank's shards of the params, which the model
        # gathers over 'data' where it uses them
        step_params = params
        self.params = params
        if mesh is not None:
            from torch.distributed.tensor import DTensor

            from repro_torch.parallel import sharding
            from repro_torch.tree import flatten
            if not isinstance(flatten(params)[0][1], DTensor):
                self.params = sharding.place_tree(
                    params, sharding.make_shardings(sharding.param_specs(
                        params, mesh, moe=cfg.moe is not None,
                        overrides=cfg.sharding_overrides), mesh))
            step_params = sharding.local_shards(self.params)
        # the layer-stacked params and the precomposed projections
        # A = (W M)^T (this rank's groups on a mesh), built once here for
        # both kernels
        self._step_params = dict(step_params)
        if self._stacked:
            self._step_params["layers"] = lm.stack_layer_params(step_params,
                                                                cfg)
        with over_model(mesh):
            self._proj = lm.build_decode_proj(self._step_params, cfg,
                                              stacked=self._stacked)
        # what the dispatch runs: no attention at all (rwkv6-7b's stack,
        # no kernel), softmax over the KV cache (no kernel), or the PRF
        # kernels, which only take CUDA tensors (on the CPU the same
        # wrappers run their plain versions), or plain torch
        path = ("none" if not lm.has_attention(cfg) else
                "exact_paged" if self._paged else
                "exact" if cfg.attn.kind == "exact" else
                "torch" if self._proj is None else
                "fused_kernel" if self.device.type == "cuda" else
                "fused_plain")
        self._serve_paths = {"prefill_path": path, "decode_path": path}
        self._pool_shardings = self._page_shardings = None
        self._row_shardings = None
        if mesh is not None:
            from repro_torch.parallel import sharding
            self._pool_shardings = sharding.make_shardings(
                sharding.serve_state_specs(self.pool, mesh), mesh)
            self.pool = sharding.place_tree(self.pool, self._pool_shardings)
            self.staging = sharding.place_tree(self.staging,
                                               self._pool_shardings)
            # a fresh row of this rank's groups; snapshots are such rows
            self._row_shardings = sharding.make_shardings(
                sharding.serve_state_specs(self._fresh_row, mesh), mesh)
            self._fresh_row = sharding.model_local(self._fresh_row,
                                                   self._row_shardings)
            if self._paged:
                # page gathers and scatters are id-indexed: replicated
                self._page_shardings = {
                    k: sharding.NamedSharding(mesh, sharding.P())
                    for k in self._pages}
                self._pages = sharding.place_tree(self._pages,
                                                  self._page_shardings)
        # prefix -> snapshot store: demotion to pinned host memory and
        # promotion back (onto the pools' placements under a mesh) never
        # wait; an evicted paged entry hands its pages back to the
        # allocator
        self.prefix_cache: Optional[PrefixCache] = None
        if self._pc_cfg is not None:
            self.prefix_cache = PrefixCache(
                self._pc_cfg, to_host=pcache.snapshot_to_host,
                to_device=functools.partial(
                    pcache.snapshot_to_device, device=self.device,
                    shardings=self._row_shardings),
                release_pages=self._alloc.release if self._paged else None)

        self._slots: list[Optional[_Slot]] = [None] * max_slots
        self._active = np.zeros(max_slots, bool)
        self._temps = np.zeros(max_slots, np.float32)
        self._top_ks = np.zeros(max_slots, np.int64)
        self._top_ps = np.ones(max_slots, np.float32)
        self._toks = np.zeros(max_slots, np.int64)
        self._uids = np.zeros(max_slots, np.int64)
        self._prefill_order: list[int] = []    # slot idx, admission FIFO
        self._queue: list[Request] = []        # sorted by arrival_time
        self._t0: Optional[float] = None
        self._ttfts: list[float] = []
        self._pack = slot_ops.PackBuffer(max_slots, _next_pow2(max_len),
                                         self.device)
        # -- overlap pipeline state (unused when overlap=False) ----------
        # device-resident token feed: decode reads last step's samples
        # from here, never through the host
        self._feed = torch.zeros(max_slots, dtype=torch.int64,
                                 device=self.device)
        self._next_chunk: Optional[dict] = None     # packed, undispatched
        self._pending_merge: Optional[dict] = None  # dispatched, unmerged
        self._inflight: Optional[dict] = None       # sampled, unretired
        self._dispatch_seq = 0          # device dispatches issued so far
        self._stall_ms: list[float] = []        # per-readback blocked time
        self._depths: list[int] = []            # per-readback queue depth
        self._stats = {"decode_steps": 0, "decode_slot_steps": 0,
                       "prefill_tokens": 0, "prefill_chunks": 0,
                       "prefill_calls": 0, "prefill_padded_tokens": 0,
                       "prefill_rows_max": 0,
                       "max_prefill_tokens_per_step": 0,
                       "emitted_tokens": 0, "admitted": 0, "finished": 0,
                       "forked_requests": 0, "forked_tokens": 0}

    # -- clock ------------------------------------------------------------

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = time.monotonic()
        return time.monotonic() - self._t0

    def _mesh_now(self, now: float) -> float:
        """The first mesh rank's ``now``, on every rank of the mesh: one
        broadcast along each mesh dim, from the dim's first rank."""
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        for d in range(self.mesh.ndim):
            group = self.mesh.get_group(d)
            dist.broadcast(t, src=dist.get_global_rank(group, 0),
                           group=group)
        return float(t.item())

    def _idx(self, rows) -> torch.Tensor:
        return to_device(rows, self.device, np.int64)

    # -- client API -------------------------------------------------------

    def submit(self, req: Union[Request, Sequence[int]], **kw) -> int:
        """Queue a request (or a bare token prompt). Returns its uid.
        Rejects empty prompts, prompts that leave no room for one
        generated token in ``max_len``, out-of-vocab ids and degenerate
        sampling parameters."""
        if not isinstance(req, Request):
            req = Request(prompt=list(req), **kw)
        if len(req.prompt) == 0:
            raise ValueError("empty prompt: a request must carry at least "
                             "one prompt token")
        if len(req.prompt) + 1 > self.max_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} does not fit max_len "
                f"{self.max_len}: a slot's context must hold the prompt "
                f"plus at least one generated token "
                f"(prompt <= max_len - 1 = {self.max_len - 1})")
        lo, hi = min(req.prompt), max(req.prompt)
        if lo < 0 or hi >= self.cfg.vocab:
            raise ValueError(
                f"prompt token ids must lie in the vocab range "
                f"[0, {self.cfg.vocab}) (got min={lo}, max={hi})")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (admission "
                             "always samples the first token)")
        if req.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if req.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")
        if req.top_p <= 0:
            raise ValueError("top_p must be > 0 (>= 1.0 disables)")
        bisect.insort(self._queue, req, key=lambda r: r.arrival_time)
        return req.uid

    def cancel(self, uid: int) -> Optional[RequestResult]:
        """Evict a queued, mid-prefill or mid-decode request. Returns its
        partial result (None if the uid is unknown).

        Under the overlapped loop the request's in-flight work is
        dropped: tokens sampled but not yet retired get no ``on_token``
        call, a packed chunk row is skipped at dispatch and a dispatched
        final chunk is never merged, so the result holds exactly the
        tokens the host had observed, as under the sequential loop."""
        for i, req in enumerate(self._queue):
            if req.uid == uid:
                self._queue.pop(i)
                return RequestResult(uid=uid, prompt=list(req.prompt),
                                     arrival_time=req.arrival_time,
                                     cancelled=True)
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.req.uid == uid:
                res = slot.result
                res.cancelled = True
                res.finish_time = self._now()
                self._free(i)
                return res
        return None

    @property
    def num_active(self) -> int:
        return int(self._active.sum())

    @property
    def num_prefilling(self) -> int:
        return len(self._prefill_order)

    @property
    def has_work(self) -> bool:
        return (bool(self._queue)
                or any(s is not None for s in self._slots)
                or self._inflight is not None)

    @property
    def _pipeline_idle(self) -> bool:
        """No in-flight or staged work anywhere in the pipeline: safe to
        jump the clock to the next arrival."""
        return (self.num_active == 0 and not self._prefill_order
                and self._next_chunk is None
                and self._pending_merge is None
                and self._inflight is None)

    # -- scheduler --------------------------------------------------------

    def _free(self, i: int) -> None:
        self._slots[i] = None
        self._active[i] = False
        self._temps[i] = 0.0
        self._top_ks[i] = 0
        self._top_ps[i] = 1.0
        self._uids[i] = 0
        if i in self._prefill_order:
            self._prefill_order.remove(i)
        if self._slot_pages[i] is not None:
            # the pages go back at the head of the next step, after the
            # row's table is reset (_flush_freed)
            self._pending_clear.append(i)

    def _flush_freed(self) -> None:
        """Reset the pool and staging page tables of the slots freed
        since the last step to the garbage page, then release their
        pages. Runs at the head of a step, before admission can hand the
        pages out again: the resets are enqueued behind every write
        already enqueued for those rows (one stream), so a reused page
        is never written by a freed row's in-flight decode or chunk."""
        if not self._pending_clear:
            return
        rows = sorted(set(self._pending_clear))
        idx = self._idx(rows)
        slot_ops.fork_slots(self.pool, self._fresh_row, idx)
        slot_ops.fork_slots(self.staging, self._fresh_row, idx)
        self._dispatch_seq += 2
        for i in rows:
            self._alloc.release(self._slot_pages[i])
            self._slot_pages[i] = None
        self._pending_clear.clear()

    def _activate(self, i: int) -> None:
        req = self._slots[i].req
        self._active[i] = True
        self._temps[i] = req.temperature
        self._top_ks[i] = req.top_k
        self._top_ps[i] = req.top_p
        self._uids[i] = req.uid

    def _sample(self, logits: torch.Tensor, rows: list[int],
                counts: list[int]) -> torch.Tensor:
        """Dispatch the draws of activated slots ``rows`` (token indices
        ``counts``) from their (n, V) logits; returns device ids."""
        uniforms = np.asarray([row_uniform(self.seed, int(self._uids[i]), n)
                               for i, n in zip(rows, counts)])
        self._dispatch_seq += 1
        return sample_tokens(logits, uniforms, self._temps[rows],
                             self._top_ks[rows], self._top_ps[rows])

    def _paged_admit_pages(self, req: Request, ent) -> tuple:
        """Build an admission's page table: the cached prefix's fully
        covered pages are SHARED (refcount retained), its partial tail
        page is queued for a copy on write, and fresh pages cover the
        rest of prompt and generation budget. Returns (table (max_pages,)
        int64, owned page ids, [(src, dst)] tail copies). Raises
        NoFreePages, after trying a cache reclaim and with this call's
        refcounts unwound, to defer the admission."""
        ps = self._page_size
        budget = min(req.max_new_tokens, self.max_len - len(req.prompt))
        n_total = -(-(len(req.prompt) + budget) // ps)
        n_shared = 0 if ent is None else len(ent.tokens) // ps
        shared = [] if ent is None else list(ent.pages[:n_shared])
        tail_src = (ent.pages[n_shared]
                    if ent is not None and len(ent.tokens) % ps else None)
        n_new = n_total - n_shared
        # pin the match BEFORE any reclaim or alloc: a reclaim that could
        # evict the entry being forked would drop its pages into the LIFO
        # free list, where alloc() hands them out again as this request's
        # writable growth pages. The retains double as the slot's own
        # refs on the shared pages; the extra ref on the tail source
        # keeps the copy's source alive even if a later admission of the
        # same batch evicts the entry (_admissions releases it once the
        # batched copy is enqueued).
        pinned = shared + ([] if tail_src is None else [tail_src])
        self._alloc.retain(pinned)
        try:
            if n_new > self._alloc.n_free:
                self.prefix_cache.reclaim_pages(self._alloc, n_new,
                                                exclude=ent)
            fresh = self._alloc.alloc(n_new)      # raises NoFreePages
        except NoFreePages:
            self._alloc.release(pinned)
            raise
        copies = [] if tail_src is None else [(tail_src, fresh[0])]
        own = shared + fresh
        table = np.zeros(self._max_pages, np.int64)
        table[:len(own)] = own
        return table, own, copies

    def _seed(self, row: dict, idxs: list, tables: list) -> None:
        """Seed staging rows ``idxs`` from the one-row state ``row`` in
        one broadcast scatter (paged rows also get their own tables)."""
        tabs = (to_device(np.stack(tables), self.device) if self._paged
                else None)
        slot_ops.fork_slots(self.staging, row, self._idx(idxs), tabs)
        self._dispatch_seq += 1

    def _admissions(self, now: float) -> None:
        """Reserve a free slot, with a freshly seeded staging row, for
        every arrived request, FIFO. With a prefix cache, admission first
        matches the longest cached prefix and seeds the staging row from
        its snapshot instead (fork-on-admit): the cursor starts at the
        cached length, so only the rest of the prompt is prefilled.
        Admissions of one entry share one broadcast seed; paged
        admissions build their page tables here (one batched copy for
        every forked tail page) and stay queued while the page pool is
        exhausted even after evicting cached prefixes."""
        pc = self.prefix_cache
        if (self.mesh is not None and self._queue
                and any(s is None for s in self._slots)):
            now = self._mesh_now(now)
        fresh_adm: list[int] = []
        fresh_tables: list = []
        forks: dict[str, list] = {}    # entry key -> [ent, idxs, tables]
        copies: list[tuple[int, int]] = []
        while self._queue and self._queue[0].arrival_time <= now:
            free = [i for i in range(self.max_slots)
                    if self._slots[i] is None]
            if not free:
                break
            req = self._queue[0]
            ent = pc.match(req.prompt) if pc is not None else None
            table = own = None
            if self._paged:
                try:
                    table, own, cps = self._paged_admit_pages(req, ent)
                except NoFreePages:
                    # backpressure: the request stays queued; undo the
                    # match's count so that the retry counts once
                    if ent is not None:
                        pc.hits -= 1
                    else:
                        pc.misses -= 1
                    break
                copies.extend(cps)
            self._queue.pop(0)
            i = free[0]
            result = RequestResult(uid=req.uid,
                                   prompt=list(map(int, req.prompt)),
                                   arrival_time=req.arrival_time)
            budget = min(req.max_new_tokens, self.max_len - len(req.prompt))
            self._slots[i] = _Slot(req, result, budget)
            self._slot_pages[i] = own
            self._prefill_order.append(i)
            if ent is not None:
                self._slots[i].cursor = len(ent.tokens)
                self._stats["forked_requests"] += 1
                self._stats["forked_tokens"] += len(ent.tokens)
                grp = forks.setdefault(ent.key, [ent, [], []])
                grp[1].append(i)
                grp[2].append(table)
            else:
                fresh_adm.append(i)
                fresh_tables.append(table)
        if copies:
            # one batched copy on write of every forked tail page, over
            # the k and v pools of every layer
            src = self._idx([s for s, _ in copies])
            dst = self._idx([d for _, d in copies])
            for pages in self._pages.values():
                pages.index_copy_(1, dst, pages.index_select(1, src))
            self._dispatch_seq += 1
            # drop the tail-source pins: the copies are enqueued, and
            # stream order protects their source from any later reuse
            self._alloc.release([s for s, _ in copies])
        if fresh_adm:
            self._seed(self._fresh_row, fresh_adm, fresh_tables)
        for ent, idxs, tables in forks.values():
            row = pc.device_state(ent)
            if self.mesh is not None:
                from repro_torch.parallel.sharding import dp_local
                row = dp_local(row)
            self._seed(row, idxs, tables)

    def _plan_prefill(self) -> list[tuple[int, int]]:
        """Token-budget packer: split this step's prompt-token budget
        across the staged admissions, FIFO. Returns [(slot, tokens)].

        Blocking mode (``chunk_tokens=None``) grants every staged
        admission its whole remaining prompt. Chunked + bucketed mode
        gives every staged row the same pow-2 grant
        ``prev_pow2(chunk_tokens // rows)``; unbucketed chunked mode
        gives FIFO ceil-shares. Either way at most ``chunk_tokens``
        prompt tokens run between two decode steps.
        """
        staged = self._prefill_order
        if self.prefill_rows is not None:
            staged = staged[:self.prefill_rows]
        grants: list[tuple[int, int]] = []
        if self.chunk_tokens is None:
            for i in staged:
                slot = self._slots[i]
                grants.append((i, len(slot.req.prompt) - slot.cursor))
            return grants
        budget = self.chunk_tokens
        if self.bucket_prefill and staged and budget >= len(staged):
            g = 1 << ((budget // len(staged)).bit_length() - 1)
            for i in staged:
                slot = self._slots[i]
                grants.append((i, min(len(slot.req.prompt) - slot.cursor,
                                      g)))
            return grants
        for j, i in enumerate(staged):
            if budget <= 0:
                break
            slot = self._slots[i]
            rem = len(slot.req.prompt) - slot.cursor
            share = -(-budget // (len(staged) - j))      # ceil division
            t = min(rem, share)
            grants.append((i, t))
            budget -= t
        return grants

    def _record_prefill_stats(self, n_rows: int, spent: int,
                              l_pad: int) -> None:
        self._stats["prefill_tokens"] += spent
        self._stats["prefill_chunks"] += n_rows
        self._stats["prefill_calls"] += 1
        self._stats["prefill_padded_tokens"] += n_rows * l_pad
        self._stats["prefill_rows_max"] = max(
            self._stats["prefill_rows_max"], n_rows)
        self._stats["max_prefill_tokens_per_step"] = max(
            self._stats["max_prefill_tokens_per_step"], spent)

    def _maybe_capture(self, i: int) -> None:
        """Capture a prefix snapshot of slot i's staging row when its
        cursor just landed on a ``block_tokens`` multiple or, with
        ``capture_final``, completed the prompt (the multi-turn reuse
        point). The snapshot is a one-row gather, a copy, enqueued behind
        the chunk that advanced the row; a paged row's entry also retains
        the pages covering the prefix, so they outlive the donor slot."""
        pc = self.prefix_cache
        if pc is None:
            return
        slot = self._slots[i]
        cur = slot.cursor
        final = cur == len(slot.req.prompt)
        if not ((cur > 0 and cur % pc.cfg.block_tokens == 0)
                or (final and pc.cfg.capture_final)):
            return
        tokens = slot.req.prompt[:cur]
        if pc.has(tokens):
            return
        snap = slot_ops.read_slots(self.staging, self._idx([i]))
        self._dispatch_seq += 1
        if self._paged:
            n_cov = -(-cur // self._page_size)
            pages = list(self._slot_pages[i][:n_cov])
            self._alloc.retain(pages)
            pc.put(tokens, snap, pages=pages,
                   page_bytes=n_cov * self._page_bytes_each)
        else:
            pc.put(tokens, snap)

    def _pack_grants(self, grants: list[tuple[int, int]]) -> dict:
        """Pack the granted prompt slices into the idle half of the
        token double buffer."""
        ts = np.asarray([t for _, t in grants], np.int32)
        l_pad = int(ts.max())
        if self.bucket_prefill:
            l_pad = _next_pow2(l_pad)
        toks = self._pack.pack(
            [self._slots[i].req.prompt[self._slots[i].cursor:
                                       self._slots[i].cursor + t]
             for i, t in grants], l_pad)
        return {"grants": [(i, self._slots[i].req.uid, t)
                           for i, t in grants],
                "toks": toks, "ts": ts, "l_pad": l_pad}

    def _run_chunk(self, ch: dict) -> torch.Tensor:
        """Advance the packed chunk's staging rows in ONE padded batched
        ``prefill_chunk`` call and advance their cursors. Returns the
        (P, V) logits at each row's last valid position."""
        ts, l_pad = ch["ts"], ch["l_pad"]
        # all-full rows take the unmasked path; ragged rows carry lengths
        vl = (None if (ts == l_pad).all()
              else to_device(ts, self.device))
        idx = self._idx([i for i, _, _ in ch["grants"]])
        sub = slot_ops.read_slots(self.staging, idx)
        logits, sub = lm.prefill_chunk(
            self._step_params, self.cfg,
            {"tokens": self._pack.to_device(ch["toks"])}, sub,
            valid_len=vl, proj=self._proj, pages=self._pages)
        slot_ops.write_slots(self.staging, sub, idx)
        self._dispatch_seq += 1
        self._record_prefill_stats(len(ts), int(ts.sum()), l_pad)
        for i, _, t in ch["grants"]:
            self._slots[i].cursor += t
            self._maybe_capture(i)
        return logits

    def _decode(self, feed: torch.Tensor) -> tuple:
        """Dispatch one batched decode over the active slots, fed their
        tokens from ``feed`` ((max_slots,) ids on the device), and their
        draws. Every call runs ``max_slots`` rows, as the reference's
        lock-step decode does: with free slots the active rows are padded
        with repeats of the first, so no product sees another row count
        (cuBLAS picks an f32 GEMM's algorithm by it, and the RG-LRU's
        gates are f32 products) and a row's result does not depend on
        how many slots are busy. Returns (the rows, their index on the
        device or None when every slot is active, their sampled ids on
        the device)."""
        rows = [int(i) for i in np.nonzero(self._active)[0]]
        counts = [self._slots[i].emitted for i in rows]
        idx = gather = None
        if not self._active.all():
            gather = self._idx(rows + rows[:1] * (self.max_slots
                                                  - len(rows)))
            idx = gather[:len(rows)]
        toks = feed if gather is None else feed.index_select(0, gather)
        logits = slot_ops.freeze_inactive(
            self.pool, gather,
            lambda st: lm.decode_step(self._step_params, self.cfg, toks, st,
                                      proj=self._proj, pages=self._pages),
            n=len(rows))
        self._dispatch_seq += 1
        return rows, idx, self._sample(logits, rows, counts)

    def _record_readback(self, t0: float, seq: int) -> None:
        self._stall_ms.append((time.perf_counter() - t0) * 1e3)
        self._depths.append(self._dispatch_seq - seq)

    def _emit(self, i: int, tok: int, now: float,
              finished: list[RequestResult]) -> None:
        """Hand a decoded token of slot i to its request; evict the slot
        when the request is done."""
        slot = self._slots[i]
        if slot.req.on_token is not None:
            slot.req.on_token(tok, now)
        slot.result.tokens.append(tok)
        slot.result.token_times.append(now)
        self._toks[i] = tok
        self._stats["emitted_tokens"] += 1
        if self._done(slot):
            finished.append(self._finish(i))

    def _emit_first(self, i: int, tok: int, now: float) -> None:
        """Hand an admission's first token to its request."""
        slot = self._slots[i]
        if slot.req.on_token is not None:
            slot.req.on_token(tok, now)
        slot.result.admit_time = now
        slot.result.tokens = [tok]
        slot.result.token_times = [now]
        self._ttfts.append(now - slot.req.arrival_time)
        self._toks[i] = tok
        self._stats["emitted_tokens"] += 1
        self._stats["admitted"] += 1

    # -- sequential scheduler ---------------------------------------------

    def _prefill_work(self) -> None:
        """Advance every scheduled admission by its granted chunk, then
        commit the admissions whose prompts finished and sample their
        first tokens."""
        grants = self._plan_prefill()
        if not grants:
            return
        ch = self._pack_grants(grants)
        logits = self._run_chunk(ch)
        done = [(r, i) for r, (i, _, _) in enumerate(ch["grants"])
                if self._slots[i].cursor == len(self._slots[i].req.prompt)]
        if not done:
            return
        slot_ops.merge_slots(self.pool, self.staging,
                             self._idx([i for _, i in done]))
        self._dispatch_seq += 1
        for r, i in done:
            self._prefill_order.remove(i)
            self._finish_admission(i, logits[r:r + 1])

    def _finish_admission(self, i: int, logits: torch.Tensor) -> None:
        """Activate pool row i (already committed from staging) and
        sample its first token, waiting for it."""
        self._activate(i)
        first = int(self._sample(logits, [i], [0]).cpu()[0])
        self._emit_first(i, first, self._now())
        self._slots[i].emitted = 1

    def step(self) -> list[RequestResult]:
        """Admit what has arrived, advance prefill and decode, evict
        finished sequences. Returns the newly finished results (possibly
        empty). The sequential loop runs one packed prefill chunk, then
        one batched decode whose tokens it waits for; the overlapped loop
        runs one turn of its pipeline (module docstring)."""
        with self._rank_pools():
            if self.overlap:
                return self._step_overlap()
            return self._step_sequential()

    @contextlib.contextmanager
    def _rank_pools(self):
        """Under a mesh: the pools (and the paged KV's page pools) as
        local tensors within, gathered over the DP axes only (every slot,
        this rank's groups), placed back with their placements after,
        and the mesh's model axis set for the model
        (``parallel.tensor_parallel.over_model``). Without one,
        nothing."""
        if self.mesh is None:
            yield
            return
        from repro_torch.parallel.sharding import dp_local, place_dp_local
        self.pool = dp_local(self.pool)
        self.staging = dp_local(self.staging)
        if self._paged:
            self._pages = dp_local(self._pages)
        try:
            with over_model(self.mesh):
                yield
        finally:
            self.pool = place_dp_local(self.pool, self._pool_shardings)
            self.staging = place_dp_local(self.staging, self._pool_shardings)
            if self._paged:
                self._pages = place_dp_local(self._pages,
                                             self._page_shardings)

    def _step_sequential(self) -> list[RequestResult]:
        finished: list[RequestResult] = []
        self._flush_freed()
        self._admissions(self._now())
        self._prefill_work()
        # admission may already exhaust a request (budget/eos on token 1)
        for i, slot in enumerate(self._slots):
            if slot is not None and self._active[i] and self._done(slot):
                finished.append(self._finish(i))
        if not self._active.any():
            return finished

        rows, _, sampled = self._decode(to_device(self._toks, self.device))
        seq = self._dispatch_seq
        t0 = time.perf_counter()
        sampled = sampled.cpu().tolist()          # waits for readiness
        self._record_readback(t0, seq)
        now = self._now()
        self._stats["decode_steps"] += 1
        self._stats["decode_slot_steps"] += len(rows)
        for i, tok in zip(rows, sampled):
            self._slots[i].emitted += 1
            self._emit(i, tok, now, finished)
        return finished

    # -- overlapped scheduler ---------------------------------------------

    def _live(self, i: int, uid: int) -> bool:
        """Slot i still holds request ``uid`` (not cancelled meanwhile)."""
        return self._slots[i] is not None and self._slots[i].req.uid == uid

    def _retire(self, finished: list[RequestResult]) -> None:
        """Wait for last step's sampled tokens, append them, evict
        finished rows: the overlapped loop's only wait, timed as the
        step's decode stall."""
        rec = self._inflight
        if rec is None:
            return
        self._inflight = None
        first, dec = rec["first"], rec["decode"]
        t0 = time.perf_counter()
        (dec or first).wait()         # the later copy, on one stream
        self._record_readback(t0, rec["seq"])
        now = self._now()
        done_now: set[int] = set()
        if first is not None:
            for i, uid, tok in zip(first.rows, first.uids, first.tokens()):
                if not self._live(i, uid):
                    continue               # cancelled while in flight
                self._emit_first(i, tok, now)
                if self._done(self._slots[i]):
                    # finished on its first token: the decode that ran
                    # beside it was speculative, its token is dropped
                    done_now.add(i)
                    finished.append(self._finish(i))
        if dec is not None:
            self._stats["decode_steps"] += 1
            self._stats["decode_slot_steps"] += len(dec.rows)
            for i, uid, tok in zip(dec.rows, dec.uids, dec.tokens()):
                if i not in done_now and self._live(i, uid):
                    self._emit(i, tok, now, finished)

    def _merge_pending(self) -> Optional[_Fetch]:
        """Commit the admissions whose final chunk was dispatched last
        step into the slot pool, sample their first tokens from the
        saved logits and scatter them into the device token feed, all
        ahead of this step's decode."""
        pm = self._pending_merge
        if pm is None:
            return None
        self._pending_merge = None
        keep = [(i, uid, r) for i, uid, r in pm["rows"]
                if self._live(i, uid)]
        if not keep:
            return None
        rows = [i for i, _, _ in keep]
        idx = self._idx(rows)
        slot_ops.merge_slots(self.pool, self.staging, idx)
        self._dispatch_seq += 1
        for i in rows:
            self._activate(i)
            self._slots[i].emitted = 1
        logits = pm["logits"].index_select(
            0, self._idx([r for _, _, r in keep]))
        toks = self._sample(logits, rows, [0] * len(rows))
        fetch = _Fetch(rows, [uid for _, uid, _ in keep], toks,
                       self._dispatch_seq)
        self._feed.index_copy_(0, idx, toks)
        self._dispatch_seq += 1
        return fetch

    def _dispatch_decode(self) -> Optional[_Fetch]:
        """Enqueue one batched decode and its draws over the active rows,
        reading the token feed on the device; the draws go back into the
        feed and on their way to the host for next step's retire."""
        if not self._active.any():
            return None
        rows, idx, toks = self._decode(self._feed)
        fetch = _Fetch(rows, [int(self._uids[i]) for i in rows], toks,
                       self._dispatch_seq)
        if idx is None:
            self._feed.copy_(toks)
        else:
            self._feed.index_copy_(0, idx, toks)
        for i in rows:
            self._slots[i].emitted += 1
        return fetch

    def _dispatch_prefill(self) -> None:
        """Enqueue the chunk packed last step (behind this step's
        decode). Rows cancelled since packing are dropped; rows whose
        prompt completes queue the merge for next step."""
        ch = self._next_chunk
        if ch is None:
            return
        self._next_chunk = None
        live = [j for j, (i, uid, _) in enumerate(ch["grants"])
                if self._live(i, uid)]
        if not live:
            return
        if len(live) != len(ch["grants"]):
            # compact the live rows inside the pinned buffer, which no
            # copy has read yet
            toks = ch["toks"]
            toks[:len(live)] = toks[live]
            ch = {"grants": [ch["grants"][j] for j in live],
                  "toks": toks[:len(live)], "ts": ch["ts"][live],
                  "l_pad": ch["l_pad"]}
        logits = self._run_chunk(ch)
        done: list[tuple[int, int, int]] = []
        for r, (i, uid, _) in enumerate(ch["grants"]):
            if self._slots[i].cursor == len(self._slots[i].req.prompt):
                self._prefill_order.remove(i)
                done.append((i, uid, r))
        if done:
            self._pending_merge = {"rows": done, "logits": logits}

    def _pack_next_chunk(self) -> None:
        """Plan and pack the next prefill chunk into the idle half of
        the double buffer while this step's chunk is in flight."""
        grants = self._plan_prefill()
        if grants:
            self._next_chunk = self._pack_grants(grants)

    def _step_overlap(self) -> list[RequestResult]:
        """One turn of the pipelined loop: retire, admit, merge, decode,
        prefill, pack (module docstring)."""
        finished: list[RequestResult] = []
        self._retire(finished)
        self._flush_freed()
        self._admissions(self._now())
        first = self._merge_pending()
        dec = self._dispatch_decode()
        self._dispatch_prefill()
        self._pack_next_chunk()
        if first is not None or dec is not None:
            # depth baseline: the earliest producing sample dispatch;
            # everything enqueued after it is work the device queue runs
            # ahead with
            seq = min(f.seq for f in (first, dec) if f is not None)
            self._inflight = {"first": first, "decode": dec, "seq": seq}
        return finished

    def flush(self) -> list[RequestResult]:
        """Drain the overlapped pipeline's in-flight tail without
        dispatching new work: retire the sampled tokens, apply a pending
        merge (whose first tokens are then retired too). Afterwards
        every token produced so far is on the host. Returns the newly
        finished results; ``[]`` on the sequential engine."""
        finished: list[RequestResult] = []
        with self._rank_pools():
            while (self._inflight is not None
                   or self._pending_merge is not None):
                self._retire(finished)
                first = self._merge_pending()
                if first is not None:
                    self._inflight = {"first": first, "decode": None,
                                      "seq": first.seq}
        return finished

    def _done(self, slot: _Slot) -> bool:
        toks = slot.result.tokens
        if len(toks) >= slot.budget:
            return True
        return slot.req.eos_id is not None and toks[-1] == slot.req.eos_id

    def _finish(self, i: int) -> RequestResult:
        res = self._slots[i].result
        res.finish_time = self._now()
        self._free(i)
        self._stats["finished"] += 1
        return res

    def run(self, realtime: bool = False) -> list[RequestResult]:
        """Drive ``step()`` until queue, slots and the overlapped
        pipeline drain. ``realtime`` sleeps through arrival gaps while
        the pipeline is idle; otherwise arrival order is kept but the
        clock jumps over the gaps."""
        results: list[RequestResult] = []
        while self.has_work:
            if self._pipeline_idle and self._queue:
                wait = self._queue[0].arrival_time - self._now()
                if wait > 0:
                    if realtime:
                        time.sleep(wait)
                    else:
                        self._t0 -= wait       # jump the clock forward
            results.extend(self.step())
        return results

    # -- metrics ----------------------------------------------------------

    @property
    def stats(self) -> dict:
        s = dict(self._stats)
        s.update(self._serve_paths)
        s["overlap"] = self.overlap
        s["paged_kv"] = self._paged
        if self.prefix_cache is not None:
            s.update(self.prefix_cache.stats)
        if self._paged:
            s["kv_page_size"] = self._page_size
            s["kv_pages_total"] = self._alloc.n_pages
            s["kv_pages_free"] = self._alloc.n_free
        steps = max(s["decode_steps"], 1)
        s["mean_occupancy"] = (s["decode_slot_steps"]
                               / (steps * self.max_slots))
        s["prefill_batch_occupancy"] = (
            s["prefill_tokens"] / s["prefill_padded_tokens"]
            if s["prefill_padded_tokens"] else 1.0)
        s["prefill_rows_per_call"] = (
            s["prefill_chunks"] / s["prefill_calls"]
            if s["prefill_calls"] else 0.0)
        if self._ttfts:
            s["ttft_p50"] = float(np.percentile(self._ttfts, 50))
            s["ttft_p99"] = float(np.percentile(self._ttfts, 99))
        # per readback: how long the host blocked on the sampled tokens,
        # and how many dispatches the device queue held beyond them
        if self._stall_ms:
            s["decode_stall_ms_p50"] = float(np.percentile(self._stall_ms,
                                                           50))
            s["decode_stall_ms_p99"] = float(np.percentile(self._stall_ms,
                                                           99))
            s["decode_stall_ms_max"] = float(np.max(self._stall_ms))
        if self._depths:
            s["dispatch_depth_mean"] = float(np.mean(self._depths))
            s["dispatch_depth_max"] = int(np.max(self._depths))
        s["pack_fence_waits"] = self._pack.fence_waits
        return s

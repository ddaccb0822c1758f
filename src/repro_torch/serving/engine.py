"""Continuous-batching serving engine over the O(1)-state PRF decode.

The counterpart of ``repro.serving.engine`` with its sequential
scheduler. Each ``step()``:

  1. admits arrived requests FIFO into free slots, seeding their rows of
     a same-shape **staging pool** from a fresh one-row template;
  2. runs the **token-budget packer**: at most ``chunk_tokens`` prompt
     tokens split across all staged admissions (equal pow-2 grants under
     ``bucket_prefill``), advanced together in ONE padded (P, L)
     ``lm.prefill_chunk`` call with per-row ``valid_len``; admissions
     whose prompt is done are committed to the slot pool and sample
     their first token;
  3. runs ONE batched ``lm.decode_step`` over the active slots and
     samples each row.

With ``cfg.use_kernel`` both calls run the hand-written kernels
(``prf_fused_prefill``, ``prf_fused_decode``, one launch per layer per
call) against projections precomposed once here. The kernels update the
state in place, so a decode with free slots advances only the active
rows (``slots.freeze_inactive``): free rows stay bit-frozen.

Sampling: greedy rows take the argmax. Sampled rows (temperature > 0,
optional top-k / top-p) draw by inverse CDF with one uniform derived
from (seed, uid, token index) alone, so a row's draws do not depend on
the step count, the batch around it or the chunk boundaries. The draws
differ from the reference package's threefry draws.

Not ported yet: the overlapped scheduler, the prefix cache and paged
exact KV, and mesh-sharded pools (ROADMAP.md Queue A, items A8, A9,
A13).
"""
from __future__ import annotations

import bisect
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import feature_maps as fm
from repro_torch.models import lm
from repro_torch.serving import slots as slot_ops
from repro_torch.serving.request import Request, RequestResult


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def row_uniform(seed: int, uid: int, count: int) -> float:
    """The uniform draw of token ``count`` of request ``uid``: a pure
    function of its arguments, hence schedule-invariant."""
    return float(np.random.default_rng([seed, uid, count]).random())


def sample_rows(logits: torch.Tensor, uniforms: np.ndarray,
                temps: np.ndarray, top_ks: np.ndarray,
                top_ps: np.ndarray) -> np.ndarray:
    """Per-row sampling of (n, V) logits: argmax where temperature is 0,
    else an inverse-CDF draw at ``uniforms`` from the temperature-scaled
    softmax restricted to the top-k logits and the top-p nucleus."""
    greedy = logits.argmax(dim=-1)
    if not (temps > 0).any():
        return greedy.cpu().numpy()
    dev = logits.device
    v = logits.shape[-1]
    t = torch.as_tensor(temps, device=dev)
    scaled = logits / t.clamp(min=1e-6)[:, None]
    if (top_ks > 0).any() or (top_ps < 1.0).any():
        k = torch.as_tensor(np.where(top_ks > 0, top_ks, v) - 1,
                            device=dev).clamp(0, v - 1)
        desc = scaled.sort(dim=-1, descending=True).values
        kth = desc.gather(1, k[:, None].long())
        scaled = torch.where(scaled >= kth, scaled, -torch.inf)
        probs = torch.softmax(scaled, dim=-1)
        sp = probs.sort(dim=-1, descending=True).values
        cum = sp.cumsum(dim=-1)
        p = torch.as_tensor(top_ps, device=dev)[:, None]
        keep = ((cum - sp) < p) | (p >= 1.0)
        cutoff = torch.where(keep, sp, torch.inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(probs >= cutoff, scaled, -torch.inf)
    cdf = torch.softmax(scaled, dim=-1).cumsum(dim=-1)
    u = torch.as_tensor(uniforms, dtype=cdf.dtype, device=dev)[:, None]
    drawn = torch.searchsorted(cdf, u * cdf[:, -1:], right=True)
    drawn = drawn[:, 0].clamp(max=v - 1)
    return torch.where(t > 0, drawn, greedy).cpu().numpy()


class _Slot:
    """Host-side record of the sequence occupying one pool row; it is
    prefilling while ``cursor < len(req.prompt)``."""

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
                            chunk_tokens=256, device="cuda")
        eng.submit(Request(prompt=[...], max_new_tokens=64))
        results = eng.run()

    ``params`` lie on ``device`` already. ``prefill_rows`` caps how many
    staged admissions share the packed prefill call (None = all).
    ``bucket_prefill`` pads packed chunk lengths to powers of two.
    """

    def __init__(self, params, cfg: lm.ModelConfig, *, max_slots: int = 4,
                 max_len: int = 256, chunk_tokens: Optional[int] = None,
                 seed: int = 0, prefill_rows: Optional[int] = None,
                 bucket_prefill: bool = True, device="cuda"):
        if chunk_tokens is not None and chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        if prefill_rows is not None and prefill_rows < 1:
            raise ValueError("prefill_rows must be >= 1 (None = no cap)")
        if cfg.attn.kind not in fm.PRF_KINDS:
            raise NotImplementedError(
                f"serving kind {cfg.attn.kind!r} is not ported yet "
                "(ROADMAP.md Queue A, item A3)")
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.chunk_tokens = chunk_tokens
        self.prefill_rows = prefill_rows
        self.bucket_prefill = bucket_prefill
        self.seed = seed
        self.device = torch.device(device)

        def pool(b):
            return lm.init_serve_state(cfg, b=b, max_len=max_len,
                                       per_slot=True, stacked=True,
                                       device=self.device)
        self.pool = pool(max_slots)
        # row i holds the partial prefill state of the admission
        # reserved on slot i
        self.staging = pool(max_slots)
        self._fresh_row = pool(1)
        # the layer-stacked params and the precomposed projections
        # A = (W M)^T, built once here for both kernels
        self._step_params = dict(params)
        self._step_params["layers"] = lm.stack_layer_params(params, cfg)
        self._proj = lm.build_decode_proj(self._step_params, cfg)
        # what the dispatch runs: the kernels only take CUDA tensors; on
        # the CPU the same wrappers run their plain versions
        path = ("torch" if self._proj is None else
                "fused_kernel" if self.device.type == "cuda" else
                "fused_plain")
        self._serve_paths = {"prefill_path": path, "decode_path": path}

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
        self._stats = {"decode_steps": 0, "decode_slot_steps": 0,
                       "prefill_tokens": 0, "prefill_chunks": 0,
                       "prefill_calls": 0, "prefill_padded_tokens": 0,
                       "prefill_rows_max": 0,
                       "max_prefill_tokens_per_step": 0,
                       "emitted_tokens": 0, "admitted": 0, "finished": 0}

    # -- clock ------------------------------------------------------------

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = time.monotonic()
        return time.monotonic() - self._t0

    def _idx(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

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
        partial result (None if the uid is unknown)."""
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
        return bool(self._queue) or any(s is not None for s in self._slots)

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

    def _activate(self, i: int) -> None:
        req = self._slots[i].req
        self._active[i] = True
        self._temps[i] = req.temperature
        self._top_ks[i] = req.top_k
        self._top_ps[i] = req.top_p
        self._uids[i] = req.uid

    def _sample(self, logits: torch.Tensor, rows: list[int],
                counts: list[int]) -> np.ndarray:
        uniforms = np.asarray([row_uniform(self.seed, int(self._uids[i]), n)
                               for i, n in zip(rows, counts)])
        return sample_rows(logits, uniforms, self._temps[rows],
                           self._top_ks[rows], self._top_ps[rows])

    def _admissions(self, now: float) -> None:
        """Reserve a free slot, with a freshly seeded staging row, for
        every arrived request, FIFO."""
        admitted: list[int] = []
        while self._queue and self._queue[0].arrival_time <= now:
            free = [i for i in range(self.max_slots)
                    if self._slots[i] is None]
            if not free:
                break
            req = self._queue.pop(0)
            i = free[0]
            result = RequestResult(uid=req.uid,
                                   prompt=list(map(int, req.prompt)),
                                   arrival_time=req.arrival_time)
            budget = min(req.max_new_tokens, self.max_len - len(req.prompt))
            self._slots[i] = _Slot(req, result, budget)
            self._prefill_order.append(i)
            admitted.append(i)
        if admitted:
            slot_ops.fork_slots(self.staging, self._fresh_row,
                                self._idx(admitted))

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

    def _prefill_work(self) -> None:
        """Advance every scheduled admission by its granted chunk in ONE
        padded batched ``prefill_chunk`` call, then commit the admissions
        whose prompts finished and sample their first tokens."""
        grants = self._plan_prefill()
        if not grants:
            return
        ts = np.asarray([t for _, t in grants], np.int32)
        l_pad = int(ts.max())
        if self.bucket_prefill:
            l_pad = _next_pow2(l_pad)
        toks = np.zeros((len(grants), l_pad), np.int64)
        for r, (i, t) in enumerate(grants):
            slot = self._slots[i]
            toks[r, :t] = slot.req.prompt[slot.cursor:slot.cursor + t]
        # all-full rows take the unmasked path; ragged rows carry lengths
        vl = (None if (ts == l_pad).all()
              else torch.as_tensor(ts, device=self.device))
        idx = self._idx([i for i, _ in grants])
        sub = slot_ops.read_slots(self.staging, idx)
        logits, sub = lm.prefill_chunk(
            self._step_params, self.cfg,
            {"tokens": torch.as_tensor(toks, device=self.device)}, sub,
            valid_len=vl, proj=self._proj)
        slot_ops.write_slots(self.staging, sub, idx)
        self._record_prefill_stats(len(grants), int(ts.sum()), l_pad)

        done: list[tuple[int, int]] = []
        for r, (i, t) in enumerate(grants):
            slot = self._slots[i]
            slot.cursor += t
            if slot.cursor == len(slot.req.prompt):
                done.append((r, i))
        if not done:
            return
        slot_ops.merge_slots(self.pool, self.staging,
                             self._idx([i for _, i in done]))
        for r, i in done:
            self._prefill_order.remove(i)
            self._finish_admission(i, logits[r:r + 1])

    def _finish_admission(self, i: int, logits: torch.Tensor) -> None:
        """Activate pool row i (already committed from staging) and
        sample its first token."""
        slot = self._slots[i]
        self._activate(i)
        first = int(self._sample(logits, [i], [0])[0])
        now = self._now()
        if slot.req.on_token is not None:
            slot.req.on_token(first, now)
        slot.result.admit_time = now
        slot.result.tokens = [first]
        slot.result.token_times = [now]
        slot.emitted = 1
        self._ttfts.append(now - slot.req.arrival_time)
        self._toks[i] = first
        self._stats["emitted_tokens"] += 1
        self._stats["admitted"] += 1

    def step(self) -> list[RequestResult]:
        """Admit what has arrived, run one packed prefill chunk, then one
        batched decode over the active slots; evict finished sequences.
        Returns the newly finished results (possibly empty)."""
        finished: list[RequestResult] = []
        self._admissions(self._now())
        self._prefill_work()
        # admission may already exhaust a request (budget/eos on token 1)
        for i, slot in enumerate(self._slots):
            if slot is not None and self._active[i] and self._done(slot):
                finished.append(self._finish(i))
        if not self._active.any():
            return finished

        rows = [int(i) for i in np.nonzero(self._active)[0]]
        counts = [self._slots[i].emitted for i in rows]
        toks = torch.as_tensor(self._toks[self._active], device=self.device)
        logits = slot_ops.freeze_inactive(
            self.pool, self._active,
            lambda st: lm.decode_step(self._step_params, self.cfg, toks, st,
                                      proj=self._proj))
        sampled = self._sample(logits, rows, counts)  # blocks on readiness
        now = self._now()
        self._stats["decode_steps"] += 1
        self._stats["decode_slot_steps"] += len(rows)
        for i, tok in zip(rows, sampled):
            slot = self._slots[i]
            tok = int(tok)
            if slot.req.on_token is not None:
                slot.req.on_token(tok, now)
            slot.result.tokens.append(tok)
            slot.result.token_times.append(now)
            slot.emitted += 1
            self._toks[i] = tok
            self._stats["emitted_tokens"] += 1
            if self._done(slot):
                finished.append(self._finish(i))
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
        """Drive ``step()`` until queue and slots drain. ``realtime``
        sleeps through arrival gaps while the pool is empty; otherwise
        arrival order is kept but the clock jumps over the gaps."""
        results: list[RequestResult] = []
        while self.has_work:
            idle = self.num_active == 0 and not self._prefill_order
            if idle and self._queue:
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
        s["overlap"] = False
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
        return s

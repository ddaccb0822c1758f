"""Synthetic LM data with learnable structure (port of
``repro.data.synthetic``; the audio and VLM streams wait with ROADMAP
A12). Host-side numpy, so a (seed, step) batch is bitwise the
reference's.

Design requirements (framework-grade, not toy):
  * deterministic: batch(step) is a pure function of (seed, step, host) —
    restart/resume replays the exact stream with no iterator state to save;
  * shardable: hosts get disjoint substreams (seed folded with host id);
  * learnable: tokens follow a sparse bigram process (each token has a small
    successor set derived from a hash) mixed with uniform noise, so
    next-token accuracy rises well above chance within a few hundred steps
    and the paper's relative comparisons (dark vs performer vs exact) are
    meaningful;
  * host-side numpy generation (no device work in the input pipeline,
    which is also what a production loader does).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _rng(seed: int, host: int, step: int, salt: int = 0):
    return np.random.default_rng(
        np.random.SeedSequence([seed, host, step, salt]))


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    batch_size: int            # per-host batch
    seed: int = 0
    host: int = 0
    branching: int = 4         # successors per token
    noise: float = 0.1         # P(uniform token)
    task: str = "bigram"       # bigram | induction
    alphabet: int = 32         # induction: symbols drawn per sequence

    def _successors(self) -> np.ndarray:
        """(vocab, branching) int32 successor table via a hash mix."""
        t = np.arange(self.vocab, dtype=np.uint32)[:, None]
        b = np.arange(self.branching, dtype=np.uint32)[None, :]
        h = (t * np.uint32(2654435761) + b * np.uint32(40503)
             + np.uint32(self.seed * 97 + 13))
        h = (h ^ (h >> np.uint32(15))) * np.uint32(2246822519)
        h = h ^ (h >> np.uint32(13))
        return (h % np.uint32(self.vocab)).astype(np.int32)

    def batch(self, step: int) -> dict:
        """Returns {"tokens": (B, L), "labels": (B, L)} — labels are the
        next token (teacher forcing), last label wraps to the first.

        task="induction": in-context copying (the induction-head task).
        Tokens are drawn from a small per-batch alphabet so symbols repeat;
        whenever x[t] occurred before at position s, the next token is
        forced to x[s+1] and the label at t is x[s+1]; other positions are
        label-masked (-1). Solving it REQUIRES attention to the previous
        occurrence — FFN memorization cannot help (associations are random
        per sequence), so attention-kernel quality is what's measured."""
        if self.task == "induction":
            return self._induction_batch(step)
        rng = _rng(self.seed, self.host, step)
        succ = self._successors()
        b, l = self.batch_size, self.seq_len
        cur = rng.integers(0, self.vocab, b).astype(np.int32)
        toks = np.empty((b, l), np.int32)
        branch = rng.integers(0, self.branching, (l, b))
        use_noise = rng.random((l, b)) < self.noise
        uni = rng.integers(0, self.vocab, (l, b)).astype(np.int32)
        for t in range(l):
            nxt = succ[cur, branch[t]]
            cur = np.where(use_noise[t], uni[t], nxt).astype(np.int32)
            toks[:, t] = cur
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        return {"tokens": toks, "labels": labels}

    def _induction_batch(self, step: int) -> dict:
        rng = _rng(self.seed, self.host, step, salt=3)
        b, l = self.batch_size, self.seq_len
        toks = np.empty((b, l), np.int32)
        labels = np.full((b, l), -1, np.int32)
        for i in range(b):
            alpha = rng.choice(self.vocab, self.alphabet, replace=False)
            seq = alpha[rng.integers(0, self.alphabet, l)]
            last_pos: dict[int, int] = {}
            for t in range(l):
                cur = int(seq[t])
                s = last_pos.get(cur)
                if s is not None and s + 1 < t:
                    seq[t + 1 if t + 1 < l else t] = seq[s + 1]
                    if t + 1 < l:
                        labels[i, t] = seq[s + 1]
                last_pos[cur] = t
            toks[i] = seq
        return {"tokens": toks, "labels": labels}

"""Synthetic LM, audio and VLM data with learnable structure (port of
``repro.data.synthetic``). Host-side numpy, so a (seed, step) batch is
bitwise the reference's.

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


@dataclasses.dataclass(frozen=True)
class SyntheticAudio:
    """Masked-frame-prediction batches for the HuBERT-style encoder."""
    d_model: int
    seq_len: int
    batch_size: int
    vocab: int = 504
    seed: int = 0
    host: int = 0
    mask_prob: float = 0.3

    def batch(self, step: int) -> dict:
        """Returns {"frames": (B, L, d_model) f32, "mask": (B, L) bool,
        "labels": (B, L) int32}: each frame a noisy linear signature of
        its label, so the task is learnable."""
        rng = _rng(self.seed, self.host, step, salt=1)
        b, l = self.batch_size, self.seq_len
        labels = rng.integers(0, self.vocab, (b, l)).astype(np.int32)
        dirs = np.random.default_rng(
            np.random.SeedSequence([self.seed + 7])).standard_normal(
            (self.vocab, self.d_model)).astype(np.float32)
        frames = dirs[labels] + 0.5 * rng.standard_normal(
            (b, l, self.d_model)).astype(np.float32)
        mask = rng.random((b, l)) < self.mask_prob
        return {"frames": frames.astype(np.float32), "mask": mask,
                "labels": labels}


@dataclasses.dataclass(frozen=True)
class SyntheticVLM:
    """Patch-prefix + caption-token batches for the VLM backbone."""
    d_model: int
    num_patches: int
    seq_len: int               # text length
    batch_size: int
    vocab: int
    seed: int = 0
    host: int = 0

    def batch(self, step: int) -> dict:
        """Returns {"tokens", "labels"} (B, seq_len) as
        :class:`SyntheticLM` gives them and "patch_embeds" (B,
        num_patches, d_model) f32."""
        lm = SyntheticLM(self.vocab, self.seq_len, self.batch_size,
                         seed=self.seed, host=self.host)
        b = lm.batch(step)
        rng = _rng(self.seed + 31, self.host, step, salt=2)
        patches = 0.02 * rng.standard_normal(
            (self.batch_size, self.num_patches,
             self.d_model)).astype(np.float32)
        return {"tokens": b["tokens"], "labels": b["labels"],
                "patch_embeds": patches}

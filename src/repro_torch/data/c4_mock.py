"""C4-mock: a deterministic byte-level pseudo-corpus (port of
``repro.data.c4_mock``, bitwise the same batches).

The paper benches on C4; the repository ships no dataset, so this emits a
deterministic stream of template-grammar English-ish sentences and tokenize
at the byte level (vocab 256 folded into the model vocab). The stream is a
pure function of (seed, step, host) like SyntheticLM.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_SUBJ = ["the model", "a transformer", "the kernel", "random features",
         "the attention map", "a long sequence", "the optimizer",
         "the data pipeline", "a pretrained network", "the covariance"]
_VERB = ["approximates", "computes", "learns", "reduces", "samples",
         "projects", "normalizes", "whitens", "stabilizes", "scales"]
_OBJ = ["the softmax kernel", "an anisotropic distribution",
        "the feature space", "a low-rank geometry", "the variance",
        "the importance weights", "a mahalanobis metric",
        "the query distribution", "a linear map", "the gradient noise"]
_ADV = ["efficiently", "unbiasedly", "in linear time", "at scale",
        "with low variance", "per head", "after finetuning",
        "during pretraining", "without retraining", "stably"]


@dataclasses.dataclass(frozen=True)
class C4Mock:
    vocab: int
    seq_len: int
    batch_size: int
    seed: int = 0
    host: int = 0

    def _sentence(self, rng: np.random.Generator) -> bytes:
        s = (f"{rng.choice(_SUBJ)} {rng.choice(_VERB)} "
             f"{rng.choice(_OBJ)} {rng.choice(_ADV)}. ")
        return s.encode()

    def batch(self, step: int) -> dict:
        rows = []
        for b in range(self.batch_size):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + self.host * 7919 + step) * 65537
                + b)
            buf = b""
            while len(buf) < self.seq_len + 1:
                buf += self._sentence(rng)
            arr = np.frombuffer(buf[: self.seq_len + 1],
                                dtype=np.uint8).astype(np.int32)
            rows.append(arr % self.vocab)
        mat = np.stack(rows)
        return {"tokens": mat[:, :-1], "labels": mat[:, 1:]}

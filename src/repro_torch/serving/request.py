"""Request/result records for the continuous-batching serving engine.

A ``Request`` is what a client submits: a token prompt plus decode
parameters. A ``RequestResult`` is what the engine hands back: the
generated tokens plus the wall-clock trace (arrival -> admission ->
per-token -> finish). Every entry of ``token_times`` is a readiness
time: the engine stamps it after the token has reached the host.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Callable, Optional, Sequence

_uid_counter = itertools.count()


def next_uid() -> int:
    return next(_uid_counter)


@dataclasses.dataclass
class Request:
    """One generation request.

    ``arrival_time`` is in seconds on the engine's clock; the scheduler
    admits no request before it arrives. ``temperature`` 0.0 is greedy.
    ``top_k`` (0 = off) and ``top_p`` (1.0 = off) restrict sampling to
    the k highest logits / the smallest nucleus of mass p. ``on_token``
    is called as ``on_token(token, t)`` for every generated token once
    it is on the host.
    """
    prompt: Sequence[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    arrival_time: float = 0.0
    uid: int = dataclasses.field(default_factory=next_uid)
    on_token: Optional[Callable[[int, float], None]] = None


@dataclasses.dataclass
class RequestResult:
    """Completed (or cancelled) request with its timing trace."""
    uid: int
    prompt: list[int]
    tokens: list[int] = dataclasses.field(default_factory=list)
    arrival_time: float = 0.0
    admit_time: float = 0.0          # when the slot prefill finished
    finish_time: float = 0.0
    token_times: list[float] = dataclasses.field(default_factory=list)
    cancelled: bool = False

    @property
    def ttft(self) -> float:
        """Time-to-first-token: arrival -> first generated token."""
        if not self.token_times:
            return float("nan")
        return self.token_times[0] - self.arrival_time

    @property
    def tpots(self) -> list[float]:
        """Per-token latencies after the first (time-per-output-token)."""
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]


def synthetic_requests(n: int, vocab: int, *, seed: int = 0,
                       rate: float = 0.0,
                       prompt_range: tuple[int, int] = (16, 64),
                       gen_range: tuple[int, int] = (16, 32),
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0) -> list[Request]:
    """Random-token request stream. ``rate`` > 0 spaces arrivals by an
    exponential (Poisson process) clock; 0 makes everything available at
    t=0. The same seed gives the reference package's stream."""
    rng = random.Random(seed)
    t, reqs = 0.0, []
    for _ in range(n):
        if rate > 0:
            t += rng.expovariate(rate)
        reqs.append(Request(
            prompt=[rng.randrange(vocab)
                    for _ in range(rng.randint(*prompt_range))],
            max_new_tokens=rng.randint(*gen_range),
            temperature=temperature, top_k=top_k, top_p=top_p,
            arrival_time=t))
    return reqs


def shared_prefix_requests(n: int, vocab: int, *, seed: int = 0,
                           rate: float = 0.0, prefix_len: int = 96,
                           n_prefixes: int = 1, reuse: float = 0.8,
                           suffix_range: tuple[int, int] = (16, 32),
                           gen_range: tuple[int, int] = (16, 32),
                           temperature: float = 0.0) -> list[Request]:
    """Prefix-heavy request stream: a ``reuse`` share of the requests
    opens with one of ``n_prefixes`` shared ``prefix_len``-token prompts
    (system-prompt and few-shot traffic, what the prefix cache is for),
    followed by a private random suffix; the rest are random control
    prompts of the same total length. ``rate`` spaces arrivals as in
    :func:`synthetic_requests`. The draws come from ``random.Random(seed)``
    in the reference package's order, so the same arguments give its
    prompts."""
    rng = random.Random(seed)
    prefixes = [[rng.randrange(vocab) for _ in range(prefix_len)]
                for _ in range(n_prefixes)]
    t, reqs = 0.0, []
    for _ in range(n):
        if rate > 0:
            t += rng.expovariate(rate)
        suffix = [rng.randrange(vocab)
                  for _ in range(rng.randint(*suffix_range))]
        if rng.random() < reuse:
            prompt = rng.choice(prefixes) + suffix
        else:
            prompt = [rng.randrange(vocab)
                      for _ in range(prefix_len)] + suffix
        reqs.append(Request(prompt=prompt,
                            max_new_tokens=rng.randint(*gen_range),
                            temperature=temperature, arrival_time=t))
    return reqs

"""Fault tolerance for long training runs (port of
``repro.runtime.fault_tolerance``).

  * TrainSupervisor — wraps the step loop: periodic checkpoints through
    ``repro_torch.checkpoint``, restore on restart, retry from the last
    checkpoint when a step fails (the software analogue of a node dying
    mid-step), a bounded restart budget. Under a process group of more
    than one rank, rank 0 writes each checkpoint, every rank reads
    ``latest_step`` after a barrier, and the preemption flag is OR-ed
    over the ranks after each step, so all of them checkpoint and stop at
    the same step however a signal reaches them.
  * SimulatedFailure — deterministic fault injector for tests and drills
    (raised at step N; the supervisor must recover to the state of an
    uninterrupted run).
  * PreemptionHandler — SIGTERM/SIGINT -> "checkpoint now and stop". It
    replaces both handlers in the process that builds it; ``restore()``
    puts the previous ones back.
  * StragglerMonitor — per-step latency EMA; steps slower than
    ``threshold x EMA`` are counted and reported to a callback.
  * elastic_shrink_plan — the largest (data, model)-consistent mesh left
    after losing hosts; ``checkpoint.restore_to_shardings`` then reloads
    a checkpoint onto it.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt_lib


class SimulatedFailure(RuntimeError):
    """Injected fault (stands in for a dead host or a link flap)."""


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 3.0          # x EMA
    ema_decay: float = 0.9
    warmup_steps: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _ema: float = 0.0
    _n: int = 0
    straggler_steps: int = 0

    def record(self, step: int, dt: float) -> bool:
        """Record a step latency; returns True if flagged as straggler."""
        self._n += 1
        if self._n <= self.warmup_steps:
            self._ema = dt if self._ema == 0.0 else (
                self.ema_decay * self._ema + (1 - self.ema_decay) * dt)
            return False
        flagged = dt > self.threshold * self._ema
        if flagged:
            self.straggler_steps += 1
            if self.on_straggler:
                self.on_straggler(step, dt, self._ema)
        else:
            # only fold non-outlier steps into the EMA
            self._ema = (self.ema_decay * self._ema
                         + (1 - self.ema_decay) * dt)
        return flagged


class PreemptionHandler:
    """SIGTERM/SIGINT -> graceful 'checkpoint and stop' flag."""

    def __init__(self, install: bool = True):
        self.preempted = False
        self._previous: dict = {}
        if install:
            try:
                for sig in (signal.SIGTERM, signal.SIGINT):
                    self._previous[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass                      # not the main thread

    def _handler(self, signum, frame):
        self.preempted = True

    def restore(self) -> None:
        """Put back the handlers this one replaced."""
        for sig, old in self._previous.items():
            signal.signal(sig, old)
        self._previous = {}


def elastic_shrink_plan(mesh_shape: tuple[int, ...], axis_names: tuple,
                        failed_hosts: int, devices_per_host: int = 4
                        ) -> tuple[int, ...]:
    """Largest valid submesh after losing ``failed_hosts`` hosts.

    Policy: shrink the DATA axis (model sharding is fixed by memory) to
    the largest power of two that fits the devices left. Returns the new
    mesh shape; restore via ``checkpoint.restore_to_shardings``.
    """
    shape = dict(zip(axis_names, mesh_shape))
    lost_devices = failed_hosts * devices_per_host
    total = 1
    for s in mesh_shape:
        total *= s
    remaining = total - lost_devices
    per_replica = shape.get("model", 1)
    pod = shape.get("pod", 1)
    max_data = remaining // (per_replica * pod)
    if max_data < 1:
        raise ValueError("cluster too small after failures")
    data = 1
    while data * 2 <= max_data:
        data *= 2
    new = dict(shape)
    new["data"] = data
    return tuple(new[a] for a in axis_names)


def _multi_rank() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _any_rank(flag: bool) -> bool:
    """``flag`` OR-ed over every rank of the default group (one
    all-reduce; on the current card under NCCL)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


@dataclasses.dataclass
class TrainSupervisor:
    """Checkpointed, restartable, straggler-aware step loop."""
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    monitor: StragglerMonitor = dataclasses.field(
        default_factory=StragglerMonitor)
    preemption: Optional[PreemptionHandler] = None

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            num_steps: int,
            fail_at: Optional[int] = None,
            on_metrics: Optional[Callable[[int, Any], None]] = None) -> Any:
        """Run ``num_steps`` of ``step_fn`` with checkpoint/restart.

        ``state`` is a tree of tensors (plain or DTensor) holding
        everything needed to resume (params, optimizer state); the step
        counter is managed here. It is also the template a restore
        follows: each restored leaf lands on its template leaf's device
        and dtype (a DTensor's mesh and placements). ``fail_at`` injects a
        SimulatedFailure once, at that step, before it runs. A failure
        before the first checkpoint restarts at step 0 from the state it
        has, as the reference's does (the steps already applied stay
        applied: holding the initial state for a cold restart would keep
        a second copy of params and optimizer state on the device).
        """
        start = 0
        restored = self._try_restore(state)
        if restored is not None:
            state, start = restored
            start += 1
        restarts = 0
        injected = False
        step = start
        while step < num_steps:
            t0 = time.monotonic()
            try:
                if fail_at is not None and step == fail_at and not injected:
                    injected = True
                    raise SimulatedFailure(f"injected failure @ step {step}")
                state = step_fn(state, step)
            except SimulatedFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                restored = self._try_restore(state)
                if restored is None:
                    step = 0            # no checkpoint yet: restart cold
                else:
                    state, last = restored
                    step = last + 1
                continue
            self.monitor.record(step, time.monotonic() - t0)
            if on_metrics:
                on_metrics(step, state)
            preempt = self.preemption is not None and \
                self.preemption.preempted
            if _multi_rank():
                preempt = _any_rank(preempt)
            if (step % self.ckpt_every == self.ckpt_every - 1) or \
                    step == num_steps - 1 or preempt:
                ckpt_lib.save_checkpoint(self.ckpt_dir, step, state,
                                         keep=self.keep)
            if preempt:
                break
            step += 1
        return state

    def _try_restore(self, template: Any):
        if _multi_rank():
            dist.barrier()              # rank 0's last write is done
        last = ckpt_lib.latest_step(self.ckpt_dir)
        if last is None:
            return None
        return ckpt_lib.restore_checkpoint(self.ckpt_dir, template, last)

"""Fault tolerance & straggler mitigation for long-running training.

A copy of ``repro.distributed.fault_tolerance`` (pure Python). The port's
resumable sweeps (``repro_torch.faults.resume``) drive it.

What runs in this container is the control logic, exercised by the tests
with simulated failures; on a real multi-pod deployment the same hooks are
driven by the platform's health signals:

  * ``HeartbeatMonitor`` — detects missing/slow participants from step-time
    telemetry (median-based straggler score, where a slow card or a flaky
    link shows up as a per-host step-time outlier).
  * ``FailurePolicy`` — decides restart-from-checkpoint vs. elastic
    continue-with-fewer-pods (checkpoints are device-agnostic, see
    ``repro_torch.checkpoint``).
  * ``run_with_retries`` — supervisor loop: run the step function, on
    (simulated or real) failure restore the latest checkpoint and resume;
    data pipeline skip-ahead guarantees bitwise-identical batches.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class StragglerReport:
    worker: int
    ratio: float  # step time / median step time


class HeartbeatMonitor:
    """Tracks per-worker step durations; flags stragglers and deaths."""

    def __init__(self, num_workers: int, window: int = 16,
                 straggler_ratio: float = 1.5, dead_after_s: float = 60.0):
        self.num_workers = num_workers
        self.window = window
        self.straggler_ratio = straggler_ratio
        self.dead_after_s = dead_after_s
        self._times: List[deque] = [deque(maxlen=window) for _ in range(num_workers)]
        self._last_seen = [time.time()] * num_workers

    def record(self, worker: int, step_time_s: float, now: Optional[float] = None):
        self._times[worker].append(step_time_s)
        self._last_seen[worker] = now if now is not None else time.time()

    def _medians(self) -> List[float]:
        meds = []
        for dq in self._times:
            if dq:
                s = sorted(dq)
                meds.append(s[len(s) // 2])
            else:
                meds.append(float("nan"))
        return meds

    def stragglers(self) -> List[StragglerReport]:
        meds = [m for m in self._medians() if m == m]
        if not meds:
            return []
        global_med = sorted(meds)[len(meds) // 2]
        out = []
        for w, dq in enumerate(self._times):
            if not dq:
                continue
            s = sorted(dq)
            med = s[len(s) // 2]
            if global_med > 0 and med / global_med >= self.straggler_ratio:
                out.append(StragglerReport(w, med / global_med))
        return out

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return [w for w, t in enumerate(self._last_seen) if now - t > self.dead_after_s]


@dataclasses.dataclass(frozen=True)
class FailurePolicy:
    max_restarts: int = 10
    elastic: bool = True  # allow continuing on a smaller mesh

    def decide(self, dead_workers: List[int], spare_capacity: int) -> str:
        if not dead_workers:
            return "continue"
        if spare_capacity >= len(dead_workers):
            return "replace"  # hot spares take over, restore from checkpoint
        if self.elastic:
            return "shrink"   # re-shard onto the survivors
        return "restart"


class SimulatedFailure(RuntimeError):
    pass


def run_with_retries(
    step_fn: Callable[[int], Dict],
    *,
    total_steps: int,
    save_every: int,
    save_fn: Callable[[int], None],
    restore_fn: Callable[[], int],
    policy: FailurePolicy = FailurePolicy(),
    on_event: Optional[Callable[[str, int], None]] = None,
    retry_on: Tuple[type, ...] = (SimulatedFailure,),
    backoff_s: float = 0.0,
    sleep_fn: Callable[[float], None] = time.sleep,
) -> Dict[str, int]:
    """Supervisor: drive ``step_fn(step)`` to ``total_steps`` with
    checkpoint/restart on failure. Returns counters for the tests.

    ``retry_on`` is the tuple of exception types worth retrying (anything
    else — including ``BaseException`` kills like a real SIGKILL —
    propagates); each restart sleeps ``backoff_s * 2**(restarts-1)`` via the
    injectable ``sleep_fn`` before restoring, so a flapping dependency gets
    exponentially more room instead of a hot retry loop."""
    restarts = 0
    step = restore_fn()
    events = {"restarts": 0, "saves": 0}
    while step < total_steps:
        try:
            step_fn(step)
            step += 1
            if step % save_every == 0:
                save_fn(step)
                events["saves"] += 1
        except retry_on:
            restarts += 1
            events["restarts"] = restarts
            if restarts > policy.max_restarts:
                raise
            if on_event:
                on_event("restart", step)
            if backoff_s > 0.0:
                sleep_fn(backoff_s * (2 ** (restarts - 1)))
            step = restore_fn()
    return events

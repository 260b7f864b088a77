"""Resumable, retrying sweep execution: the journal + supervisor plumbing.

The port of ``repro.faults.resume``. ``core.experiment.sweep(...,
resume_dir=...)`` drives grid points in chunks through three components:

- ``checkpoint.manager.CheckpointManager`` (the port's) — each completed
  chunk's result arrays are saved as one atomic checkpoint step (npz per
  field, MANIFEST.json written last). The set of manifested steps IS the
  per-point completion journal: a sweep killed mid-grid re-opens the
  directory, loads the completed steps back and computes only the rest.
- ``distributed.fault_tolerance.run_with_retries`` — the supervisor loop:
  a chunk dispatch that raises is retried (bounded, exponential backoff)
  from the journal's frontier instead of aborting the sweep.
- ``distributed.fault_tolerance.HeartbeatMonitor`` — per-chunk wall times
  feed the straggler detector; the sweep result reports chunks whose
  median step time is an outlier (a pathological grid point, a thermal
  throttle).

``call_with_timeout`` bounds each chunk's wall time (a hung chunk fails —
and then takes the retry/backoff path — instead of hanging the sweep).
``inject_kill_after`` is the deterministic mid-sweep "kill -9" used by the
tests and ``chip_smoke.py``; ``KilledMidSweep`` derives from
``BaseException`` so the supervisor's retry net never catches it — exactly
like a real process death.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..checkpoint.manager import CheckpointManager


class PointTimeout(RuntimeError):
    """A grid-point chunk exceeded its wall-time budget."""


class KilledMidSweep(BaseException):
    """Simulated hard kill (test/demo injection). BaseException on purpose:
    the retry supervisor catches Exceptions; a kill must escape it."""


_KILL_COUNTDOWN: Optional[int] = None


@contextlib.contextmanager
def inject_kill_after(n_chunks: int):
    """Within the context, the sweep dies (``KilledMidSweep``) right before
    dispatching its ``n_chunks``-th+1 chunk — after ``n_chunks`` completed
    chunks have hit the journal. Deterministic resume-after-kill testing."""
    global _KILL_COUNTDOWN
    prev = _KILL_COUNTDOWN
    _KILL_COUNTDOWN = int(n_chunks)
    try:
        yield
    finally:
        _KILL_COUNTDOWN = prev


def check_kill_switch() -> None:
    """Called by the sweep before each chunk dispatch."""
    global _KILL_COUNTDOWN
    if _KILL_COUNTDOWN is None:
        return
    if _KILL_COUNTDOWN <= 0:
        raise KilledMidSweep("injected mid-sweep kill")
    _KILL_COUNTDOWN -= 1


def call_with_timeout(fn: Callable[[], Any], timeout_s: Optional[float],
                      label: str = "chunk") -> Any:
    """Run ``fn()`` with a wall-time bound. Raises ``PointTimeout`` when it
    does not return in time (the worker thread is daemonic and abandoned —
    work queued on the card cannot be cancelled, only failed past; the sweep
    synchronizes the device before it journals the next chunk)."""
    if not timeout_s:
        return fn()
    box: Dict[str, Any] = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller
            box["err"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        raise PointTimeout(f"{label} exceeded its {timeout_s}s wall budget")
    if "err" in box:
        raise box["err"]
    return box["out"]


class SweepJournal:
    """Per-chunk completion journal over ``CheckpointManager``.

    One checkpoint step per completed chunk. A step's ``extra`` carries the
    sweep signature and the result's keys; reopening a journal against a
    different grid/spec raises instead of silently mixing results.
    """

    def __init__(self, directory: str, signature: str):
        self.mgr = CheckpointManager(directory)
        self.signature = signature
        for step in self.mgr.steps():
            extra = self._extra(step)
            if extra.get("signature") != signature:
                raise ValueError(
                    f"journal {directory!r} step {step} belongs to a "
                    "different sweep (signature "
                    f"{extra.get('signature')!r} != {signature!r}); "
                    "point resume_dir at a fresh directory")

    def _extra(self, step: int) -> dict:
        return self.mgr.manifest(step).get("extra", {})

    def completed_steps(self):
        return self.mgr.steps()

    def next_step(self) -> int:
        """The execution frontier: chunks run in order, so the journal is
        always a prefix and the first missing step is where to resume."""
        done = set(self.completed_steps())
        step = 0
        while step in done:
            step += 1
        return step

    def mark(self, step: int, result: Dict[str, Dict[str, Any]],
             meta: Optional[dict] = None) -> None:
        """Atomically journal one completed chunk's result: sections of
        named arrays."""
        keys = {sect: list(arrs) for sect, arrs in result.items()}
        extra = {"signature": self.signature, "keys": keys, **(meta or {})}
        self.mgr.save(step, {"result": result}, extra=extra)

    def load(self, step: int, verify: bool = True) -> Dict[str, Dict[str, np.ndarray]]:
        """Load one journaled chunk's result arrays back (sha-verified)."""
        keys = self._extra(step)["keys"]
        template = {sect: dict.fromkeys(names) for sect, names in keys.items()}
        return self.mgr.restore(step, {"result": template}, verify)[0]["result"]

"""``FaultTrace``: seedable, composable *realized* event streams.

The port of ``repro.faults.trace``. A trace is what actually happened to the
fleet during the day, as opposed to what the planner was told
(``EnvParams``): the solvers keep planning on the unfaulted env, and the
execution layer (``repro_torch.faults.failover``) applies the trace to a
realized env view each hour, re-projecting the planner's allocation against
realized capacity.

The trace is a NamedTuple of float32 tensors of hourly multipliers/addends
over the planner's fields (multipliers multiply, RTT penalties add):

======================  =========  =======================================
field                   shape      meaning (realized = planned ∘ trace)
======================  =========  =======================================
``avail_mult``          (D, 24)    realized avail = avail · avail_mult
``rtt_extra_ms``        (D, D, 24) realized rtt = rtt + rtt_extra_ms[..., t]
``price_mult``          (D, 24)    realized $/kWh = eprice · price_mult
``carbon_mult``         (D, 24)    realized kg/kWh = carbon · carbon_mult
======================  =========  =======================================

Each event is built on the host in numpy, as the reference builds it, and
becomes float32 tensors on a device: ``device=`` when given, else the env's
when an env is given, else the card (which raises without one). ``compose``
multiplies and adds float32 tensors, as the reference's float32 arrays, so
every trace equals the reference's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.model import resolve_device

HOURS = 24


class FaultTrace(NamedTuple):
    """Realized per-hour fault multipliers the executor applies to the
    planning env (shapes pinned in ``repro_torch.lint.pytrees.SCHEMAS``).

    Machine-read unit table (repro_torch.lint.units):

        avail_mult: 1
        rtt_extra_ms: ms
        price_mult: 1
        carbon_mult: 1
    """
    avail_mult: torch.Tensor    # (D, 24) in [0, 1]
    rtt_extra_ms: torch.Tensor  # (D, D, 24) >= 0
    price_mult: torch.Tensor    # (D, 24) > 0
    carbon_mult: torch.Tensor   # (D, 24) > 0


def _ndc(env_or_d) -> int:
    """Number of DCs from an EnvParams or a bare int."""
    if isinstance(env_or_d, (int, np.integer)):
        return int(env_or_d)
    return int(env_or_d.er.shape[-1])


def _device(env_or_d, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    if isinstance(env_or_d, (int, np.integer)):
        return resolve_device("cuda")
    return env_or_d.er.device


def _window(start: int, duration: int) -> np.ndarray:
    """(24,) float mask for [start, start+duration) mod 24 (the scenario
    transforms' convention)."""
    h = np.arange(HOURS)
    return (((h - start) % HOURS) < duration).astype(np.float64)


def _trace(device, avail, rtt_extra, price, carbon) -> FaultTrace:
    """Host arrays rounded to float32, as tensors on ``device``."""
    return FaultTrace(*(torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
                        for a in (avail, rtt_extra, price, carbon)))


def _identity(d: int):
    return [np.ones((d, HOURS)), np.zeros((d, d, HOURS)), np.ones((d, HOURS)),
            np.ones((d, HOURS))]


def no_faults(env_or_d, device=None) -> FaultTrace:
    """The identity trace: nothing happened. Engines under it reproduce
    the unfaulted planner numbers (bit-for-bit on the unrouted path; the
    routed failover re-split is allclose, see ``failover.apply_failover``)."""
    return _trace(_device(env_or_d, device), *_identity(_ndc(env_or_d)))


def dc_crash(env_or_d, dc: int = 0, start: int = 12, duration: int = 6,
             device=None) -> FaultTrace:
    """Hard crash: the DC's realized capacity is zero for the window. The
    planner still schedules onto it; the failover policy decides where that
    mass goes."""
    parts = _identity(_ndc(env_or_d))
    parts[0][dc] = 1.0 - _window(start, duration)
    return _trace(_device(env_or_d, device), *parts)


def brownout(env_or_d, dc: int = 0, start: int = 10, duration: int = 8,
             severity: float = 0.5, device=None) -> FaultTrace:
    """Capacity brownout: the DC loses ``severity`` of its realized
    capacity in the window (thermal event, partial grid curtailment)."""
    parts = _identity(_ndc(env_or_d))
    parts[0][dc] = 1.0 - severity * _window(start, duration)
    return _trace(_device(env_or_d, device), *parts)


def wan_partition(env_or_d, a: int = 0, b: int = 1, start: int = 0,
                  duration: int = 24, extra_ms: float = 500.0,
                  device=None) -> FaultTrace:
    """Link partition/degradation: the a↔b inter-region path gains
    ``extra_ms`` of realized RTT both directions for the window."""
    parts = _identity(_ndc(env_or_d))
    w = _window(start, duration) * float(extra_ms)
    parts[1][a, b] += w
    parts[1][b, a] += w
    return _trace(_device(env_or_d, device), *parts)


def telemetry_dropout(env_or_d, dc: Optional[int] = None, start: int = 0,
                      duration: int = 24, price_factor: float = 1.0,
                      carbon_factor: float = 1.0, device=None) -> FaultTrace:
    """Stale telemetry: realized $/kWh = planned · price_factor and realized
    intensity = planned · carbon_factor in the window, for ``dc`` (all DCs
    when None)."""
    parts = _identity(_ndc(env_or_d))
    rows = slice(None) if dc is None else dc
    w = _window(start, duration)
    parts[2][rows] = 1.0 + (price_factor - 1.0) * w
    parts[3][rows] = 1.0 + (carbon_factor - 1.0) * w
    return _trace(_device(env_or_d, device), *parts)


def compose(*traces: FaultTrace) -> FaultTrace:
    """Overlay traces: availability/price/carbon multipliers multiply,
    RTT penalties add. Order-independent."""
    if not traces:
        raise ValueError("compose() needs at least one trace")
    out = traces[0]
    for t in traces[1:]:
        out = FaultTrace(
            avail_mult=out.avail_mult * t.avail_mult,
            rtt_extra_ms=out.rtt_extra_ms + t.rtt_extra_ms,
            price_mult=out.price_mult * t.price_mult,
            carbon_mult=out.carbon_mult * t.carbon_mult,
        )
    return out


def stack_traces(traces: Sequence[FaultTrace]) -> FaultTrace:
    """Stack per-point traces field-wise into one batched FaultTrace whose
    leading axis lines up with a batched engine's env rows."""
    traces = list(traces)
    if not traces:
        raise ValueError("stack_traces() needs at least one trace")
    shapes = {tuple(t.avail_mult.shape) for t in traces}
    if len(shapes) != 1:
        raise ValueError(f"traces disagree on (D, hours): {sorted(shapes)}")
    return FaultTrace(*(torch.stack([getattr(t, f) for t in traces])
                        for f in FaultTrace._fields))


_KINDS = ("dc_crash", "brownout", "wan_partition", "telemetry_dropout")


def random_trace(env_or_d, seed: int = 0, n_events: int = 3,
                 kinds: Sequence[str] = _KINDS, device=None) -> FaultTrace:
    """A seeded random day of trouble: ``n_events`` events drawn from
    ``kinds`` with randomized targets/windows/severities (the reference's
    numpy stream, so the same trace as the reference's for a seed)."""
    d = _ndc(env_or_d)
    dev = _device(env_or_d, device)
    rng = np.random.default_rng(seed)
    parts = [no_faults(d, device=dev)]
    for _ in range(n_events):
        kind = kinds[int(rng.integers(len(kinds)))]
        start = int(rng.integers(0, HOURS))
        duration = int(rng.integers(2, 13))
        if kind == "dc_crash":
            parts.append(dc_crash(d, dc=int(rng.integers(d)), start=start,
                                  duration=duration, device=dev))
        elif kind == "brownout":
            parts.append(brownout(d, dc=int(rng.integers(d)), start=start,
                                  duration=duration,
                                  severity=float(rng.uniform(0.2, 0.8)), device=dev))
        elif kind == "wan_partition":
            a, b = rng.choice(d, size=2, replace=False)
            parts.append(wan_partition(d, a=int(a), b=int(b), start=start,
                                       duration=duration,
                                       extra_ms=float(rng.uniform(100, 800)), device=dev))
        elif kind == "telemetry_dropout":
            parts.append(telemetry_dropout(
                d, dc=int(rng.integers(d)), start=start, duration=duration,
                price_factor=float(rng.uniform(0.5, 2.5)),
                carbon_factor=float(rng.uniform(0.5, 2.5)), device=dev))
        else:
            raise ValueError(f"unknown fault kind {kind!r}; known: {_KINDS}")
    return compose(*parts)

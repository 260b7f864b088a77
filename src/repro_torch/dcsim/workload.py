"""Workload arrival-rate patterns (paper §6, Fig. 6) — the single source of
truth for cloud arrival-rate construction.

A copy of ``repro.dcsim.workload`` (host-side numpy, the same RNG streams).
The scenario engine's ``traffic_pattern`` and ``arrival_resample``
transforms (``repro_torch.scenarios``) call it too.

Patterns: sinusoidal (consumer-interactive), flat (continuous-compute), plus
the beyond-paper shapes used by the scenario engine (`repro.scenarios`):
weekday (double-hump business hours), weekend (late, lower peak) and bursty
(flat base with seeded spike trains). Per-run normal resampling follows the
paper (mean = pattern value, std = 20% of mean).

``build_env`` and every scenario transform route through ``base_rates`` /
``arrival_pattern`` so arrival construction is never re-implemented inline.
"""
from __future__ import annotations

import numpy as np

PATTERNS = ("sinusoidal", "flat", "weekday", "weekend", "bursty")


def base_rates(
    capacity: np.ndarray,
    utilization: float = 0.45,
    *,
    concentration: float = 3.0,
    weight_seed: int = 1234,
) -> np.ndarray:
    """Peak cloud arrival rate per task type (tasks/hour).

    ``capacity`` is the aggregate per-type execution rate ER.sum(axis=1),
    shape (I,). Each type gets a Dirichlet share w_i (Σw=1, fixed
    ``weight_seed`` so the task mix is infrastructure-stable across runs)
    of its own capacity × ``utilization``, so total utilization
    Σ_i CAR_i/cap_i peaks near ``utilization`` (the paper's
    under-subscribed regime).
    """
    capacity = np.asarray(capacity, dtype=float)
    rng = np.random.default_rng(weight_seed)
    w = rng.dirichlet(np.ones(capacity.shape[0]) * concentration)
    return utilization * w * capacity


def arrival_pattern(
    kind: str,           # one of PATTERNS
    base: np.ndarray,    # (I,) peak rates
    seed: int = 0,
    resample: bool = True,
) -> np.ndarray:
    """CAR[i, 24]: cloud arrival rate per task type per UTC hour."""
    i = base.shape[0]
    hours = np.arange(24)
    if kind == "sinusoidal":
        # consumer diurnal: trough ~6 AM, peak ~8 PM UTC (paper Fig. 6 shape)
        shape = 0.65 + 0.35 * np.sin((hours - 14.0) / 24.0 * 2 * np.pi)
    elif kind == "flat":
        shape = np.full(24, 0.82)
    elif kind == "weekday":
        # business double-hump: morning and afternoon peaks, lunch dip
        am = np.exp(-0.5 * ((hours - 15.0) / 2.2) ** 2)
        pm = np.exp(-0.5 * ((hours - 21.0) / 2.6) ** 2)
        shape = 0.40 + 0.55 * np.maximum(am, pm)
    elif kind == "weekend":
        # later, flatter leisure peak at ~60% weekday volume
        shape = 0.35 + 0.25 * np.sin((hours - 17.0) / 24.0 * 2 * np.pi)
    elif kind == "bursty":
        # low base + a seeded train of short 2-3.3x spikes (flash-crowd-like);
        # spike windows never overlap — overlapping draws used to multiply
        # magnitudes into the np.minimum cap, flattening the documented
        # 2-3.3x bursts into clipped plateaus — so every spiked hour carries
        # exactly one magnitude and stays inside capacity headroom
        rng = np.random.default_rng(seed + 7331)
        shape = np.full(24, 0.30)
        occupied = np.zeros(24, dtype=bool)
        want = int(rng.integers(2, 5))
        placed = attempts = 0
        while placed < want and attempts < 8 * want:
            attempts += 1
            t0 = int(rng.integers(0, 24))
            width = int(rng.integers(1, 4))
            window = [(t0 + k) % 24 for k in range(width)]
            if occupied[window].any():
                continue
            shape[window] *= float(rng.uniform(2.0, 3.3))
            occupied[window] = True
            placed += 1
        shape = np.minimum(shape, 1.0)  # safety net; never binds at base 0.30
    else:  # pragma: no cover
        raise ValueError(f"unknown arrival pattern {kind!r}; known: {PATTERNS}")
    car = base[:, None] * shape[None, :]
    if resample:
        car = resample_car(car, seed)
    return car


def resample_car(car: np.ndarray, seed: int, std: float = 0.2) -> np.ndarray:
    """The paper's per-run variation: CAR ~ N(CAR, std·CAR), floored at 5%."""
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(car, std * car), 0.05 * car, None)

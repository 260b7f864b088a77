"""The scenario transform library: grid, infrastructure and traffic events.

The port of ``repro.scenarios.transforms``. Each factory returns a pure
``EnvParams -> EnvParams`` transform (the stress families benchmarked in
DCcluster-Opt, arXiv:2511.00117, and the perturbed heterogeneous regimes of
Green-LLM, arXiv:2507.09942):

- ``flash_crowd``        traffic surge in an hour window (× magnitude);
                         ``sources=`` makes it regional (origin tilts there)
- ``dc_outage``          one DC's capacity zeroed for a window (avail mask)
- ``carbon_spike``       grid carbon-intensity surge in a window
- ``carbon_diurnal``     marginal-carbon dip at local midday (solar on grid)
- ``price_surge``        TOU price surge in a window (grid scarcity event)
- ``renewable_drought``  on-site renewables scaled down (becalmed/overcast)
- ``demand_response``    partial capacity curtailment in a window
- ``traffic_pattern``    rebuild arrivals from a named workload pattern
- ``arrival_resample``   the paper's per-run normal resampling of arrivals
- ``sla_tighten``        enable/tighten SLA targets and price misses
- ``wan_degradation``    inter-region RTT inflated (congestion/reroute event)
- ``origin_shift``       demand origins tilted toward given source regions
- ``workload_mix_shift`` the arrivals' mix tilted toward given task types
- ``context_length_surge`` longer requests: slower service, larger payloads
- ``identity``           no-op (baseline rows in suites)

Windows are ``[start, start+duration)`` in UTC hours, wrapping modulo 24.
All randomness flows through an explicit ``seed`` so a transform is a fixed
function of its parameters; shapes and dtypes are always preserved.

The hour and row masks are numpy, as in the reference. A transform applies
them with torch on the env's device, in the precision the reference
computes in: where it multiplies in float64 on the host and rounds to
float32, so does the port (on the device), and where it multiplies float32
arrays, the port multiplies float32 tensors, so every field equals the
reference's. ``traffic_pattern`` and ``arrival_resample`` rebuild arrivals
from numpy RNG streams on the host (``dcsim.workload``), as the reference
does, and move them to the device.

These are *planned* (briefed) events: a transform edits the ``EnvParams``
the solvers plan on. Disruptions that arrive during execution live in
``repro_torch.faults`` (``FaultTrace`` + ``run(..., faults=...)``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..dcsim import latency, workload
from ..dcsim.env import EnvParams
from .registry import Transform, register


def _window(start: int, duration: int) -> np.ndarray:
    """(24,) float mask for [start, start+duration) mod 24."""
    h = np.arange(24)
    return (((h - start) % 24) < duration).astype(np.float64)


def _rows(n: int, which: Optional[Sequence[int]]) -> np.ndarray:
    """(n,) float row-selection mask (None = all rows)."""
    m = np.zeros(n) if which is not None else np.ones(n)
    if which is not None:
        m[np.asarray(which)] = 1.0
    return m


def _on(like: torch.Tensor, a, dtype=torch.float64) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` on ``like``'s device."""
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(like.device)


def _f64_to(like: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A float64 result rounded to ``like``'s dtype, as ``jnp.asarray`` of a
    float64 host array rounds it."""
    return x.to(like.dtype)


def _scale_field(arr: torch.Tensor, row_mask: np.ndarray, hour_mask: np.ndarray,
                 factor: float) -> torch.Tensor:
    """Multiply arr (R, 24) by ``factor`` on selected rows × hours."""
    mult = 1.0 + (factor - 1.0) * np.outer(row_mask, hour_mask)
    return _f64_to(arr, arr.double() * _on(arr, mult))


def _mask32(like: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    """A float64 host mask as the float32 operand JAX makes of it."""
    return _on(like, np.asarray(a, dtype=np.float32), like.dtype)


def _clip01(avail: torch.Tensor) -> torch.Tensor:
    """Keep the EnvParams invariant avail ∈ [0, 1] whatever the params."""
    return torch.clamp(avail, 0.0, 1.0)


@register("identity")
def identity() -> Transform:
    return lambda env: env


@register("flash_crowd", severity="magnitude")
def flash_crowd(start: int = 18, duration: int = 3, magnitude: float = 3.0,
                tasks: Optional[Sequence[int]] = None,
                sources: Optional[Sequence[int]] = None) -> Transform:
    """Traffic surge: arrivals × magnitude in the window (all or some types).

    ``sources`` makes the surge *regional*: the extra demand originates at
    the given source regions, so the window's ``origin`` split tilts toward
    them; total origin mass per (task, hour) stays 1.
    """
    def t(env: EnvParams) -> EnvParams:
        mask = _rows(env.car.shape[0], tasks)
        hour = _window(start, duration)
        out = env._replace(car=_scale_field(env.car, mask, hour, magnitude))
        if sources is not None:
            mult = 1.0 + (magnitude - 1.0) * np.outer(mask, hour)     # (I, 24)
            origin = env.origin.double()                              # (S, I, 24)
            src = np.zeros(origin.shape[0])
            src[np.asarray(sources)] = 1.0 / len(sources)
            shifted = ((origin + _on(origin, (mult - 1.0)[None] * src[:, None, None]))
                       / _on(origin, np.maximum(mult, 1e-9)[None]))
            # a regional dip (magnitude < 1) can't drain a source below zero
            shifted = torch.clamp(shifted, min=0.0)
            shifted = shifted / torch.sum(shifted, dim=0, keepdim=True)
            out = out._replace(origin=_f64_to(env.origin, shifted))
        return out
    return t


@register("dc_outage", severity="duration")
def dc_outage(dc: int = 0, start: int = 8, duration: int = 6) -> Transform:
    """Full outage of one DC for the window: avail → 0 (capacity, IT power
    and idle draw all vanish). The *planned* outage: solvers see the dark
    window; ``repro_torch.faults.dc_crash`` is the unplanned one."""
    def t(env: EnvParams) -> EnvParams:
        row = _rows(env.avail.shape[0], (dc,))
        off = np.outer(row, _window(start, duration))
        return env._replace(avail=_clip01(env.avail * _mask32(env.avail, 1.0 - off)))
    return t


@register("demand_response", severity="curtail")
def demand_response(dc: int = 0, start: int = 16, duration: int = 4,
                    curtail: float = 0.5) -> Transform:
    """Demand-response event: the DC sheds ``curtail`` of its capacity."""
    def t(env: EnvParams) -> EnvParams:
        row = _rows(env.avail.shape[0], (dc,))
        cut = 1.0 - curtail * np.outer(row, _window(start, duration))
        return env._replace(avail=_clip01(env.avail * _mask32(env.avail, cut)))
    return t


@register("carbon_spike", severity="magnitude")
def carbon_spike(start: int = 6, duration: int = 6, magnitude: float = 2.5,
                 dcs: Optional[Sequence[int]] = None) -> Transform:
    """Grid carbon-intensity surge (e.g. coal peakers online) in the window."""
    def t(env: EnvParams) -> EnvParams:
        mask = _rows(env.carbon.shape[0], dcs)
        return env._replace(
            carbon=_scale_field(env.carbon, mask, _window(start, duration), magnitude))
    return t


@register("carbon_diurnal", severity="amplitude")
def carbon_diurnal(amplitude: float = 0.35, trough_utc: int = 20) -> Transform:
    """Marginal-carbon diurnal shape: intensity dips ``amplitude`` at
    ``trough_utc`` (solar-heavy afternoon grid) and rises overnight."""
    def t(env: EnvParams) -> EnvParams:
        h = np.arange(24)
        shape = 1.0 + amplitude * np.cos((h - trough_utc) / 24.0 * 2 * np.pi + np.pi)
        carbon = env.carbon.double() * _on(env.carbon, shape[None, :])
        return env._replace(carbon=_f64_to(env.carbon, carbon))
    return t


@register("price_surge", severity="magnitude")
def price_surge(start: int = 14, duration: int = 6, magnitude: float = 2.0,
                dcs: Optional[Sequence[int]] = None) -> Transform:
    """TOU price surge (grid scarcity / heat event) in the window."""
    def t(env: EnvParams) -> EnvParams:
        mask = _rows(env.eprice.shape[0], dcs)
        return env._replace(
            eprice=_scale_field(env.eprice, mask, _window(start, duration), magnitude))
    return t


@register("renewable_drought", severity="scale")
def renewable_drought(scale: float = 0.15, start: int = 0, duration: int = 24,
                      dcs: Optional[Sequence[int]] = None) -> Transform:
    """Becalmed/overcast day: on-site renewables scaled to ``scale``."""
    def t(env: EnvParams) -> EnvParams:
        mask = _rows(env.rp.shape[0], dcs)
        return env._replace(
            rp=_scale_field(env.rp, mask, _window(start, duration), scale))
    return t


@register("traffic_pattern")
def traffic_pattern(kind: str = "weekday", seed: int = 0,
                    utilization: float = 0.45) -> Transform:
    """Rebuild arrivals from a named workload pattern (weekday/weekend/
    bursty/flat/sinusoidal) against the env's actual capacity, on the host
    (``workload.base_rates`` / ``arrival_pattern``, the reference's RNG)."""
    def t(env: EnvParams) -> EnvParams:
        cap = env.er.cpu().numpy().sum(axis=1)
        base = workload.base_rates(cap, utilization)
        car = workload.arrival_pattern(kind, base, seed=seed)
        return env._replace(car=_on(env.car, car).to(env.car.dtype))
    return t


@register("sla_tighten", severity="tighten")
def sla_tighten(tighten: float = 1.0, price: float = 1e-4,
                weight: Optional[float] = None,
                tasks: Optional[Sequence[int]] = None) -> Transform:
    """Turn the SLA term on: scale the selected tasks' SLA targets by
    ``tighten`` (<1 = stricter) and charge ``price`` $/task per expected
    miss. ``weight`` optionally overrides the ``cost_sla`` objective weight."""
    def t(env: EnvParams) -> EnvParams:
        mask = _rows(env.sla_ms.shape[0], tasks)
        sla_ms = env.sla_ms.double() * _on(env.sla_ms, 1.0 + (tighten - 1.0) * mask)
        sla_price = torch.where(_on(env.sla_price, mask) > 0, price, env.sla_price.double())
        out = env._replace(sla_ms=_f64_to(env.sla_ms, sla_ms),
                           sla_price=_f64_to(env.sla_price, sla_price))
        if weight is not None:
            out = out._replace(sla_weight=torch.full_like(env.sla_weight, weight))
        return out
    return t


@register("wan_degradation", severity="factor")
def wan_degradation(factor: float = 3.0, extra_ms: float = 20.0) -> Transform:
    """WAN congestion/reroute event: inter-region RTTs × ``factor`` plus
    ``extra_ms`` of queueing delay on every off-diagonal (cross-region)
    path. A zero (paper-default) RTT matrix is first seeded from the
    canonical ``topology.location_coords`` geometry."""
    def t(env: EnvParams) -> EnvParams:
        if env.rtt.ndim != 2:
            raise ValueError(
                f"rtt must be the canonical (D, D) matrix, got {tuple(env.rtt.shape)}")
        d = env.rtt.shape[-1]
        rtt = env.rtt.double()
        if not bool(torch.any(rtt != 0)):
            rtt = _on(env.rtt, latency.rtt_matrix(num_dcs=d))
        rtt = rtt * factor + _on(env.rtt, extra_ms * (1.0 - np.eye(d)))
        return env._replace(rtt=_f64_to(env.rtt, rtt))
    return t


@register("origin_shift", severity="weight")
def origin_shift(toward: Sequence[int] = (0,), weight: float = 0.8,
                 start: int = 0, duration: int = 24,
                 tasks: Optional[Sequence[int]] = None) -> Transform:
    """Shift the demand-origin split toward the given source regions: in the
    window, the selected tasks' origins become ``(1 - weight) · origin +
    weight · uniform(toward)``."""
    def t(env: EnvParams) -> EnvParams:
        origin = env.origin.double()                              # (S, I, 24)
        target = np.zeros(origin.shape[0])
        target[np.asarray(toward)] = 1.0 / len(toward)
        w = weight * np.outer(_rows(origin.shape[1], tasks), _window(start, duration))
        shifted = _on(origin, (1.0 - w)[None]) * origin + _on(
            origin, w[None] * target[:, None, None])
        return env._replace(origin=_f64_to(env.origin, shifted))
    return t


@register("arrival_resample", severity="std")
def arrival_resample(seed: int = 0, std: float = 0.2) -> Transform:
    """The paper's run-to-run variation: CAR ~ N(CAR, std·CAR), clipped (on
    the host, the reference's RNG stream)."""
    def t(env: EnvParams) -> EnvParams:
        car = workload.resample_car(env.car.cpu().numpy(), seed, std)
        return env._replace(car=_on(env.car, car).to(env.car.dtype))
    return t


@register("workload_mix_shift", severity="weight")
def workload_mix_shift(toward: Sequence[int] = (0,), weight: float = 0.5,
                       start: int = 0, duration: int = 24) -> Transform:
    """Shift the workload mix toward the given task types: in the window,
    each hour's arrivals become ``(1 - weight) · car + weight · (hourly total
    on uniform(toward))``; the hourly totals are kept."""
    def t(env: EnvParams) -> EnvParams:
        car = env.car.double()                                    # (I, 24)
        target = np.zeros(car.shape[0])
        target[np.asarray(toward)] = 1.0 / len(toward)
        w = weight * _window(start, duration)                     # (24,)
        total = torch.sum(car, dim=0, keepdim=True)               # (1, 24)
        shifted = _on(car, (1.0 - w)[None]) * car + _on(car, w[None] * target[:, None]) * total
        return env._replace(car=_f64_to(env.car, shifted))
    return t


@register("context_length_surge", severity="factor")
def context_length_surge(factor: float = 2.0,
                         tasks: Optional[Sequence[int]] = None) -> Transform:
    """Requests get ``factor``× longer for the selected task types: their
    execution rate ``er`` divides by ``factor`` and their per-request
    payload ``sizes`` multiplies by it (whole day)."""
    def t(env: EnvParams) -> EnvParams:
        rows = _rows(env.er.shape[0], tasks)                       # (I,)
        er_scale = np.where(rows > 0, 1.0 / factor, 1.0)
        sz_scale = np.where(rows > 0, factor, 1.0)
        return env._replace(er=env.er * _mask32(env.er, er_scale)[:, None],
                            sizes=env.sizes * _mask32(env.sizes, sz_scale))
    return t

"""Named scenario suites: ordered maps of scenario-day name → Scenario list.

A copy of ``repro.scenarios.suites`` over the port's transforms. A suite row
composes registered transforms (left to right) onto a base env;
``build_suite`` materializes the envs on the base env's device, all with
identical shapes so they stack into one batch of
``schedulers.run_days_batched``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..dcsim.env import EnvParams
from .registry import Scenario, apply_all, expand_grid, severity_knob

# Each suite: name -> ordered {scenario_day: [Scenario, ...]}.
SUITES: Dict[str, Dict[str, List[Scenario]]] = {
    # the paper's protocol: resampled arrival days, nothing else
    "baseline": {
        f"resample-{r}": [Scenario("arrival_resample", {"seed": r})]
        for r in range(5)
    },
    # grid-side events only (scheduler sees unchanged traffic)
    "grid_events": {
        "carbon-spike": [Scenario("carbon_spike", {"start": 6, "duration": 8, "magnitude": 2.5})],
        "carbon-diurnal": [Scenario("carbon_diurnal", {"amplitude": 0.35})],
        "price-surge": [Scenario("price_surge", {"start": 14, "duration": 6, "magnitude": 2.2})],
        "renewable-drought": [Scenario("renewable_drought", {"scale": 0.1})],
        "demand-response": [Scenario("demand_response", {"dc": 1, "start": 16, "duration": 4, "curtail": 0.6})],
    },
    # the SLA/latency family: misses priced, WAN and capacity under stress
    # (evaluate with objective="cost_sla" so schedulers see the new term)
    "latency": {
        "sla-baseline": [Scenario("sla_tighten")],
        "sla-tight": [Scenario("sla_tighten", {"tighten": 0.6})],
        "wan-degraded": [
            Scenario("sla_tighten"),
            Scenario("wan_degradation", {"factor": 3.0, "extra_ms": 30.0}),
        ],
        "sla-flash-crowd": [
            Scenario("sla_tighten", {"tighten": 0.8}),
            Scenario("flash_crowd", {"start": 18, "duration": 4, "magnitude": 3.0}),
        ],
        "sla-curtailed": [
            Scenario("sla_tighten", {"tighten": 0.8}),
            Scenario("demand_response", {"dc": 1, "start": 14, "duration": 6, "curtail": 0.6}),
        ],
        "sla-wan-crunch": [
            Scenario("sla_tighten", {"tighten": 0.7}),
            Scenario("wan_degradation", {"factor": 2.0, "extra_ms": 15.0}),
            Scenario("flash_crowd", {"start": 17, "duration": 5, "magnitude": 2.0}),
        ],
    },
    # per-source routing family: SLA priced + WAN visible + demand origins
    # shifted/regionalized, so the (source → DC) split is worth optimizing
    # (evaluate with objective="cost_sla" and routed=True engines; source
    # indices assume the 4-DC fleet: 0=NY, 1=SF, 2=Dallas, 3=Seattle)
    "routing": {
        "uniform-origin": [
            Scenario("sla_tighten", {"tighten": 0.6}),
            Scenario("wan_degradation", {"factor": 3.0, "extra_ms": 30.0}),
        ],
        "east-business-day": [
            Scenario("sla_tighten", {"tighten": 0.6}),
            Scenario("wan_degradation", {"factor": 3.0, "extra_ms": 30.0}),
            Scenario("origin_shift", {"toward": [0], "weight": 0.7,
                                      "start": 12, "duration": 10}),
        ],
        "west-evening": [
            Scenario("sla_tighten", {"tighten": 0.6}),
            Scenario("wan_degradation", {"factor": 3.0, "extra_ms": 30.0}),
            Scenario("origin_shift", {"toward": [1, 3], "weight": 0.7,
                                      "start": 0, "duration": 8}),
        ],
        "regional-flash-crowd": [
            Scenario("sla_tighten", {"tighten": 0.7}),
            Scenario("wan_degradation", {"factor": 2.0, "extra_ms": 20.0}),
            Scenario("flash_crowd", {"start": 18, "duration": 4,
                                     "magnitude": 2.5, "sources": [0]}),
        ],
        "shifted-wan-crunch": [
            Scenario("sla_tighten", {"tighten": 0.6}),
            Scenario("wan_degradation", {"factor": 4.0, "extra_ms": 40.0}),
            Scenario("origin_shift", {"toward": [0], "weight": 0.8}),
            Scenario("demand_response", {"dc": 0, "start": 14, "duration": 6,
                                         "curtail": 0.5}),
        ],
    },
    # the full stress family: traffic, infrastructure and grid events
    "stress": {
        "baseline": [Scenario("identity")],
        "flash-crowd": [Scenario("flash_crowd", {"start": 18, "duration": 4, "magnitude": 3.0})],
        "dc-outage": [Scenario("dc_outage", {"dc": 0, "start": 8, "duration": 6})],
        "carbon-spike": [Scenario("carbon_spike", {"start": 6, "duration": 8, "magnitude": 2.5})],
        "price-surge": [Scenario("price_surge", {"start": 14, "duration": 6, "magnitude": 2.2})],
        "renewable-drought": [Scenario("renewable_drought", {"scale": 0.1})],
        "demand-response": [Scenario("demand_response", {"dc": 1, "start": 16, "duration": 4, "curtail": 0.6})],
        "weekend": [Scenario("traffic_pattern", {"kind": "weekend", "seed": 3})],
        "bursty": [Scenario("traffic_pattern", {"kind": "bursty", "seed": 4})],
        "grid-crunch": [
            Scenario("carbon_spike", {"start": 12, "duration": 8, "magnitude": 2.0}),
            Scenario("price_surge", {"start": 12, "duration": 8, "magnitude": 1.8}),
            Scenario("renewable_drought", {"scale": 0.2}),
        ],
        "crowd-plus-outage": [
            Scenario("flash_crowd", {"start": 17, "duration": 5, "magnitude": 2.5}),
            Scenario("dc_outage", {"dc": 2, "start": 17, "duration": 5}),
        ],
    },
}


def suite_names() -> Tuple[str, ...]:
    return tuple(SUITES)


def build_suite(name: str, base_env: EnvParams) -> List[Tuple[str, EnvParams]]:
    """Materialize (scenario_day, env) rows for the named suite."""
    try:
        rows = SUITES[name]
    except KeyError:
        raise KeyError(f"unknown suite {name!r}; known: {suite_names()}") from None
    return [(day, apply_all(base_env, scenarios)) for day, scenarios in rows.items()]


def _point_label(point) -> str:
    """Compact "name=value|…" label for one grid point (severity knob value
    when declared, the full params dict otherwise)."""
    parts = []
    for name, params in point.items():
        try:
            v = params.get(severity_knob(name))
        except ValueError:
            v = None
        parts.append(f"{name}={v if v is not None else params}")
    return "|".join(parts)


def build_grid(base_env: EnvParams, grid, *, base=()) -> Tuple[list, List[Tuple[str, EnvParams]]]:
    """Materialize a severity grid: ``(points, rows)``.

    ``grid`` is the ``registry.expand_grid`` grammar — transform name ->
    sequence of params dicts or bare severity-knob scalars; the cartesian
    product becomes one scenario-day per point. ``base`` scenarios (or
    transforms) apply to ``base_env`` first, before every point — e.g. an
    ``sla_tighten`` row so every grid point prices misses. All rows share
    the base env's shapes, so the whole grid stacks into ONE batch of the batched
    engine (``repro_torch.core.experiment.sweep`` drives exactly this).
    """
    points = expand_grid(grid)
    env0 = apply_all(base_env, base)
    rows = [(_point_label(pt),
             apply_all(env0, [Scenario(n, p) for n, p in pt.items()]))
            for pt in points]
    return points, rows


def build_month(base_env: EnvParams, days: int = 30, *,
                seed: int = 0) -> List[Tuple[str, EnvParams]]:
    """Per-day (name, env) rows for a month-scale episode.

    A simple calendar: weekday traffic Mon–Fri, the weekend shape on days 5
    and 6 of each week, and every day's arrivals independently resampled
    (the paper's run-to-run 20%-std variation) so no two days are identical.
    Feed the env column to ``schedulers.run_month``, which threads the
    monthly peak-demand state across the stacked days.
    """
    rows = []
    for d in range(days):
        kind = "weekend" if d % 7 >= 5 else "weekday"
        scens = [Scenario("traffic_pattern", {"kind": kind, "seed": seed}),
                 Scenario("arrival_resample", {"seed": seed + 100 + d})]
        rows.append((f"day{d:02d}-{kind}", apply_all(base_env, scens)))
    return rows

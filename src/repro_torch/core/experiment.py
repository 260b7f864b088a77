"""``ExperimentSpec`` and ``run``: one day of the carbon/cost game, hour by hour.

The port of ``repro.core.experiment`` for one env. Each hour does what the
JAX package's ``_day_core`` body does: the registered solver plans, its
fractions become a feasible allocation (``game.fractions_to_ar``), the hour
is simulated (``dcsim.env.step_epoch``), and the monthly peak threads into
the next hour. The metrics stay on the device, and one transfer at the end
builds the result dict of the JAX package's ``run``.

The ``scan`` and ``loop`` engines are one plain hour loop here: the JAX
package compiles the day into one ``lax.scan`` artifact keyed by the spec,
and jit keys have no torch counterpart, so there is no compile cache. Both
engines step the registered technique through one
``schedulers.StatefulScheduler`` from the same initial state, so they give
the same day exactly. What this port does not run
yet raises ``NotImplementedError`` naming its ROADMAP.md item; nothing is
ignored silently.

Key discipline (the port's own; ``jax.random`` keys have no torch
counterpart): ``spec.seed`` seeds a ``numpy.random.SeedSequence`` whose two
children seed two CPU ``torch.Generator``s, one for the solver's initial
state (gt-drl's pretraining) and one that every hour's solver draws from in
turn. Drawing on the host makes a card run and a CPU run of one spec see
the same draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..dcsim import env as E
from . import game
from . import schedulers as SCH
from .draws import generator
from .game import GameContext, fractions_to_ar

_TOTAL_KEYS = ("carbon_kg", "cost_usd", "sla_miss_cost_usd", "violation")

ENGINES = ("scan", "loop", "batched", "month")

# the realized-fault failover policies of ``repro.faults.failover``; the spec
# validates against them, and a non-default one is not run yet (ROADMAP A.8)
FAILOVER_POLICIES = ("renormalize", "spill_nearest", "drop")
DEFAULT_FAILOVER = "renormalize"

@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One evaluation, declaratively: the fields, defaults and validation of
    the JAX package's spec.

    ``engine``: ``"scan"`` and ``"loop"`` run the day (one hour loop here);
    ``"batched"`` and ``"month"`` are validated but not run yet. ``seed``
    seeds the solver's generators (the module docstring says how).
    """
    technique: str = "fd"
    objective: str = "carbon"
    engine: str = "scan"
    routed: bool = False
    hours: int = 24
    days: Optional[int] = None
    seed: int = 0
    seeds: Optional[Tuple[int, ...]] = None
    pretrain: bool = True
    cfg: Any = None                       # solver config (frozen dataclass)
    taps: Optional[Tuple[str, ...]] = None
    failover: str = DEFAULT_FAILOVER
    guard: bool = False
    workload: str = "aibench"             # capability layer the envs came from

    def __post_init__(self):
        if not isinstance(self.workload, str):
            raise ValueError(
                "spec.workload is a capability-layer *name* (the envs "
                "already embed the derived numbers), got "
                f"{type(self.workload).__name__}")
        if self.engine not in ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; known: {ENGINES}")
        if self.objective not in E.OBJECTIVES:
            raise ValueError(f"unknown objective {self.objective!r}; "
                             f"known: {E.OBJECTIVES}")
        if self.failover not in FAILOVER_POLICIES:
            raise ValueError(f"unknown failover policy {self.failover!r}; "
                             f"known: {FAILOVER_POLICIES}")
        if self.seeds is not None and not isinstance(self.seeds, tuple):
            object.__setattr__(self, "seeds", tuple(self.seeds))
        if self.taps is not None and not isinstance(self.taps, tuple):
            object.__setattr__(self, "taps", tuple(self.taps))

    def replace(self, **changes) -> "ExperimentSpec":
        return dataclasses.replace(self, **changes)


def _unported(spec: ExperimentSpec, shard: bool, record: Any, faults: Any) -> Optional[str]:
    """What of ``spec`` (and ``run``'s options) this port does not run yet."""
    if spec.engine in ("batched", "month") or shard:
        return f"engine {spec.engine!r} (shard={shard}): ROADMAP.md A.7"
    if faults is not None or spec.guard or spec.failover != DEFAULT_FAILOVER:
        return "realized faults, failover policies and the finite-guard: ROADMAP.md A.8"
    if spec.taps or record:
        return "telemetry taps and run records: ROADMAP.md A.9"
    return None


def _generators(seed: int) -> Tuple[torch.Generator, torch.Generator]:
    """(initial-state generator, per-hour generator), both from ``seed``."""
    children = np.random.SeedSequence(seed).spawn(2)
    return tuple(generator(int(c.generate_state(1)[0])) for c in children)


def _day_inputs(env, technique, objective, seed, pretrain, cfg, solver_state0=None,
                routed: bool = False):
    """(per-hour generator, initial solver state) of a day. An injected
    ``solver_state0`` skips building the state; the generators are the same."""
    g_init, g_hour = _generators(seed)
    if solver_state0 is not None:
        return g_hour, solver_state0
    t = game.get_technique(technique)
    return g_hour, t.init_state(g_init, env, objective, t.resolve_cfg(cfg), routed, pretrain)


def run(
    spec: ExperimentSpec,
    env: E.EnvParams,
    *,
    peak_state0: Optional[torch.Tensor] = None,
    solver_state0: Any = None,
    solver: Optional[Callable] = None,
    shard: bool = False,
    record: Any = None,
    faults: Any = None,
) -> Dict[str, Any]:
    """Run one day of ``spec`` on ``env``, on the env's device.

    ``peak_state0`` is the monthly peak (W) the day starts from (zeros by
    default). ``solver_state0`` injects the solver's initial carry (scan
    only); ``solver`` injects a prebuilt ``(gen, ctx, peak) -> SolveResult``
    closure (loop only). ``shard``, ``record`` and ``faults`` are the JAX
    package's options; the port does not run them yet and raises.

    Returns ``{"per_epoch": [row per hour], "totals": {...}, "technique",
    "objective"}``, each row the hour's ``step_epoch`` metrics as floats plus
    ``"tau"``, and the totals the hourly sums of ``carbon_kg``, ``cost_usd``,
    ``sla_miss_cost_usd`` and ``violation``.
    """
    game.get_technique(spec.technique)  # fails with the known names
    missing = _unported(spec, shard, record, faults)
    if missing:
        raise NotImplementedError(f"the port does not run {missing}")
    if solver is not None and spec.engine != "loop":
        raise ValueError("a prebuilt solver closure needs engine='loop', "
                         f"got {spec.engine!r}")
    if solver_state0 is not None and spec.engine == "loop":
        raise ValueError("the loop engine derives solver state from the "
                         "seed or a prebuilt solver=; solver_state0 is scan-only")

    device = env.er.device
    if solver is None:
        # both engines step the registered technique from the same carry
        gen, state0 = _day_inputs(env, spec.technique, spec.objective, spec.seed,
                                  spec.pretrain, spec.cfg, solver_state0, spec.routed)
        solver = SCH.StatefulScheduler(spec.technique, state0, spec.cfg).solve_epoch
    else:
        _, gen = _generators(spec.seed)

    peak = (peak_state0 if peak_state0 is not None
            else torch.zeros((E.num_dcs(env),), dtype=env.er.dtype, device=device))
    keys, rows = (), []
    for tau in range(spec.hours):
        ctx = GameContext(env=env, tau=tau, objective=spec.objective, routed=spec.routed)
        res = solver(gen, ctx, peak)
        ar = fractions_to_ar(ctx, res.fractions)
        peak, m = E.step_epoch(env, peak, ar, tau)
        keys = tuple(m)
        rows.append(torch.stack(list(m.values())))
    return _format_day(keys, rows, spec.technique, spec.objective)


def _format_day(keys, rows, technique: str, objective: str) -> Dict[str, Any]:
    """Per-hour metric vectors on the device -> the result dict, by ONE
    transfer to the host."""
    host = torch.stack(rows).cpu().double().tolist() if rows else []
    per_epoch = [{**dict(zip(keys, vals)), "tau": t} for t, vals in enumerate(host)]
    totals = {k: 0.0 for k in _TOTAL_KEYS}
    for row in per_epoch:
        for k in totals:
            totals[k] += row[k]
    return {"per_epoch": per_epoch, "totals": totals, "technique": technique,
            "objective": objective}

"""``ExperimentSpec``, ``run`` and ``sweep``: the one front door to every engine.

The port of ``repro.core.experiment``. Each hour does what the JAX package's
``_day_core`` body does: the registered solver plans, its fractions become a
feasible allocation (``game.fractions_to_ar``), the hour is simulated
(``dcsim.env.step_epoch``), and the monthly peak threads into the next hour.
The metrics stay on the device, and one transfer at the end builds the
result dict of the JAX package's ``run``.

- ``"scan"`` and ``"loop"``: one env, one plain hour loop. The JAX package
  compiles the day into one ``lax.scan`` artifact keyed by the spec; jit
  keys have no torch counterpart, so there is no compile cache (the same
  keys account dispatches, ``obs.cache_stats()``). Both engines step the
  registered technique through one ``schedulers.StatefulScheduler`` from
  the same initial state, so they give the same day exactly.
- ``"batched"``: a fleet of scenario-days. Each hour is ONE
  ``torch.func.vmap`` over the rows (the JAX package's ``jax.vmap`` of the
  day), so a batch launches the kernels of one day, each over all rows.
  Stochastic techniques split their hour into host draws and device
  compute (``game.TechniqueDef``): every row draws from its own generator,
  the draws are stacked and moved to the device once, and the compute runs
  under the vmap.
- ``"month"``: days in a row, the monthly peak and the solver state
  threaded from one day into the next.
- ``sweep``: a grid of scenario-transform parameters expands into one
  stacked env batch that each technique runs through the batched engine;
  ``resume_dir`` runs it in journaled chunks that survive a kill.

Realized faults (``repro_torch.faults``): ``run(spec, envs, faults=trace)``
plans on the unfaulted env and executes each hour against the trace's
realized env under ``spec.failover``, adding ``unserved_demand``,
``failover_moved``, ``degraded_sla_cost_usd`` and the finite-guard's
``fallback_hours`` to the metrics (``guard=True`` adds the guard alone).

Key discipline (the port's own; ``jax.random`` keys have no torch
counterpart): a seed seeds a ``numpy.random.SeedSequence`` whose two
children seed two CPU ``torch.Generator``s, one for the solver's initial
state (gt-drl's pretraining) and one that every hour's solver draws from in
turn. Batched row r draws from the hour generator of ``spec.seeds[r]``, so
it equals the scan day of that seed from the same initial state; month day
d draws from that of ``spec.seed + d``. Drawing on the host makes a card
run and a CPU run of one spec see the same draws.

Telemetry (``repro_torch.obs``): the scan, batched and month engines run
each dispatch under the spec's tap set (``ExperimentSpec.effective_taps``)
and stream the ``engine/hour`` and ``game/nash_residual`` taps, the batched
engine's rows through ``obs.tap_mod.vmap``. The loop engine, as the
reference's, has no tap of its own; its stateful solver keeps the ambient
set it was built under. ``record=`` appends a JSONL record
(``obs.records``).

``shard=True`` splits the batched engine's rows over every local card, as
the reference's ``_sharded_batch`` does over its devices (``_run_batched``).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import faults as FL
from .. import obs
from ..dcsim import env as E
from ..tree import tree_map
from . import game
from . import schedulers as SCH
from .draws import generator, stack_draws
from .game import GameContext, fractions_to_ar

_TOTAL_KEYS = ("carbon_kg", "cost_usd", "sla_miss_cost_usd", "violation")

# degradation metrics: present (and summed into the totals) only on faulted
# or guarded runs; unfaulted results never carry them
_FAULT_KEYS = ("unserved_demand", "failover_moved", "degraded_sla_cost_usd",
               "fallback_hours")

# per-hour physical signals streamed by the "engine/hour" tap
_TAP_HOUR_KEYS = ("carbon_kg", "cost_usd", "sla_miss_cost_usd", "latency_ms",
                  "grid_power_w")

ENGINES = ("scan", "loop", "batched", "month")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One evaluation, declaratively: the fields, defaults and validation of
    the JAX package's spec.

    ``engine``: ``"scan"`` and ``"loop"`` run one env's day (one hour loop
    here); ``"batched"`` a fleet of scenario-days under one vmap a hour,
    row r with ``seeds[r]`` (default ``range(n)``); ``"month"`` days in a
    row from ``seed``, day d's draws from ``seed + d``. ``failover`` is the
    realized-fault policy, consulted only when ``run`` gets ``faults=``;
    ``guard=True`` runs the finite-guard on an unfaulted run too.
    ``taps`` opts the spec into telemetry streams (``repro_torch.obs`` tap
    patterns, e.g. ``("engine/hour", "gt_drl/*")``); ``None`` defers to the
    ambient ``obs.taps(...)`` context (default: everything off).
    """
    technique: str = "fd"
    objective: str = "carbon"
    engine: str = "scan"
    routed: bool = False
    hours: int = 24
    days: Optional[int] = None            # lint: runtime-only(month engine day count: how many times the one hour program runs, not which program)
    seed: int = 0                         # lint: runtime-only(seeds the host torch.Generators the hour draws from; the hour's program is the same for every seed)
    seeds: Optional[Tuple[int, ...]] = None  # lint: runtime-only(batched engine per-row generators: drawn on the host, stacked as vmapped inputs)
    pretrain: bool = True                 # lint: runtime-only(selects the initial solver state passed in at run time; the hour's program is identical)
    cfg: Any = None                       # solver config (frozen dataclass)
    taps: Optional[Tuple[str, ...]] = None
    failover: str = FL.DEFAULT_POLICY
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
        if self.failover not in FL.POLICIES:
            raise ValueError(f"unknown failover policy {self.failover!r}; "
                             f"known: {FL.POLICIES}")
        if self.seeds is not None and not isinstance(self.seeds, tuple):
            object.__setattr__(self, "seeds", tuple(self.seeds))
        if self.taps is not None and not isinstance(self.taps, tuple):
            object.__setattr__(self, "taps", tuple(self.taps))

    def replace(self, **changes) -> "ExperimentSpec":
        return dataclasses.replace(self, **changes)

    def static_key(self) -> Tuple[str, str, int, Any, bool, str, bool, str]:
        """The reference's compile-relevant fields, in its ``_day_core``
        argument order: the engine key's core and the records' ``spec_key``."""
        return (self.technique, self.objective, self.hours, self.cfg,
                self.routed, self.failover, self.guard, self.workload)

    def effective_taps(self) -> frozenset:
        """The tap set this spec's engines run under: the spec's own
        ``taps`` when given, else the ambient ``obs.taps(...)`` state."""
        return obs.active_taps() if self.taps is None else frozenset(self.taps)


def _engine_key(spec: ExperimentSpec, *, shard: bool = False, faulted: bool = False,
                fault_axis: bool = False) -> tuple:
    """The reference's engine key for this spec (the join key of
    ``obs.engine_stat`` and run records): (kind, technique, objective,
    hours, cfg, routed, failover, guard, workload, faulted, fault_axis,
    taps). ``failover`` and ``fault_axis`` are normalized out of unfaulted
    keys, as there."""
    kind = {"scan": "day", "batched": "sharded" if shard else "batched",
            "month": "month"}.get(spec.engine)
    if kind is None:
        raise ValueError(f"engine {spec.engine!r} is not compiled")
    technique, objective, hours, cfg, routed, failover, guard, workload = spec.static_key()
    if not faulted:
        failover = FL.DEFAULT_POLICY
        fault_axis = False
    return (kind, technique, objective, hours, cfg, routed, failover, guard,
            workload, faulted, fault_axis, spec.effective_taps())


def _dispatch(spec: ExperimentSpec, shard: bool = False, faults=None):
    """The obs dispatch span of one engine run: counted and timed under the
    spec's key, run under the spec's tap set."""
    return obs.spans.dispatch(_engine_key(spec, shard=shard, faulted=faults is not None,
                                          fault_axis=_trace_stacked(faults)))


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


def _totals_keys(present) -> Tuple[str, ...]:
    """The invariant ``_TOTAL_KEYS`` plus the degradation metrics the run
    emitted (faulted or guarded runs only)."""
    return _TOTAL_KEYS + tuple(k for k in _FAULT_KEYS if k in present)


def _trace_stacked(faults) -> bool:
    """Does this FaultTrace carry a leading env-batch axis (one realized
    trace per env row)? (n, D, 24) against (D, 24) ``avail_mult``."""
    return faults is not None and faults.avail_mult.ndim == 3


# ---------------------------------------------------------------------------
# one hour: plan -> (guard) -> feasible allocation -> simulated epoch
# ---------------------------------------------------------------------------

def _execute(spec: ExperimentSpec, ctx: GameContext, fractions: torch.Tensor,
             peak: torch.Tensor, trace) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The hour after the plan: the Nash-residual tap, the finite-guard
    (faulted or ``guard=True``), the feasible allocation, the simulated
    epoch (on the realized env under a trace) and the ``engine/hour`` tap."""
    game.tap_nash_residual(ctx, fractions, peak)
    guard = spec.guard or trace is not None
    if guard:
        fractions, fell_back = FL.guard_fractions(ctx.env, ctx.tau, fractions)
    ar = fractions_to_ar(ctx, fractions)
    if trace is None:
        peak, m = E.step_epoch(ctx.env, peak, ar, ctx.tau)
    else:
        peak, m = FL.execute_hour(ctx.env, trace, peak, ar, ctx.tau, spec.failover)
    if guard:
        m = {**m, "fallback_hours": fell_back}
    obs.tap("engine/hour", thunk=lambda: {
        "tau": ctx.tau, **{k: m[k] for k in _TAP_HOUR_KEYS + _FAULT_KEYS if k in m}})
    return peak, m


def _hours(spec: ExperimentSpec, env, solver: Callable, gen, peak, trace):
    """One env's day, hour by hour: (final peak, metric keys, one stacked
    metric vector per hour, on the device)."""
    keys, rows = (), []
    for tau in range(spec.hours):
        ctx = GameContext(env=env, tau=tau, objective=spec.objective, routed=spec.routed)
        res = solver(gen, ctx, peak)
        peak, m = _execute(spec, ctx, res.fractions, peak, trace)
        keys = tuple(m)
        rows.append(torch.stack(list(m.values())))
    return peak, keys, rows


# ---------------------------------------------------------------------------
# the façade
# ---------------------------------------------------------------------------

def run(
    spec: ExperimentSpec,
    envs,
    *,
    peak_state0: Optional[torch.Tensor] = None,
    solver_state0: Any = None,
    solver: Optional[Callable] = None,
    shard: bool = False,
    record: Any = None,
    faults: Any = None,
) -> Dict[str, Any]:
    """Run one experiment on the envs' device. ``envs`` is one EnvParams for
    the scan/loop engines, one or many (a list or a stacked EnvParams) for
    batched, and one (tiled to ``spec.days``, 30 by default), a list or a
    stacked EnvParams of per-day envs for month.

    ``peak_state0`` is the monthly peak (W) the run starts from (zeros by
    default; the batched engine always starts from zeros).
    ``solver_state0`` injects the solver's initial carry (deployed gt-drl
    agents; not on the loop engine); ``solver`` injects a prebuilt
    ``(gen, ctx, peak) -> SolveResult`` closure (loop only). ``shard=True``
    (batched only) splits the rows over every local card (one card: the
    unsharded program). ``faults`` (a ``FaultTrace``,
    or on the batched engine a stacked one, a row each) executes every hour
    against the realized env under ``spec.failover``. ``record`` (True, or
    a JSONL path) appends a spec-keyed run record (``repro_torch.obs.records``;
    ``runs/torch_records.jsonl`` by default).

    scan/loop return ``{"per_epoch": [row per hour], "totals": {...},
    "technique", "objective"}``, each row the hour's metrics as floats plus
    ``"tau"``. batched returns ``{"totals": {k: (n,)}, "per_epoch": {k:
    (n, hours)}, "seeds", ...}`` as numpy arrays; month ``{"per_day": {k:
    (days, hours)}, "day_totals", "totals", "peak_w": (days, D),
    "final_peak_w", "days", ...}``.
    """
    game.get_technique(spec.technique)  # fails with the known names
    if shard and spec.engine != "batched":
        raise ValueError(f"shard=True needs engine='batched', got {spec.engine!r}")
    if shard and spec.effective_taps():
        raise ValueError("the sharded engine streams no taps (as the reference's "
                         "shard_map engine); run shard=False when tapping")
    if solver is not None and spec.engine != "loop":
        raise ValueError("a prebuilt solver closure needs engine='loop', "
                         f"got {spec.engine!r}")
    if peak_state0 is not None and spec.engine == "batched":
        raise ValueError("the batched engine starts every scenario-day from "
                         "a zero peak; peak_state0 is not supported")
    if solver_state0 is not None and spec.engine == "loop":
        raise ValueError("the loop engine derives solver state from the seed or a "
                         "prebuilt solver=; solver_state0 is scan-only among the day "
                         "engines (batched and month take it too)")
    if faults is not None and spec.engine == "month":
        raise ValueError("the month engine does not take realized faults "
                         "(a FaultTrace describes one day); run faulted "
                         "days through scan/loop/batched")
    if _trace_stacked(faults) and spec.engine != "batched":
        raise ValueError("a stacked (per-point) FaultTrace needs engine='batched', "
                         f"got {spec.engine!r}; the scan/loop engines evaluate one "
                         "env against one trace")
    if spec.engine in ("scan", "loop"):
        result = _run_day(spec, envs, peak_state0, solver_state0, solver, faults)
    elif spec.engine == "batched":
        result = _run_batched(spec, envs, solver_state0, shard, faults)
    else:
        result = _run_month(spec, envs, peak_state0, solver_state0)
    if record:
        _record_run(spec, result, record, shard=shard, faults=faults, device=_device_of(envs))
    return result


def _device_of(envs) -> torch.device:
    """The device of one env, a list of envs (or ``(name, env)`` rows) or a
    stacked EnvParams."""
    first = envs if isinstance(envs, E.EnvParams) else envs[0]
    return (first if isinstance(first, E.EnvParams) else first[1]).er.device


def _record_run(spec: ExperimentSpec, result: Dict[str, Any], path: Any, *, shard: bool,
                faults, device) -> str:
    """Append one JSONL record of a finished ``run`` result (to ``path``, or
    the default file when ``path`` is True)."""
    engine_spans = (None if spec.engine == "loop"
                    else obs.engine_stat(_engine_key(spec, shard=shard, faulted=faults is not None,
                                                     fault_axis=_trace_stacked(faults))))
    rec = obs.make_record(spec, result, engine_spans=engine_spans, device=device)
    return obs.write_record(rec, path if isinstance(path, str) else None)


def _run_day(spec, env, peak_state0, solver_state0, solver, faults):
    """The scan and loop engines: both step the registered technique from
    the same carry, or the prebuilt ``solver`` (loop). The scan day runs in
    the obs dispatch span, its scheduler built under the spec's tap set; the
    loop day has no tap of its own (its scheduler keeps the ambient set)."""
    peak = (peak_state0 if peak_state0 is not None
            else torch.zeros((E.num_dcs(env),), dtype=env.er.dtype, device=env.er.device))
    if solver is None:
        gen, state0 = _day_inputs(env, spec.technique, spec.objective, spec.seed,
                                  spec.pretrain, spec.cfg, solver_state0, spec.routed)
    else:
        _, gen = _generators(spec.seed)
    if spec.engine == "scan":
        with _dispatch(spec, faults=faults):
            solver = SCH.StatefulScheduler(spec.technique, state0, spec.cfg).solve_epoch
            _, keys, rows = _hours(spec, env, solver, gen, peak, faults)
            return _format_day(keys, rows, spec.technique, spec.objective)
    if solver is None:
        solver = SCH.StatefulScheduler(spec.technique, state0, spec.cfg).solve_epoch
    with obs.tracing(frozenset()):
        _, keys, rows = _hours(spec, env, solver, gen, peak, faults)
    return _format_day(keys, rows, spec.technique, spec.objective)


def _format_day(keys, rows, technique: str, objective: str) -> Dict[str, Any]:
    """Per-hour metric vectors on the device -> the result dict, by ONE
    transfer to the host."""
    host = torch.stack(rows).cpu().double().tolist() if rows else []
    per_epoch = [{**dict(zip(keys, vals)), "tau": t} for t, vals in enumerate(host)]
    totals = {k: 0.0 for k in _totals_keys(keys)}
    for row in per_epoch:
        for k in totals:
            totals[k] += row[k]
    return {"per_epoch": per_epoch, "totals": totals, "technique": technique,
            "objective": objective}


def _rows_of(envs) -> Tuple[E.EnvParams, E.EnvParams, int]:
    """(stacked envs, the first env, n) from one env, a list of envs (or of
    ``(name, env)`` rows) or an already stacked EnvParams."""
    if isinstance(envs, E.EnvParams) and envs.er.ndim == 2:
        envs = [envs]
    if isinstance(envs, E.EnvParams):
        return envs, E.EnvParams(*(x[0] for x in envs)), int(envs.er.shape[0])
    envs = [e if isinstance(e, E.EnvParams) else e[1] for e in envs]
    return E.stack_envs(envs), envs[0], len(envs)


def _by_key(keys, stacked: torch.Tensor) -> Dict[str, np.ndarray]:
    """(n, hours, K) metrics on the device -> {key: (n, hours) float32}, by
    one transfer."""
    host = stacked.cpu().numpy()
    return {k: np.ascontiguousarray(host[:, :, j]) for j, k in enumerate(keys)}


def local_devices(env0: E.EnvParams) -> List[torch.device]:
    """The devices ``shard=True`` splits the rows over: every local card for
    envs on a card, the envs' own device otherwise."""
    dev = env0.er.device
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _to(tree, device):
    return tree_map(lambda x: x.to(device) if torch.is_tensor(x) else x, tree)


def _rows(tree, lo: int, hi: int, device):
    return tree_map(lambda x: x[lo:hi].to(device), tree)


def _pad_rows(tree, n: int):
    """A stacked tree padded to ``n`` rows by repeating its last row."""
    return tree_map(lambda x: torch.cat([x, x[-1:].expand((n - x.shape[0],) + x.shape[1:])]),
                    tree)


def _batched_hour(spec: ExperimentSpec, compute: Callable, cfg, tau: int, keys: List[str],
                  env, peak, state, draws, trace):
    """One row's hour under the batched engine's ``vmap``: the technique's
    device half (``compute``) on the row's draws, then ``_execute``.
    ``keys`` receives the metric keys; returns (peak, state, metrics)."""
    ctx = GameContext(env=env, tau=tau, objective=spec.objective, routed=spec.routed)
    state, res = compute(draws, state, ctx, peak, cfg)
    peak, m = _execute(spec, ctx, res.fractions, peak, trace)
    keys[:] = list(m)
    return peak, state, torch.stack(list(m.values()))


def _run_batched(spec, envs, solver_state0, shard, faults=None, devices=None):
    """The batched engine: one ``vmap`` a hour over the rows. ``shard=True``
    splits the rows over ``devices`` (every local card by default), as the
    reference's ``_sharded_batch``: the rows are padded to a multiple of the
    device count with copies of the last (its seed's generator drawn anew),
    each device runs the vmapped hour on its slice, no collective joins them,
    and the padded rows' metrics are dropped. On one device it is the
    unsharded program."""
    env_b, env0, n = _rows_of(envs)
    seeds = list(range(n)) if spec.seeds is None else list(spec.seeds)
    if len(seeds) != n:
        raise ValueError(f"{len(seeds)} seeds for {n} scenario-days")
    stacked = _trace_stacked(faults)  # per-row traces vs one shared trace
    if stacked and int(faults.avail_mult.shape[0]) != n:
        raise ValueError(f"stacked FaultTrace has {int(faults.avail_mult.shape[0])} rows "
                         f"for {n} scenario-days")
    devices = ([env0.er.device] if not shard else
               [torch.device(d) for d in (devices or local_devices(env0))])

    # deploy once, on the first seed's initial-state generator; every row
    # then draws from its own seed's per-hour generator
    _, state0 = _day_inputs(env0, spec.technique, spec.objective, seeds[0], spec.pretrain,
                            spec.cfg, solver_state0, spec.routed)
    gens = [_generators(s)[1] for s in seeds]
    pad = (-n) % len(devices)
    if pad:
        env_b = E.pad_env_batch(env_b, n + pad)
        gens += [_generators(seeds[-1])[1] for _ in range(pad)]
        faults = _pad_rows(faults, n + pad) if stacked else faults
    per = (n + pad) // len(devices)
    t = game.get_technique(spec.technique)
    cfg = t.resolve_cfg(spec.cfg)
    draw, compute = t.split()
    shards = []  # (device, env rows, peak, state, state's vmap dim, generators, trace, rows)
    for i, dev in enumerate(devices):
        lo, hi = i * per, (i + 1) * per
        shards.append([dev, _rows(env_b, lo, hi, dev),
                       torch.zeros((per, E.num_dcs(env0)), dtype=env0.er.dtype, device=dev),
                       _to(state0, dev), None, gens[lo:hi],
                       (_rows(faults, lo, hi, dev) if stacked else _to(faults, dev)), []])
    keys = []
    with _dispatch(spec, shard, faults):
        for tau in range(spec.hours):
            for sh in shards:
                dev, env_s, peak, state, state_dim, sgens, trace, rows = sh
                draws = None
                if draw is not None:
                    ctx0 = GameContext(env=env0, tau=tau, objective=spec.objective,
                                       routed=spec.routed)
                    draws = stack_draws([draw(g, ctx0, cfg, "cpu") for g in sgens], dev)

                hour = functools.partial(_batched_hour, spec, compute, cfg, tau, keys)
                # the rows' live taps leave the vmap as outputs, a row each
                in_dims = (0, 0, state_dim, None if draws is None else 0,
                           0 if stacked else None)
                sh[2], sh[3], row = obs.tap_mod.vmap(hour, in_dims=in_dims)(
                    env_s, peak, state, draws, trace)
                sh[4] = 0  # the deployed state is shared until hour 0
                rows.append(row)
        metrics = [torch.stack(sh[7], dim=1) for sh in shards]  # (per, hours, K) each
        metrics = metrics[0] if len(metrics) == 1 else torch.cat([m.cpu() for m in metrics])
        out = _by_key(keys, metrics[:n])  # (n, hours) each
    totals = {k: out[k].sum(axis=1) for k in _totals_keys(out)}
    return {"totals": totals, "per_epoch": out, "technique": spec.technique,
            "objective": spec.objective, "seeds": seeds}


def _run_month(spec, envs, peak_state0, solver_state0):
    days = spec.days
    if isinstance(envs, E.EnvParams) and envs.er.ndim == 2:
        envs = E.tile_env(envs, 30 if days is None else int(days))
    env_days, env0, n = _rows_of(envs)
    if days is not None and int(days) != n:
        raise ValueError(f"days={days} but {n} per-day envs were given")

    _, state0 = _day_inputs(env0, spec.technique, spec.objective, spec.seed, spec.pretrain,
                            spec.cfg, solver_state0, spec.routed)
    peak = (peak_state0 if peak_state0 is not None
            else torch.zeros((E.num_dcs(env0),), dtype=env0.er.dtype, device=env0.er.device))
    peaks, day_rows = [], []
    with _dispatch(spec):
        sched = SCH.StatefulScheduler(spec.technique, state0, spec.cfg)
        for d in range(n):
            env = E.EnvParams(*(x[d] for x in env_days))
            _, gen = _generators(spec.seed + d)
            peak, keys, rows = _hours(spec, env, sched.solve_epoch, gen, peak, None)
            day_rows.append(torch.stack(rows))
            peaks.append(peak)
        per_day = _by_key(keys, torch.stack(day_rows))  # (days, hours) each
        peak_w, final_peak_w = torch.stack(peaks).cpu().numpy(), peak.cpu().numpy()
    day_totals = {k: per_day[k].sum(axis=1) for k in _TOTAL_KEYS}
    return {"per_day": per_day, "day_totals": day_totals,
            "totals": {k: float(day_totals[k].sum()) for k in _TOTAL_KEYS},
            "peak_w": peak_w, "final_peak_w": final_peak_w,
            "days": n, "technique": spec.technique, "objective": spec.objective}


# ---------------------------------------------------------------------------
# severity sweeps: parameter grids -> stacked envs -> per-point curves
# ---------------------------------------------------------------------------

def sweep(
    spec: ExperimentSpec,
    grid: Mapping[str, Sequence[Any]],
    *,
    base_env: Optional[E.EnvParams] = None,
    techniques: Optional[Sequence[str]] = None,
    base_scenarios: Sequence[Any] = (),
    cfg_overrides: Optional[Mapping[str, Any]] = None,
    shard: bool = False,
    record: Any = None,
    faults: Any = None,
    resume_dir: Optional[str] = None,
    chunk_points: Optional[int] = None,
    max_retries: int = 2,
    backoff_s: float = 0.25,
    point_timeout_s: Optional[float] = None,
) -> Dict[str, Any]:
    """Severity sweep: the cartesian ``grid`` of scenario-transform
    parameters expands into one stacked env batch, and every technique runs
    through the batched engine over all grid points.

    ``grid`` maps a registered transform name to a sequence of points — a
    params dict, or a bare scalar for the transform's declared severity knob.
    ``base_scenarios`` apply to ``base_env`` (``build_env(4, seed=0)`` on the
    card by default) before every grid point. Every point runs with
    ``spec.seed``'s generators, so severity is the only variable along a
    curve. ``cfg_overrides`` maps technique -> solver config; ``spec.cfg``
    covers ``spec.technique``. ``faults`` executes every point under
    ``spec.failover``: one ``FaultTrace`` shared by every point, a sequence
    of traces (one per point) or an already stacked trace.

    ``resume_dir`` runs the grid in chunks of ``chunk_points`` points
    (default 1) per technique, each completed chunk journaled atomically
    under ``resume_dir`` (``faults.SweepJournal``); a rerun after a kill
    computes only the missing chunks. A raising chunk is retried up to
    ``max_retries`` times with backoff ``backoff_s * 2**k``;
    ``point_timeout_s`` bounds each chunk's wall time. The result then has
    a ``"resume"`` block (chunks restored and computed, retries,
    stragglers). ``record`` (True, or a JSONL path) appends one record per
    technique, each grid point's totals forming its curve along the labels.

    Returns ``{"points", "labels", "results": {technique: {"totals": {k:
    (P,)}, "per_epoch": {k: (P, hours)}}}, ...}``.
    """
    from .. import scenarios as S

    base_env = base_env if base_env is not None else E.build_env(4, seed=0)
    points, rows = S.build_grid(base_env, grid, base=base_scenarios)
    labels = [lbl for lbl, _ in rows]
    envs = [env for _, env in rows]
    n = len(rows)
    techniques = tuple(techniques) if techniques else (spec.technique,)
    overrides = dict(cfg_overrides or {})

    if faults is not None and not isinstance(faults, FL.FaultTrace):
        faults = FL.stack_traces(faults)  # sequence: one trace per point
    if _trace_stacked(faults) and int(faults.avail_mult.shape[0]) != n:
        raise ValueError(f"per-point faults: {int(faults.avail_mult.shape[0])} traces "
                         f"for {n} grid points")

    def point_spec(t, n_pts):
        cfg = overrides.get(t, spec.cfg if t == spec.technique else None)
        return spec.replace(technique=t, cfg=cfg, engine="batched", seeds=(spec.seed,) * n_pts)

    if resume_dir is not None:
        results, resume_meta = _sweep_resumable(
            point_spec, envs, techniques, labels, faults=faults, shard=shard,
            resume_dir=resume_dir, chunk_points=chunk_points or 1, max_retries=max_retries,
            backoff_s=backoff_s, point_timeout_s=point_timeout_s)
    else:
        resume_meta = None
        env_b = E.stack_envs(envs)
        results = {}
        for t in techniques:
            res = _run_batched(point_spec(t, n), env_b, None, shard, faults)
            results[t] = {"totals": res["totals"], "per_epoch": res["per_epoch"]}
    if record:
        for t in techniques:
            # one record per technique: each grid point's daily totals form
            # the "curve" along the sweep's label axis
            pspec = point_spec(t, n)
            rec = obs.make_record(
                pspec, {**results[t], "technique": t, "objective": spec.objective},
                kind="sweep",
                curves={k: np.asarray(v, dtype=float).tolist()
                        for k, v in results[t]["totals"].items()},
                engine_spans=obs.engine_stat(_engine_key(
                    pspec, shard=shard, faulted=faults is not None,
                    fault_axis=_trace_stacked(faults))),
                extra={"labels": labels,
                       "grid": {name: list(pts) for name, pts in grid.items()}},
                device=base_env.er.device)
            obs.write_record(rec, record if isinstance(record, str) else None)
    out = {"grid": {name: list(pts) for name, pts in grid.items()},
           "points": points, "labels": labels, "results": results,
           "objective": spec.objective, "hours": spec.hours,
           "routed": spec.routed, "techniques": list(techniques)}
    if resume_meta is not None:
        out["resume"] = resume_meta
    return out


def _sweep_resumable(point_spec, envs, techniques, labels, *, faults, shard, resume_dir,
                     chunk_points, max_retries, backoff_s, point_timeout_s):
    """The journaled chunk-at-a-time sweep (see ``sweep``'s docstring).

    Plan: techniques in order, each technique's grid points in chunks of
    ``chunk_points``; the global chunk index is the journal step. Chunks
    run strictly in order, so the journal is always a prefix of the plan
    and ``SweepJournal.next_step()`` is the resume frontier. The supervisor
    is ``distributed.fault_tolerance.run_with_retries``;
    ``HeartbeatMonitor`` turns per-chunk wall times into straggler reports.
    """
    from ..distributed import fault_tolerance as FT

    n = len(envs)
    chunks = [(start, min(start + chunk_points, n)) for start in range(0, n, chunk_points)]
    plan = [(t, start, end) for t in techniques for start, end in chunks]
    sig_spec = point_spec(techniques[0], 1)
    stacked = _trace_stacked(faults)
    sig = hashlib.sha256(repr((
        tuple(labels), tuple(techniques), chunk_points,
        sig_spec.objective, sig_spec.hours, sig_spec.routed,
        sig_spec.failover, sig_spec.guard, sig_spec.seed,
        sig_spec.workload, faults is not None, stacked,
    )).encode()).hexdigest()[:16]
    journal = FL.SweepJournal(resume_dir, sig)
    monitor = FT.HeartbeatMonitor(num_workers=len(plan), window=max(len(plan), 1))
    device = envs[0].er.device

    restored_steps = [s for s in journal.completed_steps() if s < len(plan)]
    computed_steps: List[int] = []
    pending: Dict[int, Dict[str, Any]] = {}

    def step_fn(step):
        FL.check_kill_switch()
        t, start, end = plan[step]
        pspec = point_spec(t, end - start)
        env_b = E.stack_envs(envs[start:end])
        chunk_faults = (FL.FaultTrace(*(x[start:end] for x in faults)) if stacked
                        else faults)
        t0 = time.perf_counter()
        res = FL.call_with_timeout(
            lambda: _run_batched(pspec, env_b, None, shard, chunk_faults),
            point_timeout_s, label=f"chunk {step} ({t}[{start}:{end}])")
        monitor.record(step, time.perf_counter() - t0)
        pending[step] = {"totals": dict(res["totals"]), "per_epoch": dict(res["per_epoch"])}
        computed_steps.append(step)

    def save_fn(step_after):
        step = step_after - 1
        if step in pending:  # journal the chunk that just completed
            if device.type == "cuda":
                # a chunk abandoned by its timeout may still have work queued
                torch.cuda.synchronize(device)
            t, start, end = plan[step]
            journal.mark(step, pending.pop(step),
                         meta={"technique": t, "start": start, "end": end})

    events = FT.run_with_retries(
        step_fn, total_steps=len(plan), save_every=1, save_fn=save_fn,
        restore_fn=journal.next_step,
        policy=FT.FailurePolicy(max_restarts=max_retries, elastic=False),
        retry_on=(Exception,), backoff_s=backoff_s)

    results: Dict[str, Dict[str, Any]] = {}
    for step, (t, start, end) in enumerate(plan):
        part = journal.load(step)
        node = results.setdefault(t, {"totals": {}, "per_epoch": {}})
        for sect in ("totals", "per_epoch"):
            for k, v in part[sect].items():
                node[sect].setdefault(k, []).append(np.asarray(v))
    for t in results:
        for sect in ("totals", "per_epoch"):
            results[t][sect] = {k: np.concatenate(v) for k, v in results[t][sect].items()}
    meta = {"journal": resume_dir, "signature": sig, "chunks": len(plan),
            "chunk_points": chunk_points, "restored": len(restored_steps),
            "computed": len(computed_steps), "retries": events["restarts"],
            "stragglers": [{"chunk": s.worker, "ratio": float(s.ratio)}
                           for s in monitor.stragglers()]}
    return results, meta

"""The paper's six technique registrations and the evaluation entry points.

The port of the technique part of ``repro.core.schedulers``. Every technique
exposes ``step(gen, state, ctx, peak_state, cfg) -> (state, SolveResult)``
through the registry in ``core.game``; ``gen`` is a CPU ``torch.Generator``
from which the solver draws (``core.draws``). gt-drl is stateful: its
deployed agents thread from hour to hour.

``run_day``, ``run_day_scan``, ``run_days_batched`` and ``run_month`` are
shims over ``ExperimentSpec``; ``compare_techniques`` is the paper's table
protocol, on the batched engine by default; ``record=`` writes one run
record per technique (``repro_torch.obs``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..dcsim import env as E
from . import ddpg, force_directed, game, genetic, gt_drl, nash, ppo_joint
from .draws import generator
from .game import GameContext, SolveResult

TECHNIQUES = ("fd", "ga", "nash", "ddpg", "ppo", "gt-drl")  # the paper's six

_MODS = {"fd": (force_directed, force_directed.FDConfig()),
         "ga": (genetic, genetic.GAConfig()),
         "nash": (nash, nash.NashConfig()),
         "ddpg": (ddpg, ddpg.DDPGConfig()),
         "ppo": (ppo_joint, ppo_joint.JointPPOConfig())}

# the stochastic solvers also register their hour split into draws and
# compute (``game.TechniqueDef``), which the batched engine runs
for _name, (_mod, _cfg) in _MODS.items():
    game.register_technique(_name, _mod.solve_epoch, default_cfg=_cfg,
                            draw=getattr(_mod, "draw_epoch", None),
                            compute=getattr(_mod, "solve_drawn", None))
game.register_technique(
    "gt-drl", step=gt_drl.solve_epoch, default_cfg=gt_drl.GTDRLConfig(),
    init_state=lambda gen, env, objective, cfg, routed, pretrain:
        gt_drl.deploy(gen, env, objective, cfg, routed, pretrain),
    stateful=True, draw=gt_drl.draw_epoch, compute=gt_drl.solve_drawn)


class StatefulScheduler:
    """Stateful wrapper for the loop engine: holds the solver carry (e.g.
    per-player agents) across epochs, advancing it each ``solve_epoch``.

    The obs tap set active at construction is pinned for the scheduler's
    lifetime (the ambient set on the loop engine, the spec's on the
    engines that build it inside their dispatch), as in the reference."""

    def __init__(self, name: str, state0, cfg=None):
        t = game.get_technique(name)
        self.state = state0
        self._step = t.step
        self._cfg = t.resolve_cfg(cfg)
        self._taps = obs.active_taps()

    def solve_epoch(self, gen, ctx: GameContext, peak_state) -> SolveResult:
        with obs.tracing(self._taps):
            self.state, res = self._step(gen, self.state, ctx, peak_state, self._cfg)
        return res


class GTDRLScheduler(StatefulScheduler):
    """Holds (pre)trained per-player agents across epochs. ``agents``
    injects a deployed snapshot; otherwise ``pretrain_gen`` pretrains, else
    fresh agents."""

    def __init__(self, env: E.EnvParams, objective: str,
                 cfg: Optional[gt_drl.GTDRLConfig] = None, pretrain_gen=None, agents=None,
                 routed: bool = False):
        if agents is None:
            agents = gt_drl.deploy(pretrain_gen, env, objective, cfg, routed,
                                   pretrain_agents=pretrain_gen is not None)
        super().__init__("gt-drl", agents, cfg)

    @property
    def agents(self):
        return self.state

    @agents.setter
    def agents(self, value):
        self.state = value


def get_scheduler(name: str, env: E.EnvParams, objective: str,
                  pretrain_gen=None, routed: bool = False, **overrides) -> Callable:
    """Returns solve_epoch(gen, ctx, peak_state) -> SolveResult. ``routed``
    sizes stateful solvers' carries for the (S, I, D) routing game."""
    t = game.get_technique(name)
    if t.step is gt_drl.solve_epoch:
        return GTDRLScheduler(env, objective, overrides.get("cfg"), pretrain_gen,
                              overrides.get("agents"), routed).solve_epoch
    cfg = t.resolve_cfg(overrides.get("cfg"))
    if t.stateful:
        state0 = overrides.get("state0")
        if state0 is None:
            state0 = t.init_state(pretrain_gen if pretrain_gen is not None else generator(0),
                                  env, objective, cfg, routed, pretrain_gen is not None)
        return StatefulScheduler(name, state0, cfg).solve_epoch
    step = t.step

    def solve(gen, ctx, peak_state):
        return step(gen, (), ctx, peak_state, cfg)[1]
    return solve


# ---------------------------------------------------------------------------
# legacy entry points: thin shims over ExperimentSpec
# ---------------------------------------------------------------------------

def _spec(technique, objective, engine, **kw):
    from . import experiment
    return experiment.ExperimentSpec(technique=technique, objective=objective,
                                     engine=engine, **kw)


def run_day_scan(env: E.EnvParams, technique: str, objective: str = "carbon", *,
                 seed: int = 0, hours: int = 24, pretrain: bool = True,
                 peak_state0: Optional[torch.Tensor] = None, cfg_override: Any = None,
                 solver_state0: Any = None, routed: bool = False) -> Dict[str, Any]:
    """One technique through a day: ``run(spec, env)`` with engine="scan"."""
    from . import experiment
    spec = _spec(technique, objective, "scan", seed=seed, hours=hours,
                 pretrain=pretrain, cfg=cfg_override, routed=routed)
    return experiment.run(spec, env, peak_state0=peak_state0, solver_state0=solver_state0)


def run_days_batched(envs, technique: str, objective: str = "carbon", *,
                     seeds: Optional[Sequence[int]] = None, hours: int = 24,
                     pretrain: bool = True, cfg_override: Any = None,
                     solver_state0: Any = None, routed: bool = False,
                     shard: bool = False) -> Dict[str, Any]:
    """A fleet of scenario-days, one vmap over the rows a hour:
    ``run(spec, envs)`` with engine="batched"."""
    from . import experiment
    spec = _spec(technique, objective, "batched", hours=hours, pretrain=pretrain,
                 cfg=cfg_override, routed=routed,
                 seeds=None if seeds is None else tuple(seeds))
    return experiment.run(spec, envs, solver_state0=solver_state0, shard=shard)


def run_month(envs, technique: str, objective: str = "carbon", *,
              days: Optional[int] = None, seed: int = 0, hours: int = 24,
              pretrain: bool = True, peak_state0: Optional[torch.Tensor] = None,
              cfg_override: Any = None, solver_state0: Any = None,
              routed: bool = False) -> Dict[str, Any]:
    """Days in a row, the monthly peak and the solver state threaded:
    ``run(spec, envs)`` with engine="month"."""
    from . import experiment
    spec = _spec(technique, objective, "month", days=days, seed=seed, hours=hours,
                 pretrain=pretrain, cfg=cfg_override, routed=routed)
    return experiment.run(spec, envs, peak_state0=peak_state0, solver_state0=solver_state0)


def run_day(env: E.EnvParams, technique: str, objective: str = "carbon", *,
            seed: int = 0, hours: int = 24, pretrain: bool = True,
            peak_state0: Optional[torch.Tensor] = None, cfg_override: Any = None,
            solver: Optional[Callable] = None, solver_state0: Any = None,
            engine: str = "scan", routed: bool = False) -> Dict[str, Any]:
    """Run one technique through a day. A prebuilt ``solver`` forces the
    loop engine (the closure may carry state across calls and runs)."""
    from . import experiment
    if engine not in ("scan", "loop"):
        raise ValueError(f"unknown engine {engine!r}; known: scan, loop")
    if solver is None and engine == "scan":
        return run_day_scan(env, technique, objective, seed=seed, hours=hours,
                            pretrain=pretrain, peak_state0=peak_state0,
                            cfg_override=cfg_override, solver_state0=solver_state0,
                            routed=routed)
    spec = _spec(technique, objective, "loop", seed=seed, hours=hours,
                 pretrain=pretrain, cfg=cfg_override, routed=routed)
    return experiment.run(spec, env, peak_state0=peak_state0, solver=solver)


def _stats(vals, curves) -> Dict[str, Any]:
    """mean ± stderr of daily totals + the mean per-epoch curve. A single
    run reports stderr 0.0 (the ddof=1 std of one value is NaN)."""
    vals = np.asarray(vals, dtype=float)
    curves = np.asarray(curves, dtype=float)
    n = vals.shape[0]
    return {
        "mean": float(vals.mean()),
        "stderr": float(vals.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0,
        "curve_mean": curves.mean(axis=0).tolist(),
    }


def compare_techniques(envs, techniques=TECHNIQUES, objective: str = "carbon", *,
                       hours: int = 24, seed0: int = 0, engine: str = "batched",
                       cfg_overrides: Optional[Dict[str, Any]] = None, routed: bool = False,
                       shard: bool = False, record: Any = None) -> Dict[str, Dict[str, Any]]:
    """The paper's protocol: one day per env (one env per resampled arrival
    pattern), mean ± stderr of the daily totals. The ranked metric is daily
    carbon under ``objective="carbon"`` and daily total cost otherwise.

    ``engine="batched"`` (default) runs every technique once over all the
    envs through ``run_days_batched`` (one vmap over the envs a hour;
    ``shard`` as there). ``engine="loop"`` plays each env's day on the hour
    loop, the parity reference. Both deploy each stateful technique once,
    from ``generator(seed0 + 999)`` on the first env, and start every day
    from that snapshot; env r's day runs with seed ``seed0 + r``, so the two
    engines agree within float32 summation order. ``cfg_overrides`` maps
    technique -> config.

    ``record`` (True, or a JSONL path) appends one record per technique: the
    ranked mean ± stderr, its mean curve, and the batched engine's dispatch
    spans (``repro_torch.obs``).
    """
    if isinstance(envs, E.EnvParams):
        envs = [envs]
    envs = list(envs)
    if engine not in ("batched", "loop"):
        raise ValueError(f"unknown engine {engine!r}; known: batched, loop")
    overrides = dict(cfg_overrides or {})
    metric = "carbon_kg" if objective == "carbon" else "cost_usd"
    seeds = [seed0 + r for r in range(len(envs))]
    env_b = E.stack_envs(envs) if engine == "batched" else None
    out: Dict[str, Dict[str, Any]] = {}
    for t in techniques:
        tdef = game.get_technique(t)
        cfg = overrides.get(t)
        state0 = (tdef.init_state(generator(seed0 + 999), envs[0], objective,
                                  tdef.resolve_cfg(cfg), routed, True)
                  if tdef.stateful else None)
        if engine == "batched":
            res = run_days_batched(env_b, t, objective, seeds=seeds, hours=hours,
                                   cfg_override=cfg, solver_state0=state0, routed=routed,
                                   shard=shard)
            out[t] = _stats(res["totals"][metric], res["per_epoch"][metric])
            continue
        solver = None if tdef.stateful else get_scheduler(
            t, envs[0], objective, **({"cfg": cfg} if cfg is not None else {}))
        vals, curves = [], []
        for r, env in enumerate(envs):
            s = StatefulScheduler(t, state0, cfg).solve_epoch if tdef.stateful else solver
            res = run_day(env, t, objective, seed=seeds[r], hours=hours, solver=s,
                          engine="loop", routed=routed)
            vals.append(res["totals"][metric])
            curves.append([e[metric] for e in res["per_epoch"]])
        out[t] = _stats(vals, curves)
    if record:
        from . import experiment as X
        for t in techniques:
            # one record a technique: the ranked mean ± stderr and mean curve
            spec = X.ExperimentSpec(technique=t, objective=objective, engine=engine,
                                    routed=routed, hours=hours, cfg=overrides.get(t))
            spans = None if engine == "loop" else obs.engine_stat(X._engine_key(spec, shard=shard))
            rec = obs.make_record(
                spec, kind="compare", curves={metric: out[t]["curve_mean"]}, engine_spans=spans,
                extra={"metric": metric, "mean": out[t]["mean"], "stderr": out[t]["stderr"],
                       "runs": len(envs), "totals": {metric: out[t]["mean"]}},
                device=envs[0].er.device)
            obs.write_record(rec, record if isinstance(record, str) else None)
    return out

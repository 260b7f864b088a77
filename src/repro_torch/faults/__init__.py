"""``repro_torch.faults`` — the realized-fault execution layer.

The port of ``repro.faults``. Three pieces, one contract: **``faults=None``
engines run the unfaulted programs** (no fault code runs on them).

- **FaultTrace** (``faults.trace``): seedable, composable *realized* event
  streams — DC hard-crash, capacity brownout, WAN link partition,
  price/carbon telemetry dropout — as float32 tensors of hourly
  multipliers over the planner's ``EnvParams``. Solvers keep planning on
  the unfaulted env; the trace is what actually happened.
- **Failover execution** (``faults.failover``): each hour builds the
  realized env view, re-projects the planner's allocation against realized
  capacity via a policy (``renormalize | spill_nearest | drop``) and
  simulates the epoch there, emitting ``unserved_demand`` /
  ``failover_moved`` / ``degraded_sla_cost_usd`` through the engines'
  totals.
- **Graceful degradation + resume** (``faults.guard`` / ``faults.resume``):
  finite-guards on solver outputs with a fallback to the
  capacity-proportional baseline (the ``fallback_hours`` counter), and the
  journal/supervisor plumbing behind ``sweep(..., resume_dir=...)``.

Typical use::

    from repro_torch import faults
    from repro_torch.core import ExperimentSpec, run

    trace = faults.compose(faults.dc_crash(env, dc=1, start=12, duration=6),
                           faults.wan_partition(env, a=0, b=1))
    res = run(ExperimentSpec(technique="gt-drl",
                             failover="spill_nearest"), env, faults=trace)
    res["totals"]["unserved_demand"], res["totals"]["failover_moved"]
"""
from .failover import (DEFAULT_POLICY, POLICIES, apply_failover, execute_hour,
                       realized_env)
from .guard import guard_fractions
from .resume import (KilledMidSweep, PointTimeout, SweepJournal,
                     call_with_timeout, check_kill_switch, inject_kill_after)
from .trace import (FaultTrace, brownout, compose, dc_crash, no_faults,
                    random_trace, stack_traces, telemetry_dropout,
                    wan_partition)

__all__ = [
    "FaultTrace", "no_faults", "dc_crash", "brownout", "wan_partition",
    "telemetry_dropout", "compose", "random_trace", "stack_traces",
    "POLICIES", "DEFAULT_POLICY", "realized_env", "apply_failover",
    "execute_hour", "guard_fractions",
    "SweepJournal", "KilledMidSweep", "PointTimeout", "call_with_timeout",
    "check_kill_switch", "inject_kill_after",
]

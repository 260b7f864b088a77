"""Realized-hour execution: the plan/execute split's execute side.

The port of ``repro.faults.failover``. ``execute_hour`` is what the faulted
engines run instead of a bare ``E.step_epoch``: build the hour's *realized*
env view from the trace, re-project the planner's allocation against
realized capacity via a failover policy, then simulate the epoch on the
realized env. Everything is tensor math on the env's device (the reference's
4-round ``lax.scan`` water-fill is a plain loop), so it also runs under the
batched engine's ``torch.func.vmap``.

Failover policies:

- ``renormalize``  — shed the over-capacity mass and redistribute it to
  DCs with headroom in proportion to that headroom.
- ``spill_nearest`` — redistribute headroom-proportionally *weighted by
  realized network nearness* ``1 / (1 + rtt / SPILL_RTT_SCALE_MS)``. With an
  all-zero RTT matrix (the paper default) this is ``renormalize``.
- ``drop``         — no failover: over-capacity mass is simply unserved.

Degradation metrics appended to the epoch's dict (and summed into the
result totals by the engines):

- ``unserved_demand``       tasks/h the realized fleet could not serve;
- ``failover_moved``        tasks/h served at a DC the planner did not pick;
- ``degraded_sla_cost_usd`` realized SLA bill minus what the plan would
  have paid on the unfaulted env (negative under ``drop``: dropped requests
  pay no SLA charge; they show up in ``unserved_demand``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..dcsim import env as E
from ..dcsim import ties
from .trace import FaultTrace

POLICIES = ("renormalize", "spill_nearest", "drop")
DEFAULT_POLICY = "renormalize"

SPILL_RTT_SCALE_MS = 25.0   # nearness kernel scale for spill_nearest
REDISTRIBUTE_ROUNDS = 4     # water-fill rounds (project_feasible's budget)

_EPS = 1e-9


def realized_env(env: E.EnvParams, trace: FaultTrace, tau: int) -> E.EnvParams:
    """The hour's realized env view: planner fields composed with the trace
    (``rtt`` is per hour, indexed here)."""
    return env._replace(
        avail=env.avail * trace.avail_mult,
        eprice=env.eprice * trace.price_mult,
        carbon=env.carbon * trace.carbon_mult,
        rtt=env.rtt + trace.rtt_extra_ms[:, :, tau],
    )


def _nearness(renv: E.EnvParams, policy: str) -> torch.Tensor:
    """(D, D) redistribution kernel K[from, to] for the water-fill."""
    if policy == "spill_nearest":
        return 1.0 / (1.0 + renv.rtt / SPILL_RTT_SCALE_MS)
    d = E.num_dcs(renv)
    return torch.ones((d, d), dtype=renv.rtt.dtype, device=renv.rtt.device)


def _redistribute(kept: torch.Tensor, over: torch.Tensor, cap: torch.Tensor,
                  kern: torch.Tensor) -> torch.Tensor:
    """Place homeless mass ``over`` (I, D; tagged by the DC it was shed
    from) into headroom, weighted by headroom × kernel, for
    ``REDISTRIBUTE_ROUNDS`` rounds. Mass that finds no headroom stays
    unserved."""
    for _ in range(REDISTRIBUTE_ROUNDS):
        head = ties.maximum(cap - kept, 0.0)                      # (I, D)
        w = head[:, None, :] * kern[None, :, :]                   # (I, Df, Dt)
        w = w / ties.maximum(torch.sum(w, dim=-1, keepdim=True), _EPS)
        inc = torch.einsum("if,ift->it", over, w)                 # (I, D)
        acc = torch.minimum(inc, head)
        kept, over = kept + acc, inc - acc
    return kept


def apply_failover(renv: E.EnvParams, ar: torch.Tensor, tau: int,
                   policy: str = DEFAULT_POLICY
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Re-project a planned allocation against *realized* capacity.

    ``ar`` is the planner's (I, D) allocation or routed (S, I, D) tensor.
    Returns ``(ar_realized, unserved, moved)``: the realized same-shape
    allocation, total unserved tasks/h, total tasks/h moved off-plan.
    Routed tensors fail over on their (I, D) totals (capacity is
    source-blind); each realized cell then splits across sources by the
    planned per-source share, and mass moved into cells the plan left empty
    by the hour's demand-origin mix.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown failover policy {policy!r}; known: {POLICIES}")
    ar3 = ar if ar.ndim == 3 else None
    tot = torch.sum(ar3, dim=0) if ar3 is not None else ar    # (I, D)
    cap = E.capacity_at(renv, tau)                             # (I, D)
    kept0 = torch.minimum(tot, cap)
    if policy == "drop":
        kept = kept0
    else:
        kept = _redistribute(kept0, tot - kept0, cap, _nearness(renv, policy))
    # clamped: at 1e9-scale allocations the float32 reductions can land a
    # few hundred tasks/h on either side of zero
    unserved = ties.maximum(torch.sum(tot) - torch.sum(kept), 0.0)
    moved = ties.maximum(torch.sum(kept - kept0), 0.0)
    if ar3 is None:
        return kept, unserved, moved
    origin = E.origin_at(renv, tau)                            # (S, I)
    share = torch.where(tot[None] > _EPS, ar3 / ties.maximum(tot[None], _EPS),
                        origin[:, :, None])
    return kept[None] * share, unserved, moved


def execute_hour(env: E.EnvParams, trace: FaultTrace, peak_state: torch.Tensor,
                 ar: torch.Tensor, tau: int, policy: str = DEFAULT_POLICY):
    """One realized epoch: failover the planned ``ar`` against the hour's
    realized env, simulate it there, and append the degradation metrics.
    The planner's own SLA bill (planned ``ar`` on the unfaulted ``env``) is
    recomputed so that ``degraded_sla_cost_usd`` is a pure delta."""
    renv = realized_env(env, trace, tau)
    ar_r, unserved, moved = apply_failover(renv, ar, tau, policy)
    peak_state, m = E.step_epoch(renv, peak_state, ar_r, tau)
    if ar.ndim == 3:
        planned_sla = torch.sum(E.sla_cost_routed(env, ar, tau))
    else:
        planned_sla = torch.sum(E.sla_cost(env, ar, tau))
    m["unserved_demand"] = unserved
    m["failover_moved"] = moved
    m["degraded_sla_cost_usd"] = m["sla_miss_cost_usd"] - planned_sla
    return peak_state, m

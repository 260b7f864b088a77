"""The geo-distributed cloud environment: paper eqs. (1)–(18) in PyTorch.

The port of ``repro.dcsim.env``. Everything is a function of an ``EnvParams``
NamedTuple of float32 tensors on one device, so objectives run on the card and
are differentiable by autograd (fd's forces and nash's best reply take
gradients through them). Construction is host-side numpy with the reference's
RNG streams, so every field equals the JAX package's; the tensors then move to
the device once.

Shapes: I task types × D data centers × 24 UTC hours.

Units (every cost metric is $ per one-hour epoch):

====================  =========  =================================================
field / quantity      shape      unit
====================  =========  =================================================
``er``, ``car``       (I, D)/…   tasks/h
``it_idle``/``dyn``   (D,)       W
``rp``                (D, 24)    W
``eprice``            (D, 24)    $/kWh (applied to W/1000 → $/h)
``peak_price``        (D,)       $/kW-month (applied to peak W/1000)
``nprice``            scalar     $/GB (× ``sizes`` GB/task × AR tasks/h → $/h)
``carbon``            (D, 24)    kg CO₂ / kWh (→ kg/h)
``rtt``               (D, D)     ms round-trip between regions (row = source)
``sla_ms``            (I,)       ms response-time target per task type
``sla_price``         (I,)       $/task charged per expected SLA miss
``sla_weight``        scalar     weight of the SLA term in ``cost_sla`` rewards
``origin``            (S, I, 24) demand-origin split: fraction of task i's
                                 hour-t arrivals sourced from region s (sums
                                 to 1 over s); S = D (sources = DC regions,
                                 the default) or S = 1 (aggregate source)
latency               (I, D)     ms = access RTT + M/M/c-style queued service
routed latency        (S, I, D)  ms = rtt[s, d] + the same queued sojourn
SLA miss cost         (I, D)     $/h = sla_price · AR · p_miss(latency, sla_ms)
routed SLA miss cost  (S, I, D)  $/h priced per (source, task) path
====================  =========  =================================================

``workload="llm"`` (``dcsim.capability``) makes the task types model families
and keeps every unit above: one "task" is one request, ``er`` is requests/h
derived from the roofline over the DC's accelerator mix.

With ``avail == 1``, a constant carbon profile and the default SLA fields
(``rtt = 0``, ``sla_price = 0``) the model reduces exactly to the paper's.

Per-source request routing: ``origin`` (S, I, 24) records where each task
type's demand comes from, and the routed action space is an (S, I, D) tensor.
``step_epoch``/``player_reward`` accept either an (I, D) or an (S, I, D)
assignment. The degenerate S = 1 aggregate source reproduces the unrouted
model exactly.

Gradients: every differentiated min, max and clip goes through ``ties``, so
that a tie splits the gradient in half, as in JAX. ``tau`` is a Python int.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.model import resolve_device
from ..units import W_PER_KW
from . import capability, latency, renewables, ties, topology
from . import workload as _workload
from .topology import CRAC_MAX_W, CRAC_PER_DC, NETWORK_PRICE


class EnvParams(NamedTuple):
    """Everything the simulator knows about the fleet: float32 tensors on one
    device, with the field names, shapes and units of the JAX package's.

    Machine-read unit table (repro_torch.lint.units):

        er: task/h
        it_idle: W
        it_dyn: W
        tsupply: degC
        eff: 1
        rp: W
        carbon: kgCO2/kWh
        eprice: USD/kWh
        peak_price: USD/kW
        alpha: 1
        nprice: USD/GB
        sizes: GB/task
        nn_total: node
        car: task/h
        avail: 1
        rtt: ms
        sla_ms: ms
        sla_price: USD/task
        sla_weight: 1
        origin: 1
    """
    er: torch.Tensor          # (I, D) max execution rate, tasks/h (eq. 3)
    it_idle: torch.Tensor     # (D,) W
    it_dyn: torch.Tensor      # (D,) W at full utilization
    tsupply: torch.Tensor     # (D,) CRAC supply temperature °C
    eff: torch.Tensor         # (D,) PSU overhead ≥ 1
    rp: torch.Tensor          # (D, 24) renewable W
    carbon: torch.Tensor      # (D, 24) kg CO2 / kWh (hourly grid intensity)
    eprice: torch.Tensor      # (D, 24) $/kWh TOU
    peak_price: torch.Tensor  # (D,) $/kW-month
    alpha: torch.Tensor       # (D,) net metering fraction
    nprice: torch.Tensor      # scalar $/GB
    sizes: torch.Tensor       # (I,) GB per task
    nn_total: torch.Tensor    # (D,) node count
    car: torch.Tensor         # (I, 24) cloud arrival rates
    avail: torch.Tensor       # (D, 24) capacity availability in [0, 1]
    rtt: torch.Tensor         # (D, D) inter-region RTT ms (row = source)
    sla_ms: torch.Tensor      # (I,) response-time SLA target, ms
    sla_price: torch.Tensor   # (I,) $/task per expected SLA miss (0 = unpriced)
    sla_weight: torch.Tensor  # scalar weight of the SLA term under "cost_sla"
    origin: torch.Tensor      # (S, I, 24) demand-origin split, sums to 1 over s


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _f32(a, device: torch.device) -> torch.Tensor:
    """A host array as a float32 tensor on ``device``, rounded on the host as
    ``jnp.asarray`` rounds a float64 array with x64 off."""
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)


def build_env(
    num_dcs: int = 4,
    *,
    month: int = 6,
    pattern: str = "sinusoidal",
    seed: int = 0,
    utilization: float = 0.45,
    include_tpu: bool = False,
    renewable_scale: float = 0.8,
    workload: "str | capability.WorkloadModel" = "aibench",
    device="cuda",
) -> EnvParams:
    """Build one day's EnvParams for ``num_dcs`` data centers on ``device``.

    The fields are built in numpy exactly as the JAX package builds them, then
    rounded to float32 and moved to ``device``: the card unless the caller
    asks for the CPU (raises without a card). ``workload`` selects the
    capability layer (``dcsim.capability``): ``"aibench"``, ``"llm"``, any
    registered name or a ``WorkloadModel`` instance.
    """
    device = resolve_device(device)
    locs = topology.dc_locations(num_dcs)
    loc_rows = [topology.LOCATIONS[i] for i in locs]
    wl = capability.resolve(workload, include_tpu=include_tpu)
    cap = wl.capabilities(num_dcs, seed)
    er, it_idle, it_dyn = cap.er, cap.it_idle, cap.it_dyn
    num_tasks = er.shape[0]
    rng = np.random.default_rng(seed + 17)
    tsupply = rng.uniform(16.0, 24.0, num_dcs)
    eff = rng.uniform(1.10, 1.25, num_dcs)

    tz = np.array([r[2] for r in loc_rows])
    carbon = np.array([r[3] for r in loc_rows])
    base_price = np.array([r[4] for r in loc_rows])
    peak_price = np.array([r[5] for r in loc_rows])
    alpha = np.array([r[6] for r in loc_rows])
    solar_cap = np.array([r[7] for r in loc_rows])
    wind_cap = np.array([r[8] for r in loc_rows])

    # TOU profile: peak window 2–8 PM local at 1.7×, shoulder 1.2×, off 0.8×
    hours = np.arange(24)
    eprice = np.zeros((num_dcs, 24))
    for d in range(num_dcs):
        local = (hours + tz[d]) % 24
        mult = np.where((local >= 14) & (local < 20), 1.7,
                        np.where((local >= 8) & (local < 14), 1.2, 0.8))
        eprice[d] = base_price[d] * mult

    installed = renewable_scale * (it_idle + 0.5 * it_dyn)
    rp = renewables.renewable_profile(tz, solar_cap, wind_cap, 1.0, month, seed)
    rp = rp * installed[:, None]

    # peak rate per type via workload.base_rates: w_i (Σw=1) of its own
    # capacity × utilization, so Σ_i CAR_i/cap_i peaks near ``utilization``
    base = _workload.base_rates(np.asarray(er).sum(axis=1), utilization)
    car = _workload.arrival_pattern(pattern, base, seed=seed)

    def f(a):
        return _f32(a, device)

    return EnvParams(
        er=f(er), it_idle=f(it_idle), it_dyn=f(it_dyn), tsupply=f(tsupply),
        eff=f(eff), rp=f(rp), carbon=f(np.tile(carbon[:, None], (1, 24))),
        eprice=f(eprice), peak_price=f(peak_price), alpha=f(alpha),
        nprice=f(NETWORK_PRICE), sizes=f(cap.sizes),
        nn_total=f(cap.nn_total), car=f(car),
        avail=f(np.ones((num_dcs, 24))),
        # SLA/latency defaults: the paper's model (no WAN delay, misses
        # unpriced). sla_ms is a finite slack target so sla_tighten scales it.
        rtt=f(np.zeros((num_dcs, num_dcs))),
        sla_ms=f(cap.sla_ms),
        sla_price=f(np.zeros(num_tasks)),
        sla_weight=f(1.0),
        # demand origins: uniform across the DC regions (S = D)
        origin=f(np.full((num_dcs, num_tasks, 24), 1.0 / num_dcs)),
    )


def stack_envs(envs) -> EnvParams:
    """Stack same-shape envs field-wise into one batched EnvParams (a leading
    scenario-day axis), on the envs' device."""
    return EnvParams(*(torch.stack(xs) for xs in zip(*list(envs))))


def tile_env(env: EnvParams, n: int) -> EnvParams:
    """Broadcast one env to a leading axis of ``n`` identical days."""
    return EnvParams(*(x.expand((n,) + tuple(x.shape)) for x in env))


def pad_env_batch(env_b: EnvParams, n: int) -> EnvParams:
    """Pad a stacked EnvParams' leading axis to ``n`` rows by repeating the
    last scenario-day."""
    m = int(env_b.er.shape[0])
    if n == m:
        return env_b
    if n < m:
        raise ValueError(f"cannot pad a {m}-row batch down to {n}")
    return EnvParams(*(torch.cat([x, x[-1:].expand((n - m,) + tuple(x.shape[1:]))])
                       for x in env_b))


def num_players(env: EnvParams) -> int:
    return env.er.shape[0]


def num_dcs(env: EnvParams) -> int:
    return env.er.shape[1]


def capacity_at(env: EnvParams, tau: int) -> torch.Tensor:
    """Effective (I, D) execution-rate ceiling ER·avail at hour tau."""
    return env.er * env.avail[:, tau][None, :]


# ---------------------------------------------------------------------------
# per-source request routing: the (S, I, D) decision surface
# ---------------------------------------------------------------------------

def num_sources(env: EnvParams) -> int:
    return env.origin.shape[0]


def origin_at(env: EnvParams, tau: int) -> torch.Tensor:
    """(S, I) demand-origin split at hour tau (columns sum to 1 over s)."""
    return env.origin[:, :, tau]


def source_rtt(env: EnvParams) -> torch.Tensor:
    """(S, D) source-region → DC round trip: the RTT matrix when S = D, its
    uniform-origin row mean when S = 1 (what the unrouted model prices)."""
    s, d = num_sources(env), num_dcs(env)
    if s == d:
        return env.rtt
    if s == 1:
        return torch.mean(env.rtt, dim=0, keepdim=True)
    raise ValueError(
        f"origin has {s} source regions; expected {d} (DC regions) or 1")


def aggregate_origin(env: EnvParams) -> EnvParams:
    """Collapse ``origin`` to the degenerate S = 1 aggregate source."""
    i = num_players(env)
    return env._replace(origin=torch.ones((1, i, 24), dtype=env.origin.dtype,
                                          device=env.origin.device))


def project_feasible_routed(env: EnvParams, fractions: torch.Tensor, tau: int) -> torch.Tensor:
    """Map routing fractions (S, I, D) to a feasible routed assignment AR3
    (S, I, D), tasks/h.

    The totals are water-filled as in ``project_feasible`` from the
    demand-aggregated fractions; each feasible (i, d) cell then splits across
    sources in proportion to the requested per-source mass, and mass placed
    where no source asked splits by the hour's origin mix. With S = 1 the
    routed projection *is* ``project_feasible``: the shortcut keeps values and
    gradients identical to the unrouted game.
    """
    if fractions.shape[0] == 1:
        return project_feasible(env, fractions[0], tau)[None]
    origin = origin_at(env, tau)                                  # (S, I)
    agg = torch.sum(origin[:, :, None] * fractions, dim=0)        # (I, D)
    ar = project_feasible(env, agg, tau)                          # (I, D)
    demand = env.car[:, tau][None, :] * origin                    # (S, I)
    req3 = demand[:, :, None] * fractions                         # (S, I, D)
    req = torch.sum(req3, dim=0)                                  # (I, D)
    ratio = torch.where(req[None] > 1e-9,
                        req3 / ties.maximum(req[None], 1e-9),
                        origin[:, :, None])
    return ar[None] * ratio


# ---------------------------------------------------------------------------
# paper objective functions
# ---------------------------------------------------------------------------

def crac_cap_t(env: EnvParams, tau: int) -> torch.Tensor:
    """(D,) CRAC cooling-power ceiling at hour tau, scaled by ``avail``."""
    return CRAC_PER_DC * CRAC_MAX_W * env.avail[:, tau]


def dp_max_t(env: EnvParams, tau: int) -> torch.Tensor:
    """DP_max[d] at hour tau (eq. 9)."""
    it = (env.it_idle + env.it_dyn) * env.avail[:, tau]
    crac = torch.minimum(it / power_cop(env), crac_cap_t(env, tau))
    return (it + crac) * env.eff - env.rp[:, tau]


def power_cop(env: EnvParams) -> torch.Tensor:
    t = env.tsupply
    # empirical CRAC COP fit: the coefficients absorb the degC units
    return 0.0068 * t * t + 0.0008 * t + 0.458  # lint: unit-ok(empirical COP quadratic in supply degC)


def load_share(env: EnvParams, ar: torch.Tensor, tau: int) -> torch.Tensor:
    """(I, D) per-player share of each DC's load: frac_i / Σ_i frac_i
    (columns sum to 1 on a loaded DC and to 0 on an idle one)."""
    frac = ar / ties.maximum(capacity_at(env, tau), 1e-9)
    rho = torch.sum(frac, dim=0)
    return frac / ties.maximum(rho, 1e-9)[None, :]


def dp_est(env: EnvParams, ar: torch.Tensor, tau: int) -> torch.Tensor:
    """DP_est[i, d] (eq. 10, reconciled): each player's load share of the
    detailed DC power ``grid_power``."""
    return grid_power(env, ar, tau)[None, :] * load_share(env, ar, tau)


def cet_est(env: EnvParams, ar: torch.Tensor, tau: int) -> torch.Tensor:
    """CET[i] (eqs. 11–12): estimated cloud carbon per player, kg/h."""
    de = env.carbon[:, tau][None, :] * dp_est(env, ar, tau) / W_PER_KW
    return torch.sum(de, dim=1)


def ce_est(env: EnvParams, ar: torch.Tensor, tau: int) -> torch.Tensor:
    """CE (eq. 13): total estimated cloud carbon."""
    return torch.sum(cet_est(env, ar, tau))


def nc_est(env: EnvParams, ar: torch.Tensor) -> torch.Tensor:
    """NC_est[i, d] (eqs. 14–15): nprice · sizes · AR, $/h."""
    return env.nprice * env.sizes[:, None] * ar


def grid_power(env: EnvParams, ar: torch.Tensor, tau: int) -> torch.Tensor:
    """Detailed net DC power DP[d] (eq. 4) for a full assignment."""
    rho = torch.sum(ar / ties.maximum(capacity_at(env, tau), 1e-9), dim=0)  # (D,)
    a = env.avail[:, tau]
    it = (env.it_idle + env.it_dyn * ties.clip(rho, 0.0, 1.0)) * a
    crac = torch.minimum(it / power_cop(env), crac_cap_t(env, tau))
    return (it + crac) * env.eff - env.rp[:, tau]


def peak_increase(env: EnvParams, ar: torch.Tensor, tau: int,
                  peak_state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Δ_peak[d] (eq. 6) in $, plus the updated monthly peak state (W)."""
    draw = ties.maximum(grid_power(env, ar, tau), 0.0)
    new_peak = torch.maximum(peak_state, draw)
    delta = env.peak_price * (new_peak - peak_state) / W_PER_KW
    return delta, new_peak


def cct_est(env: EnvParams, ar: torch.Tensor, tau: int,
            peak_state: torch.Tensor) -> torch.Tensor:
    """CCT[i] (eqs. 16–17): estimated cloud operating cost per player, $/h:
    energy on the load-share attribution of the actual DC power, the
    monthly-peak delta split by the same shares, and the network bill."""
    share = load_share(env, ar, tau)
    dpe = dp_est(env, ar, tau)
    a = torch.where(dpe > 0, 1.0, env.alpha[None, :])
    energy = env.eprice[:, tau][None, :] * a * dpe / W_PER_KW
    delta, _ = peak_increase(env, ar, tau, peak_state)
    dc = energy + delta[None, :] * share + nc_est(env, ar)  # lint: unit-ok(peak delta is a one-off $ within the 1 h epoch, commensurable with $/h here)
    return torch.sum(dc, dim=1)


def cc_est(env: EnvParams, ar: torch.Tensor, tau: int, peak_state: torch.Tensor) -> torch.Tensor:
    """CC (eq. 18)."""
    return torch.sum(cct_est(env, ar, tau, peak_state))


# ---------------------------------------------------------------------------
# SLA/latency model (dcsim.latency over EnvParams)
# ---------------------------------------------------------------------------

def _rho_for_latency(env: EnvParams, ar: torch.Tensor, tau: int) -> torch.Tensor:
    """(D,) utilization for the queueing model; a fully dark DC (avail == 0)
    counts as saturated, not idle-fast."""
    rho = torch.sum(ar / ties.maximum(capacity_at(env, tau), 1e-9), dim=0)
    return torch.where(env.avail[:, tau] > 0.0, rho, 1.0)


def latency_ms(env: EnvParams, ar: torch.Tensor, tau: int) -> torch.Tensor:
    """(I, D) expected response time: mean access RTT + the M/M/c-style
    queued service sojourn at the hour's utilization (``dcsim.latency``)."""
    return latency.expected_latency_ms(env.er, env.nn_total,
                                       _rho_for_latency(env, ar, tau), env.rtt)


def sla_cost(env: EnvParams, ar: torch.Tensor, tau: int,
             lat_ms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(I, D) expected SLA-miss cost, $/h: sla_price · AR · p_miss.
    ``lat_ms`` reuses an already-computed ``latency_ms``."""
    lat = latency_ms(env, ar, tau) if lat_ms is None else lat_ms
    p = latency.sla_miss_prob(lat, env.sla_ms[:, None])
    return env.sla_price[:, None] * ar * p


def sla_cost_est(env: EnvParams, ar: torch.Tensor, tau: int) -> torch.Tensor:
    """(I,) per-player SLA-miss cost — the latency term of ``cost_sla``."""
    return torch.sum(sla_cost(env, ar, tau), dim=1)


def latency_ms_routed(env: EnvParams, ar: torch.Tensor, tau: int) -> torch.Tensor:
    """(S, I, D) per-path response time: rtt[s, d] + queued sojourn. ``ar`` is
    the (I, D) totals or a routed (S, I, D) tensor (summed over sources)."""
    if ar.ndim == 3:
        ar = torch.sum(ar, dim=0)
    return latency.expected_latency_ms_routed(
        env.er, env.nn_total, _rho_for_latency(env, ar, tau), source_rtt(env))


def sla_cost_routed(env: EnvParams, ar3: torch.Tensor, tau: int,
                    lat_ms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, I, D) expected SLA-miss cost, $/h, priced per (source, task) path.
    ``lat_ms`` reuses an already-computed ``latency_ms_routed``."""
    lat3 = latency_ms_routed(env, ar3, tau) if lat_ms is None else lat_ms
    p = latency.sla_miss_prob(lat3, env.sla_ms[None, :, None])
    return env.sla_price[None, :, None] * ar3 * p


def sla_cost_est_routed(env: EnvParams, ar3: torch.Tensor, tau: int) -> torch.Tensor:
    """(I,) per-player SLA-miss cost of a routed assignment."""
    return torch.sum(sla_cost_routed(env, ar3, tau), dim=(0, 2))


OBJECTIVES = ("carbon", "cost", "cost_sla")


def player_reward(env, ar, tau, peak_state, objective: str) -> torch.Tensor:
    """(I,) per-player objective value (lower is better).

    ``carbon``: CET (eq. 12). ``cost``: CCT (eq. 17). ``cost_sla``: CCT plus
    ``sla_weight`` × the expected SLA-miss cost. ``ar`` is the (I, D)
    allocation, or a routed (S, I, D) tensor whose SLA term prices each path.
    """
    ar3 = ar if ar.ndim == 3 else None
    if ar3 is not None:
        ar = torch.sum(ar3, dim=0)
    if objective == "carbon":
        return cet_est(env, ar, tau)
    if objective == "cost":
        return cct_est(env, ar, tau, peak_state)
    if objective == "cost_sla":
        sla = (sla_cost_est(env, ar, tau) if ar3 is None
               else sla_cost_est_routed(env, ar3, tau))
        return cct_est(env, ar, tau, peak_state) + env.sla_weight * sla
    raise ValueError(f"unknown objective {objective!r}; known: {OBJECTIVES}")


# ---------------------------------------------------------------------------
# constraints (eqs. 1–2)
# ---------------------------------------------------------------------------

def feasible_violation(env: EnvParams, ar: torch.Tensor, tau: int) -> torch.Tensor:
    """Aggregate constraint violation (0 when feasible)."""
    split = torch.abs(torch.sum(ar, dim=1) - env.car[:, tau])  # eq. (1)
    over = ties.maximum(ar - capacity_at(env, tau), 0.0)       # eq. (2)
    return torch.sum(split) + torch.sum(over)


WATER_FILL_ROUNDS = 4  # enough at <= 60% utilization


def project_feasible(env: EnvParams, fractions: torch.Tensor, tau: int) -> torch.Tensor:
    """Map simplex fractions (I, D) → feasible AR (both constraints).

    Rates beyond a DC's effective ER are redistributed to DCs with headroom
    (iterative water-filling). If the whole fleet lacks headroom the residual
    is dropped, and eq. (1) reports the shed load as violation.
    """
    car = env.car[:, tau]
    er_t = capacity_at(env, tau)
    ar = fractions * car[:, None]
    for _ in range(WATER_FILL_ROUNDS):
        over = ties.maximum(ar - er_t, 0.0)
        ar = ar - over
        head = ties.maximum(er_t - ar, 0.0)
        w = head / ties.maximum(torch.sum(head, dim=1, keepdim=True), 1e-9)
        ar = ar + torch.sum(over, dim=1, keepdim=True) * w
    return torch.minimum(ar, er_t)


# ---------------------------------------------------------------------------
# detailed epoch simulation (ground-truth metrics, not the estimate)
# ---------------------------------------------------------------------------

def step_epoch(
    env: EnvParams, peak_state: torch.Tensor, ar: torch.Tensor, tau: int
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Simulate one epoch under assignment ``ar``; returns (new_peak, metrics),
    the metrics 0-d tensors on the env's device.

    ``ar`` is the (I, D) allocation or a routed (S, I, D) tensor; physics
    depends only on the totals, while the SLA charge and the ``latency_ms``
    metric are priced per (source, task) path when routed.
    """
    ar3 = ar if ar.ndim == 3 else None
    if ar3 is not None:
        ar = torch.sum(ar3, dim=0)
    dp = grid_power(env, ar, tau)  # (D,) W, can be negative
    de = env.carbon[:, tau] * dp / W_PER_KW  # kg/h (negative = displaced grid carbon)
    a = torch.where(dp > 0, 1.0, env.alpha)
    energy_cost = env.eprice[:, tau] * a * dp / W_PER_KW
    delta, new_peak = peak_increase(env, ar, tau, peak_state)
    net_cost = torch.sum(env.nprice * env.sizes[:, None] * ar, dim=0)
    if ar3 is None:
        lat = latency_ms(env, ar, tau)          # (I, D) ms
        sla = torch.sum(sla_cost(env, ar, tau, lat_ms=lat), dim=0)  # (D,) $/h
        lat_mean = torch.sum(ar * lat) / ties.maximum(torch.sum(ar), 1e-9)
    else:
        lat = latency_ms_routed(env, ar3, tau)  # (S, I, D) ms per path
        sla = torch.sum(sla_cost_routed(env, ar3, tau, lat_ms=lat), dim=(0, 1))
        lat_mean = torch.sum(ar3 * lat) / ties.maximum(torch.sum(ar3), 1e-9)
    total_cost = energy_cost + delta + net_cost + sla  # lint: unit-ok(peak delta is a one-off $ within the 1 h epoch, commensurable with $/h here)
    viol = feasible_violation(env, ar, tau)
    rho = torch.sum(ar / ties.maximum(capacity_at(env, tau), 1e-9), dim=0)
    metrics = {
        "carbon_kg": torch.sum(de),
        "cost_usd": torch.sum(total_cost),
        "energy_cost_usd": torch.sum(energy_cost),
        "peak_cost_usd": torch.sum(delta),
        "network_cost_usd": torch.sum(net_cost),
        "sla_miss_cost_usd": torch.sum(sla),
        "latency_ms": lat_mean,
        "grid_power_w": torch.sum(ties.maximum(dp, 0.0)),
        "violation": viol,
        "max_rho": torch.max(rho),
    }
    return new_peak, metrics

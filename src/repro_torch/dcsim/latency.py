"""SLA/latency model: M/M/c-style queueing delay + WAN RTT + miss pricing.

The port of ``repro.dcsim.latency``: the network helpers that build the RTT
matrix stay numpy (host-side construction); the queueing and pricing pieces
take torch tensors. Every differentiated clip goes through ``ties`` so that
gradients at a tie match JAX's.

The paper's schedulers trade carbon against cost with no performance term at
all — nothing stops them from piling every task onto the cheapest/greenest
DC. DCcluster-Opt (arXiv:2511.00117) and Green-LLM (arXiv:2507.09942) make
queueing delay and SLA violations first-class objective terms for exactly
this workload; this module is that subsystem for the repro.

Three pure pieces (plain array math — no EnvParams import, so
``dcsim.env`` can layer its latency/SLA accessors on top without a cycle):

- **Network**: an inter-region RTT matrix from the great-circle distances of
  ``topology.location_coords()`` (fiber speed ≈ c/1.5, a path-stretch
  factor, per-direction hop overhead). The canonical representation is the
  full (D, D) matrix (row = source region); ``access_ms`` collapses it to
  the (D,) uniform-origin mean for the unrouted model, while the routed
  model (``expected_latency_ms_routed``) keeps the per-path values so the
  (source → DC) split is a real decision surface.
- **Queueing**: each DC is an M/M/c-style station whose c = NN_d nodes
  jointly serve at ER[i, d] tasks/h. The per-task service share is
  ``s_ms[i, d] = 3.6e6 · NN_d / ER[i, d]`` (node-internal core parallelism
  is already folded into ER) and the expected sojourn scales it by the
  processor-sharing factor ``1 / (1 - rho)``, with utilization clipped at
  ``RHO_MAX`` so saturated hours stay finite and differentiable. ``avail``
  curtailment cancels out of s_ms (nodes and rate shrink together) and
  enters through rho, which is computed against effective capacity.
- **SLA pricing**: a smooth miss probability ``sigmoid((lat - sla) /
  (SLA_SOFTNESS · sla))`` (a differentiable stand-in for the M/M/c waiting
  tail) priced per task: ``$ / h = sla_price · AR · p_miss``. With the
  paper-default ``sla_price = 0`` every term below is exactly zero.

Units: latencies/SLAs ms, rates tasks/h, distances km, prices $/task.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import ties, topology
from ..units import MS_PER_H

EARTH_RADIUS_KM = 6371.0    # lint: unit(km)
FIBER_KM_PER_MS = 200.0    # signal speed in glass ≈ c/1.5  # lint: unit(km/ms)
PATH_STRETCH = 1.4         # real fiber routes vs the great circle
HOP_OVERHEAD_MS = 2.0      # serialization + routing + handoff  # lint: unit(ms)
RHO_MAX = 0.995            # queueing-factor utilization clip (keeps 1/(1-ρ) finite)
SLA_SOFTNESS = 0.1         # sigmoid width as a fraction of the SLA target
SLA_MARGIN = 4.0           # default SLA = margin × fleet-mean zero-load latency

_EPS = 1e-9


# ---------------------------------------------------------------------------
# network: inter-region RTT from LOCATIONS coordinates
# ---------------------------------------------------------------------------

def haversine_km(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """(D, D) great-circle distances for degree coordinate vectors."""
    la, lo = np.radians(np.asarray(lat, float)), np.radians(np.asarray(lon, float))
    dla = la[:, None] - la[None, :]
    dlo = lo[:, None] - lo[None, :]
    h = (np.sin(dla / 2.0) ** 2
         + np.cos(la)[:, None] * np.cos(la)[None, :] * np.sin(dlo / 2.0) ** 2)
    return 2.0 * EARTH_RADIUS_KM * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))


def rtt_matrix(loc_indices: Optional[Sequence[int]] = None, *,
               num_dcs: Optional[int] = None) -> np.ndarray:
    """(D, D) round-trip times (ms) between DC regions.

    ``loc_indices`` rows into ``topology.LOCATIONS``; ``num_dcs`` instead
    picks the paper's east/west mix via ``topology.dc_locations`` (falling
    back to the first D rows for non-standard fleet sizes). The diagonal is
    intra-region: no propagation, no hop overhead.
    """
    if loc_indices is None:
        assert num_dcs is not None, "need loc_indices or num_dcs"
        loc_indices = (topology.dc_locations(num_dcs) if num_dcs in (4, 8, 16)
                       else list(range(num_dcs)))
    lat, lon = topology.location_coords(loc_indices)
    dist = haversine_km(lat, lon)
    rtt = 2.0 * (dist * PATH_STRETCH / FIBER_KM_PER_MS + HOP_OVERHEAD_MS)
    np.fill_diagonal(rtt, 0.0)
    return rtt


def access_ms(rtt: torch.Tensor) -> torch.Tensor:
    """(D,) mean access RTT over uniform request origins.

    ``rtt`` must be the canonical (D, D) matrix (axis 0 = source region);
    the old (D,)-vector alternate representation is gone — per-path values
    are needed by the routed model, and the dual shape bred special cases
    (``wan_degradation``'s scalar cross-path factor mispriced ``extra_ms``).
    """
    if rtt.ndim != 2:
        raise ValueError(
            f"rtt must be the canonical (D, D) matrix, got shape {tuple(rtt.shape)}")
    return torch.mean(rtt, dim=0)


# ---------------------------------------------------------------------------
# queueing: M/M/c-style sojourn per (task, DC)
# ---------------------------------------------------------------------------

def service_ms(er: torch.Tensor, nn_total: torch.Tensor) -> torch.Tensor:
    """(I, D) zero-load service share per task: 3.6e6 · NN_d / ER[i, d]."""
    # ms/h * node / (task/h) reads as ms per request: node is a
    # dimensionless server count in the M/M/c convention
    return MS_PER_H * nn_total[None, :] / ties.maximum(er, _EPS)  # lint: unit-ok(node is a dimensionless server count)


def queue_factor(rho: torch.Tensor) -> torch.Tensor:
    """Processor-sharing delay factor 1 / (1 - ρ), clipped at RHO_MAX.

    Monotone non-decreasing in ρ, equal to 1 at ρ = 0.
    """
    return 1.0 / (1.0 - ties.clip(rho, 0.0, RHO_MAX))


def expected_latency_ms(er: torch.Tensor, nn_total: torch.Tensor,
                        rho: torch.Tensor, rtt: torch.Tensor) -> torch.Tensor:
    """(I, D) expected response time: access RTT + queued service sojourn."""
    return access_ms(rtt)[None, :] + service_ms(er, nn_total) * queue_factor(rho)[None, :]


def expected_latency_ms_routed(er: torch.Tensor, nn_total: torch.Tensor,
                               rho: torch.Tensor,
                               src_rtt: torch.Tensor) -> torch.Tensor:
    """(S, I, D) per-path response time: ``src_rtt[s, d]`` + queued sojourn.

    ``src_rtt`` is the (S, D) source-region → DC round trip (``rtt`` itself
    when sources are the DC regions; its uniform-origin row mean when S = 1,
    the degenerate aggregate source that reproduces ``expected_latency_ms``
    bit-for-bit). The queued sojourn is source-independent — requests queue
    at the serving DC — so it broadcasts over the source axis.
    """
    sojourn = service_ms(er, nn_total) * queue_factor(rho)[None, :]
    return src_rtt[:, None, :] + sojourn[None, :, :]


# ---------------------------------------------------------------------------
# SLA pricing
# ---------------------------------------------------------------------------

def sla_miss_prob(lat_ms: torch.Tensor, sla_ms: torch.Tensor) -> torch.Tensor:
    """Smooth miss probability: sigmoid((lat - sla) / (SLA_SOFTNESS · sla))."""
    width = SLA_SOFTNESS * ties.maximum(sla_ms, _EPS)
    return torch.sigmoid((lat_ms - sla_ms) / width)


def default_sla_ms(er: np.ndarray, nn_total: np.ndarray,
                   margin: float = SLA_MARGIN) -> np.ndarray:
    """(I,) canonical per-task SLA target: ``margin`` × the capacity-weighted
    fleet mean of the zero-load latency. Comfortably slack at the paper's
    ≤60% utilization, so default envs (sla_price = 0 anyway) never bind."""
    er = np.asarray(er, float)
    nn_total = np.asarray(nn_total, float)
    s = MS_PER_H * nn_total[None, :] / np.maximum(er, _EPS)
    w = er / np.maximum(er.sum(axis=1, keepdims=True), _EPS)
    return margin * (s * w).sum(axis=1)  # lint: unit-ok(node count is dimensionless, as in service_ms)

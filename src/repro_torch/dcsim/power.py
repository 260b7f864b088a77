"""Data-center power models (paper §3.3.3, detailed models from [16]).

A copy of ``repro.dcsim.power`` (host-side numpy).

Node power: idle + dynamic × utilization (per node type, with the dynamic
part averaged over task types as the paper's P_j^D).  Cooling: CRAC power
from compute heat via the classic HP COP(T_supply) quadratic used by [16].
Net DC power (eq. 4): (CRAC + nodes) · Eff − renewables, may be negative.
"""
from __future__ import annotations

import numpy as np

from .topology import CRAC_MAX_W, NODE_TYPES


def cop(t_supply_c: np.ndarray) -> np.ndarray:
    """HP CRAC coefficient-of-performance model."""
    t = np.asarray(t_supply_c, float)
    # the empirical fit's coefficients absorb the degC units
    return 0.0068 * t * t + 0.0008 * t + 0.458  # lint: unit-ok(empirical COP quadratic in supply degC)


def node_power_arrays(num_node_types: int):
    """(idle_w[j], peak_dyn_w[j]) vectors."""
    idle = np.array([NODE_TYPES[j].idle_w for j in range(num_node_types)])
    dyn = np.array([NODE_TYPES[j].peak_dyn_w for j in range(num_node_types)])
    return idle, dyn


def compute_power(nn: np.ndarray, rho: np.ndarray) -> np.ndarray:
    """IT (node) power per DC, W.

    nn: NN[d, j]; rho: (D,) total utilization of each DC in [0, 1]
    (assumes the DWM spreads load so all node types see equal utilization —
    the paper's DWM detail collapses to this at CWM granularity).
    """
    idle, dyn = node_power_arrays(nn.shape[1])
    idle_total = nn @ idle   # (D,)
    dyn_total = nn @ dyn     # (D,)
    return idle_total + dyn_total * np.clip(rho, 0.0, 1.0)


def crac_power(it_power_w: np.ndarray, t_supply_c: np.ndarray) -> np.ndarray:
    """Cooling power needed to extract IT heat at the given supply temp."""
    return it_power_w / cop(t_supply_c)


def dp_max(nn: np.ndarray, eff: np.ndarray, t_supply_c: np.ndarray, ncr: int, rp_w: np.ndarray) -> np.ndarray:
    """DP_max[d] (eq. 9): all nodes at peak dynamic power + rated CRAC."""
    idle, dyn = node_power_arrays(nn.shape[1])
    it = nn @ (idle + dyn)
    crac = np.minimum(crac_power(it, t_supply_c), ncr * CRAC_MAX_W)
    return (it + crac) * eff - rp_w

"""Co-location interference model (paper §3.3.2, model form of [37]).

A copy of ``repro.dcsim.colocation`` (host-side numpy).

Execution time of task i on a core of node type j under co-location is a
linear-regression blow-up over the solo base time, driven by: number of
co-located tasks on the package, the task's own memory intensity, the
average memory intensity of residents, and clock frequency. [37] reports
~7% MAPE for this family of models on real Xeon measurements; coefficients
here are synthetic-but-shaped per memory-intensity class.

The CWM-level quantity is the *maximum* execution rate ER[i, d] (eq. 3):
all cores of every node running task i, i.e. co-location with (cores-1)
same-type residents.
"""
from __future__ import annotations

import numpy as np

from ..units import S_PER_H
from .topology import NODE_TYPES, NUM_XEON_TYPES, TASK_TYPES

# interference slope per memory-intensity class (low, med, high):
# fractional exec-time increase per co-resident task per unit avg intensity
CLASS_SLOPE = np.array([0.010, 0.030, 0.065])
# memory intensity value per class (LLC misses / instruction, scaled)
CLASS_INTENSITY = np.array([0.15, 0.45, 0.85])


def base_time_table(num_node_types: int) -> np.ndarray:
    """BET[i, j]: solo execution time (s) of task i on one core of type j."""
    i = len(TASK_TYPES)
    out = np.zeros((i, num_node_types))
    for ti, (_, _, _, times) in enumerate(TASK_TYPES):
        for j in range(min(num_node_types, NUM_XEON_TYPES)):
            out[ti, j] = times[j]
        if num_node_types > NUM_XEON_TYPES:
            # TPU host node: inference offloaded to accelerator, ~20x faster
            out[ti, NUM_XEON_TYPES] = min(times) / 20.0
    return out


def coer_core(num_node_types: int) -> np.ndarray:
    """CoER[i, j]: co-located execution rate (tasks/s) per core (eq. [37]).

    exec_time = BET * (1 + slope_class(i) * (cores_j - 1) * mi_avg)
    with mi_avg = own class intensity (uniform same-type co-location) and a
    mild clock-frequency correction.
    """
    bet = base_time_table(num_node_types)
    i_n = bet.shape[0]
    out = np.zeros_like(bet)
    ghz_ref = 2.8
    for ti in range(i_n):
        cls = TASK_TYPES[ti][1]
        for j in range(num_node_types):
            node = NODE_TYPES[j]
            freq_corr = 1.0 if node.ghz == 0 else (ghz_ref / node.ghz) ** 0.3
            blowup = 1.0 + CLASS_SLOPE[cls] * (node.cores - 1) * CLASS_INTENSITY[cls]
            t = bet[ti, j] * blowup * freq_corr
            out[ti, j] = 1.0 / t
    return out


def er_table(nn: np.ndarray) -> np.ndarray:
    """ER[i, d] tasks/hour (eq. 3): sum of core rates over all nodes of d.

    nn: NN[d, j] node counts.
    """
    num_types = nn.shape[1]
    coer = coer_core(num_types)  # (I, J) tasks/s per core
    cores = np.array([NODE_TYPES[j].cores for j in range(num_types)], float)
    per_node = coer * cores[None, :]  # (I, J) tasks/s per node
    er = per_node @ nn.T.astype(float)  # (I, D) tasks/s
    return er * S_PER_H

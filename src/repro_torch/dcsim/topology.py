"""Geo-distributed data-center topology: locations, node types, task types.

A copy of ``repro.dcsim.topology`` (host-side numpy, the same RNG streams), so
that the port imports nothing of ``repro``.

Faithful to the paper's simulation environment (§6): 4/8/16 DC configs over
continental-US cities with an even east/west split; each DC has 4,320 nodes
in four aisles drawn from three Xeon node types; ten AIBench-derived task
types. The raw measurement tables of [16]/[37] are unpublished, so the
numeric tables here are synthetic-but-shaped: magnitudes match the cited
hardware (Xeon TDPs, AIBench-class inference latencies) and all relative
structure (memory-intensity classes, heterogeneous speeds) is preserved.
A TPU-v5e node type is included as the beyond-paper bridge to the serving
substrate (execution rates derived from the roofline analysis).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Node types (paper §6: Intel Xeon E3-1225v3, E5649, E5-2697v2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodeType:
    name: str
    cores: int
    idle_w: float     # package idle power, W
    peak_dyn_w: float  # peak dynamic power (all cores), W
    ghz: float


NODE_TYPES: Tuple[NodeType, ...] = (
    NodeType("xeon-e3-1225v3", 4, 18.0, 66.0, 3.2),
    NodeType("xeon-e5649", 6, 35.0, 80.0, 2.53),
    NodeType("xeon-e5-2697v2", 12, 45.0, 130.0, 2.7),
    # beyond-paper accelerator node (execution rates filled from roofline)
    NodeType("tpu-v5e-host", 4, 120.0, 400.0, 0.0),
)
NUM_XEON_TYPES = 3

# ---------------------------------------------------------------------------
# Task types (paper Table 2: AIBench inference workloads)
# columns: name, mem-intensity class (0 low,1 med,2 high), size GB,
#          base exec time (s) on the three Xeon types
# ---------------------------------------------------------------------------

TASK_TYPES: Tuple[Tuple[str, int, float, Tuple[float, float, float]], ...] = (
    ("image-classification", 1, 0.30, (0.08, 0.12, 0.05)),
    ("image-generation", 2, 0.80, (1.90, 2.60, 1.20)),
    ("image-to-text", 1, 0.45, (0.55, 0.80, 0.35)),
    ("image-to-image", 2, 0.90, (2.30, 3.10, 1.50)),
    ("speech-recognition", 1, 0.60, (0.70, 1.00, 0.45)),
    ("face-embedding", 0, 0.25, (0.06, 0.09, 0.04)),
    ("face-recognition-3d", 1, 0.55, (0.90, 1.30, 0.60)),
    ("video-prediction", 2, 1.20, (2.80, 3.90, 1.80)),
    ("image-compression", 1, 0.40, (0.50, 0.75, 0.32)),
    ("object-reconstruction-3d", 2, 1.00, (2.10, 2.90, 1.40)),
)

NUM_TASK_TYPES = len(TASK_TYPES)

# ---------------------------------------------------------------------------
# Locations: (city, state, tz offset h vs UTC, carbon factor kgCO2/kWh
#             [EIA-shaped], TOU base $/kWh, peak demand $/kW, net metering α,
#             solar capacity factor, wind capacity factor, lat °N, lon °E)
# The trailing (lat, lon) pair feeds the inter-region RTT matrix of the
# SLA/latency model (``dcsim.latency.rtt_matrix``).
# ---------------------------------------------------------------------------

LOCATIONS: Tuple[Tuple[str, str, int, float, float, float, float, float, float, float, float], ...] = (
    ("new-york", "NY", -5, 0.23, 0.180, 18.0, 1.00, 0.35, 0.25, 40.71, -74.01),
    ("san-francisco", "CA", -8, 0.21, 0.220, 20.0, 1.00, 0.65, 0.40, 37.77, -122.42),
    ("chicago", "IL", -6, 0.43, 0.120, 14.0, 1.00, 0.40, 0.55, 41.88, -87.63),
    ("dallas", "TX", -6, 0.41, 0.095, 11.0, 0.75, 0.60, 0.85, 32.78, -96.80),
    ("seattle", "WA", -8, 0.09, 0.090, 10.0, 1.00, 0.30, 0.45, 47.61, -122.33),
    ("miami", "FL", -5, 0.39, 0.110, 12.0, 0.50, 0.60, 0.20, 25.76, -80.19),
    ("denver", "CO", -7, 0.55, 0.115, 13.0, 1.00, 0.70, 0.75, 39.74, -104.99),
    ("boston", "MA", -5, 0.31, 0.210, 19.0, 1.00, 0.35, 0.35, 42.36, -71.06),
    ("phoenix", "AZ", -7, 0.37, 0.105, 12.5, 0.70, 0.85, 0.30, 33.45, -112.07),
    ("atlanta", "GA", -5, 0.40, 0.100, 11.5, 0.00, 0.50, 0.20, 33.75, -84.39),
    ("portland", "OR", -8, 0.12, 0.095, 10.5, 1.00, 0.35, 0.50, 45.52, -122.68),
    ("columbus", "OH", -5, 0.52, 0.115, 13.5, 1.00, 0.38, 0.40, 39.96, -83.00),
    ("salt-lake-city", "UT", -7, 0.58, 0.098, 11.0, 0.85, 0.75, 0.55, 40.76, -111.89),
    ("kansas-city", "MO", -6, 0.60, 0.100, 12.0, 1.00, 0.48, 0.70, 39.10, -94.58),
    ("las-vegas", "NV", -8, 0.34, 0.102, 12.0, 0.90, 0.88, 0.35, 36.17, -115.14),
    ("charlotte", "NC", -5, 0.33, 0.098, 11.0, 0.00, 0.52, 0.22, 35.23, -80.84),
)


# named column accessors for LOCATIONS rows — downstream code must not index
# the tuple by magic position (a schema change would silently corrupt, e.g.,
# the RTT matrix built from the trailing coordinate pair)
LOC_LAT, LOC_LON = 9, 10


def location_coords(loc_indices=None) -> Tuple[np.ndarray, np.ndarray]:
    """(lat °N, lon °E) arrays for the given LOCATIONS rows (default: all).

    The single named accessor for the coordinate columns; the geometry
    regression test pins a known city-pair RTT through it, so a LOCATIONS
    schema change breaks loudly instead of silently skewing distances.
    """
    rows = (LOCATIONS if loc_indices is None
            else [LOCATIONS[i] for i in loc_indices])
    lat = np.array([r[LOC_LAT] for r in rows], dtype=float)
    lon = np.array([r[LOC_LON] for r in rows], dtype=float)
    return lat, lon


def dc_locations(num_dcs: int) -> List[int]:
    """Pick an even east/west coast mix as the paper does (Fig. 5)."""
    assert num_dcs in (4, 8, 16), num_dcs
    if num_dcs == 4:
        return [0, 1, 3, 4]  # NY, SF, Dallas, Seattle
    if num_dcs == 8:
        return [0, 1, 2, 3, 4, 5, 6, 7]
    return list(range(16))


NODES_PER_DC = 4320  # paper §6
AISLES_PER_DC = 4
CRAC_PER_DC = 4         # CRAC units per DC  # lint: unit(1)
CRAC_MAX_W = 120_000.0  # per CRAC unit rating  # lint: unit(W)
NETWORK_PRICE = 0.085   # AWS CloudFront-shaped  # lint: unit(USD/GB)


# ---------------------------------------------------------------------------
# Accelerator fleet (beyond-paper, the token-grounded "llm" workload model).
# Each accelerator node is one host of ``chips`` chips; per-chip peak compute,
# HBM bandwidth/capacity, and interconnect bandwidth are expressed relative to
# the reference chip constants in ``launch/roofline.py`` (simulator data that
# sizes this simulated fleet, copied from the JAX package; not a measurement
# of any card). idle_w/dyn_w are hardware-spec node power draws (the one kind
# of constant the llm path is allowed: hardware, never per-task execution
# times).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AccelType:
    """One accelerator node type: per-chip roofline specs + node power.

    Machine-read unit table (repro_torch.lint.units):

        name: -
        chips: chip/node
        peak_flops: FLOP/s
        hbm_bw: B/s
        hbm_gb: GiB
        ici_bw: B/s
        idle_w: W
        dyn_w: W
    """
    name: str
    chips: int          # chips per node (host)
    peak_flops: float   # per chip, bf16 FLOP/s
    hbm_bw: float       # per chip, bytes/s
    hbm_gb: float       # per chip, GiB of HBM
    ici_bw: float       # per chip, interconnect bytes/s
    idle_w: float       # node idle power, W
    dyn_w: float        # node peak dynamic power, W


def _accel_types() -> Tuple[AccelType, ...]:
    from ..launch import roofline as R  # constants only

    return (
        # previous generation: weaker compute, more HBM per chip
        AccelType("tpu-gen-a", 4, 0.70 * R.PEAK_FLOPS, 0.75 * R.HBM_BW,
                  32.0, 0.90 * R.ICI_BW, 140.0, 1000.0),
        # the reference chip of launch/roofline.py (1x by construction)
        AccelType("tpu-gen-b", 4, 1.00 * R.PEAK_FLOPS, 1.00 * R.HBM_BW,
                  16.0, 1.00 * R.ICI_BW, 120.0, 1100.0),
        # large-model generation: big HBM, fat interconnect
        AccelType("tpu-gen-c", 4, 2.33 * R.PEAK_FLOPS, 3.35 * R.HBM_BW,
                  95.0, 2.00 * R.ICI_BW, 220.0, 2600.0),
    )


ACCEL_TYPES: Tuple[AccelType, ...] = _accel_types()

# one accelerator aisle's worth of hosts per DC (mirrors the include_tpu
# carve-out in ``node_mix``)
ACCEL_NODES_PER_DC = NODES_PER_DC // AISLES_PER_DC


def accel_mix(seed: int, num_dcs: int,
              num_accel_types: int | None = None,
              nodes_per_dc: int = ACCEL_NODES_PER_DC) -> np.ndarray:
    """NN[d, a]: accelerator node counts per DC, rows sum to ``nodes_per_dc``.

    Mirrors ``node_mix``'s heterogeneity story for the accelerator fleet:
    most DCs run a dirichlet blend of generations; every 3rd DC is a
    single-generation fleet (procurement waves are lumpy). Seeded off a
    distinct stream (``seed + 101``) so the Xeon and accelerator mixes of
    one scenario seed are independent draws.
    """
    if num_accel_types is None:
        num_accel_types = len(ACCEL_TYPES)
    rng = np.random.default_rng(seed + 101)
    out = np.zeros((num_dcs, num_accel_types), np.int64)
    for d in range(num_dcs):
        if d % 3 == 2 and num_accel_types > 1:  # single-generation fleet
            out[d, int(rng.integers(num_accel_types))] = nodes_per_dc
            continue
        w = rng.dirichlet(np.ones(num_accel_types) * 2.0)
        for a in range(num_accel_types):
            out[d, a] = int(round(w[a] * nodes_per_dc))
        out[d] = _fix_sum(out[d], nodes_per_dc)
    return out


def node_mix(seed: int, num_dcs: int, include_tpu: bool = False) -> np.ndarray:
    """NN[d, j]: heterogeneous node counts per DC, rows sum to 4320.

    'most locations having three node types', some with two (paper §6).
    """
    rng = np.random.default_rng(seed)
    jn = NUM_XEON_TYPES + (1 if include_tpu else 0)
    out = np.zeros((num_dcs, jn), np.int64)
    for d in range(num_dcs):
        if d % 4 == 3:  # every 4th DC has two node types
            w = rng.dirichlet(np.ones(2) * 4.0)
            types = rng.choice(NUM_XEON_TYPES, 2, replace=False)
            for t, wi in zip(types, w):
                out[d, t] = int(round(wi * NODES_PER_DC))
        else:
            w = rng.dirichlet(np.ones(NUM_XEON_TYPES) * 4.0)
            for t in range(NUM_XEON_TYPES):
                out[d, t] = int(round(w[t] * NODES_PER_DC))
        if include_tpu:
            # carve out a TPU aisle (beyond-paper)
            out[d, -1] = NODES_PER_DC // AISLES_PER_DC
        out[d, : NUM_XEON_TYPES] = _fix_sum(out[d, : NUM_XEON_TYPES], NODES_PER_DC - out[d, -1] if include_tpu else NODES_PER_DC)
    return out


def _fix_sum(row: np.ndarray, want: int) -> np.ndarray:
    diff = want - row.sum()
    j = int(np.argmax(row))
    row[j] += diff
    return row

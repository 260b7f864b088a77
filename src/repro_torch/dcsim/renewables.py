"""Renewable power generation: diurnal solar + stochastic wind, per location.

A copy of ``repro.dcsim.renewables`` (host-side numpy, the same RNG stream).

NSRDB-shaped procedural generators (seeded, documented): solar follows a
clipped cosine of local solar hour scaled by a monthly insolation factor;
wind is a seeded AR(1) process around each site's capacity factor. Units
are watts of on-site generation per data center.
"""
from __future__ import annotations

import numpy as np

# monthly insolation scale (northern hemisphere, Jun=1.0)
MONTH_SOLAR = np.array([0.55, 0.62, 0.75, 0.85, 0.95, 1.00, 0.98, 0.92, 0.82, 0.70, 0.58, 0.52])
MONTH_WIND = np.array([1.10, 1.08, 1.05, 1.00, 0.92, 0.85, 0.82, 0.85, 0.92, 1.00, 1.06, 1.10])


def renewable_profile(
    tz_offsets: np.ndarray,      # (D,) hours vs UTC
    solar_cap: np.ndarray,       # (D,) capacity factors 0..1
    wind_cap: np.ndarray,        # (D,)
    installed_w: float,          # nameplate W per DC
    month: int,                  # 1..12
    seed: int,
) -> np.ndarray:
    """RP[d, 24] watts available at each UTC hour of a representative day."""
    d = len(tz_offsets)
    rng = np.random.default_rng(seed * 100 + month)
    hours = np.arange(24)
    rp = np.zeros((d, 24))
    for i in range(d):
        local = (hours + tz_offsets[i]) % 24
        # solar: cosine bump centered at 13:00 local, ~7h half-width
        ang = (local - 13.0) / 7.0 * (np.pi / 2)
        solar = np.clip(np.cos(ang), 0.0, None) ** 1.3
        solar *= solar_cap[i] * MONTH_SOLAR[month - 1]
        # wind: AR(1) around site capacity, mildly nocturnal
        w = np.zeros(24)
        x = 0.0
        for h in range(24):
            x = 0.7 * x + 0.3 * rng.normal(0.0, 0.35)
            w[h] = x
        wind = np.clip(wind_cap[i] * MONTH_WIND[month - 1] * (1.0 + w + 0.15 * np.cos((local - 2) / 24 * 2 * np.pi)), 0.0, 1.2)
        rp[i] = installed_w * (0.6 * solar + 0.4 * wind)
    return rp

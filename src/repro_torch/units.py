"""Named unit-conversion constants — the only sanctioned scale factors.

A copy of ``repro.units``, verbatim in its values.

The simulator core mixes $/kWh prices with W of IT power, GB payloads with
token counts, and ms latencies with tasks/h rates; a scale factor applied
(or dropped) in the wrong place is a silent bug. Every cross-unit conversion
therefore goes through a constant below, each declared with its unit via
``# lint: unit(...)``.
"""
from __future__ import annotations

W_PER_KW = 1000.0            # lint: unit(W/kW)
MS_PER_H = 3.6e6             # lint: unit(ms/h)
S_PER_H = 3600.0             # lint: unit(s/h)
BYTES_PER_GB = 1e9           # lint: unit(B/GB)
BYTES_PER_GIB = 2.0 ** 30    # lint: unit(B/GiB)
BYTES_PER_FP32_TOKEN = 4.0   # lint: unit(B/token)

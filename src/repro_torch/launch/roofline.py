"""The reference chip constants of ``repro.launch.roofline``, copied as data.

``dcsim.topology`` specs the simulated accelerator fleet of the ``llm``
workload relative to these three numbers (``topology._accel_types``). They are
inputs of the simulator, the same in both packages, and say nothing about the
card this package runs on. The roofline analyzer itself is not ported.
"""
from __future__ import annotations

PEAK_FLOPS = 197e12     # bf16 per chip  # lint: unit(FLOP/s)
HBM_BW = 819e9          # per chip  # lint: unit(B/s)
ICI_BW = 50e9           # per link  # lint: unit(B/s)

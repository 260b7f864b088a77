#!/usr/bin/env python3
"""Count what one fd hour launches on the card, for one source tree.

    python3 count_launches.py [--src DIR] [--taps-first]

Runs ``chip_smoke.py``'s ``[sched-profile]`` hour (fd, the priced D = 16
fleet, routed, cost_sla, taps off) from the ``repro_torch`` package under
``DIR`` (default: this checkout's ``src``): once to warm up, once under a
``TorchDispatchMode`` that counts the torch operators dispatched, and once
under ``torch.profiler`` that counts the card's kernels, as ``[sched-profile]``
does. ``--taps-first`` runs the same hour with ``engine/hour`` and
``game/nash_residual`` live before the counted runs (a tree without
``repro_torch.obs`` refuses it). Two commits are compared in one session on
the card: unpack the other under a directory ``.gitignore`` lists (``git
archive``) and run parent, change, change, parent. Prints one JSON line;
exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the directory that holds the repro_torch package to count")
    parser.add_argument("--taps-first", action="store_true",
                        help="run the hour with its taps live before counting")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("count_launches: no CUDA device", file=sys.stderr)
        return 1
    src = args.src.resolve()
    sys.path.insert(0, str(src))
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import ExperimentSpec, run
    from repro_torch.dcsim import env as E
    from repro_torch.dcsim import latency
    if not Path(E.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"count_launches: repro_torch came from {E.__file__}")

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.count = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.count[str(func)] += 1
            return func(*args, **(kwargs or {}))

    dev = torch.device("cuda")
    env = E.build_env(16, seed=0, device=dev)
    rtt = torch.from_numpy(latency.rtt_matrix(num_dcs=16).astype(np.float32)).to(dev)
    env = env._replace(rtt=rtt, sla_price=torch.full_like(env.sla_price, 1e-4))
    spec = ExperimentSpec(technique="fd", objective="cost_sla", routed=True, hours=1)
    if args.taps_first:
        run(spec.replace(taps=("engine/hour", "game/nash_residual")), env)
    run(spec, env)
    with Ops() as ops:
        day = run(spec, env)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(spec, env)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    print(json.dumps({
        "src": str(src), "taps_first": args.taps_first,
        "device": torch.cuda.get_device_name(0),
        "ops": sum(ops.count.values()), "kernels": sum(e.count for e in kernels),
        "kernels_by_name": {e.key[:80]: e.count for e in kernels},
        "cost_usd": day["totals"]["cost_usd"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

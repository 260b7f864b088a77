"""Readings for a cell's correctness limit: the program's widest logit gap
on many seeds and the float8 control's on some, in one process.

    python3 -m portbench.calibrate --workload <name> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--witness-seeds 11] [--fault-seeds 21,22] \
        [--faults token_altered,...] [--seconds 1] [--out FILE]

Each seed is a whole run of the cell (``harness.run``: its weights, warm-up,
a short window at the cell's own load, the check); a control seed also
reads the control's gap on the same sample, and a witness seed the bf16
witness's (``check.judge``), and judges the control by the cell's limits
as a run judges the program (``control_correct``, which has to be false).
A fault seed runs the cell once more for each fault of ``faults.py``
(``--faults``, all by default) planted under the timed path: its
``correct`` has to be false. One JSON line per run. The benchmark's own runs never run the control.
"""
import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

import torch  # noqa: E402

from portbench import check, faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default=",".join(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, CHECKOUT)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    witness = {int(s) for s in args.witness_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), f) for s in args.fault_seeds.split(",") if s
             for f in args.faults.split(",")]
    for seed, fault in runs:
        others = () if fault else ((("fp8",) if seed in control else ())
                                   + (("bf16",) if seed in witness else ()))
        t0 = time.perf_counter()
        with faults.planted(fault) if fault else contextlib.nullcontext():
            res = harness.run(cell, seed, args.seconds, False, t_start=t0, device="cuda",
                              others=others)
        line = {"cell": cell.name, "seed": seed, "fault": fault, "correct": res["correct"],
                "batches_requests": res["attempted"], **res["_numbers"], "check": res["check"],
                "tokens_per_s": res["metrics"]["tokens_per_s"]["value"],
                "seconds": time.perf_counter() - t0,
                "card": torch.cuda.get_device_name(0)}
        if "fp8" in others:  # the control judged by the cell's own limits
            checks = check.control_verdict(res["_numbers"], cell.limit)
            line["control_correct"] = check.within(checks)
            line["control_check"] = checks
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The card benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. It sets up the
cell of ``BENCHMARK.json`` (weights drawn on the card from the seed, the
kernels built or loaded, one warm-up batch of the traffic's shapes), drives
``repro_torch.launch.serve.ModelServer.generate`` for ``--seconds`` (with
``--trace 1``, then the mix's traced batches under the profiler), checks
the served tokens against the plain reference, and prints one JSON line last
on standard output, the compared numbers with their limits last on standard
error. Without a card, or with fewer cards than the cell asks for, it exits
2 and prints no result; where the run loaded JAX or the JAX package, 3.
"""
import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
for _path in (str(CHECKOUT / "src"), str(CHECKOUT)):  # the port, and this package
    if _path not in sys.path:
        sys.path.insert(0, _path)

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock, from the
    kernel's record of it (``/proc/self/stat``, to 10 ms), so that set-up
    counts the interpreter's start too; the import of this module where
    that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return T_IMPORT
    return time.perf_counter() - max(0.0, uptime - started)


def emit(result) -> int:
    """Print the result line last on standard output and the compared
    numbers last on standard error; where this process has loaded JAX or the
    JAX package, print no result and return 3."""
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}: the port must run without them",
              file=sys.stderr)
        return 3
    lines = result.pop("_lines")
    result.pop("_numbers")
    result["check"] = result.pop("check")  # the compared numbers, last
    print(json.dumps(result), flush=True)
    print(lines, file=sys.stderr, flush=True)
    return 0


def main(argv=None) -> int:
    t_start = process_start()
    # every build and kernel cache inside the checkout, at fixed paths (the
    # port's own kernels build into build/kernels/ there)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CHECKOUT / "build" / "portbench" / "cache" / sub)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, CHECKOUT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one process, few host threads: the host paces decode
    return emit(harness.run(cell, args.seed, args.seconds, bool(args.trace),
                            t_start=t_start, device="cuda"))


if __name__ == "__main__":
    sys.exit(main())

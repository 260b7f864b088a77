"""One run of one cell: set-up, the measured window, the traced batches, the
check, and the result line.

``run(cell, seed, seconds, trace)`` is what ``run.py`` calls on the card;
the tests call it on the CPU at a small size (``device="cpu"``), with a
fault planted underneath where they need one. The window drives
``repro_torch.launch.serve.ModelServer.generate`` in a closed loop: one
client hands the mix's batches to ``generate`` back to back, in arrival
order, starting a batch only while ``seconds`` have not elapsed; the window
closes when the last batch returns, so it holds whole batches. A traced run
serves the same window, then the mix's ``trace_batches`` batches under the
profiler, and reports the per-layer metrics: what the host's clock measures
from the window, what the device did from the traced batches. Where a
per-layer metric of the cell reads the program (``PROGRAM = True`` in its
file, with the taps it reads under ``TAPS``), a traced run then serves one
more batch under the profiler, the program batch, with the program's own
spans recorded (``obs.spans.recording()``) and those taps captured, and
hands its reduction to the metrics (``View.program``, ``View.taps``); the
traced batches before it are served and reduced with recording off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from . import archs, check, tracing, traffic, weights

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]  # the configuration file
    mix: Dict[str, Any]  # the traffic file
    limit: Dict[str, Any]  # limits/<cell>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_root: Path) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=w["chips"],
        config=json.loads((bench_root / conf["file"]).read_text()),
        mix=json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text()),
        limit=json.loads((ROOT / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

def port_config(cfg: Dict, pc=None):
    """The port's registry entry for the configuration file (or ``pc``, a
    config of the port given in its place), held to the file's published
    numbers by the file's architecture module."""
    if pc is None:
        from repro_torch.configs import get_config

        pc = get_config(cfg["port_arch"])
    archs.of(cfg).check_port_config(pc, cfg)
    return pc


@contextlib.contextmanager
def _given_weights(params):
    """``ModelServer`` takes the benchmark's weights: the port's ``init``
    returns them while the server is built, so it draws none of its own."""
    from repro_torch.models import model as model_lib

    saved = model_lib.init
    model_lib.init = lambda cfg, **kw: params
    try:
        yield
    finally:
        model_lib.init = saved


def build_server(port_cfg, params, mix: Dict, device):
    from repro_torch.launch.serve import ModelServer

    with _given_weights(params):
        server = ModelServer(port_cfg, batch_size=mix["batch"], cache_len=mix["cache_len"],
                             seed=0, device=device)
    if server.params is not params:
        raise RuntimeError("ModelServer did not take the benchmark's weights")
    return server


class Taps:
    """The harness's wrappers of the two step functions ``generate`` calls
    (``serve.prefill_step`` and ``serve.decode_step``): the prefill's span by
    the host clock, ended after a synchronize (``generate`` synchronizes
    there itself), and the token every decode step takes (the one the
    previous pass produced, for every row), kept without a copy or a read
    of the device."""

    TARGET = "repro_torch.launch.serve"

    def __init__(self, clock):
        self.fed: List[torch.Tensor] = []
        self.prefill: List[tuple] = []
        self._module = importlib.import_module(self.TARGET)
        self._orig = (self._module.prefill_step, self._module.decode_step)
        prefill_step, decode_step = self._orig

        def prefill(params, batch, **kwargs):
            t0 = time.perf_counter()
            out = prefill_step(params, batch, **kwargs)
            self.prefill.append((t0, clock()))
            return out

        def decode(params, token, *args, **kwargs):
            self.fed.append(token)
            return decode_step(params, token, *args, **kwargs)

        self._module.prefill_step, self._module.decode_step = prefill, decode

    def take(self):
        """(the tokens its decode steps took, each (rows, 1), the prefill's
        (start, end)) of the batch just served."""
        fed = self.fed
        span = self.prefill[-1] if self.prefill else (float("nan"), float("nan"))
        self.fed, self.prefill = [], []
        return fed, span

    def remove(self) -> None:
        self._module.prefill_step, self._module.decode_step = self._orig


def requests(batch: traffic.Batch):
    from repro_torch.launch.serve import Request

    return [Request(uid, torch.from_numpy(p), n)
            for uid, (p, n) in enumerate(zip(batch.prompts, batch.max_new))]


def serve_one(server, batch: traffic.Batch, taps: Taps) -> check.Served:
    reqs = requests(batch)
    t_hand = time.perf_counter()
    outs = server.generate(reqs)
    t_return = time.perf_counter()
    fed, (p0, p1) = taps.take()
    return check.Served(batch, [outs[uid] for uid in range(len(reqs))], fed,
                        t_hand=t_hand, prefill_start=p0, first_token=p1, t_return=t_return)


def warm_up(server, mix: Dict, vocab: int, seed: int, taps: Taps) -> None:
    """One batch of the mix's own shapes (the padded prompt every batch has,
    two decode positions): builds and loads the kernels, and runs every
    product and kernel shape the window runs."""
    b = next(traffic.batches(mix, vocab, seed, traffic.STREAM_WARMUP))
    b.max_new = [min(n, 2) for n in b.max_new]
    server.generate(requests(b))
    taps.take()


def failed_requests(served: List[check.Served], vocab: int) -> int:
    """Requests whose output is not ``max_new`` token ids of the vocabulary."""
    bad = 0
    for s in served:
        for out, n in zip(s.outs, s.batch.max_new):
            bad += int(len(out) != n or not all(0 <= t < vocab for t in out))
    return bad


def forbidden_modules() -> List[str]:
    """The top-level names of ``FORBIDDEN`` that this process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def metric_module(name: str):
    """``metrics/<name>.py``, loaded by its file (a name may hold dots)."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class View:
    """What a metric's reader reads. ``served`` and ``window_s`` are the
    measured window, served without the profiler; ``traced`` the batches
    served after it under the profiler, with its reduced ``trace`` and the
    ranges' ``notes`` (a traced run only, else empty and None);
    ``program_served`` the program batch, with the reduction of the
    program's spans in its trace (``program``) and each captured tap's
    values (``taps``: name -> values in order; a traced run whose cell has a
    metric that reads the program only, else empty and None)."""

    cfg: Dict[str, Any]
    setup_s: float
    served: List[check.Served]
    window_s: float
    traced: List[check.Served] = dataclasses.field(default_factory=list)
    trace: Optional[tracing.Trace] = None
    notes: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)
    program_served: List[check.Served] = dataclasses.field(default_factory=list)
    program: Optional[tracing.Program] = None
    taps: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)


def p95(values: List[float]) -> float:
    """The 95th percentile (``statistics.quantiles``' exclusive method; the
    largest value below 20 samples)."""
    if len(values) < 20:
        return max(values)
    return statistics.quantiles(values, n=20)[18]


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def _clock_for(device: torch.device):
    def clock() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()
    return clock


def _traced_batches(server, source, taps: Taps, metrics, n: int, clock):
    """``n`` batches under the profiler, with every metric's ranges."""
    ranges, wrapped = tracing.Ranges(), set()
    try:
        for mod in metrics:
            for target, rng_name, note in mod.RANGES:
                if target not in wrapped:
                    ranges.wrap(target, rng_name, note)
                    wrapped.add(target)
        with tracing.profiled() as prof:
            clock()
            traced = [serve_one(server, next(source), taps) for _ in range(n)]
    finally:
        ranges.remove()
    return traced, prof, dict(ranges.notes)


def _program_batch(server, source, taps: Taps, names: List[str], clock):
    """One batch under the profiler with the program's spans recorded and
    the taps ``names`` captured: (its ``check.Served``, the profile, each
    tap's values)."""
    from repro_torch import obs

    with obs.spans.recording(), obs.capture(*names) as buf:
        with tracing.profiled() as prof:
            clock()
            served = serve_one(server, next(source), taps)
    return served, prof, {n: buf.by_name(n) for n in names}


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, t_start: float,
        device="cuda", port_cfg=None, others=(),
        log=lambda msg: print(msg, file=sys.stderr, flush=True)) -> Dict[str, Any]:
    """One run; returns the result object (``check_lines`` under ``"_lines"``,
    every number the check read under ``"_numbers"``)."""
    device = torch.device(device)
    clock = _clock_for(device)
    cfg, mix = cell.config, cell.mix
    traffic.check_fits(mix)
    port_cfg = port_config(cfg, port_cfg)

    marks = [("start", time.perf_counter())]
    params = weights.draw(cfg, seed, device)
    clock()
    marks.append(("weights", time.perf_counter()))
    server = build_server(port_cfg, params, mix, device)
    marks.append(("server", time.perf_counter()))
    metrics = [metric_module(m["name"]) for m in (cell.per_layer if trace else cell.end_to_end)]
    program = trace and any(getattr(mod, "PROGRAM", False) for mod in metrics)
    tap_names = list(dict.fromkeys(n for mod in metrics for n in getattr(mod, "TAPS", ())))
    taps = Taps(clock)
    try:
        warm_up(server, mix, cfg["vocab_size"], seed, taps)
        gc.collect()
        clock()
        setup_s = time.perf_counter() - t_start
        marks.append(("warm-up", time.perf_counter()))
        parts = [f"{a} {t1 - t0:.3f}" for (_, t0), (a, t1) in zip(marks, marks[1:])]
        log(f"portbench: {cell.name} seed {seed}: set-up {setup_s:.3f} s (to run() "
            f"{marks[0][1] - t_start:.3f}, {', '.join(parts)}), weights "
            f"{weights.nbytes(params) / 2 ** 30:.2f} GiB")

        source = traffic.batches(mix, cfg["vocab_size"], seed)
        served: List[check.Served] = []
        gc.disable()
        try:
            w0 = clock()
            while not served or time.perf_counter() - w0 < seconds:
                served.append(serve_one(server, next(source), taps))
            window_s = served[-1].t_return - w0
        finally:
            gc.enable()
        view = View(cfg, setup_s, served, window_s)
        if trace:
            view.traced, prof, view.notes = _traced_batches(
                server, source, taps, metrics, mix["trace_batches"], clock)
        if program:
            served_p, prof_p, view.taps = _program_batch(server, source, taps, tap_names,
                                                         clock)
            view.program_served = [served_p]
    finally:
        taps.remove()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    requests_n = sum(len(s.outs) for s in served)
    result: Dict[str, Any] = {
        "correct": False, "attempted": requests_n,
        "failed": failed_requests(served, cfg["vocab_size"]), "metrics": {},
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        t_reduce = time.perf_counter()
        t = tracing.reduce_events(prof["events"], prof["window"])
        del prof
        view.trace = t
        log(f"portbench: reduced {t.device_events} device operations in "
            f"{time.perf_counter() - t_reduce:.3f} s, {t.unlinked} without a launch; ranges: "
            f"calls {t.range_calls}, kernels {t.range_kernels}, device s {t.range_device_s}")
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": [[n, s] for n, s in t.device_ops],
                               "idle_gaps": [[n, s] for n, s in t.idle_gaps]}
    if program:
        t_reduce = time.perf_counter()
        view.program = tracing.reduce_program(prof_p["events"], prof_p["window"])
        del prof_p
        log(f"portbench: reduced the program batch's {len(view.program.by_name)} span names "
            f"in {time.perf_counter() - t_reduce:.3f} s; taps: "
            + ", ".join(f"{n} {len(v)}" for n, v in view.taps.items()))
    for m, mod in zip(cell.per_layer if trace else cell.end_to_end, metrics):
        v = mod.read(view)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    log(f"portbench: window {window_s:.3f} s, {len(served)} batches, {requests_n} requests; "
        "a batch's seconds (prefill, decode): "
        + " ".join(f"{s.t_return - s.t_hand:.3f}({s.first_token - s.prefill_start:.3f},"
                   f"{s.t_return - s.first_token:.3f})"
                   for s in served + view.traced + view.program_served))

    # the check: the program's state freed first; the weights are the benchmark's
    del server, view
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.judge(served, cfg, params, cell.limit["served_tokens"], seed,
                          device=device, others=others)
    checks = check.verdict(numbers, cell.limit, check.fed_mismatches(served))
    result["correct"] = check.within(checks) and result["failed"] == 0
    extra = {k: v for k, v in numbers.items() if k not in checks}
    extra["check_s"] = time.perf_counter() - t_check
    result["check"] = checks
    result["_lines"] = check.check_lines(checks, extra)
    result["_numbers"] = numbers
    return result

"""The program's own spans and counter in a traced run, and the readings
built on them.

    python3 -m portbench.program_spans --workload <name> --seeds 11,12,13 \
        [--seconds 25] [--out FILE]

``repro_torch`` records spans inside ``obs.spans.recording()`` only, each a
``repro_torch/<name>`` range of the profiler, and emits the ``moe/dispatch``
tap inside ``obs.capture``. The benchmark's runs turn neither on, so its
per-layer metrics cannot read them yet; this tool takes the readings on
the card the way a run would. For each seed it sets the cell up as a run
does (weights drawn from the seed, the server, one warm-up batch), serves
two windows of ``--seconds`` of the cell's closed loop, one with span
recording off and one with it on (off first on even seeds), then the mix's
traced batches under the profiler with recording and the tap on and the
per-layer metrics' ranges around them, then the first traced batch again
with recording off. It prints one JSON line a seed: each window's
``tokens_per_s``, ``ttft_p95_ms`` and ``decode_step_ms``; the accepted
per-layer metrics over the traced batches with the program's ranges taken
out of the events (``per_layer``) and left in (``per_layer_as_is``: the
benchmark's reduction would count any device-side copy of them as device
work);
the five readings of :func:`readings`; the spans by phase; the decode
step's self host time by span; the idle gaps labelled with the spans open
at them; whether the replayed batch's tokens equal the traced ones.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import harness, tracing, traffic, weights

CHECKOUT = Path(__file__).resolve().parents[1]
RANGE_PREFIX = "repro_torch/"  # the program's ranges (``obs.spans.RANGE_PREFIX``)
ROOT_SPAN = "serve.generate"
# the CUDA runtime's calls that wait for the card
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
ROUTING = ("moe.route", "moe.aux", "moe.dispatch", "moe.combine")  # the MoE less its products
WINDOW_METRICS = ("tokens_per_s", "ttft_p95_ms", "decode_step_ms")


@dataclasses.dataclass
class Program:
    """The program's spans in a trace. A row holds ``calls``, ``host_s``,
    ``device_s`` and ``ops`` (the device operations launched inside the
    span, nested spans included) and ``syncs`` (the runtime's waits for the
    card inside it). ``by_phase`` keys a row by (phase, name): the phase is
    the span directly under ``serve.generate`` that holds it (a span
    outside any ``serve.generate`` is its own outermost span's)."""

    by_name: Dict[str, Dict[str, float]]
    by_phase: Dict[Tuple[str, str], Dict[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def row(self, name: str, phase: Optional[str] = None) -> Dict[str, float]:
        got = self.by_name.get(name) if phase is None else self.by_phase.get((phase, name))
        return got or _row()


def _row() -> Dict[str, float]:
    return {"calls": 0, "host_s": 0.0, "device_s": 0.0, "ops": 0, "syncs": 0}


def without_program(events) -> list:
    """The events less the program's ranges and their device-side copies:
    what the benchmark's reduction reads from a run that records no span."""
    return [ev for ev in events if not ev.name().startswith(RANGE_PREFIX)]


def _phases(spans: List[Tuple[int, int, str]]) -> List[str]:
    """Each span's phase, the spans sorted by (start, -end); spans of one
    thread nest, so a stack of the open ones gives each its outermost two."""
    phases, stack = [], []
    for s, e, name in spans:
        while stack and stack[-1][0] <= s:
            stack.pop()
        stack.append((e, name))
        outer = [n for _, n in stack[:2]]
        phases.append(outer[1] if outer[0] == ROOT_SPAN and len(outer) > 1 else outer[0])
    return phases


def reduce_program(events, window: Tuple[int, int]) -> Program:
    """The program's spans in the profiler's raw events over ``window``. A
    device operation belongs to every span open when the host launched it,
    by the launch's runtime event (or the host operation linked to it), as
    ``tracing.reduce_events`` attributes the benchmark's ranges."""
    dev_s, dev_e, dev_corr, dev_link = [], [], [], []
    runtime: Dict[int, int] = {}
    frontend: Dict[int, int] = {}
    syncs: List[int] = []
    spans: List[Tuple[int, int, str]] = []
    host_s, host_e, host_names = [], [], []
    bench: Dict[str, List[Tuple[int, int]]] = collections.defaultdict(list)
    cuda = torch.autograd.DeviceType.CUDA
    for ev in events:
        name, start = ev.name(), ev.start_ns()
        if ev.device_type() == cuda:
            if name.startswith((RANGE_PREFIX, tracing.PREFIX)) or name == tracing.WINDOW:
                continue
            dev_s.append(start)
            dev_e.append(start + ev.duration_ns())
            dev_corr.append(ev.correlation_id())
            dev_link.append(ev.linked_correlation_id())
        elif name.startswith("cu"):
            runtime[ev.correlation_id()] = start
            if name in SYNCS:
                syncs.append(start)
        else:
            end = start + ev.duration_ns()
            frontend[ev.correlation_id()] = start
            if name.startswith(RANGE_PREFIX):
                spans.append((start, end, name[len(RANGE_PREFIX):]))
            elif name.startswith(tracing.PREFIX):
                bench[name[len(tracing.PREFIX):]].append((start, end))
            elif name != tracing.WINDOW:
                host_s.append(start)
                host_e.append(end)
                host_names.append(name)

    launched = np.asarray([runtime.get(c, frontend.get(link, -1))
                           for c, link in zip(dev_corr, dev_link)], dtype=np.int64)
    dur = np.asarray(dev_e, dtype=np.int64) - np.asarray(dev_s, dtype=np.int64)
    order = np.argsort(launched, kind="stable")
    at, cum = launched[order], np.concatenate([[0], np.cumsum(dur[order])])
    waits = np.sort(np.asarray(syncs, dtype=np.int64))

    spans.sort(key=lambda x: (x[0], -x[1]))
    by_name: Dict[str, Dict[str, float]] = {}
    by_phase: Dict[Tuple[str, str], Dict[str, float]] = {}
    for (s, e, name), phase in zip(spans, _phases(spans)):
        lo, hi = np.searchsorted(at, s, side="left"), np.searchsorted(at, e, side="right")
        nsync = int(np.searchsorted(waits, e, side="right") - np.searchsorted(waits, s))
        for row in (by_name.setdefault(name, _row()), by_phase.setdefault((phase, name), _row())):
            row["calls"] += 1
            row["host_s"] += (e - s) / 1e9
            row["device_s"] += float(cum[hi] - cum[lo]) / 1e9
            row["ops"] += int(hi - lo)
            row["syncs"] += nsync

    # the device's idle gaps, as reduce_events finds them, labelled with the
    # program's spans and the benchmark's ranges open at each
    starts, ends = np.asarray(dev_s, dtype=np.int64), np.asarray(dev_e, dtype=np.int64)
    gaps: List[Tuple[int, int]] = []
    if len(starts):
        _, inner = tracing._union(starts, ends)
        gaps = [(window[0], int(starts.min()))] + inner + [(int(ends.max()), window[1])]
    opened = collections.defaultdict(list)
    for s, e, name in spans:
        opened[name].append((s, e))
    for name, iv in bench.items():
        opened[tracing.PREFIX + name] = sorted(iv)
    ranges = {n: (np.asarray([s for s, _ in iv], dtype=np.int64),
                  np.asarray([e for _, e in iv], dtype=np.int64)) for n, iv in opened.items()}
    hs, he = np.asarray(host_s, dtype=np.int64), np.asarray(host_e, dtype=np.int64)
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:tracing.TOP]
    labels = [(tracing._host_label((a + b) // 2, hs, he, host_names, ranges), (b - a) / 1e9)
              for a, b in top]
    return Program(by_name, by_phase, labels)


def readings(p: Program, traced, dispatch: List[Dict[str, Any]]) -> Dict[str, float]:
    """The five per-layer readings of the traced batches (``traced``, their
    ``check.Served``) from their spans and their ``moe/dispatch`` events;
    a reading with nothing to read is left out."""
    out: Dict[str, float] = {}
    decode, readback = p.row("serve.decode", "serve.decode"), p.row("serve.readback")
    if decode["ops"]:  # the host's time a device operation launched at decode
        out["decode_host_us_per_launch"] = decode["host_s"] * 1e6 / decode["ops"]
    if readback["calls"]:  # one readback a generated token
        out["decode_syncs_per_step"] = ((readback["syncs"] + p.row("serve.decode")["syncs"])
                                        / readback["calls"])
    prompt = sum(len(q) for s in traced for q in s.batch.prompts)
    norm_rope = sum(p.row(n, "serve.prefill")["device_s"] for n in ("norm", "rope"))
    if prompt and norm_rope > 0:
        out["norm_rope_ms_per_ktok"] = norm_rope * 1e3 / (prompt / 1e3)
    slots = sum(int(v["slots"]) for v in dispatch)
    if slots:  # the share of the expert products' rows that hold a pair
        out["moe_slot_fill"] = 100.0 * sum(int(np.sum(v["keep"])) for v in dispatch) / slots
    # the tokens moe_device_ms_per_ktok counts: padded prompts, a row a step
    tokens = sum(len(s.outs) * (s.batch.padded_len + s.batch.steps - 1) for s in traced)
    routing = sum(p.row(n)["device_s"] for n in ROUTING)
    if tokens and routing > 0:
        out["moe_routing_ms_per_ktok"] = routing * 1e3 / (tokens / 1e3)
    return out


def decode_self_ms(recorded) -> Dict[str, float]:
    """Self host milliseconds a decode step, by span name, of the spans
    inside ``serve.decode`` (the step's own span included)."""
    from repro_torch import obs

    def in_decode(s) -> bool:
        while s.parent is not None and s.name != "serve.decode":
            s = s.parent
        return s.name == "serve.decode"

    rows = obs.spans.summary([s for s in recorded if in_decode(s)])
    steps = rows.get("serve.decode", {}).get("calls", 0)
    return {n: r["self_s"] * 1e3 / steps
            for n, r in sorted(rows.items(), key=lambda kv: -kv[1]["self_s"])} if steps else {}


def _window(server, source, taps, seconds: float, clock):
    """The cell's closed loop for ``seconds``, as a run serves its window."""
    served = []
    gc.disable()
    try:
        w0 = clock()
        while not served or time.perf_counter() - w0 < seconds:
            served.append(harness.serve_one(server, next(source), taps))
    finally:
        gc.enable()
    return served, served[-1].t_return - w0


def measure(cell: harness.Cell, seed: int, seconds: float, *, device="cuda",
            port_cfg=None) -> Dict[str, Any]:
    """One seed's readings (see the module docstring)."""
    from repro_torch import obs

    device = torch.device(device)
    clock = harness._clock_for(device)
    cfg, mix = cell.config, cell.mix
    params = weights.draw(cfg, seed, device)
    server = harness.build_server(port_cfg if port_cfg is not None else harness.port_config(cfg),
                                  params, mix, device)
    metrics = [harness.metric_module(m["name"]) for m in cell.per_layer]
    taps = harness.Taps(clock)
    views: Dict[str, harness.View] = {}
    try:
        harness.warm_up(server, mix, cfg["vocab_size"], seed, taps)
        source = traffic.batches(mix, cfg["vocab_size"], seed)
        for mode in ("off", "on") if seed % 2 == 0 else ("on", "off"):
            gc.collect()
            with obs.spans.recording() if mode == "on" else contextlib.nullcontext():
                views[mode] = harness.View(cfg, 0.0, *_window(server, source, taps, seconds,
                                                              clock))
        obs.reset_stats()
        with obs.spans.recording(), obs.capture("moe/dispatch") as buf:
            traced, prof, notes = harness._traced_batches(server, source, taps, metrics,
                                                          mix["trace_batches"], clock)
        recorded = obs.all_spans()
        replay = harness.serve_one(server, traced[0].batch, taps)
    finally:
        taps.remove()
    dispatch = buf.by_name("moe/dispatch")
    events, span_ns = prof["events"], prof["window"]
    program = reduce_program(events, span_ns)
    windows = {mode: {"batches": len(v.served), "window_s": v.window_s,
                      **{m: harness.metric_module(m).read(v) for m in WINDOW_METRICS}}
               for mode, v in views.items()}
    off = views["off"]
    per_layer = {}
    for key, evs in (("per_layer", without_program(events)), ("per_layer_as_is", events)):
        trace = tracing.reduce_events(evs, span_ns)
        view = harness.View(cfg, 0.0, off.served, off.window_s, traced=traced, trace=trace,
                            notes=notes)
        per_layer[key] = {m["name"]: mod.read(view) for m, mod in zip(cell.per_layer, metrics)}
        per_layer[key]["busy_s"] = trace.busy_s
    decode = program.row("serve.decode", "serve.decode")
    kept = sum(int(np.sum(v["keep"])) for v in dispatch)
    return {
        "cell": cell.name, "seed": seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "windows": windows, **per_layer,
        "program": readings(program, traced, dispatch),
        "decode_span_over_window_step": (
            decode["host_s"] * 1e3 / decode["calls"] / windows["off"]["decode_step_ms"]
            if decode["calls"] and windows["off"]["decode_step_ms"] else None),
        "dispatch": {"events": len(dispatch), "routed": sum(int(v["routed"]) for v in dispatch),
                     "kept": kept, "slots": sum(int(v["slots"]) for v in dispatch)},
        "by_phase": {f"{ph} | {n}": r for (ph, n), r in sorted(program.by_phase.items())},
        "decode_self_ms": decode_self_ms(recorded),
        "idle_gaps": program.idle_gaps,
        "replay_equal": replay.outs == traced[0].outs,
    }


def main(argv=None) -> int:
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("program_spans: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload, CHECKOUT)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(measure(cell, seed, args.seconds))
        print(line, flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

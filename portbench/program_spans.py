"""The program's own spans and counter in a traced run, and the readings
built on them.

    python3 -m portbench.program_spans --workload <name> --seeds 11,12,13 \
        [--seconds 25] [--out FILE]

``repro_torch`` records spans inside ``obs.spans.recording()`` only, each a
``repro_torch/<name>`` range of the profiler, and emits the ``moe/dispatch``
tap inside ``obs.capture``. A traced run of the benchmark turns both on for
one batch of its own when a per-layer metric of the cell reads the program
(``harness.py``; ``decode_syncs_per_step`` does). This tool takes all five
readings on the card, and what recording costs. For each seed it sets the
cell up as a run does (weights drawn from the seed, the server, one warm-up
batch), serves two windows of ``--seconds`` of the cell's closed loop, one
with span recording off and one with it on (off first on even seeds), then
the mix's traced batches under the profiler with recording and the tap on
and the per-layer metrics' ranges around them, then the first traced batch
again with recording off. It prints one JSON line a seed: each window's
``tokens_per_s``, ``ttft_p95_ms`` and ``decode_step_ms``; the accepted
per-layer metrics over the traced batches with the program's ranges taken
out of the events (``per_layer``) and left in (``per_layer_as_is``: the
benchmark's reduction would count any device-side copy of them as device
work); the five readings of :func:`readings`; the spans by phase; the
decode step's self host time by span; the idle gaps labelled with the spans
open at them; whether the replayed batch's tokens equal the traced ones.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import harness, tracing, traffic, weights
from portbench.tracing import RANGE_PREFIX, Program, _row, reduce_program  # noqa: F401 (_row: the tests')

CHECKOUT = Path(__file__).resolve().parents[1]
ROUTING = ("moe.route", "moe.aux", "moe.dispatch", "moe.combine")  # the MoE less its products
WINDOW_METRICS = ("tokens_per_s", "ttft_p95_ms", "decode_step_ms")


def without_program(events) -> list:
    """The events less the program's ranges and their device-side copies:
    what the benchmark's reduction reads from a run that records no span."""
    return [ev for ev in events if not ev.name().startswith(RANGE_PREFIX)]


def readings(p: Program, traced, dispatch: List[Dict[str, Any]]) -> Dict[str, float]:
    """The five per-layer readings of the traced batches (``traced``, their
    ``check.Served``) from their spans and their ``moe/dispatch`` events;
    a reading with nothing to read is left out."""
    out: Dict[str, float] = {}
    decode = p.row("serve.decode", "serve.decode")
    if decode["ops"]:  # the host's time a device operation launched at decode
        out["decode_host_us_per_launch"] = decode["host_s"] * 1e6 / decode["ops"]
    syncs = harness.metric_module("decode_syncs_per_step").read(
        harness.View({}, 0.0, [], 0.0, program=p))
    if syncs is not None:
        out["decode_syncs_per_step"] = syncs
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
    server = harness.build_server(harness.port_config(cfg, port_cfg), params, mix, device)
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
                            notes=notes, program_served=traced, program=program,
                            taps={"moe/dispatch": dispatch})
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

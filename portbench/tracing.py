"""Traced runs: ranges around the port's module attributes, the profiler,
and the reduction of its events to device time per range.

A per-layer metric's file names the attributes it wraps (``RANGES``). In a
traced run only, :class:`Ranges` replaces each with a wrapper that opens a
``torch.profiler.record_function`` range ``portbench/<range>`` and keeps a
note of the call's shapes; a range entered again inside itself (``moe_apply``
under ``moe_apply_ep``) is not opened twice. :func:`reduce_events` reads the
profiler's raw events: a device operation (kernel, copy or set) belongs to a
range when the host launched it inside the range, by the launch's CUDA
runtime event (or, failing that, by the host operation the profiler links it
to), so every kernel counts whatever implements the wrapped call, ctypes
launches included. :func:`reduce_program` reads the program's own spans
(``repro_torch/<name>`` ranges, which ``repro_torch`` opens inside
``obs.spans.recording()`` only) from a trace the same way, with the CUDA
runtime's waits for the card inside each.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

PREFIX = "portbench/"
WINDOW = "portbench.window"  # the traced window's own range
TOP = 10  # entries of each breakdown list
RANGE_PREFIX = "repro_torch/"  # the program's ranges (``obs.spans.RANGE_PREFIX``)
ROOT_SPAN = "serve.generate"
# the CUDA runtime's calls that wait for the card
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


class Ranges:
    """Wrappers around module attributes, installed until :meth:`remove`."""

    def __init__(self):
        self.notes: Dict[str, List[Any]] = collections.defaultdict(list)
        self._depth: Dict[str, int] = collections.defaultdict(int)
        self._saved: List[Tuple[Any, str, Any]] = []

    def wrap(self, target: str, name: str, note: Optional[Callable] = None) -> None:
        """Wrap ``target`` ("package.module.attribute") in range ``name``."""
        module_name, attr = target.rsplit(".", 1)
        module = importlib.import_module(module_name)
        fn = getattr(module, attr)
        if any(m is module and a == attr for m, a, _ in self._saved):
            raise ValueError(f"{target} is wrapped twice")
        self._saved.append((module, attr, fn))
        label = PREFIX + name

        def wrapped(*args, **kwargs):
            if self._depth[name]:
                return fn(*args, **kwargs)
            self._depth[name] += 1
            try:
                with torch.profiler.record_function(label):
                    if note is not None:
                        self.notes[name].append(note(*args, **kwargs))
                    return fn(*args, **kwargs)
            finally:
                self._depth[name] -= 1

        setattr(module, attr, wrapped)

    def remove(self) -> None:
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()


@dataclasses.dataclass
class Trace:
    """What a traced window's device did, reduced."""

    window_s: float
    busy_s: float
    range_device_s: Dict[str, float]
    range_kernels: Dict[str, int]
    range_calls: Dict[str, int]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    unlinked: int  # device operations whose launch the trace does not show
    device_events: int


def _union(starts: np.ndarray, ends: np.ndarray) -> Tuple[float, List[Tuple[int, int]]]:
    """(covered ns, the gaps between covered spans as (start, end) ns)."""
    order = np.argsort(starts, kind="stable")
    covered, gaps = 0, []
    cur_s, cur_e = None, None
    for s, e in zip(starts[order].tolist(), ends[order].tolist()):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    return covered, gaps


def _host_label(t: int, hs: np.ndarray, he: np.ndarray, names: List[str],
                ranges: Dict[str, Tuple[np.ndarray, np.ndarray]]) -> str:
    """What the host was doing at ``t``: the benchmark ranges open then,
    outermost first, and the innermost host operation."""
    open_ranges = []
    for n, (s, e) in ranges.items():
        i = np.searchsorted(s, t, side="right") - 1
        if i >= 0 and t <= e[i]:
            open_ranges.append((int(s[i]), n))
    open_ops = np.nonzero((hs <= t) & (he >= t))[0]
    op = names[open_ops[np.argmax(hs[open_ops])]] if open_ops.size else "python (no op)"
    return " > ".join([n for _, n in sorted(open_ranges)] + [op])


def reduce_events(events, window: Tuple[int, int]) -> Trace:
    """Reduce the profiler's raw events (``kineto_results.events()``) over the
    window (start, end) in the profiler's ns. Events are told apart by device
    and name (torch 2.11's give no activity type): on the card, operations,
    and copies of the benchmark's ranges under the ranges' names; on the
    host, the CUDA runtime's and driver's calls, which start "cu", and the
    operators and ranges."""
    dev_s, dev_e, dev_name, dev_corr, dev_link = [], [], [], [], []
    runtime: Dict[int, int] = {}
    frontend: Dict[int, int] = {}
    host_s, host_e, host_names = [], [], []
    range_spans: Dict[str, List[Tuple[int, int]]] = collections.defaultdict(list)
    cuda = torch.autograd.DeviceType.CUDA
    for ev in events:  # millions of events: each accessor called once
        name, start = ev.name(), ev.start_ns()
        if ev.device_type() == cuda:
            if name.startswith(PREFIX) or name == WINDOW:
                continue  # the card's copy of a range
            dev_s.append(start)
            dev_e.append(start + ev.duration_ns())
            dev_name.append(name)
            dev_corr.append(ev.correlation_id())
            dev_link.append(ev.linked_correlation_id())
        elif name.startswith("cu"):
            runtime[ev.correlation_id()] = start
        else:
            end = start + ev.duration_ns()
            frontend[ev.correlation_id()] = start
            if name == WINDOW:
                continue
            if name.startswith(PREFIX):
                range_spans[name[len(PREFIX):]].append((start, end))
            else:
                host_s.append(start)
                host_e.append(end)
                host_names.append(name)
    w0, w1 = window
    starts, ends = np.asarray(dev_s, dtype=np.int64), np.asarray(dev_e, dtype=np.int64)
    busy_ns, gaps = _union(starts, ends) if len(starts) else (0, [])
    if len(starts):  # the idle time before the first and after the last operation
        gaps = [(w0, int(starts.min()))] + gaps + [(int(ends.max()), w1)]

    launched = np.asarray([runtime.get(c, frontend.get(link, -1))
                           for c, link in zip(dev_corr, dev_link)], dtype=np.int64)
    dur = (ends - starts) if len(starts) else np.zeros(0, dtype=np.int64)
    ranges = {}
    for name, spans in range_spans.items():
        spans.sort()
        ranges[name] = (np.asarray([s for s, _ in spans], dtype=np.int64),
                        np.asarray([e for _, e in spans], dtype=np.int64))
    range_s, range_k = {}, {}
    for name, (rs, re_) in ranges.items():
        idx = np.searchsorted(rs, launched, side="right") - 1
        inside = (idx >= 0) & (launched >= 0) & (launched <= re_[np.maximum(idx, 0)])
        range_s[name] = float(dur[inside].sum()) / 1e9
        range_k[name] = int(inside.sum())

    by_op: Dict[str, int] = collections.defaultdict(int)
    for name, d in zip(dev_name, dur.tolist()):
        by_op[name] += d
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    hs, he = np.asarray(host_s, dtype=np.int64), np.asarray(host_e, dtype=np.int64)
    top_gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return Trace(
        window_s=(w1 - w0) / 1e9,
        busy_s=busy_ns / 1e9,
        range_device_s=range_s,
        range_kernels=range_k,
        range_calls={n: len(s) for n, s in range_spans.items()},
        device_ops=[(n, d / 1e9) for n, d in top_ops],
        idle_gaps=[(_host_label((a + b) // 2, hs, he, host_names, ranges), (b - a) / 1e9)
                   for a, b in top_gaps],
        unlinked=int((launched < 0).sum()),
        device_events=len(starts),
    )


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
            if name.startswith((RANGE_PREFIX, PREFIX)) or name == WINDOW:
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
            elif name.startswith(PREFIX):
                bench[name[len(PREFIX):]].append((start, end))
            elif name != WINDOW:
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
        _, inner = _union(starts, ends)
        gaps = [(window[0], int(starts.min()))] + inner + [(int(ends.max()), window[1])]
    opened = collections.defaultdict(list)
    for s, e, name in spans:
        opened[name].append((s, e))
    for name, iv in bench.items():
        opened[PREFIX + name] = sorted(iv)
    ranges = {n: (np.asarray([s for s, _ in iv], dtype=np.int64),
                  np.asarray([e for _, e in iv], dtype=np.int64)) for n, iv in opened.items()}
    hs, he = np.asarray(host_s, dtype=np.int64), np.asarray(host_e, dtype=np.int64)
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    labels = [(_host_label((a + b) // 2, hs, he, host_names, ranges), (b - a) / 1e9)
              for a, b in top]
    return Program(by_name, by_phase, labels)


@contextlib.contextmanager
def profiled():
    """Profile the block (host operations and the card); yields a dict that
    holds, once the block ends, the raw events and the window's (start, end)
    in the profiler's ns."""
    from torch.profiler import ProfilerActivity, profile

    out: Dict[str, Any] = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, profile_memory=False, with_stack=False)
    prof.start()
    try:
        with torch.profiler.record_function(WINDOW):
            yield out
            torch.cuda.synchronize()
    finally:
        prof.stop()
    events = prof.profiler.kineto_results.events()
    window = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
              if e.name() == WINDOW and e.device_type() != torch.autograd.DeviceType.CUDA]
    out["events"], out["window"] = events, window[0]

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
launches included.
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

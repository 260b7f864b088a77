"""Dispatch-span accounting for the engines, ad-hoc spans and profiles.

The port of ``repro.obs.spans``. Three pieces:

- ``span(name, **meta)``: a ``with``-able region of the program. Spans are
  recorded only inside ``recording()`` (``enabled()`` says whether): off,
  ``span`` returns one shared object that reads no clock, opens no range
  and records nothing, so a span can sit on the serving path. On, a span
  records its name, its host start and end (``perf_counter_ns``, no
  synchronize: it measures the host's time, the card's work runs on
  behind it), the span open around it (``parent``) and ``meta`` into a
  bounded stream, and opens a ``torch.profiler`` range
  ``repro_torch/<name>``: under a profiler the range sits on the
  profiler's clock, and every operation the host launches inside it is
  correlated to it. ``summary()`` gives calls, host seconds and self host
  seconds per name; ``note_bench`` records a benchmark row as a span.
- engine accounting. ``core.experiment.run`` wraps every engine dispatch in
  ``dispatch(key)``: it pins the tap set to the key's (``tap.tracing``),
  times the call, and moves the run's tap values to the host before it
  ends. The keys and ``engine_key_str`` are the reference's. The port
  compiles nothing, so ``cache_stats()`` keeps the reference's fields with
  what the port has behind them:

  - ``misses``: first dispatches of a key since the last reset or eviction;
  - ``hits``: later dispatches of that key;
  - ``build_s``: always 0.0 (there is no artifact to build);
  - ``first_dispatch_s``, ``dispatch_s``, ``last_dispatch_s``: wall time
    around the dispatch, which ends when the result is on the host (the
    engines return host values).

  ``game.register_technique(overwrite=True)`` and
  ``unregister_technique`` count as evictions (``note_eviction``), as in
  the reference.
- ``profile(label)``: a ``torch.profiler`` trace (CPU, plus CUDA where a
  card is present) written under ``runs/profiles/<label>``.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

from . import tap as _tap

# two traced batches of a 24-layer MoE server (~3,500 spans a batch) fit
SPAN_CAPACITY = 65536
RANGE_PREFIX = "repro_torch/"  # the profiler range of span "x" is "repro_torch/x"


class Span:
    """One timed region: ``seconds`` (and the host clock's ``start_ns`` and
    ``end_ns``) are set when it exits; ``parent`` is the span that was open
    around it. Spans nest by the order they are entered, so they are
    recorded from one thread at a time (the serving path has one)."""

    __slots__ = ("name", "seconds", "meta", "start_ns", "end_ns", "parent", "_range")

    def __init__(self, name: str, seconds: float = 0.0,
                 meta: Optional[Dict[str, Any]] = None):
        self.name, self.seconds, self.meta = name, seconds, {} if meta is None else meta
        self.start_ns = self.end_ns = 0
        self.parent: Optional[Span] = None
        self._range = None

    def __repr__(self) -> str:
        return f"Span(name={self.name!r}, seconds={self.seconds!r}, meta={self.meta!r})"

    def __enter__(self) -> "Span":
        global _OPEN
        self.parent, _OPEN = _OPEN, self
        # the profiler's range, on its clock (the C++ context manager: a
        # Python ``record_function`` costs the host ~8 us more a span)
        self._range = torch._C._profiler._RecordFunctionFast(RANGE_PREFIX + self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _OPEN
        self.end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        self._range = None
        _OPEN = self.parent
        self.seconds = (self.end_ns - self.start_ns) / 1e9
        _SPANS.append(self)


class _Off:
    """What ``span`` returns while not recording."""
    __slots__ = ()
    seconds = 0.0

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()
_SPANS: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_RECORDING = False
_OPEN: Optional[Span] = None  # the innermost open span


@contextmanager
def recording():
    """Record spans inside the block (see the module docstring)."""
    global _RECORDING
    prev, _RECORDING = _RECORDING, True
    try:
        yield
    finally:
        _RECORDING = prev


def enabled() -> bool:
    """Whether spans are being recorded."""
    return _RECORDING


def span(name: str, **meta):
    """``with obs.span("phase") as s: ...``, then read ``s.seconds``; inside
    ``recording()`` only (else the shared no-op, whose ``seconds`` is 0)."""
    if not _RECORDING:
        return _OFF
    return Span(name, meta=meta)


def spans(name: Optional[str] = None) -> List[Span]:
    out = list(_SPANS)
    return out if name is None else [s for s in out if s.name == name]


def summary(recorded: Optional[List[Span]] = None) -> Dict[str, Dict[str, float]]:
    """Per span name over the recorded spans (or ``recorded``, a part of
    them that holds each span's children): ``calls``, ``host_s`` (their
    seconds) and ``self_s`` (their seconds less what their child spans
    cover): where the host's time went, without a profiler."""
    recorded = list(_SPANS) if recorded is None else recorded
    covered: Dict[int, float] = collections.defaultdict(float)
    for s in recorded:
        if s.parent is not None:
            covered[id(s.parent)] += s.seconds
    out: Dict[str, Dict[str, float]] = {}
    for s in recorded:
        row = out.setdefault(s.name, {"calls": 0, "host_s": 0.0, "self_s": 0.0})
        row["calls"] += 1
        row["host_s"] += s.seconds
        row["self_s"] += s.seconds - covered[id(s)]
    return out


def note_bench(name: str, seconds: float, derived: str = "") -> None:
    """Record one benchmark row as a span."""
    _SPANS.append(Span(name=name, seconds=seconds, meta={"kind": "bench", "derived": derived}))


# ---------------------------------------------------------------------------
# engine dispatch accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineStat:
    """Counters of one engine key (see the module docstring)."""
    hits: int = 0
    misses: int = 0
    build_s: float = 0.0
    first_dispatch_s: float = 0.0
    dispatches: int = 0
    dispatch_s: float = 0.0
    last_dispatch_s: float = 0.0
    evicted: bool = False

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k in ("dispatch_s", "build_s", "first_dispatch_s", "last_dispatch_s"):
            d[k] = round(d[k], 6)
        return d


_known: set = set()                  # keys dispatched since the last reset or eviction
_engine: Dict[str, EngineStat] = {}  # accounting, by key string
_evictions: int = 0


def engine_key_str(key: tuple) -> str:
    """Compact form of an engine key:
    ``kind:technique:objective:h<hours>:cfg=<...>:routed=<...>:
    wl=<workload>:faults=<policy|off[/point]>:guard=<on|off>:taps=<...>``."""
    (kind, technique, objective, hours, cfg, routed, failover, guard,
     workload, faulted, fault_axis, taps) = key
    cfg_s = "default" if cfg is None else type(cfg).__name__
    taps_s = ",".join(sorted(taps)) if taps else "off"
    faults_s = failover if faulted else "off"
    if faulted and fault_axis:
        faults_s += "/point"  # one trace per env row
    return (f"{kind}:{technique}:{objective}:h{hours}:cfg={cfg_s}:"
            f"routed={bool(routed)}:wl={workload}:faults={faults_s}:"
            f"guard={'on' if guard else 'off'}:taps={taps_s}")


def _stat(key: tuple) -> EngineStat:
    ks = engine_key_str(key)
    st = _engine.get(ks)
    if st is None:
        st = _engine[ks] = EngineStat()
    return st


def note_eviction() -> None:
    """A technique was re-registered or removed: every key's next dispatch
    is a miss again."""
    global _evictions
    if _known:
        _evictions += len(_known)
        _known.clear()
    for st in _engine.values():
        st.evicted = True


@contextmanager
def dispatch(key: tuple):
    """One engine dispatch under ``key``: counted, timed, run under exactly
    the key's tap set (its last field), and its tap values moved to the
    host before the span ends."""
    st = _stat(key)
    if key in _known:
        st.hits += 1
    else:
        st.misses += 1
        _known.add(key)
    t0 = time.perf_counter()
    with _tap.tracing(key[-1]):
        yield
    _tap.flush()
    dt = time.perf_counter() - t0
    st.dispatches += 1
    st.dispatch_s += dt
    st.last_dispatch_s = dt
    if st.dispatches == 1:
        st.first_dispatch_s = dt


def cache_stats() -> Dict[str, Any]:
    """Hit/miss/eviction totals plus per-key spans
    (``{"engines": {key: EngineStat dict}}``)."""
    return {
        "hits": sum(s.hits for s in _engine.values()),
        "misses": sum(s.misses for s in _engine.values()),
        "evictions": _evictions,
        "live_keys": len(_known),
        "engines": {k: s.as_dict() for k, s in _engine.items()},
    }


def engine_stat(key: tuple) -> Optional[Dict[str, Any]]:
    st = _engine.get(engine_key_str(key))
    return None if st is None else st.as_dict()


def reset_stats() -> None:
    """Zero the accounting: counters, spans, and the keys seen (the next
    dispatch of every key is a miss)."""
    global _evictions
    _engine.clear()
    _SPANS.clear()
    _known.clear()
    _evictions = 0


# ---------------------------------------------------------------------------
# profiler traces
# ---------------------------------------------------------------------------

@contextmanager
def profile(label: str = "trace", logdir: str = "runs/profiles"):
    """A ``torch.profiler`` trace of the block (host operators, and the
    card's kernels where a card is present), written as Chrome trace JSON to
    ``<logdir>/<label>/trace.json`` (Perfetto reads it). Yields the trace
    directory; the spans recorded inside it are its ranges."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    path = os.path.join(logdir, label)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(os.path.join(path, "trace.json"))

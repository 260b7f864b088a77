"""Metric streams out of the engines: ``tap(name, value)``.

The port of ``repro.obs.tap``. A *tap* is a named emission point in engine
and solver code (the hour of every engine, GT-DRL's best-response rounds).
Whether a tap is live is decided when it is called, against the active tap
set, which the engines pin to the spec's set for the length of a run
(``tracing``):

- a tap that is off costs one Python check: ``tap`` returns before its
  ``thunk`` runs or its value is touched, so nothing is launched;
- a live tap keeps its value (any tree of tensors) as it is, on its device,
  without reading it. The run's pending values move to the host together,
  one copy per device and dtype, when the run ends (``flush``), so the
  events hold numpy values when ``run`` returns, as the reference's do, and
  the solver code reads nothing back on the way.

Under ``torch.func.vmap`` a tensor cannot be kept past the call. The
engines vmap through :func:`vmap` here instead: the body runs in a
collecting scope, the live taps' tensors come back as extra outputs of the
vmapped function (which taps fire is decided on the host, so every row
fires the same ones), and afterwards each row's events are emitted,
unbatched.

The order of events is deterministic: hour, then row (batched engine), then
the order of the tap calls within the row's hour (GT-DRL: round, half,
player). The reference's host callbacks arrive in no fixed order, so
compare the two by counts and by values grouped by key.

Expensive diagnostics (the Nash-residual probe) use the ``thunk=`` form so
that the value is computed only when the tap is live::

    obs.tap("game/nash_residual", thunk=lambda: {"residual": ...})

Enablement is ambient (``with obs.taps("engine/*"): ...``) or per spec
(``ExperimentSpec(taps=("engine/hour",))``); patterns are exact names,
``prefix/*`` wildcards, or ``"*"`` for everything.
"""
from __future__ import annotations

import collections
import functools
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

DEFAULT_CAPACITY = 65536

#: The tap registry: every name passed to ``tap(...)`` in the port is
#: declared here (tests/test_torch_obs.py checks the sources). The first
#: four are the reference's; ``moe/dispatch`` is the serving path's own.
KNOWN_TAPS = (
    "engine/hour",          # experiment engines: per-hour metrics
    "game/nash_residual",   # game loop: best-reply residual probe
    "gt_drl/ppo",           # GT-DRL: per-player PPO actor loss and reward
    "gt_drl/round",         # GT-DRL: per-round best-response telemetry
    "moe/dispatch",         # MoE layer: tokens, pairs, slots, kept pairs (the port's own)
)


class TapEvent(NamedTuple):
    """One host-side record: the tap's name and its value (numpy tree)."""
    name: str
    value: Any


class TapBuffer:
    """Bounded ring buffer of ``TapEvent``s (oldest events drop first).
    Reading it first moves every pending value to the host (``flush``)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._dq: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def append(self, event: TapEvent) -> None:
        with self._lock:
            self._dq.append(event)

    def __len__(self) -> int:
        flush()
        return len(self._dq)

    def clear(self) -> None:
        flush()
        with self._lock:
            self._dq.clear()

    @property
    def events(self) -> List[TapEvent]:
        flush()
        return list(self._dq)

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted({e.name for e in self.events}))

    def by_name(self, name: str) -> List[Any]:
        """All values emitted under ``name``, in order."""
        return [e.value for e in self.events if e.name == name]

    def series(self, name: str, field: Optional[str] = None) -> np.ndarray:
        """Stack a tap's values (or one ``field`` of dict-valued taps) into
        one array: the convergence-curve accessor."""
        vals = self.by_name(name)
        if field is not None:
            vals = [v[field] for v in vals]
        return np.stack([np.asarray(v) for v in vals]) if vals else np.empty((0,))

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.name] = out.get(e.name, 0) + 1
        return out


# ---------------------------------------------------------------------------
# module state: the active tap set, the sinks, the values not yet on the host
# ---------------------------------------------------------------------------

_ACTIVE: frozenset = frozenset()   # patterns live now
_RING = TapBuffer()                # default sink
_SINKS: List[TapBuffer] = [_RING]  # capture() pushes and pops
# (sink, name, value) of live taps whose tensors are still on their device
_PENDING: List[Tuple[TapBuffer, str, Any]] = []
# inside a vmapped body (``vmap``): the (name, value) of its live taps
_COLLECT: Optional[List[Tuple[str, Any]]] = None


def active_taps() -> frozenset:
    """The ambient tap patterns."""
    return _ACTIVE


def normalize(patterns) -> frozenset:
    """None/str/iterable -> the frozenset form."""
    if patterns is None:
        return frozenset()
    if isinstance(patterns, str):
        patterns = (patterns,)
    return frozenset(patterns)


@functools.lru_cache(maxsize=1024)
def _matches(name: str, patterns: frozenset) -> bool:
    for p in patterns:
        if p == name or p == "*" or (p.endswith("/*") and name.startswith(p[:-1])):
            return True
    return False


def enabled(name: str) -> bool:
    """Is the tap ``name`` live now?"""
    return bool(_ACTIVE) and _matches(name, _ACTIVE)  # lint: host-ok(liveness is decided over the host-side set of active patterns, never over a tensor)


def enable_taps(*patterns: str) -> None:
    global _ACTIVE
    _ACTIVE = _ACTIVE | normalize(patterns)


def disable_taps() -> None:
    global _ACTIVE
    _ACTIVE = frozenset()


@contextmanager
def taps(*patterns: str):
    """Ambient enablement: every tap matching ``patterns`` is live for runs
    started inside the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = prev | normalize(patterns)
    try:
        yield _RING
    finally:
        _ACTIVE = prev


@contextmanager
def tracing(patterns: frozenset):
    """Pin the active set to exactly ``patterns`` for the duration: the
    engines run each dispatch under the spec's set, whatever the ambient
    state is."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = frozenset(patterns)
    try:
        yield
    finally:
        _ACTIVE = prev


@contextmanager
def capture(*patterns: str, capacity: int = DEFAULT_CAPACITY):
    """Collect events into a fresh buffer (and enable ``patterns``, if any).

    ``with obs.capture("engine/hour") as buf: run(...)`` leaves the global
    ring untouched and hands back exactly this block's events.
    """
    buf = TapBuffer(capacity)
    _SINKS.append(buf)
    try:
        if patterns:
            with taps(*patterns):
                yield buf
        else:
            yield buf
    finally:
        flush()
        _SINKS.remove(buf)


def _kept(x):
    """``x`` cut from autograd; a tensor that needs no gradient is kept as it
    is, so that a live tap dispatches no operator."""
    return x.detach() if isinstance(x, torch.Tensor) and x.requires_grad else x


def tap(name: str, value: Any = None, *, thunk: Optional[Callable] = None) -> None:
    """Emit ``value`` (any tree of tensors and numbers) under ``name``.

    When ``name`` is not live this returns at once: ``thunk`` is not called
    and nothing is launched. When live, ``thunk`` (if given) builds the
    value, which is kept on its device until ``flush``; inside :func:`vmap`
    it goes out of the vmapped function instead.
    """
    if not enabled(name):
        return
    if thunk is not None:
        value = thunk()
    if _COLLECT is not None:
        _COLLECT.append((name, value))  # lint: host-ok(the vmap scope's list of live taps: a host list of references, read back as extra outputs of the vmapped call)
        return
    _PENDING.append((_SINKS[-1], name, tree_map(_kept, value)))  # lint: host-ok(the sanctioned obs escape hatch: keeps a reference to the device value, no read-back; flush moves it after the run; parity tests pin taps-on == taps-off)


def flush() -> None:
    """Move every pending value to the host and append its event to its
    sink: the tensors are gathered into one flat copy per (device, dtype),
    so a run's events cost a few transfers, whatever their number."""
    global _PENDING
    if not _PENDING:
        return
    pending, _PENDING = _PENDING, []
    leaves = [tree_leaves(value) for _, _, value in pending]
    groups: Dict[Tuple[torch.device, torch.dtype], List[torch.Tensor]] = {}
    for ls in leaves:
        for x in ls:
            if isinstance(x, torch.Tensor):
                groups.setdefault((x.device, x.dtype), []).append(x)
    host: Dict[int, np.ndarray] = {}
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts]).cpu().numpy()
        offset = 0
        for t in ts:
            n = t.numel()
            host[id(t)] = flat[offset:offset + n].reshape(tuple(t.shape))
            offset += n
    for (sink, name, value), ls in zip(pending, leaves):
        new = [host[id(x)] if isinstance(x, torch.Tensor) else np.asarray(x) for x in ls]
        sink.append(TapEvent(name, tree_unflatten(value, new)))


def _batch_size(args, in_dims) -> int:
    dims = in_dims if isinstance(in_dims, tuple) else (in_dims,) * len(args)
    for a, d in zip(args, dims):
        if d is None:
            continue
        x = next(t for t in tree_leaves(a) if isinstance(t, torch.Tensor))
        return int(x.shape[d])
    raise ValueError("vmap: no batched input")


def vmap(fn: Callable, in_dims: Any = 0) -> Callable:
    """``torch.func.vmap(fn, in_dims)`` whose live taps are emitted once per
    row, unbatched, after the call (row order, then call order within the
    row). With no tap set active it is ``torch.func.vmap`` itself."""

    def batched(*args):
        if not _ACTIVE:
            return torch.func.vmap(fn, in_dims=in_dims)(*args)
        templates: List[Tuple[str, Any, List[int]]] = []

        def body(*a):
            global _COLLECT
            prev, _COLLECT = _COLLECT, []
            try:
                out = fn(*a)
                collected = _COLLECT
            finally:
                _COLLECT = prev
            tensors: List[torch.Tensor] = []
            for name, value in collected:
                ls = tree_leaves(value)
                slots = []
                for x in ls:
                    if isinstance(x, torch.Tensor):
                        slots.append(len(tensors))
                        tensors.append(x)
                    else:
                        slots.append(-1)
                templates.append((name, value, slots))
            return out, tuple(tensors)

        out, tensors = torch.func.vmap(body, in_dims=in_dims)(*args)
        n = _batch_size(args, in_dims)
        for r in range(n):
            for name, value, slots in templates:
                ls = tree_leaves(value)
                row = [tensors[s][r].detach() if s >= 0 else x for s, x in zip(slots, ls)]
                _PENDING.append((_SINKS[-1], name, tree_unflatten(value, row)))
        return out

    return batched


def events(name: Optional[str] = None) -> List[TapEvent]:
    """The default ring's events (optionally filtered by exact name)."""
    evs = _RING.events
    return evs if name is None else [e for e in evs if e.name == name]


def ring() -> TapBuffer:
    return _RING


def clear_events() -> None:
    _RING.clear()

"""Scenario registry: named, parameterized, composable EnvParams transforms.

A copy of ``repro.scenarios.registry`` (pure Python over the port's
``EnvParams``).

A *transform* is a pure function ``EnvParams -> EnvParams`` (same shapes and
dtypes in and out, deterministic given its parameters — any randomness is
driven by an explicit ``seed`` parameter). A *factory* builds a transform
from keyword parameters; factories are registered by name so scenarios can
be specified, serialized and round-tripped as plain ``(name, params)`` data
(the ``Scenario`` spec below), then composed into named suites
(``repro.scenarios.suites``).

    >>> t = make("flash_crowd", start=18, duration=3, magnitude=3.0)
    >>> stressed = t(env)                       # pure, repeatable
    >>> s = Scenario("dc_outage", {"dc": 0})
    >>> s.apply(env)                            # round-trips by name
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

from ..dcsim.env import EnvParams

Transform = Callable[[EnvParams], EnvParams]
Factory = Callable[..., Transform]

_REGISTRY: Dict[str, Factory] = {}
_SEVERITY: Dict[str, str] = {}


def register(name: str,
             severity: Optional[str] = None) -> Callable[[Factory], Factory]:
    """Decorator: register a transform factory under ``name``.

    ``severity`` names the factory's canonical severity knob — the one
    parameter a magnitude grid sweeps (``wan_degradation``'s ``factor``,
    ``origin_shift``'s ``weight``, …) — so ``expand_grid`` can accept bare
    scalars for this transform.
    """
    def deco(factory: Factory) -> Factory:
        if name in _REGISTRY:
            raise KeyError(f"scenario transform {name!r} already registered")
        _REGISTRY[name] = factory
        if severity is not None:
            _SEVERITY[name] = severity
        return factory
    return deco


def severity_knob(name: str) -> str:
    """The registered transform's canonical severity parameter name."""
    get(name)  # raise the unknown-transform error, not a knob error
    try:
        return _SEVERITY[name]
    except KeyError:
        raise ValueError(
            f"transform {name!r} declares no severity knob; "
            "pass explicit params dicts in the grid instead") from None


def get(name: str) -> Factory:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario transform {name!r}; known: {names()}") from None


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make(name: str, **params: Any) -> Transform:
    """Build the named transform with ``params`` (round-trip of a spec)."""
    return get(name)(**params)


def compose(*transforms: Transform) -> Transform:
    """Left-to-right composition: compose(f, g)(env) == g(f(env))."""
    def composed(env: EnvParams) -> EnvParams:
        for t in transforms:
            env = t(env)
        return env
    return composed


class Scenario(NamedTuple):
    """Serializable (name, params) spec for one registered transform."""
    name: str
    params: Mapping[str, Any] = {}

    def build(self) -> Transform:
        return make(self.name, **dict(self.params))

    def apply(self, env: EnvParams) -> EnvParams:
        return self.build()(env)


def apply_all(env: EnvParams, scenarios) -> EnvParams:
    """Apply a sequence of Scenario specs (or transforms) in order."""
    for s in scenarios:
        env = s.apply(env) if isinstance(s, Scenario) else s(env)
    return env


def expand_grid(grid: Mapping[str, Any]) -> list:
    """Expand a severity grid into the cartesian list of grid points.

    ``grid`` maps a registered transform name to a sequence of points; a
    point is either a params dict (passed to the factory verbatim) or a
    bare scalar for the transform's declared severity knob::

        expand_grid({"wan_degradation": (1.0, 3.0),
                     "origin_shift": ({"weight": 0.8, "toward": (0,)},)})
        # -> [{"wan_degradation": {"factor": 1.0},
        #      "origin_shift": {"weight": 0.8, "toward": (0,)}}, ...]

    Axes combine in insertion order (the first axis varies slowest); each
    returned point is an ordered ``{name: params}`` dict, directly
    convertible to a ``Scenario`` list.
    """
    import itertools

    axes = []
    for name, pts in grid.items():
        get(name)  # unknown transforms fail before any env is built
        norm = []
        for p in pts:
            if isinstance(p, Mapping):
                norm.append((name, dict(p)))
            else:
                norm.append((name, {severity_knob(name): p}))
        axes.append(norm)
    return [dict(combo) for combo in itertools.product(*axes)]

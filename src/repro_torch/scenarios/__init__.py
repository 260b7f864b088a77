"""Scenario engine: composable EnvParams transforms + named stress suites.

The port of ``repro.scenarios``. See ``registry`` (the Scenario spec,
transform registry and severity-grid expansion), ``transforms`` (the
built-in event families, each with a declared severity knob, applied with
torch on the env's device) and ``suites`` (named suites and ``build_grid``
severity grids, sized for the batched day engine: one batch per technique).
"""
from . import transforms  # noqa: F401  (imports register the built-ins)
from .registry import (Scenario, Transform, apply_all, compose, expand_grid,
                       get, make, names, register, severity_knob)
from .suites import (SUITES, build_grid, build_month, build_suite,
                     suite_names)

__all__ = [
    "Scenario", "Transform", "apply_all", "compose", "expand_grid", "get",
    "make", "names", "register", "severity_knob", "SUITES", "build_grid",
    "build_month", "build_suite", "suite_names",
]

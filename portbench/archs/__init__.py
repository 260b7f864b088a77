"""Architecture modules: what the benchmark knows of one model family.

A configuration file names its module under ``"arch"``
(``archs/<arch>.py``), and everything that depends on the block's equations
goes through it: the weight tree ``weights.draw`` fills, the plain
reference ``check.judge`` reruns, whether a batch's rows are coupled, the
model FLOPs ``mfu`` divides, and the check that the port's config holds to
the file. A module exposes exactly the functions of ``FUNCTIONS``:

- ``layout(cfg)``: the weight tree of ``(kind, shape, dtype, std)`` leaves;
- ``forward(cfg, params, tokens, positions, reduce, *, prefill_len,
  precision)``: the plain float32 reference, teacher-forced, with the fp8
  control and the bf16 witness (``precision``);
- ``couples_rows(cfg)``: whether serving couples a batch's rows, so that
  the check reruns whole batches;
- ``request_flops(cfg, prompt, max_new)``: the model FLOPs of one request;
- ``check_port_config(pc, cfg)``: raise where the port's config departs
  from the file.

A new architecture is a new file here; nothing else of the benchmark
changes. A module imports neither the port nor JAX.
"""
from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

FUNCTIONS = ("layout", "forward", "couples_rows", "request_flops", "check_port_config")


def of(cfg: Dict) -> ModuleType:
    """The architecture module that the configuration ``cfg`` names."""
    name = cfg.get("arch")
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"configuration {cfg.get('name')!r} names no architecture: "
                         f"its key 'arch' is {name!r}")
    try:
        mod = importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise ValueError(f"configuration {cfg.get('name')!r}: its key 'arch' names "
                         f"{name!r}, which is no module of portbench/archs") from e
    missing = [f for f in FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"configuration {cfg.get('name')!r}: architecture {name!r} "
                         f"(key 'arch') lacks {missing}")
    return mod

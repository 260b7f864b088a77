"""Spec-keyed run records: every evaluation can leave a JSONL provenance row.

The port of ``repro.obs.records``. A record is one JSON object per line
holding what is needed to attribute and regenerate a result: the spec's
fields and static-key hash, git SHA, torch/CUDA/device info, the totals,
per-epoch convergence curves, and the engine's dispatch spans from
``obs.cache_stats()``. ``run(spec, envs, record=True)``, ``sweep(...,
record=...)`` and ``compare_techniques(..., record=...)`` all emit through
here; ``python -m repro_torch.obs`` renders a scoreboard from the files.

The default file is ``runs/torch_records.jsonl``; ``runs/records.jsonl``
holds the reference's committed records, which the port never writes.

This module never imports ``repro_torch.core``; specs arrive duck-typed
(any frozen dataclass with the ExperimentSpec fields).
"""
from __future__ import annotations

import dataclasses
import glob as _glob
import hashlib
import json
import os
import subprocess
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

DEFAULT_PATH = os.path.join("runs", "torch_records.jsonl")


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def run_info(device: Any = None) -> Dict[str, Any]:
    """Provenance stamped on every record: git SHA, torch and CUDA versions,
    the backend and device of ``device`` (the first card when one is
    present, else the CPU, by default), the card count and the CPU count."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    cuda = device.type == "cuda"
    return {
        "git_sha": _git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": device.type,
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "cpu_count": os.cpu_count(),
    }


def _jsonable(x):
    if isinstance(x, (np.ndarray, np.generic)):
        return np.asarray(x).tolist()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return repr(x)
    return x


def spec_fields(spec) -> Dict[str, Any]:
    """The spec as plain JSON (the solver cfg collapses to its repr)."""
    d = dataclasses.asdict(spec)
    if d.get("cfg") is not None:
        d["cfg"] = repr(spec.cfg)
    return _jsonable(d)


def spec_key(spec) -> str:
    """Stable short hash of the spec's static fields: the join key between
    records and engine stats."""
    return hashlib.sha1(repr(spec.static_key()).encode()).hexdigest()[:12]


def curves_from_result(result: Dict[str, Any],
                       keys: Iterable[str] = ("carbon_kg", "cost_usd",
                                              "sla_miss_cost_usd",
                                              "latency_ms")) -> Dict[str, list]:
    """Per-epoch convergence curves out of any engine's result shape:
    scan/loop's list of dicts, batched's (n, hours) arrays (mean over the
    env axis), or month's per-day arrays."""
    per_epoch = result.get("per_epoch", result.get("per_day"))
    curves: Dict[str, list] = {}
    if isinstance(per_epoch, list):  # scan/loop: [{metric: float}, ...]
        for k in keys:
            if per_epoch and k in per_epoch[0]:
                curves[k] = [float(row[k]) for row in per_epoch]
    elif isinstance(per_epoch, dict):  # batched/month: {metric: (n, hours)}
        for k in keys:
            if k in per_epoch:
                curves[k] = np.asarray(per_epoch[k], dtype=float).mean(axis=0).tolist()
    return curves


def make_record(
    spec,
    result: Optional[Dict[str, Any]] = None,
    *,
    kind: str = "run",
    curves: Optional[Dict[str, list]] = None,
    engine_spans: Optional[Dict[str, Any]] = None,
    taps: Optional[Dict[str, int]] = None,
    extra: Optional[Dict[str, Any]] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """Assemble one JSONL record from a spec and an engine result;
    ``device`` is the run's (``run_info``)."""
    rec: Dict[str, Any] = {
        "kind": kind,
        "spec": spec_fields(spec),
        "spec_key": spec_key(spec),
        "timestamp_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        **run_info(device),
    }
    if result is not None:
        rec["totals"] = _jsonable(result.get("totals", {}))
        rec["curves"] = curves if curves is not None else curves_from_result(result)
    elif curves is not None:
        rec["curves"] = curves
    if engine_spans is not None:
        rec["engine_spans"] = _jsonable(engine_spans)
    if taps:
        rec["taps"] = dict(taps)
    if extra:
        rec.update(_jsonable(extra))
    return rec


def write_record(record: Dict[str, Any], path: Optional[str] = None) -> str:
    """Append one record to a JSONL file (default ``runs/torch_records.jsonl``),
    creating the directory as needed. Returns the path written.

    The whole line goes down in ONE ``os.write`` on an ``O_APPEND`` fd, so
    concurrent writers never interleave bytes, and a crash can at worst
    truncate the final line, which ``load_records`` tolerates.
    """
    path = path or DEFAULT_PATH
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    line = json.dumps(record, sort_keys=True) + "\n"
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, line.encode("utf-8"))
    finally:
        os.close(fd)
    return path


def load_records(*paths: str) -> List[Dict[str, Any]]:
    """Read records back from JSONL files (paths may be globs).

    A truncated final line (what a crash mid-append leaves) is skipped; a
    malformed line anywhere else raises: that is corruption, not a torn
    write."""
    files: List[str] = []
    for p in paths or (DEFAULT_PATH,):
        hits = sorted(_glob.glob(p))
        files.extend(hits if hits else [p])
    out: List[Dict[str, Any]] = []
    for fp in files:
        with open(fp) as f:
            lines = [ln.strip() for ln in f]
        lines = [ln for ln in lines if ln]
        for i, line in enumerate(lines):
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    continue  # torn final append from a crash: skip it
                raise
    return out

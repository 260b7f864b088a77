"""Scoreboard generator: JSONL run records -> a markdown table.

The port of ``repro.obs.report``: records become a ranked markdown
scoreboard with per-technique totals, convergence sparklines, and the
engine's dispatch spans::

    python -m repro_torch.obs runs/torch_records.jsonl -o board.md
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from . import records as R

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: Iterable[float], width: int = 16) -> str:
    """Unicode sparkline of a curve, resampled to ``width`` points."""
    v = np.asarray(list(values), dtype=float)
    if v.size == 0 or not np.all(np.isfinite(v)):
        return ""
    if v.size > width:
        idx = np.linspace(0, v.size - 1, width).round().astype(int)
        v = v[idx]
    lo, hi = float(v.min()), float(v.max())
    if hi - lo < 1e-12:
        return _BLOCKS[0] * v.size
    t = (v - lo) / (hi - lo)
    return "".join(_BLOCKS[int(x * (len(_BLOCKS) - 1))] for x in t)


def _tot(rec: Dict[str, Any], key: str) -> Optional[float]:
    """A scalar total out of any record shape: scan/loop scalars, batched
    per-env arrays (mean), compare records' ``mean``."""
    totals = rec.get("totals", {})
    v = totals.get(key)
    if isinstance(v, list):
        return float(np.mean(v)) if v else None
    if v is None and key == rec.get("metric") and "mean" in rec:
        return float(rec["mean"])
    return None if v is None else float(v)


def _rank_metric(rec: Dict[str, Any]) -> str:
    return "carbon_kg" if rec["spec"].get("objective") == "carbon" else "cost_usd"


def _fmt(v: Optional[float], nd: int = 1) -> str:
    return "—" if v is None else f"{v:.{nd}f}"


def report(recs: List[Dict[str, Any]], title: str = "Scoreboard") -> str:
    """Render records as a markdown scoreboard, ranked per objective group
    by daily carbon (``objective="carbon"``) or total cost otherwise."""
    lines = [f"# {title}", ""]
    if not recs:
        return "\n".join(lines + ["_no records_", ""])
    info = {(r.get("git_sha"), r.get("torch_version"), r.get("device_kind")) for r in recs}
    for sha, torchv, dev in sorted(info, key=str):
        lines.append(f"- git `{sha}` · torch {torchv} · {dev} "
                     f"({sum(1 for r in recs if r.get('git_sha') == sha)} records)")
    lines.append("")

    by_obj: Dict[str, List[Dict[str, Any]]] = {}
    for r in recs:
        by_obj.setdefault(r["spec"].get("objective", "?"), []).append(r)

    for obj in sorted(by_obj):
        group = by_obj[obj]
        metric = _rank_metric(group[0])
        group = sorted(group, key=lambda r: (_tot(r, metric) if _tot(r, metric) is not None
                                             else float("inf")))
        lines += [f"## objective = `{obj}` (ranked by `{metric}`, lower is better)",
                  "",
                  "| technique | engine | hours | carbon_kg | cost_usd | "
                  "sla_usd | convergence | dispatch_ms | first_s | spec key |",
                  "|---|---|---:|---:|---:|---:|---|---:|---:|---|"]
        for r in group:
            spec = r["spec"]
            curves = r.get("curves", {})
            curve = curves.get(metric) or next(iter(curves.values()), [])
            sp = r.get("engine_spans") or {}
            disp = (sp.get("dispatch_s", 0.0) / sp["dispatches"] * 1e3
                    if sp.get("dispatches") else None)
            lines.append(
                "| {t} | {e} | {h} | {c} | {u} | {s} | `{cv}` | {d} | {k} | `{key}` |".format(
                    t=spec.get("technique"), e=spec.get("engine"),
                    h=spec.get("hours"),
                    c=_fmt(_tot(r, "carbon_kg")),
                    u=_fmt(_tot(r, "cost_usd")),
                    s=_fmt(_tot(r, "sla_miss_cost_usd")),
                    cv=sparkline(curve) or "n/a",
                    d=_fmt(disp, 1),
                    k=_fmt(sp.get("first_dispatch_s"), 2),
                    key=r.get("spec_key", "?")))
        lines.append("")
    lines += ["Convergence column: per-epoch curve of the ranked metric "
              "(sparkline, earliest epoch left). `first_s` is the first "
              "dispatch's wall time (the port compiles nothing: it is the "
              "first run, with any first-use setup); `dispatch_ms` the mean "
              "dispatch.", ""]
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="render a markdown scoreboard from JSONL run records")
    ap.add_argument("paths", nargs="*", default=[R.DEFAULT_PATH],
                    help=f"record files (globs ok); default {R.DEFAULT_PATH}")
    ap.add_argument("-o", "--out", default=None, help="write markdown here (default: stdout)")
    ap.add_argument("--title", default="Scoreboard")
    args = ap.parse_args(argv)
    md = report(R.load_records(*args.paths), title=args.title)
    if args.out:
        # write-then-rename: a reader (or a crash) never sees a half scoreboard
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            f.write(md)
        os.replace(tmp, args.out)
        print(f"wrote {args.out}")
    else:
        print(md)


if __name__ == "__main__":
    main()

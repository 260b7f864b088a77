"""``repro_torch.obs`` — telemetry for the port's engines (``repro.obs``'s names).

Three pieces; a tap that is off costs one Python check and launches nothing.

- **Taps** (``obs.tap``): named emission points in the engines' hour and in
  GT-DRL's rounds. A live tap keeps its value on the device; the run's values
  move to the host once, when the run ends. Under ``torch.func.vmap`` (the
  batched engine's rows) they leave as extra outputs and are emitted per row.

  ========================  ===================================================
  name                      payload (per event)
  ========================  ===================================================
  ``engine/hour``           tau, carbon_kg, cost_usd, sla_miss_cost_usd,
                            latency_ms, grid_power_w (and the fault metrics of
                            a faulted run) — one event per hour and row
  ``game/nash_residual``    tau, residual — the Nash-gap probe (computed
                            only when tapped)
  ``gt_drl/round``          value, best, delta — per best-response round
  ``gt_drl/ppo``            player, actor_loss, mean_reward — per player
                            and PPO improve call
  ``moe/dispatch``          tokens, routed (pairs), slots (experts x
                            capacity), keep (each pair's kept mask) — per
                            MoE layer call; the port's own, for serving
  ========================  ===================================================

- **Spans** (``obs.spans``): per engine key dispatch counts and wall time
  (``obs.cache_stats()``; the port compiles nothing, see ``spans``),
  ``obs.span(name)`` for regions of the program, recorded inside
  ``obs.spans.recording()`` only (the serving path's spans are listed in
  ``launch/serve.py``; ``obs.spans.summary()`` sums them by name), and
  ``obs.profile(label)`` for ``torch.profiler`` traces, which show the
  recorded spans as ``repro_torch/<name>`` ranges.

- **Records** (``obs.records`` / ``obs.report``): ``run(spec, envs,
  record=True)`` (also ``sweep`` and ``compare_techniques``) appends a
  spec-keyed JSONL record under ``runs/torch_records.jsonl``; ``python -m
  repro_torch.obs`` renders the scoreboard from them.

Typical use::

    from repro_torch import obs
    from repro_torch.core import ExperimentSpec, run

    with obs.capture("engine/hour") as buf:
        run(ExperimentSpec(technique="fd"), env, record=True)
    buf.series("engine/hour", "carbon_kg")   # (24,) curve
    obs.cache_stats()                        # dispatch accounting
"""
from . import records, report as report_mod, spans, tap as tap_mod
from .records import load_records, make_record, run_info, spec_fields, spec_key, write_record
from .report import report, sparkline
from .spans import (Span, cache_stats, engine_key_str, engine_stat, note_bench, profile,
                    reset_stats, span)
from .spans import spans as all_spans
from .tap import (KNOWN_TAPS, TapBuffer, TapEvent, active_taps, capture, clear_events,
                  disable_taps, enable_taps, enabled, events, ring, tap, taps, tracing)

__all__ = [
    "tap", "taps", "capture", "events", "ring", "clear_events",
    "enable_taps", "disable_taps", "enabled", "active_taps", "tracing",
    "KNOWN_TAPS", "TapBuffer", "TapEvent",
    "span", "all_spans", "Span", "cache_stats", "engine_stat",
    "engine_key_str", "reset_stats", "note_bench", "profile",
    "make_record", "write_record", "load_records", "run_info",
    "spec_fields", "spec_key",
    "report", "sparkline",
]

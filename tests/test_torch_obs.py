"""The port's telemetry (``repro_torch.obs``) against its own contract and
the JAX package's ``repro.obs``, on the CPU at D = 4.

The first part mirrors ``tests/test_obs.py`` test for test: taps are free
when off (taps-off totals bit for bit, and a tapped run adds no dispatch
under the taps-off key: the port compiles nothing, so "compiles nothing
new" becomes that), faithful when on (the ``engine/hour`` series equals
``per_epoch`` exactly), dispatch accounting, run records and the
scoreboard. Two reference tests read the JAX benchmark harness
(``benchmarks.common.Timer``, ``benchmarks.run.rows_to_json``), which the
port does not have: they become ``note_bench``'s span and ``run_info``'s
provenance fields.

The second part holds the port's events against the reference's per tap
name on the same inputs: the same count and the same keys on every engine.
The reference's host callbacks arrive in no fixed order, so values are
grouped by hour (``tau``) and sorted within it. Tolerances: fd's
``engine/hour`` metrics and ``game/nash_residual`` at rtol 1e-5, the day
engine's parity tolerance of ``tests/test_torch_experiment.py`` (the probe's
8 normalized gradient steps start from the fd allocation held there;
measured 2e-7 apart here). gt-drl's draws differ between ``jax.random`` and
``torch.Generator``, so its taps are held by count per player and finite
values. The loop engine streams nothing under a spec's taps, in either
package.
"""
# ruff: noqa: E402
import collections
import math
import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_jax as H
from repro import obs as jobs
from repro.core import ExperimentSpec as JaxSpec
from repro.core import experiment as JX
from repro.core import gt_drl as JGT
from repro.core import run as jax_run
from repro.core.force_directed import FDConfig as JFDConfig
from repro.core.ppo import PPOConfig as JPPOConfig
from repro.dcsim import env as JE
from repro_torch import obs
from repro_torch.convert import env_from_numpy
from repro_torch.core import ExperimentSpec, run, sweep
from repro_torch.core import experiment as X
from repro_torch.core import game
from repro_torch.core import gt_drl as TGT
from repro_torch.core import schedulers as SCH
from repro_torch.core.force_directed import FDConfig
from repro_torch.dcsim import env as E

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, so intra-op threads only contend
    with the other test workers' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _carry(jenv):
    return env_from_numpy({k: np.asarray(v) for k, v in jenv._asdict().items()}, device="cpu")


J_ENVS = [JE.build_env(4, seed=s) for s in range(3)]
ENVS = [_carry(e) for e in J_ENVS]
ENV = ENVS[0]
FD_CFG, J_FD_CFG = FDConfig(iters=10), JFDConfig(iters=10)
SPEC = ExperimentSpec(technique="fd", objective="carbon", hours=2, cfg=FD_CFG)
# the tiny gt-drl config of tests/test_obs.py
J_GT_CFG = JGT.GTDRLConfig(ppo=JPPOConfig(horizon=2, episodes=4, iters=1, update_epochs=1),
                           rounds=2, polish_steps=2, pretrain_iters=2)
GT_CFG = H.port_cfg(J_GT_CFG, TGT.GTDRLConfig)


# ---------------------------------------------------------------------------
# taps are free when off, faithful when on
# ---------------------------------------------------------------------------

def test_taps_off_is_bit_identical_and_adds_no_dispatch_under_its_key():
    """A taps-off run after a tapped run reproduces the taps-off totals bit
    for bit; the tapped run is accounted under its own key, never under the
    taps-off one; and the tapped totals are the taps-off totals exactly."""
    off = SPEC.replace(taps=())
    base = run(off, ENV)
    key_off = X._engine_key(off)
    st0 = obs.engine_stat(key_off)

    on = SPEC.replace(taps=("engine/hour",))
    with obs.capture("engine/hour") as buf:
        tapped = run(on, ENV)
    assert len(buf.events) == SPEC.hours  # one event per hour
    assert obs.engine_stat(key_off) == st0  # nothing dispatched under the taps-off key

    again = run(off, ENV)
    st1 = obs.engine_stat(key_off)
    assert st1["misses"] == st0["misses"] and st1["hits"] == st0["hits"] + 1
    assert st1["dispatches"] == st0["dispatches"] + 1
    for k, v in base["totals"].items():
        assert again["totals"][k] == v
        assert tapped["totals"][k] == v


def test_tapped_and_untapped_artifacts_coexist_under_distinct_keys():
    run(SPEC.replace(taps=()), ENV)
    run(SPEC.replace(taps=("engine/hour",)), ENV)
    key_off = X._engine_key(SPEC.replace(taps=()))
    key_on = X._engine_key(SPEC.replace(taps=("engine/hour",)))
    assert key_off != key_on
    stats = obs.cache_stats()
    assert obs.engine_key_str(key_off) in stats["engines"]
    assert obs.engine_key_str(key_on) in stats["engines"]
    assert stats["engines"][obs.engine_key_str(key_on)]["dispatches"] >= 1


@pytest.mark.parametrize("engine", ["scan", "batched", "month"])
def test_tap_series_equals_engine_per_epoch_exactly(engine):
    """The streamed engine/hour values ARE the engine's metrics, so the
    series equals per_epoch exactly: hour, then row (batched), then day."""
    spec = SPEC.replace(taps=("engine/hour",), engine=engine,
                        days=2 if engine == "month" else None)
    envs = ENV if engine == "scan" else ENVS[:2]
    with obs.capture("engine/hour") as buf:
        res = run(spec, envs)
    for k in ("carbon_kg", "cost_usd", "sla_miss_cost_usd", "grid_power_w"):
        series = buf.series("engine/hour", k)
        if engine == "scan":
            expected = np.asarray([row[k] for row in res["per_epoch"]])
        elif engine == "batched":
            expected = res["per_epoch"][k].T.reshape(-1)  # hour, then row
        else:
            expected = res["per_day"][k].reshape(-1)  # day, then hour
        np.testing.assert_array_equal(series, expected.astype(series.dtype), err_msg=k)
    taus = buf.series("engine/hour", "tau")
    want = {"scan": np.arange(2), "batched": np.repeat(np.arange(2), 2),
            "month": np.tile(np.arange(2), 2)}[engine]
    np.testing.assert_array_equal(taus, want)


def test_vmap_emits_each_rows_taps_unbatched():
    """Under ``obs.tap_mod.vmap`` a live tap's tensors leave the vmapped
    function as outputs and come back as one event a row, in row order;
    with no tap set active it is ``torch.func.vmap`` and emits nothing."""
    def body(x):
        obs.tap("engine/hour", {"tau": 3, "total": x.sum(), "row": x})
        return x * 2

    xs = torch.arange(6.0).reshape(3, 2)
    with obs.capture("engine/hour") as buf:
        out = obs.tap_mod.vmap(body)(xs)
    assert torch.equal(out, xs * 2)
    vals = buf.by_name("engine/hour")
    assert [float(v["total"]) for v in vals] == [1.0, 5.0, 9.0]
    assert all(int(v["tau"]) == 3 for v in vals)
    np.testing.assert_array_equal(vals[2]["row"], [4.0, 5.0])
    with obs.capture() as buf:
        assert torch.equal(obs.tap_mod.vmap(body)(xs), xs * 2)
    assert buf.events == []


def test_shard_map_engine_rejects_taps():
    spec = ExperimentSpec(technique="fd", engine="batched", hours=2, cfg=FD_CFG,
                          taps=("engine/hour",))
    with pytest.raises(ValueError, match="shard"):
        run(spec, [ENV, ENV], shard=True)


# ---------------------------------------------------------------------------
# solver-trace taps
# ---------------------------------------------------------------------------

def test_nash_residual_tap_streams_finite_nonnegative_values():
    spec = SPEC.replace(hours=3, taps=("game/nash_residual",))
    with obs.capture() as buf:
        run(spec, ENV)
    res = buf.series("game/nash_residual", "residual")
    assert res.shape == (3,)
    assert np.all(np.isfinite(res)) and np.all(res >= 0.0)
    # the probe runs only when tapped; taps-off streams nothing
    with obs.capture() as buf2:
        run(SPEC.replace(hours=3, taps=()), ENV)
    assert buf2.events == []


def test_gt_drl_taps_stream_round_and_ppo_diagnostics():
    """Pretrained (nothing fires while pretraining), then hours x rounds
    round events and hours x rounds x I ppo events, each player's own."""
    spec = ExperimentSpec(technique="gt-drl", hours=2, cfg=GT_CFG, taps=("gt_drl/*",))
    with obs.capture() as buf:
        run(spec, ENV)
    counts = buf.counts()
    i = E.num_players(ENV)
    assert counts["gt_drl/round"] == spec.hours * GT_CFG.rounds
    assert counts["gt_drl/ppo"] == spec.hours * GT_CFG.rounds * i
    players = collections.Counter(int(v["player"]) for v in buf.by_name("gt_drl/ppo"))
    assert players == {p: spec.hours * GT_CFG.rounds for p in range(i)}
    assert np.all(np.isfinite(buf.series("gt_drl/round", "delta")))
    assert np.all(np.isfinite(buf.series("gt_drl/ppo", "actor_loss")))


def test_tap_pattern_matching_prefix_and_wildcard():
    assert obs.tap_mod._matches("engine/hour", frozenset(["engine/*"]))
    assert obs.tap_mod._matches("engine/hour", frozenset(["*"]))
    assert obs.tap_mod._matches("engine/hour", frozenset(["engine/hour"]))
    assert not obs.tap_mod._matches("engine/hour", frozenset(["gt_drl/*"]))
    assert not obs.tap_mod._matches("engine/hour", frozenset())


def test_ambient_taps_context_drives_spec_default():
    spec = SPEC.replace(hours=2)  # taps=None -> ambient
    assert spec.effective_taps() == frozenset()
    with obs.taps("engine/*"):
        assert spec.effective_taps() == frozenset({"engine/*"})
        with obs.capture("engine/hour") as buf:
            run(spec, ENV)
        assert len(buf.events) == 2
    assert spec.effective_taps() == frozenset()


# ---------------------------------------------------------------------------
# spans + dispatch accounting
# ---------------------------------------------------------------------------

def test_span_records_wall_time_into_the_stream():
    with obs.spans.recording(), obs.span("test/region", tag=1) as s:
        sum(range(1000))
    assert s.seconds > 0.0
    got = obs.all_spans("test/region")
    assert got and got[-1] is s and got[-1].meta == {"tag": 1}


def test_bench_row_is_an_obs_span():
    """``note_bench`` (the reference's bench harness emits through it)
    records a benchmark row as a span of kind "bench"."""
    obs.note_bench("test/bench_row", 0.5, "derived=1")
    bench = [s for s in obs.all_spans("test/bench_row") if s.meta.get("kind") == "bench"]
    assert bench and bench[-1].seconds == 0.5 and bench[-1].meta["derived"] == "derived=1"


def test_span_off_is_one_shared_no_op_that_records_nothing():
    assert not obs.spans.enabled()
    before = len(obs.all_spans())
    a, b = obs.span("test/off"), obs.span("test/other", tag=2)
    assert a is b and not isinstance(a, obs.Span)
    with a as s:
        sum(range(10))
    assert s.seconds == 0.0 and len(obs.all_spans()) == before
    with obs.spans.recording():
        assert obs.spans.enabled()
    assert not obs.spans.enabled()


def test_span_summary_self_time_leaves_out_the_children():
    obs.reset_stats()
    with obs.spans.recording():
        with obs.span("test/outer") as outer:
            for _ in range(2):
                with obs.span("test/inner"):
                    sum(range(1000))
    inner = obs.all_spans("test/inner")
    assert [s.parent for s in inner] == [outer, outer] and outer.parent is None
    got = obs.spans.summary()
    assert got["test/inner"]["calls"] == 2 and got["test/outer"]["calls"] == 1
    assert got["test/outer"]["host_s"] == outer.seconds
    assert got["test/outer"]["self_s"] == pytest.approx(
        outer.seconds - sum(s.seconds for s in inner), abs=1e-12)
    assert got["test/inner"]["self_s"] == got["test/inner"]["host_s"]


# ---------------------------------------------------------------------------
# the serving path's spans and the moe/dispatch tap
# ---------------------------------------------------------------------------

SERVE_ARCHS = ("qwen2-7b", "qwen2-moe-a2.7b")
LENS, MAX_NEW = (12, 9, 5), (4, 2, 4)  # ragged prompts and answers: 4 passes a batch


def _server(arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ModelServer

    return ModelServer(get_config(arch).smoke(), batch_size=3, cache_len=32, seed=1,
                       device="cpu")


def _requests(cfg):
    from repro_torch.launch.serve import Request

    g = torch.Generator().manual_seed(0)
    return [Request(10 + i, torch.randint(0, cfg.vocab_size, (n,), generator=g,
                                          dtype=torch.int32), m)
            for i, (n, m) in enumerate(zip(LENS, MAX_NEW))]


def _profiled_names(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name for e in prof.events()]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_generate_is_bit_equal_with_spans_and_taps_on_or_off(arch):
    """Off, ``generate`` opens no ``repro_torch/`` profiler range; recording
    spans and the ``moe/dispatch`` tap changes no output token."""
    srv = _server(arch)
    reqs = _requests(srv.cfg)
    off, names = _profiled_names(lambda: srv.generate(reqs))
    assert not [n for n in names if n.startswith(obs.spans.RANGE_PREFIX)]
    obs.reset_stats()
    with obs.spans.recording(), obs.capture("moe/dispatch") as buf:
        on, names = _profiled_names(lambda: srv.generate(reqs))
    assert on == off
    assert {n for n in names if n.startswith(obs.spans.RANGE_PREFIX)} == {
        obs.spans.RANGE_PREFIX + s.name for s in obs.all_spans()}
    assert len(buf.by_name("moe/dispatch")) == (
        srv.cfg.num_layers * max(MAX_NEW) if srv.cfg.num_experts else 0)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_spans_nest_under_generate_with_their_call_counts(arch):
    srv = _server(arch)
    reqs = _requests(srv.cfg)
    srv.generate(reqs)  # the server's call 0
    obs.reset_stats()
    with obs.spans.recording():
        srv.generate(reqs)
    layers, passes = srv.cfg.num_layers, max(MAX_NEW)  # the prefill, then 3 decode steps
    want = {"serve.generate": 1, "serve.batchify": 1, "serve.prefill": 1,
            "serve.readback": passes, "serve.decode": passes - 1,
            "block.attn": layers * passes, "block.ffn": layers * passes,
            "norm": (2 * layers + 1) * passes, "rope": layers * passes}
    parents = {"serve.generate": {None}, "serve.batchify": {"serve.generate"},
               "serve.prefill": {"serve.generate"}, "serve.readback": {"serve.generate"},
               "serve.decode": {"serve.generate"},
               "block.attn": {"serve.prefill", "serve.decode"},
               "block.ffn": {"serve.prefill", "serve.decode"},
               "norm": {"block.attn", "block.ffn", "serve.prefill", "serve.decode"},
               "rope": {"block.attn"}}
    if srv.cfg.num_experts:
        for name in ("moe.route", "moe.aux", "moe.dispatch", "moe.experts", "moe.combine",
                     "moe.shared"):
            want[name], parents[name] = layers * passes, {"block.ffn"}
    recorded = obs.all_spans()
    assert collections.Counter(s.name for s in recorded) == want
    root = next(s for s in recorded if s.name == "serve.generate")
    assert root.meta == {"call": 1, "uids": (10, 11, 12)}
    for s in recorded:
        assert (s.parent.name if s.parent else None) in parents[s.name], s.name
        while s.parent is not None:
            s = s.parent
        assert s is root
    got = obs.spans.summary()
    assert {n: r["calls"] for n, r in got.items()} == want
    assert all(0 <= r["self_s"] <= r["host_s"] for r in got.values())


def _moe_overloaded():
    """qwen2-moe's smoke layer (fp32) with a router that sends every token
    to expert 0 first: expert 0's slots overflow, so pairs are dropped."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").smoke(), dtype="float32",
                              param_dtype="float32")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    p["router"]["w"][:, 0] += 4.0
    x = torch.rand((2, 9, cfg.d_model), generator=torch.Generator().manual_seed(1))
    return cfg, p, x


def _recount(sel, e, cap):
    """Kept pairs by a host loop over (token, choice) pairs in order."""
    used, keep = collections.Counter(), []
    for ex in sel.reshape(-1).tolist():
        keep.append(used[ex] < cap)
        used[ex] += 1
    return np.asarray(keep)


def test_moe_dispatch_tap_equals_a_host_recount_and_adds_no_operator():
    from repro_torch.models import moe

    cfg, p, x = _moe_overloaded()
    t, k, e = x.shape[0] * x.shape[1], cfg.num_experts_per_tok, cfg.num_experts
    cap = math.ceil(t * k * 1.25 / e)
    _, sel, _ = moe._route(p, cfg, x.reshape(t, -1))
    keep = _recount(sel, e, cap)
    assert not keep.all()  # the router overloads expert 0
    (y_off, _), ops_off = _profiled_names(lambda: moe.moe_apply(p, cfg, x))
    with obs.capture("moe/dispatch") as buf:
        (y_on, _), ops_on = _profiled_names(lambda: moe.moe_apply(p, cfg, x))
    assert torch.equal(y_on, y_off) and ops_on == ops_off
    (ev,) = buf.by_name("moe/dispatch")
    assert (int(ev["tokens"]), int(ev["routed"]), int(ev["slots"])) == (t, t * k, e * cap)
    np.testing.assert_array_equal(ev["keep"], keep)

    # expert-parallel: each rank's event counts the pairs kept on its experts
    size = 2
    e_pad, e_loc, cap_ep = moe.ep_layout(e, size, t, k, 1.25)
    keep_ep = _recount(sel, e_pad, cap_ep)
    with obs.capture("moe/dispatch") as buf:
        for rank in range(size):
            moe.ep_shard(p, cfg, x, rank, size)
    evs = buf.by_name("moe/dispatch")
    assert [int(v["slots"]) for v in evs] == [e_loc * cap_ep] * size
    assert sum(int(v["keep"].sum()) for v in evs) == int(keep_ep.sum())
    assert all(int(v["routed"]) == t * k for v in evs)


def test_cache_stats_dispatch_accounting():
    run(SPEC, ENV)
    st = obs.engine_stat(X._engine_key(SPEC))
    assert st["dispatches"] >= 1
    assert st["dispatch_s"] >= st["last_dispatch_s"] > 0.0
    assert st["first_dispatch_s"] > 0.0
    assert st["build_s"] == 0.0  # the port builds no artifact
    totals = obs.cache_stats()
    assert totals["misses"] >= 1 and totals["live_keys"] >= 1


def test_stats_single_run_stderr_is_zero_not_nan():
    out = SCH._stats([42.0], [[1.0, 2.0, 3.0]])
    assert out["mean"] == 42.0
    assert out["stderr"] == 0.0 and not np.isnan(out["stderr"])
    multi = SCH._stats([40.0, 44.0], [[1.0], [3.0]])
    assert multi["stderr"] > 0.0


def test_reregistering_a_technique_is_an_eviction():
    """As the reference's caches: a re-registered or removed technique makes
    every key's next dispatch a miss again."""
    run(SPEC, ENV)
    before = obs.cache_stats()["evictions"]
    fd = game.get_technique("fd")
    game.register_technique("obs-evict", step=fd.step, default_cfg=fd.default_cfg)
    assert obs.cache_stats()["evictions"] == before
    game.register_technique("obs-evict", step=fd.step, default_cfg=fd.default_cfg,
                            overwrite=True)
    assert obs.cache_stats()["evictions"] > before and obs.cache_stats()["live_keys"] == 0
    game.unregister_technique("obs-evict")
    st0 = obs.engine_stat(X._engine_key(SPEC))
    run(SPEC, ENV)
    assert obs.engine_stat(X._engine_key(SPEC))["misses"] == st0["misses"] + 1


# ---------------------------------------------------------------------------
# run records + the scoreboard
# ---------------------------------------------------------------------------

def test_run_record_roundtrip_with_provenance(tmp_path):
    path = str(tmp_path / "records.jsonl")
    res = run(SPEC, ENV, record=path)
    recs = obs.load_records(path)
    assert len(recs) == 1
    rec = recs[0]
    for field in ("git_sha", "torch_version", "cuda_version", "backend", "device_kind",
                  "device_count", "cpu_count", "timestamp_utc"):
        assert field in rec, field
    assert rec["kind"] == "run" and rec["backend"] == "cpu" and rec["device_kind"] == "cpu"
    assert rec["spec"]["technique"] == "fd" and rec["spec"]["hours"] == 2
    assert rec["spec_key"] == obs.spec_key(SPEC)
    assert rec["totals"]["carbon_kg"] == res["totals"]["carbon_kg"]
    assert len(rec["curves"]["carbon_kg"]) == SPEC.hours
    assert rec["engine_spans"]["dispatches"] >= 1


def test_compare_techniques_emits_one_record_per_technique(tmp_path):
    path = str(tmp_path / "compare.jsonl")
    out = SCH.compare_techniques([ENV], ("fd",), "carbon", hours=2,
                                 cfg_overrides={"fd": FD_CFG}, record=path)
    recs = obs.load_records(path)
    assert len(recs) == 1 and recs[0]["kind"] == "compare"
    assert recs[0]["mean"] == out["fd"]["mean"]
    assert recs[0]["curves"]["carbon_kg"] == out["fd"]["curve_mean"]
    assert recs[0]["runs"] == 1 and recs[0]["stderr"] == 0.0
    assert recs[0]["engine_spans"]["dispatches"] >= 1


def test_sweep_emits_records_with_grid_labels(tmp_path):
    path = str(tmp_path / "sweep.jsonl")
    spec = ExperimentSpec(technique="fd", objective="cost_sla", engine="batched", hours=2,
                          cfg=FD_CFG)
    sweep(spec, {"wan_degradation": (1.0, 2.0)}, base_env=ENV, record=path)
    recs = obs.load_records(path)
    assert len(recs) == 1 and recs[0]["kind"] == "sweep"
    assert len(recs[0]["labels"]) == 2


def test_report_renders_ranked_scoreboard(tmp_path):
    path = str(tmp_path / "records.jsonl")
    for t in ("fd", "ga"):
        spec = ExperimentSpec(technique=t, hours=2, cfg=FD_CFG if t == "fd" else None)
        run(spec, ENV, record=path)
    md = obs.report(obs.load_records(path), title="test board")
    assert "test board" in md and "fd" in md and "ga" in md
    assert "carbon_kg" in md and f"torch {torch.__version__}" in md
    assert any(c in md for c in "▁▂▃▄▅▆▇█")  # convergence sparklines
    rows = [ln for ln in md.splitlines() if ln.startswith("| ") and "technique" not in ln]
    assert len(rows) == 2
    carbons = [float(ln.split("|")[4]) for ln in rows]
    assert carbons == sorted(carbons)


def test_report_cli_renders_the_records(tmp_path):
    """``python -m repro_torch.obs <records> -o <md>``, as ``make scoreboard``
    runs the reference's."""
    import subprocess
    import sys
    path = str(tmp_path / "records.jsonl")
    run(SPEC, ENV, record=path)
    out = tmp_path / "board.md"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs", path, "-o", str(out)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "| fd | scan | 2 |" in out.read_text()


def test_sparkline_shapes():
    assert obs.sparkline([]) == ""
    assert len(obs.sparkline([1.0])) == 1
    s = obs.sparkline(list(range(32)), width=16)
    assert len(s) == 16 and s[0] == "▁" and s[-1] == "█"
    assert set(obs.sparkline([5.0, 5.0, 5.0])) <= set("▁▂▃▄▅▆▇█")


def test_run_info_carries_provenance():
    """What the reference stamps on BENCH_*.json meta blocks, with torch's
    versions where it has jax's; a torn final record line is skipped."""
    meta = obs.run_info("cpu")
    for field in ("git_sha", "torch_version", "cuda_version", "device_kind", "cpu_count"):
        assert field in meta, field
    assert meta["torch_version"] == torch.__version__ and meta["backend"] == "cpu"


def test_load_records_skips_a_torn_final_line(tmp_path):
    path = tmp_path / "torn.jsonl"
    obs.write_record({"kind": "run", "n": 1}, str(path))
    with open(path, "a") as f:
        f.write('{"kind": "ru')
    assert obs.load_records(str(path)) == [{"kind": "run", "n": 1}]
    with open(path, "a") as f:
        f.write('\n{"kind": "run"}\n')
    with pytest.raises(ValueError):
        obs.load_records(str(path))


def test_default_record_path_is_the_ports_own():
    assert obs.records.DEFAULT_PATH == os.path.join("runs", "torch_records.jsonl")


def test_profile_writes_a_trace(tmp_path):
    with obs.profile("unit", logdir=str(tmp_path)) as p:
        torch.ones((8, 8)) @ torch.ones((8, 8))
    assert os.path.isdir(p) and os.path.getsize(os.path.join(p, "trace.json")) > 0


# ---------------------------------------------------------------------------
# the tap registry (the port's stand-in for repro.lint's taps checker)
# ---------------------------------------------------------------------------

def test_every_tap_name_in_the_port_is_registered():
    names = set()
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        names |= set(re.findall(r"""\btap\(\s*["']([^"']+)["']""", path.read_text()))
        names |= set(re.findall(r"""\benabled\(\s*["']([^"']+)["']""", path.read_text()))
    assert names, "no tap site found"
    assert names <= set(obs.KNOWN_TAPS), names - set(obs.KNOWN_TAPS)
    # the reference's taps, and the serving path's own
    assert set(obs.KNOWN_TAPS) - set(jobs.KNOWN_TAPS) == {"moe/dispatch"}
    assert set(jobs.KNOWN_TAPS) <= set(obs.KNOWN_TAPS)


# ---------------------------------------------------------------------------
# the port's events against the reference's
# ---------------------------------------------------------------------------

def _by_tau(values, key):
    """{tau: sorted values of ``key``}: the reference keeps no order."""
    out = collections.defaultdict(list)
    for v in values:
        out[int(v["tau"])].append(np.asarray(v[key], np.float64))
    return {t: np.sort(np.stack(vs), axis=0) for t, vs in out.items()}


def _envs(engine, jax):
    envs = J_ENVS if jax else ENVS
    return {"scan": envs[0], "loop": envs[0], "batched": envs, "month": envs[:2]}[engine]


def _both(spec_kw, jax_cfg, cfg, engine):
    with jobs.capture() as jbuf:
        jax_run(JaxSpec(cfg=jax_cfg, **spec_kw), _envs(engine, True))
    with obs.capture() as buf:
        run(ExperimentSpec(cfg=cfg, **spec_kw), _envs(engine, False))
    return buf, jbuf


@pytest.mark.parametrize("engine", ["scan", "loop", "batched", "month"])
def test_fd_taps_match_the_reference(engine):
    spec_kw = dict(technique="fd", hours=2, engine=engine,
                   days=2 if engine == "month" else None,
                   taps=("engine/hour", "game/nash_residual"))
    buf, jbuf = _both(spec_kw, J_FD_CFG, FD_CFG, engine)
    assert buf.counts() == jbuf.counts()
    if engine == "loop":
        assert buf.counts() == {}  # the loop engine has no tap of its own
        return
    for name in ("engine/hour", "game/nash_residual"):
        got, want = buf.by_name(name), jbuf.by_name(name)
        assert all(set(g) == set(want[0]) for g in got), name
    hour, jhour = buf.by_name("engine/hour"), jbuf.by_name("engine/hour")
    for k in hour[0]:
        if k in ("tau", "violation"):
            continue
        g, w = _by_tau(hour, k), _by_tau(jhour, k)
        assert g.keys() == w.keys()
        for t in g:
            np.testing.assert_allclose(g[t], w[t], rtol=1e-5, err_msg=(k, t))
    g = _by_tau(buf.by_name("game/nash_residual"), "residual")
    w = _by_tau(jbuf.by_name("game/nash_residual"), "residual")
    assert g.keys() == w.keys()
    for t in g:
        np.testing.assert_allclose(g[t], w[t], rtol=1e-5, err_msg=t)


GT_TAPS = ("gt_drl/*", "engine/hour")


@pytest.mark.parametrize("engine,ambient", [("scan", False), ("loop", False),
                                            ("batched", False), ("scan", True)],
                         ids=["scan", "loop", "batched", "scan-ambient-pretrained"])
def test_gt_drl_taps_match_the_reference_by_count(engine, ambient):
    """Equal counts a name and a player, the same keys, finite values. Under
    the spec's taps nothing fires while pretraining (the engines pretrain
    before their dispatch); under ambient taps the pretraining contexts'
    players stream too, in both packages."""
    spec_kw = dict(technique="gt-drl", hours=1, engine=engine, pretrain=ambient,
                   taps=None if ambient else GT_TAPS)
    n = 2 if engine == "batched" else 1
    if engine == "batched":
        spec_kw["seeds"] = (0, 1)
    envs = {True: J_ENVS[0] if n == 1 else J_ENVS[:n], False: ENVS[0] if n == 1 else ENVS[:n]}
    with jobs.taps(*(GT_TAPS if ambient else ())), jobs.capture() as jbuf:
        jax_run(JaxSpec(cfg=J_GT_CFG, **spec_kw), envs[True])
    with obs.taps(*(GT_TAPS if ambient else ())), obs.capture() as buf:
        run(ExperimentSpec(cfg=GT_CFG, **spec_kw), envs[False])
    assert buf.counts() == jbuf.counts()
    if engine == "loop":
        assert buf.counts() == {}
        return
    if ambient:  # the pretraining step's 4 contexts x I players, then the hour's
        i = E.num_players(ENV)
        assert buf.counts()["gt_drl/ppo"] == 4 * i + GT_CFG.rounds * i
    for name in ("gt_drl/ppo", "gt_drl/round", "engine/hour"):
        got, want = buf.by_name(name), jbuf.by_name(name)
        for g in got:
            assert set(g) == set(want[0]), name
            assert all(np.all(np.isfinite(np.asarray(x, np.float64))) for x in g.values())
    per_player = [collections.Counter(int(v["player"]) for v in b.by_name("gt_drl/ppo"))
                  for b in (buf, jbuf)]
    assert per_player[0] == per_player[1]
    assert np.shape(buf.by_name("gt_drl/ppo")[0]["actor_loss"]) == \
        np.shape(jbuf.by_name("gt_drl/ppo")[0]["actor_loss"])


SPECS = [
    dict(technique="fd"),
    dict(technique="fd", hours=2, cfg="fd"),
    dict(technique="fd", engine="batched", routed=True, taps=("engine/hour",)),
    dict(technique="nash", engine="month", objective="cost_sla", guard=True),
    dict(technique="gt-drl", cfg="gt-drl", taps=("gt_drl/*", "game/nash_residual")),
]


@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: "-".join(str(v) for v in kw.values()))
@pytest.mark.parametrize("faulted", [False, True], ids=["unfaulted", "faulted"])
def test_engine_key_and_spec_key_equal_the_references(kw, faulted):
    cfgs = {"fd": (FD_CFG, J_FD_CFG), "gt-drl": (GT_CFG, J_GT_CFG)}
    ours, theirs = dict(kw), dict(kw)
    if "cfg" in kw:
        ours["cfg"], theirs["cfg"] = cfgs[kw["cfg"]]
    spec, jspec = ExperimentSpec(failover="drop", **ours), JaxSpec(failover="drop", **theirs)
    fkw = dict(faulted=faulted, fault_axis=faulted and spec.engine == "batched")
    assert obs.engine_key_str(X._engine_key(spec, **fkw)) == \
        jobs.engine_key_str(JX._engine_key(jspec, **fkw))
    assert obs.spec_key(spec) == jobs.spec_key(jspec)
    if spec.engine == "batched":
        assert obs.engine_key_str(X._engine_key(spec, shard=True)) == \
            jobs.engine_key_str(JX._engine_key(jspec, shard=True))

"""The port's realized-fault layer (``repro_torch.faults``), resumable
sweeps and their supervision against the JAX package, on the CPU at D = 4.

Tolerances:

- traces equal the reference's exactly (numpy-built, float32 products);
- ``apply_failover`` on the same random allocation: rtol 1e-5 on the
  realized allocation and the moved mass; the unserved mass within 1e-6 of
  the allocation's total (it is a clamped float32 difference of ~1e9 sums);
- faulted fd days against the reference's faulted days: rtol 1e-5 on the
  carbon, cost and SLA totals and on ``failover_moved``, the unserved mass
  and the violation within 1e-6 of the day's Σ CAR. The routed ones are held
  against the reference's *faulted* output, never its unfaulted one: its
  routed identity trace does not reproduce its own unfaulted totals (the
  re-split is a ratio round trip, ROADMAP C.1);
- faulted scan, loop and batched engines: equal (scan = loop exactly,
  batched rows at rtol 1e-5).
"""
# ruff: noqa: E402
import os
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import faults as JF
from repro.core import ExperimentSpec as JaxSpec
from repro.core import run as jax_run
from repro.core.force_directed import FDConfig as JFDConfig
from repro.dcsim import env as JE
from repro_torch import faults as F
from repro_torch import scenarios as SC
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import ExperimentSpec, register_technique, run, sweep
from repro_torch.core import experiment as X
from repro_torch.core.force_directed import FDConfig
from repro_torch.core.game import SolveResult, uniform_fractions
from repro_torch.dcsim import env as TE
from repro_torch.distributed import fault_tolerance as FT
from repro_torch.tree import tree_leaves, tree_unflatten


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, so intra-op threads only contend
    with the other test workers' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


J_ENV = JE.build_env(4, seed=0)
T_ENV = TE.build_env(4, seed=0, device="cpu")
HOURS = 4
CFG, J_CFG = FDConfig(iters=30), JFDConfig(iters=30)
SUM_CAR = float(np.asarray(J_ENV.car, np.float64)[:, :HOURS].sum())


def _crash(M, env):
    """DC 1 down for hours 1-2, DC 0 browned out, a partitioned WAN link."""
    return M.compose(M.dc_crash(env, dc=1, start=1, duration=2),
                     M.brownout(env, dc=0, start=0, duration=3, severity=0.6),
                     M.wan_partition(env, a=0, b=2, extra_ms=300.0))


T_TRACE, J_TRACE = _crash(F, T_ENV), _crash(JF, J_ENV)


def _trace_equal(t, j):
    for f in F.FaultTrace._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)


@pytest.mark.parametrize("kind,kw", [
    ("no_faults", {}), ("dc_crash", dict(dc=2, start=20, duration=8)),
    ("brownout", dict(dc=3, start=5, duration=4, severity=0.3)),
    ("wan_partition", dict(a=1, b=3, start=22, duration=5, extra_ms=123.0)),
    ("telemetry_dropout", dict(dc=None, start=2, duration=6, price_factor=1.7,
                               carbon_factor=0.6)),
])
def test_trace_matches_jax(kind, kw):
    _trace_equal(getattr(F, kind)(T_ENV, **kw), getattr(JF, kind)(J_ENV, **kw))


def test_composed_random_and_stacked_traces_match_jax():
    _trace_equal(T_TRACE, J_TRACE)
    for seed in range(6):
        _trace_equal(F.random_trace(T_ENV, seed=seed, n_events=4),
                     JF.random_trace(J_ENV, seed=seed, n_events=4))
    stacked = F.stack_traces([F.random_trace(4, seed=s, device="cpu") for s in (0, 1)])
    _trace_equal(stacked, JF.stack_traces([JF.random_trace(4, seed=s) for s in (0, 1)]))
    with pytest.raises(ValueError):
        F.stack_traces([F.no_faults(4, device="cpu"), F.no_faults(8, device="cpu")])
    with pytest.raises(ValueError):
        F.compose()


@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
@pytest.mark.parametrize("policy", ["renormalize", "spill_nearest", "drop"])
def test_apply_failover_matches_jax(policy, routed):
    """A random over-capacity allocation against the crash hour's realized
    env: the realized allocation, unserved and moved mass."""
    rng = np.random.default_rng(7)
    shape = (4, 10, 4) if routed else (10, 4)
    cap = np.asarray(JE.capacity_at(J_ENV, 1), np.float64)
    ar = (rng.uniform(0.2, 1.4, shape) * (cap if not routed else cap[None] / 4)).astype(np.float32)
    jrenv = JF.realized_env(J_ENV, J_TRACE, 1)
    trenv = F.realized_env(T_ENV, T_TRACE, 1)
    want = [np.asarray(x) for x in JF.apply_failover(jrenv, ar, 1, policy)]
    got = [x.numpy() for x in F.apply_failover(trenv, torch.from_numpy(ar), 1, policy)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-3)
    total = float(ar.astype(np.float64).sum())
    assert abs(float(got[1]) - float(want[1])) <= 1e-6 * total
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6 * total)
    assert float(got[1]) > 0 if policy == "drop" else True


@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
@pytest.mark.parametrize("policy", ["renormalize", "spill_nearest", "drop"])
def test_faulted_day_matches_jax(policy, routed):
    spec = dict(technique="fd", hours=HOURS, routed=routed, failover=policy)
    got = run(ExperimentSpec(cfg=CFG, **spec), T_ENV, faults=T_TRACE)["totals"]
    want = jax_run(JaxSpec(cfg=J_CFG, **spec), J_ENV, faults=J_TRACE)["totals"]
    assert set(got) == set(want) == set(X._totals_keys(X._FAULT_KEYS))
    for k in ("carbon_kg", "cost_usd", "sla_miss_cost_usd", "failover_moved"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-30, err_msg=k)
    for k in ("unserved_demand", "violation"):
        assert abs(got[k] - want[k]) <= 1e-6 * SUM_CAR, k
    np.testing.assert_allclose(got["degraded_sla_cost_usd"], want["degraded_sla_cost_usd"],
                               rtol=1e-5, atol=1e-3)
    assert got["fallback_hours"] == want["fallback_hours"] == 0.0


def test_identity_trace_unrouted_is_the_unfaulted_day():
    spec = ExperimentSpec(technique="fd", hours=HOURS, cfg=CFG)
    base = run(spec, T_ENV)["totals"]
    ident = run(spec, T_ENV, faults=F.no_faults(T_ENV))["totals"]
    for k, v in base.items():
        assert ident[k] == v, k
    for k in X._FAULT_KEYS:
        assert k not in base and ident[k] == 0.0


def test_faulted_scan_loop_batched_parity():
    """One shared trace: scan = loop exactly, and each batched row equals
    the scan day of its seed; a stacked trace gives each row its own."""
    spec = ExperimentSpec(technique="fd", hours=HOURS, cfg=CFG, routed=True,
                          failover="spill_nearest")
    scan = run(spec, T_ENV, faults=T_TRACE)
    assert run(spec.replace(engine="loop"), T_ENV, faults=T_TRACE) == scan
    batch = spec.replace(engine="batched", seeds=(0, 0))
    shared = run(batch, [T_ENV, T_ENV], faults=T_TRACE)
    traces = [T_TRACE, F.random_trace(T_ENV, seed=3)]
    stacked = run(batch, [T_ENV, T_ENV], faults=F.stack_traces(traces))
    for k, v in scan["totals"].items():
        np.testing.assert_allclose(shared["totals"][k], [v, v], rtol=1e-5, atol=1e-3, err_msg=k)
        np.testing.assert_allclose(stacked["totals"][k][0], v, rtol=1e-5, atol=1e-3, err_msg=k)
    other = run(spec, T_ENV, faults=traces[1])["totals"]
    for k, v in other.items():
        np.testing.assert_allclose(stacked["totals"][k][1], v, rtol=1e-5, atol=1e-3, err_msg=k)
    with pytest.raises(ValueError, match="batched"):
        run(spec, T_ENV, faults=F.stack_traces(traces))
    with pytest.raises(ValueError, match="rows"):
        run(batch, [T_ENV] * 2, faults=F.stack_traces(traces * 2))
    with pytest.raises(ValueError, match="month"):
        run(spec.replace(engine="month", days=1), T_ENV, faults=T_TRACE)


def test_guard_falls_back_on_a_nan_solver_and_is_invisible_otherwise():
    def nan_solve(gen, ctx, peak, cfg=None):
        return SolveResult(uniform_fractions(ctx) * float("nan"), {})

    register_technique("nan-solver", nan_solve)
    try:
        for engine in ("scan", "batched"):
            spec = ExperimentSpec(technique="nan-solver", hours=3, guard=True, engine=engine)
            res = run(spec, T_ENV)["totals"]
            fell = res["fallback_hours"]
            assert np.all(np.asarray(fell) == 3.0), engine
            assert np.all(np.isfinite(np.asarray(res["cost_usd"]))), engine
    finally:
        X.game.unregister_technique("nan-solver")
    spec = ExperimentSpec(technique="fd", hours=2, cfg=CFG)
    healthy, guarded = run(spec, T_ENV), run(spec.replace(guard=True), T_ENV)
    assert guarded["totals"]["fallback_hours"] == 0.0
    for k, v in healthy["totals"].items():
        assert guarded["totals"][k] == v, k


# ---------------------------------------------------------------------------
# sweeps, resumable sweeps and their supervision
# ---------------------------------------------------------------------------

GRID = {"wan_degradation": (1.0, 2.0, 4.0)}
SPEC = ExperimentSpec(technique="fd", hours=2, cfg=CFG)


def test_sweep_identity_point_matches_unswept_run():
    """An origin_shift weight-0 grid point is the identity transform: its
    curve equals the unswept batched run on the same base env."""
    base = (SC.Scenario("sla_tighten", {"tighten": 0.8}),
            SC.Scenario("wan_degradation", {"factor": 2.0, "extra_ms": 20.0}))
    spec = SPEC.replace(objective="cost_sla", routed=True)
    res = sweep(spec, {"origin_shift": (0.0, 0.7)}, base_env=T_ENV, base_scenarios=base)
    unswept = run(spec.replace(engine="batched", seeds=(spec.seed,)),
                  SC.apply_all(T_ENV, base))
    for k, v in unswept["totals"].items():
        assert res["results"]["fd"]["totals"][k][0] == v[0], k
    assert res["labels"] == ["origin_shift=0.0", "origin_shift=0.7"]
    assert res["results"]["fd"]["per_epoch"]["cost_usd"].shape == (2, 2)
    assert (res["results"]["fd"]["totals"]["sla_miss_cost_usd"][0]
            != res["results"]["fd"]["totals"]["sla_miss_cost_usd"][1])


def test_sweep_takes_shared_and_per_point_faults():
    traces = [F.random_trace(T_ENV, seed=s) for s in range(3)]
    per_point = sweep(SPEC, GRID, base_env=T_ENV, faults=traces)
    shared = sweep(SPEC, GRID, base_env=T_ENV, faults=traces[1])
    tot = per_point["results"]["fd"]["totals"]
    assert tot["unserved_demand"].shape == (3,) and "fallback_hours" in tot
    for k, v in shared["results"]["fd"]["totals"].items():
        np.testing.assert_allclose(v[1], tot[k][1], rtol=1e-6, atol=1e-3, err_msg=k)
    with pytest.raises(ValueError, match="traces"):
        sweep(SPEC, GRID, base_env=T_ENV, faults=traces[:2])


def test_sweep_kill_resume_roundtrip(tmp_path, monkeypatch):
    ref = sweep(SPEC, GRID, base_env=T_ENV)
    journal = str(tmp_path / "journal")
    with pytest.raises(F.KilledMidSweep):
        with F.inject_kill_after(2):
            sweep(SPEC, GRID, base_env=T_ENV, resume_dir=journal)
    assert len(os.listdir(journal)) == 2
    calls = []
    orig = X._run_batched
    monkeypatch.setattr(X, "_run_batched", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    res = sweep(SPEC, GRID, base_env=T_ENV, resume_dir=journal)
    assert len(calls) == 1  # completed chunks are not recomputed
    assert res["resume"]["restored"] == 2 and res["resume"]["computed"] == 1
    for sect in ("totals", "per_epoch"):
        for k, v in ref["results"]["fd"][sect].items():
            np.testing.assert_array_equal(res["results"]["fd"][sect][k], v, err_msg=k)
    with pytest.raises(ValueError, match="different sweep"):
        sweep(SPEC.replace(hours=1), GRID, base_env=T_ENV, resume_dir=journal)


def test_sweep_retries_with_backoff_and_exhausts_its_budget(tmp_path, monkeypatch):
    orig = X._run_batched
    fails = {"left": 2}

    def flaky(*a, **kw):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("transient")
        return orig(*a, **kw)

    ref = sweep(SPEC, GRID, base_env=T_ENV)
    monkeypatch.setattr(X, "_run_batched", flaky)
    res = sweep(SPEC, GRID, base_env=T_ENV, resume_dir=str(tmp_path / "a"), max_retries=3,
                backoff_s=0.0)
    assert res["resume"]["retries"] == 2
    for k, v in ref["results"]["fd"]["totals"].items():
        np.testing.assert_array_equal(res["results"]["fd"]["totals"][k], v, err_msg=k)
    monkeypatch.setattr(X, "_run_batched",
                        lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("always broken")))
    with pytest.raises(RuntimeError, match="always broken"):
        sweep(SPEC, GRID, base_env=T_ENV, resume_dir=str(tmp_path / "b"), max_retries=1,
              backoff_s=0.0)


def test_run_with_retries_backoff_schedule_and_monitor():
    sleeps, calls = [], {"n": 0}

    def step(_):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise FT.SimulatedFailure()

    FT.run_with_retries(step, total_steps=1, save_every=1, save_fn=lambda s: None,
                        restore_fn=lambda: 0, backoff_s=0.1, sleep_fn=sleeps.append)
    assert sleeps == [0.1, 0.2, 0.4]
    mon = FT.HeartbeatMonitor(num_workers=3)
    for w, dt in ((0, 1.0), (1, 1.1), (2, 5.0)):
        mon.record(w, dt, now=0.0)
    assert [s.worker for s in mon.stragglers()] == [2] and mon.dead(now=100.0) == [0, 1, 2]
    assert FT.FailurePolicy(elastic=False).decide([1], 0) == "restart"


def test_call_with_timeout():
    assert F.call_with_timeout(lambda: 42, None) == 42
    assert F.call_with_timeout(lambda: 42, 5.0) == 42
    with pytest.raises(F.PointTimeout):
        F.call_with_timeout(lambda: time.sleep(10), 0.2)
    with pytest.raises(ZeroDivisionError):
        F.call_with_timeout(lambda: 1 / 0, 5.0)


def test_checkpoint_manager_round_trips_tensor_trees(tmp_path):
    """Tensors and arrays in dicts, lists and NamedTuples, atomically, with
    the sha256 check; every step is kept, and restore puts each leaf on its
    template's dtype."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"trace": F.random_trace(T_ENV, seed=1), "arrs": [np.arange(3), torch.ones(2)]}
    for step in range(3):
        mgr.save(step, {"state": tree}, extra={"step": step})
    assert mgr.steps() == [0, 1, 2]
    out, extra = mgr.restore(2, {"state": tree})
    assert extra == {"step": 2}
    _trace_equal(out["state"]["trace"], JF.random_trace(J_ENV, seed=1))
    assert np.array_equal(out["state"]["arrs"][0], np.arange(3))
    assert torch.equal(out["state"]["arrs"][1], torch.ones(2))
    as_f64 = {"trace": tree["trace"], "arrs": [np.zeros(3), torch.zeros(2, dtype=torch.float64)]}
    back = mgr.restore(1, {"state": as_f64})[0]["state"]["arrs"]
    assert back[0].dtype == np.float64 and back[1].dtype == torch.float64
    assert torch.equal(back[1], torch.ones(2, dtype=torch.float64))
    os.makedirs(tmp_path / "step_000000007")  # torn: no manifest
    assert mgr.steps() == [0, 1, 2]
    with open(tmp_path / "step_000000002" / "state.npz", "ab") as f:
        f.write(b"x")
    with pytest.raises(IOError, match="sha256"):
        mgr.restore(2, {"state": tree})


def test_tree_unflatten_matches_jax():
    """``tree.tree_unflatten`` rebuilds leaves in JAX's order (sorted dict
    keys) and keeps the template's own key order, as the checkpoint
    manager's restore needs."""
    template = {"b": [1, (2, 3)], "a": F.no_faults(T_ENV), "c": {"z": 4, "y": 5}}
    leaves = [np.full(1, i) for i in range(len(tree_leaves(template)))]
    got = tree_unflatten(template, leaves)
    want = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template), leaves)
    assert list(got) == ["b", "a", "c"] and list(got["c"]) == ["z", "y"]
    assert type(got["a"]) is type(template["a"])
    assert all(np.array_equal(g, w) for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)))
    assert [int(x[0]) for x in tree_leaves(got)] == list(range(len(leaves)))

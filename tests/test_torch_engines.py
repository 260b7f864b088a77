"""The port's batched and month engines (``repro_torch.core.run`` with
``engine="batched"`` / ``"month"``) against the port's own day and the JAX
package, on the CPU at D = 4.

Tolerances:

- batched row r against the port's scan day of seed ``seeds[r]`` from the
  same initial state: rtol 1e-5 each hour (the rows draw from the same
  generators; only float32 summation order under ``torch.func.vmap`` may
  differ);
- port batched against JAX batched on the same envs (fd, nash): the day
  engine's tolerances of ``tests/test_torch_experiment.py``, rtol 1e-5 each
  hour, violation within 1e-6 of the hour's Σ CAR;
- the month's day totals and peaks against the reference: rtol 1e-5;
- stochastic solvers (GA, DDPG, joint PPO, GT-DRL) batched over six seeds against JAX
  batched: the port's mean within the JAX mean ± 3 combined standard errors
  (``jax.random`` cannot be reproduced); fd or the uniform split planted in
  a technique's place fails that check.
"""
# ruff: noqa: E402
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_jax as H
from repro import scenarios as JSC
from repro.core import ExperimentSpec as JaxSpec
from repro.core import ddpg as JD
from repro.core import force_directed as JFD
from repro.core import genetic as JGA
from repro.core import nash as JN
from repro.core import ppo_joint as JPJ
from repro.core import run as jax_run
from repro.core import schedulers as JS
from repro.dcsim import env as JE
from repro_torch import scenarios as SC
from repro_torch.convert import env_from_numpy
from repro_torch.core import ExperimentSpec, compare_techniques, run
from repro_torch.core import ddpg as TD
from repro_torch.core import force_directed as TFD
from repro_torch.core import game as TG
from repro_torch.core import genetic as TGA
from repro_torch.core import nash as TN
from repro_torch.core import ppo_joint as TPJ
from repro_torch.core import schedulers as TS
from repro_torch.dcsim import env as TE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, so intra-op threads only contend
    with the other test workers' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BASE = JE.build_env(4, seed=0)
# three scenario-days whose events fall in the first hours, SLA priced
ROWS = {"resample": [JSC.Scenario("arrival_resample", {"seed": 1})],
        "outage": [JSC.Scenario("sla_tighten", {"tighten": 0.8}),
                   JSC.Scenario("dc_outage", {"dc": 1, "start": 0, "duration": 2})],
        "shifted": [JSC.Scenario("wan_degradation", {"factor": 3.0, "extra_ms": 30.0}),
                    JSC.Scenario("origin_shift", {"toward": [0], "weight": 0.8}),
                    JSC.Scenario("flash_crowd", {"start": 1, "duration": 2,
                                                 "magnitude": 2.0})]}
J_ENVS = [JSC.apply_all(BASE, scen) for scen in ROWS.values()]


def _carry(jenv):
    return env_from_numpy({k: np.asarray(v) for k, v in jenv._asdict().items()}, device="cpu")


T_ENVS = [_carry(e) for e in J_ENVS]
HOURS = 3
FAST = {"fd": (JFD.FDConfig(iters=30), TFD.FDConfig(iters=30)),
        "nash": (JN.NashConfig(sweeps=2, inner_steps=10), TN.NashConfig(sweeps=2, inner_steps=10)),
        "ga": (JGA.GAConfig(population=8, generations=12),
               TGA.GAConfig(population=8, generations=12)),
        "ddpg": (JD.DDPGConfig(steps=24, batch=8, buffer=16, warmup=8, hidden=(16, 16)),
                 TD.DDPGConfig(steps=24, batch=8, buffer=16, warmup=8, hidden=(16, 16))),
        "gt-drl": (H.FAST_GTDRL, H.FAST_T)}
PPO = TPJ.JointPPOConfig(ppo=H.FAST_T.ppo)
FAST["ppo"] = (JPJ.JointPPOConfig(ppo=H.FAST_GTDRL.ppo), PPO)


def _hold_hours(got, want, keys, rtol=1e-5, sum_car=None):
    """(n, hours) per-hour metric arrays, key by key; violation within 1e-6
    of the hour's Σ CAR of each row."""
    for k in keys:
        if k == "violation":
            lim = 1e-6 * sum_car
            assert np.all(np.abs(np.asarray(got[k]) - np.asarray(want[k])) <= lim), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-30, err_msg=k)


def _sum_car(envs, hours):
    return np.stack([np.asarray(e.car, np.float64).sum(axis=0)[:hours] for e in envs])


def test_grad_of_runs_under_vmap():
    """``game.grad_of`` is ``torch.func``: under ``vmap`` each row gets its
    own gradient, equal to the unbatched one."""
    x = torch.tensor([[0.2, 0.3, 0.5], [0.6, 0.1, 0.3]])
    fn = lambda v: torch.sum(torch.sin(v) * v)
    vals, grads = torch.func.vmap(lambda v: TG.grad_of(fn, v))(x)
    for r in range(2):
        v, g = TG.grad_of(fn, x[r])
        assert torch.equal(vals[r], v) and torch.equal(grads[r], g)


@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
@pytest.mark.parametrize("technique", ["fd", "nash"])
def test_batched_rows_equal_scan_and_match_jax(technique, routed):
    """One vmap a hour over three scenario-days: row r equals the port's scan
    day of seed r, and every row the reference's batched engine."""
    jcfg, tcfg = FAST[technique]
    spec = dict(technique=technique, hours=HOURS, routed=routed, engine="batched",
                objective="carbon")
    got = run(ExperimentSpec(cfg=tcfg, **spec), T_ENVS)
    assert got["seeds"] == [0, 1, 2] and got["per_epoch"]["cost_usd"].shape == (3, HOURS)
    for r, env in enumerate(T_ENVS):
        day = run(ExperimentSpec(cfg=tcfg, **{**spec, "engine": "scan"}, seed=r), env)
        for k in ("carbon_kg", "cost_usd", "sla_miss_cost_usd", "latency_ms", "max_rho"):
            np.testing.assert_allclose(got["per_epoch"][k][r],
                                       [e[k] for e in day["per_epoch"]], rtol=1e-5, err_msg=k)
    want = jax_run(JaxSpec(cfg=jcfg, **spec), J_ENVS)
    keys = [k for k in want["per_epoch"] if k != "violation"]
    assert set(got["per_epoch"]) == set(want["per_epoch"])
    _hold_hours(got["per_epoch"], want["per_epoch"], keys + ["violation"],
                sum_car=_sum_car(J_ENVS, HOURS))
    for k in ("carbon_kg", "cost_usd", "sla_miss_cost_usd"):
        np.testing.assert_allclose(got["totals"][k], want["totals"][k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("technique", ["ga", "ddpg", "ppo", "gt-drl"])
def test_batched_stochastic_rows_equal_scan(technique):
    """Each row draws from its own seed's generator, stacked; the deployed
    state (gt-drl's fresh agents) is shared by every row: row r is the scan
    day of seed ``seeds[r]`` from that state."""
    cfg = FAST[technique][1]
    spec = ExperimentSpec(technique=technique, hours=2, routed=True, engine="batched",
                          cfg=cfg, seeds=(5, 7), pretrain=False)
    got = run(spec, T_ENVS[:2])
    for r, seed in enumerate(spec.seeds):
        day = run(spec.replace(engine="scan", seed=seed), T_ENVS[r])
        for k in ("carbon_kg", "cost_usd"):
            np.testing.assert_allclose(got["per_epoch"][k][r], [e[k] for e in day["per_epoch"]],
                                       rtol=1e-5, err_msg=k)


SEEDS6 = dict(hours=2, pretrain=False, engine="batched", seeds=tuple(range(6)))


@functools.lru_cache(maxsize=None)
def _jax_carbon(technique):
    """The reference's batched day carbon over six seeds on ``BASE``."""
    spec = JaxSpec(technique=technique, cfg=FAST[technique][0], **SEEDS6)
    return jax_run(spec, [BASE] * 6)["totals"]["carbon_kg"]


def _port_carbon(technique, cfg):
    spec = ExperimentSpec(technique=technique, cfg=cfg, **SEEDS6)
    return run(spec, [_carry(BASE)] * 6)["totals"]["carbon_kg"]


def _same_distribution(got, want):
    """The port's mean within the JAX mean ± 3 combined standard errors."""
    se = math.sqrt(got.var(ddof=1) / len(got) + want.var(ddof=1) / len(want))
    return abs(got.mean() - want.mean()) <= 3 * se


@pytest.mark.parametrize("technique", ["ga", "ddpg", "ppo", "gt-drl"])
def test_batched_stochastic_solvers_match_jax_by_distribution(technique):
    """Two-hour days over six seeds on one env, each engine batched: the
    port's mean carbon within the JAX mean ± 3 combined standard errors."""
    got, want = _port_carbon(technique, FAST[technique][1]), _jax_carbon(technique)
    assert _same_distribution(got, want), (got, want)


@functools.lru_cache(maxsize=None)
def _planted_carbon(plant):
    """The port's carbon over the six seeds with fd or the uniform split
    planted in a technique's place."""
    if plant == "fd":
        return _port_carbon("fd", FAST["fd"][1])
    TG.register_technique("uniform-plant", lambda gen, ctx, peak, cfg=None:
                          TG.SolveResult(TG.uniform_fractions(ctx), {}), overwrite=True)
    try:
        return _port_carbon("uniform-plant", None)
    finally:
        TG.unregister_technique("uniform-plant")


@pytest.mark.parametrize("plant", ["fd", "uniform"])
@pytest.mark.parametrize("technique", ["ga", "ddpg", "ppo", "gt-drl"])
def test_distribution_check_rejects_a_planted_solver(technique, plant):
    """The check above fails when another solver stands in the technique's
    place: fd, or the uniform split."""
    got, want = _planted_carbon(plant), _jax_carbon(technique)
    assert not _same_distribution(got, want), (got, want)


def test_batched_takes_a_stacked_env_and_rejects_mismatches():
    spec = ExperimentSpec(technique="fd", hours=1, cfg=FAST["fd"][1], engine="batched")
    listed = run(spec, T_ENVS)
    stacked = run(spec, TE.stack_envs(T_ENVS))
    for k, v in listed["totals"].items():
        assert np.array_equal(v, stacked["totals"][k]), k
    one = run(spec, T_ENVS[0])  # a single env is a batch of one
    assert one["per_epoch"]["cost_usd"].shape == (1, 1)
    with pytest.raises(ValueError, match="seeds"):
        run(spec.replace(seeds=(0,)), T_ENVS)
    with pytest.raises(ValueError, match="zero peak"):
        run(spec, T_ENVS, peak_state0=torch.zeros(4))
    with pytest.raises(ValueError, match="shard"):
        run(spec.replace(engine="scan"), T_ENVS[0], shard=True)


def test_shard_on_one_device_is_the_unsharded_program():
    spec = ExperimentSpec(technique="fd", hours=2, cfg=FAST["fd"][1], engine="batched")
    a, b = run(spec, T_ENVS), run(spec, T_ENVS, shard=True)
    for k, v in a["per_epoch"].items():
        assert np.array_equal(v, b["per_epoch"][k]), k


def test_month_day0_is_the_scan_day_and_matches_jax():
    """Three days in a row: day 0 equals the scan day of ``seed``; the peak
    only grows, is charged once, and matches the reference's month."""
    jcfg, tcfg = FAST["fd"]
    spec = dict(technique="fd", hours=HOURS, engine="month", days=3, seed=2)
    got = run(ExperimentSpec(cfg=tcfg, **spec), T_ENVS)
    day0 = run(ExperimentSpec(cfg=tcfg, technique="fd", hours=HOURS, seed=2), T_ENVS[0])
    for k in ("carbon_kg", "cost_usd"):
        np.testing.assert_allclose(got["per_day"][k][0], [e[k] for e in day0["per_epoch"]],
                                   rtol=1e-6, err_msg=k)
    assert got["days"] == 3 and got["peak_w"].shape == (3, 4)
    assert np.all(np.diff(got["peak_w"], axis=0) >= 0)
    np.testing.assert_array_equal(got["peak_w"][-1], got["final_peak_w"])
    # the peak charge lands where the peak grows: a day that raises no DC's
    # peak pays none
    rises = np.any(np.diff(got["peak_w"], axis=0) > 0, axis=1)
    paid = got["per_day"]["peak_cost_usd"][1:].sum(axis=1) > 0
    assert np.array_equal(rises, paid)
    want = jax_run(JaxSpec(cfg=jcfg, **spec), J_ENVS)
    np.testing.assert_allclose(got["peak_w"], want["peak_w"], rtol=1e-5)
    for k in ("carbon_kg", "cost_usd", "sla_miss_cost_usd"):
        np.testing.assert_allclose(got["day_totals"][k], want["day_totals"][k], rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got["totals"][k], want["totals"][k], rtol=1e-5, err_msg=k)


def test_month_tiles_one_env_and_threads_the_solver_state():
    """One env tiles to ``days``; a stacked month equals the listed one; a
    stateful technique's carry runs on from one day into the next."""
    tcfg = FAST["fd"][1]
    spec = ExperimentSpec(technique="fd", hours=1, engine="month", days=2, cfg=tcfg)
    tiled = run(spec, T_ENVS[0])
    listed = run(spec, [("d0", T_ENVS[0]), ("d1", T_ENVS[0])])
    assert np.array_equal(tiled["peak_w"], listed["peak_w"])
    with pytest.raises(ValueError, match="days"):
        run(spec.replace(days=3), T_ENVS[:2])
    calls = []

    def step(gen, state, ctx, peak, cfg):
        calls.append(state)
        return state + 1, TG.SolveResult(TG.uniform_fractions(ctx), {})

    TG.register_technique("month-state", step=step, stateful=True,
                          init_state=lambda gen, env, obj, cfg, routed, pretrain: 0)
    try:
        run(ExperimentSpec(technique="month-state", hours=2, engine="month", days=2),
            T_ENVS[0])
    finally:
        TG.unregister_technique("month-state")
    assert calls == [0, 1, 2, 3]


def test_compare_techniques_batched_matches_loop_and_jax():
    """The default engine over three envs (deploy-once, env r with seed r)
    equals the hour loop's table and the reference's batched one (fd, nash)."""
    techniques = ("fd", "nash")
    port = {t: FAST[t][1] for t in techniques}
    got = compare_techniques(T_ENVS, techniques, "cost", hours=2, cfg_overrides=port)
    loop = compare_techniques(T_ENVS, techniques, "cost", hours=2, engine="loop",
                              cfg_overrides=port)
    want = JS.compare_techniques(J_ENVS, techniques, "cost", hours=2,
                                 cfg_overrides={t: FAST[t][0] for t in techniques})
    for t in techniques:
        for ref in (loop[t], want[t]):
            np.testing.assert_allclose(got[t]["mean"], ref["mean"], rtol=1e-5)
            np.testing.assert_allclose(got[t]["curve_mean"], ref["curve_mean"], rtol=1e-5)
            assert abs(got[t]["stderr"] - ref["stderr"]) <= 1e-5 * abs(ref["mean"])


def test_legacy_batched_and_month_shims():
    tcfg = FAST["fd"][1]
    got = TS.run_days_batched(T_ENVS, "fd", hours=1, seeds=(4, 5, 6), cfg_override=tcfg)
    spec = ExperimentSpec(technique="fd", hours=1, engine="batched", seeds=(4, 5, 6), cfg=tcfg)
    assert got["seeds"] == [4, 5, 6]
    assert np.array_equal(got["totals"]["cost_usd"], run(spec, T_ENVS)["totals"]["cost_usd"])
    month = TS.run_month(T_ENVS[0], "fd", days=2, hours=1, cfg_override=tcfg)
    want = run(ExperimentSpec(technique="fd", hours=1, engine="month", days=2, cfg=tcfg),
               T_ENVS[0])
    assert np.array_equal(month["peak_w"], want["peak_w"])


def test_suite_rows_run_batched():
    """A scenario suite built by the port runs as one batch."""
    rows = SC.build_suite("grid_events", T_ENVS[0])
    res = run(ExperimentSpec(technique="fd", hours=1, cfg=FAST["fd"][1], engine="batched"),
              [env for _, env in rows])
    assert res["totals"]["carbon_kg"].shape == (len(rows),)
    assert np.all(np.isfinite(res["totals"]["cost_usd"]))


def test_registered_technique_with_draws_runs_batched():
    """An external stochastic technique registers its hour split
    (``draw``/``compute``): its batched rows equal its scan days; a half
    split is refused."""
    def draw(gen, ctx, cfg, device):
        return torch.rand(ctx.joint_shape(), generator=gen).to(device)

    def compute(draws, ctx, peak, cfg):
        return TG.SolveResult(draws / torch.sum(draws, dim=-1, keepdim=True), {})

    TG.register_technique("random-split", lambda gen, ctx, peak, cfg=None: compute(
        draw(gen, ctx, cfg, ctx.env.er.device), ctx, peak, cfg), draw=draw, compute=compute)
    try:
        spec = ExperimentSpec(technique="random-split", hours=2, engine="batched", seeds=(3, 4))
        got = run(spec, T_ENVS[:2])
        for r, seed in enumerate(spec.seeds):
            day = run(spec.replace(engine="scan", seed=seed), T_ENVS[r])
            np.testing.assert_allclose(got["per_epoch"]["cost_usd"][r],
                                       [e["cost_usd"] for e in day["per_epoch"]], rtol=1e-6)
        with pytest.raises(ValueError, match="both"):
            TG.register_technique("half-split", lambda *a, **k: None, draw=draw)
    finally:
        TG.unregister_technique("random-split")

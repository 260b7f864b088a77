"""The port's other learning solvers and the comparison driver against the
JAX package, on the CPU: GA, DDPG, joint PPO (``repro_torch.core.genetic``,
``ddpg``, ``ppo_joint``), the scheduler entry points and
``compare_techniques`` (``core.schedulers``), and GT-DRL through the engine.

Sub-steps are held from the same state and the same draws, built from
``jax.random`` with the reference's key splits (``tests/_torch_jax.py``): a
GA generation, a DDPG solve (every ``td_update`` after warm-up) and a joint
PPO solve, by the objective value of the chosen strategy at rtol 1e-5 and
the rewards at 1e-4. fd and nash are deterministic, so ``compare_techniques``
over them is held at 1e-5. The stochastic solvers are held by distribution:
day totals over six seeds, the port's mean within the JAX mean ± 3 combined
standard errors plus a floor of 1e-3 of the JAX mean.
"""
# ruff: noqa: E402
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs torch; the imports below need the port (hence the E402 waiver)
torch = pytest.importorskip("torch")

import _torch_jax as H
from repro.core import ExperimentSpec as JaxSpec
from repro.core import ddpg as JD
from repro.core import force_directed as JFD
from repro.core import game as JG
from repro.core import genetic as JGA
from repro.core import nash as JN
from repro.core import ppo as JP
from repro.core import ppo_joint as JPJ
from repro.core import run as jax_run
from repro.core import schedulers as JS
from repro.dcsim import env as JE
from repro_torch.convert import env_from_numpy, tree_from_jax
from repro_torch.core import ExperimentSpec, compare_techniques, run, technique_names
from repro_torch.core import ddpg as TD
from repro_torch.core import force_directed as TFD
from repro_torch.core import game as TG
from repro_torch.core import genetic as TGA
from repro_torch.core import nash as TN
from repro_torch.core import ppo_joint as TPJ
from repro_torch.core import schedulers as TS
from repro_torch.optim.adamw import OptState


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, so intra-op threads only contend
    with the other test workers' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ENVS = [JE.build_env(4, seed=s) for s in (0, 1)]
T_ENVS = [env_from_numpy({k: np.asarray(v) for k, v in e._asdict().items()}, device="cpu")
          for e in ENVS]
KEY = jax.random.PRNGKey(0)
TAU = 14
GA = JGA.GAConfig(population=8, generations=1)
DDPG = JD.DDPGConfig(steps=12, batch=8, buffer=8, warmup=4, hidden=(16, 16))
JOINT = JPJ.JointPPOConfig(ppo=JP.PPOConfig(horizon=3, episodes=8, iters=2, update_epochs=2))
# tiny configs of every technique, for runs of a few hours
FAST = {"fd": (JFD.FDConfig(iters=20), TFD.FDConfig),
        "nash": (JN.NashConfig(sweeps=1, inner_steps=8), TN.NashConfig),
        "ga": (JGA.GAConfig(population=8, generations=12), TGA.GAConfig),
        "ddpg": (JD.DDPGConfig(steps=24, batch=8, buffer=16, warmup=8, hidden=(16, 16)),
                 TD.DDPGConfig),
        "ppo": (JPJ.JointPPOConfig(ppo=JP.PPOConfig(horizon=3, episodes=8, iters=3,
                                                    update_epochs=2)), TPJ.JointPPOConfig),
        "gt-drl": (H.FAST_GTDRL, H.TGT.GTDRLConfig)}


def _fast(name, port=True):
    jcfg, cls = FAST[name]
    return H.port_cfg(jcfg, cls) if port else jcfg


def _ctxs(routed, objective="carbon", env=0):
    return (JG.GameContext(env=ENVS[env], tau=jnp.int32(TAU), objective=objective,
                           routed=routed),
            TG.GameContext(env=T_ENVS[env], tau=TAU, objective=objective, routed=routed))


def _peak():
    return (0.4 * np.asarray(JE.dp_max_t(ENVS[0], TAU))).astype(np.float32)


def _hold_value(tctx, got, want, peak, rtol=1e-5):
    """The cloud objective of the two chosen strategies."""
    value = lambda f: float(TG.cloud_objective(tctx, H.t(np.asarray(f)), H.t(peak)))
    np.testing.assert_allclose(value(got.detach().numpy()), value(want), rtol=rtol)


# ---------------------------------------------------------------------------
# sub-steps with injected draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
def test_ga_generation_matches_jax(routed):
    """One Genitor generation from the reference's population and draws; the
    parents are chosen by the port's inverse CDF from the reference's
    uniforms, so the choice itself is held too."""
    jctx, tctx = _ctxs(routed)
    peak = _peak()
    want = jax.jit(lambda k, p: JGA.solve_epoch(k, jctx, p, GA))(KEY, jnp.asarray(peak))
    obj = lambda f: JG.cloud_objective(jctx, f, jnp.asarray(peak))
    k0, key = jax.random.split(KEY)
    pop = jax.random.dirichlet(k0, jnp.ones((GA.population,) + jctx.joint_shape()))
    pop = pop.at[0].set(JG.uniform_fractions(jctx))
    fit = jax.vmap(obj)(pop)
    k1, k2, k3, k4 = jax.random.split(jax.random.split(key, 1)[0], 4)
    ranks = jnp.argsort(jnp.argsort(fit))
    p_sel = (GA.population - ranks).astype(jnp.float32)
    p_sel = p_sel / jnp.sum(p_sel)
    pa, pb = (int(jax.random.choice(k, GA.population, p=p_sel)) for k in (k1, k2))
    mix = jax.random.uniform(k3, (jctx.num_players(), 1))
    child = mix * pop[pa] + (1 - mix) * pop[pb]
    draws = TGA.GenerationDraws(
        H.t(jax.random.uniform(k1, ())).reshape(1), H.t(jax.random.uniform(k2, ())).reshape(1),
        H.t(mix), H.t(jax.random.dirichlet(k4, child * GA.mutate_conc + 0.3)),
        H.t(jax.random.uniform(jax.random.fold_in(k4, 1), (jctx.num_players(), 1))))
    tobj = lambda f: TG.cloud_objective(tctx, f, H.t(peak))
    cfg = H.port_cfg(GA, TGA.GAConfig)
    assert [int(TGA.choice(H.t(p_sel), d)) for d in draws[:2]] == [pa, pb]
    tpop, tfit = TGA.generation(H.t(pop), torch.func.vmap(tobj)(H.t(pop)), draws, tobj, cfg)
    best = tpop[torch.argmin(tfit)]
    _hold_value(tctx, best, want.fractions, peak)
    np.testing.assert_allclose(float(tfit.min()), float(want.info["best"]), rtol=1e-5)


@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
def test_ddpg_solve_matches_jax(routed):
    """A DDPG solve from the reference's initial networks and draws: 12
    steps through an 8-slot ring, a ``td_update`` at each of the last 9.
    Each step's reward reflects the actor those updates left."""
    jctx, tctx = _ctxs(routed)
    peak = _peak()
    want = jax.jit(lambda k, p: JD.solve_epoch(k, jctx, p, DDPG))(KEY, jnp.asarray(peak))
    st = H.np_tree(JD.ddpg_init(KEY, jctx, DDPG))
    carry = lambda x: tree_from_jax(x, device="cpu")
    state = TD.DDPGState(carry(st.actor), carry(st.critic), carry(st.target_actor),
                         carry(st.target_critic), OptState(*carry(st.actor_opt)),
                         OptState(*carry(st.critic_opt)),
                         *(H.t(b) for b in (st.buf_s, st.buf_a, st.buf_r, st.buf_s2)))
    adim = int(np.prod(jctx.joint_shape()))
    noise, idx = [], []
    for t, key_t in enumerate(jax.random.split(KEY, DDPG.steps)):
        k1, k2 = jax.random.split(key_t)
        noise.append(np.asarray(jax.random.normal(k1, (adim,))))
        idx.append(H.t(jax.random.randint(k2, (DDPG.batch,), 0,
                                          max(min(t + 1, DDPG.buffer), 1))).long())
    got = TD.solve_with(state, TD.StepDraws(H.t(np.stack(noise)), torch.stack(idx)), tctx,
                        H.t(peak), H.port_cfg(DDPG, TD.DDPGConfig))
    np.testing.assert_allclose(got.info["rewards"].numpy(), np.asarray(want.info["rewards"]),
                               rtol=1e-4)
    _hold_value(tctx, got.fractions, want.fractions, peak)


@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
def test_joint_ppo_solve_matches_jax(routed):
    """A joint-PPO solve (two PPO iterations, then the 30-step polish) from
    the reference's agent and draws."""
    jctx, tctx = _ctxs(routed, objective="cost")
    peak = _peak()
    want = jax.jit(lambda k, p: JPJ.solve_epoch(k, jctx, p, JOINT))(KEY, jnp.asarray(peak))
    shape = jctx.joint_shape()
    adim = int(np.prod(shape))
    k1, k2 = jax.random.split(KEY)
    agent = H.stack1(H.agents(JP.agent_init(k1, adim, adim, JOINT.ppo)))
    alpha = JG.uniform_fractions(jctx) * 20.0 + 0.5

    def state0_fn(k):
        fr = jax.random.dirichlet(k, jnp.broadcast_to(alpha, (JOINT.ppo.episodes,) + shape))
        return fr.reshape(JOINT.ppo.episodes, -1)

    s0, eps = H.ppo_draws(k2, state0_fn, JOINT.ppo, adim)
    got = TPJ.solve_with(agent, TPJ.JointDraws(H.t(s0)[None], H.t(eps)[None]), tctx,
                         H.t(peak), H.port_cfg(JOINT, TPJ.JointPPOConfig))
    np.testing.assert_allclose(got.info["mean_reward"].numpy(),
                               np.asarray(want.info["mean_reward"]), rtol=1e-4)
    _hold_value(tctx, got.fractions, want.fractions, peak)


# ---------------------------------------------------------------------------
# the engine and the comparison driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
@pytest.mark.parametrize("technique", ["fd", "ga", "nash", "ddpg", "ppo", "gt-drl"])
def test_each_technique_plays_a_day(technique, routed):
    """``run`` plays two hours of each of the paper's six techniques (tiny
    configs) on a CPU env: finite totals, a feasible allocation."""
    assert technique in technique_names()
    res = run(ExperimentSpec(technique=technique, hours=2, cfg=_fast(technique),
                             routed=routed), T_ENVS[0])
    assert len(res["per_epoch"]) == 2 and all(math.isfinite(v) for v in res["totals"].values())
    assert res["totals"]["violation"] <= 1e-6 * float(T_ENVS[0].car[:, :2].double().sum())


def test_gtdrl_scan_equals_loop_exactly():
    """Both engines step gt-drl from the same pretrained agents with the
    same per-hour generator: the same day, bit for bit."""
    spec = ExperimentSpec(technique="gt-drl", hours=2, cfg=_fast("gt-drl"), routed=True, seed=3)
    assert run(spec, T_ENVS[1]) == run(spec.replace(engine="loop"), T_ENVS[1])


def test_compare_techniques_fd_nash_match_jax():
    """The loop protocol over two envs for the deterministic techniques:
    ranked mean, stderr and mean curve at 1e-5."""
    techniques = ("fd", "nash")
    want = JS.compare_techniques(ENVS, techniques, "carbon", hours=2, engine="loop",
                                 cfg_overrides={t: _fast(t, port=False) for t in techniques})
    got = compare_techniques(T_ENVS, techniques, "carbon", hours=2, engine="loop",
                             cfg_overrides={t: _fast(t) for t in techniques})
    for t in techniques:
        np.testing.assert_allclose(got[t]["mean"], want[t]["mean"], rtol=1e-5)
        np.testing.assert_allclose(got[t]["curve_mean"], want[t]["curve_mean"], rtol=1e-5)
        assert abs(got[t]["stderr"] - want[t]["stderr"]) <= 1e-5 * abs(want[t]["mean"])


def test_compare_techniques_ranks_the_six_and_deploys_once(tmp_path):
    """All six on the loop engine and on the default batched one; gt-drl is
    deployed once a comparison (one pretraining for both envs); the batched
    and month shims run; ``record=`` writes a record a technique."""
    cfgs = {t: _fast(t) for t in technique_names()}
    calls = []
    deploy = TS.gt_drl.deploy

    def counting_deploy(*a, **kw):
        calls.append(1)
        return deploy(*a, **kw)

    TS.gt_drl.deploy = counting_deploy
    try:
        out = compare_techniques(T_ENVS, objective="cost", hours=1, engine="loop",
                                 cfg_overrides=cfgs)
    finally:
        TS.gt_drl.deploy = deploy
    assert len(calls) == 1 and tuple(out) == TS.TECHNIQUES
    for t, r in out.items():
        assert math.isfinite(r["mean"]) and r["stderr"] >= 0 and len(r["curve_mean"]) == 1, t
    # the default (batched) engine deploys once too, and ranks as the loop
    TS.gt_drl.deploy = counting_deploy
    try:
        batched = compare_techniques(T_ENVS, objective="cost", hours=1, cfg_overrides=cfgs)
    finally:
        TS.gt_drl.deploy = deploy
    assert len(calls) == 2 and tuple(batched) == TS.TECHNIQUES
    for t in ("fd", "nash"):
        np.testing.assert_allclose(batched[t]["mean"], out[t]["mean"], rtol=1e-5)
    from repro_torch import obs
    path = str(tmp_path / "compare.jsonl")
    looped = compare_techniques(T_ENVS, ("fd",), hours=1, engine="loop", record=path,
                                cfg_overrides=cfgs)
    recs = obs.load_records(path)
    assert len(recs) == 1 and recs[0]["kind"] == "compare" and recs[0]["runs"] == 2
    assert recs[0]["mean"] == looped["fd"]["mean"] and recs[0]["spec"]["engine"] == "loop"
    days = TS.run_days_batched(T_ENVS, "fd", hours=1, cfg_override=cfgs["fd"])
    month = TS.run_month(T_ENVS, "fd", hours=1, cfg_override=cfgs["fd"])
    assert days["totals"]["cost_usd"].shape == (2,) and month["days"] == 2
    np.testing.assert_allclose(month["per_day"]["cost_usd"][0], days["per_epoch"]["cost_usd"][0],
                               rtol=1e-6)


def test_stats_guards_a_single_run():
    """``_stats`` as the reference's: stderr 0.0 at n = 1, ddof 1 beyond."""
    for vals, curves in (([3.5], [[1.0, 2.5]]), ([1.0, 2.0, 4.0], [[1, 2], [3, 4], [5, 9]])):
        got, want = TS._stats(vals, curves), JS._stats(vals, curves)
        assert got == want
    assert TS._stats([3.5], [[1.0]])["stderr"] == 0.0


def test_legacy_run_day_shims():
    """``run_day`` on both engines and with a prebuilt scheduler, and
    ``get_scheduler`` for a stateful technique, give the spec's day."""
    cfg = _fast("gt-drl")
    spec = ExperimentSpec(technique="gt-drl", hours=1, cfg=cfg, pretrain=False)
    want = run(spec, T_ENVS[0])
    assert TS.run_day(T_ENVS[0], "gt-drl", hours=1, cfg_override=cfg, pretrain=False) == want
    assert TS.run_day(T_ENVS[0], "gt-drl", hours=1, cfg_override=cfg, pretrain=False,
                      engine="loop") == want
    solver = TS.get_scheduler("gt-drl", T_ENVS[0], "carbon", cfg=cfg)
    assert TS.run_day(T_ENVS[0], "gt-drl", hours=1, solver=solver, engine="loop") == want
    with pytest.raises(ValueError, match="unknown engine"):
        TS.run_day(T_ENVS[0], "fd", engine="batched")


# ---------------------------------------------------------------------------
# whole stochastic solvers, by distribution
# ---------------------------------------------------------------------------

SEEDS = range(6)


@pytest.mark.parametrize("technique", ["ga", "ddpg", "ppo", "gt-drl"])
def test_stochastic_solvers_match_jax_by_distribution(technique):
    """Two-hour day totals (carbon objective, fresh gt-drl agents) over six
    seeds: the port's mean carbon within the JAX mean ± 3 combined standard
    errors plus 1e-3 of the JAX mean."""
    spec = dict(technique=technique, hours=2, pretrain=False)
    jspec = JaxSpec(cfg=_fast(technique, port=False), **spec)
    want = np.array([jax_run(jspec.replace(seed=s), ENVS[0])["totals"]["carbon_kg"]
                     for s in SEEDS])
    got = np.array([run(ExperimentSpec(cfg=_fast(technique), seed=s, **spec),
                        T_ENVS[0])["totals"]["carbon_kg"] for s in SEEDS])
    se = math.sqrt(got.var(ddof=1) / len(got) + want.var(ddof=1) / len(want))
    assert abs(got.mean() - want.mean()) <= 3 * se + 1e-3 * abs(want.mean()), (got, want)

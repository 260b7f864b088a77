"""The port's learning machinery against the JAX package, on the CPU: the
networks, AdamW, PPO and GT-DRL (``repro_torch.core.networks``, ``optim.adamw``,
``core.ppo``, ``core.gt_drl``).

Both packages start from the same state (JAX's, carried by
``convert.agents_from_jax``) and compute from the same draws: the port's
draw NamedTuples are built from ``jax.random`` with the reference's own key
splits (``tests/_torch_jax.py``). Tolerances: the networks and AdamW steps
at 1e-6 (float32 rounding of a few operations); a rollout and GAE at 1e-5;
PPO updates at 1e-4 (several AdamW steps, each dividing by a root of the
second moment); GT-DRL's agents at 1e-4 and its adopted rows by the
player's objective value at 1e-5 (the row itself can move along directions
the objective does not see, as fd's and nash's do in tests/test_torch_game.py).
A tree is held leaf by leaf, with an absolute floor of the same tolerance
times the leaf's largest magnitude. An agent's weights are held so in
at least 99% of each leaf's entries, and every entry within one learning
rate: an Adam step moves each entry by up to the learning rate whatever its
gradient's size (it divides by the root of the entry's own second moment),
so an entry whose gradient cancels to near zero carries float32 rounding at
the scale of a step. Its moments are held at 1e-4 all the same (measured:
one bias entry in 640 off by 1.5e-5 after a pretraining step at lr 3e-3,
while its moments agree at 1e-6).
"""
# ruff: noqa: E402
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs torch; the imports below need the port (hence the E402 waiver)
torch = pytest.importorskip("torch")

import _torch_jax as H
from repro import scenarios as S
from repro.core import game as JG
from repro.core import gt_drl as JGT
from repro.core import networks as JN
from repro.core import ppo as JP
from repro.dcsim import env as JE
from repro.optim import adamw as JA
from repro_torch.convert import env_from_numpy
from repro_torch.core import game as TG
from repro_torch.core import gt_drl as TGT
from repro_torch.core import networks as TN
from repro_torch.core import ppo as TP
from repro_torch.core.draws import Gammas, dirichlet, draw_gammas
from repro_torch.optim import adamw as TA
from repro_torch.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, so intra-op threads only contend
    with the other test workers' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ENV = JE.build_env(4, seed=0)
SLA_ENV = S.make("wan_degradation", factor=3.0, extra_ms=30.0)(
    S.make("sla_tighten", tighten=0.6, price=1e-4)(ENV))
SHIFTED = S.make("origin_shift", toward=[0], weight=0.8)(SLA_ENV)
T_ENV = env_from_numpy({k: np.asarray(v) for k, v in ENV._asdict().items()}, device="cpu")
T_SHIFTED = env_from_numpy({k: np.asarray(v) for k, v in SHIFTED._asdict().items()},
                           device="cpu")
KEY = jax.random.PRNGKey(0)
PPO = JP.PPOConfig(horizon=4, episodes=8, iters=2, update_epochs=3)
PPO_T = TP.PPOConfig(horizon=4, episodes=8, iters=2, update_epochs=3)


def _close(got, want, rtol, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _close_trees(got, want, rtol, floor):
    """Leaf by leaf at ``rtol``, with an absolute floor of ``floor`` times the
    leaf's largest magnitude; integer leaves (AdamW's step) exactly."""
    want = jax.tree_util.tree_leaves(want)
    got = tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)
        else:
            _close(g, w, rtol, floor * float(np.max(np.abs(w), initial=0.0)))


def _close_agents(got, want, rtol, lr):
    """An AgentState: each weight leaf at ``rtol`` (floor ``rtol`` of the
    leaf's largest magnitude) in 99% of its entries and within ``lr``
    everywhere; the AdamW states by ``_close_trees``."""
    for field in ("actor", "critic"):
        for g, w in zip(tree_leaves(getattr(got, field)),
                        jax.tree_util.tree_leaves(getattr(want, field))):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape
            err = np.abs(g - w)
            tight = err <= rtol * np.abs(w) + rtol * np.max(np.abs(w))
            assert tight.mean() >= 0.99 and err.max() <= lr, (field, w.shape, err.max())
    for field in ("actor_opt", "critic_opt"):
        _close_trees(getattr(got, field), getattr(want, field), rtol, rtol)


# ---------------------------------------------------------------------------
# networks and AdamW
# ---------------------------------------------------------------------------

def _carry(params):
    return H.convert.tree_from_jax(H.np_tree(params), device="cpu")


def test_networks_match_jax():
    """mlp_apply, actor_mean, gaussian_logp and actor_sample (injected eps),
    one network and a stack of three (jax.vmap), at 1e-6."""
    k1, k2, k3, k4 = jax.random.split(KEY, 4)
    actor = JN.actor_init(k1, 6, 4)
    x = jax.random.normal(k2, (5, 6))
    ta = _carry(actor)
    _close(TN.mlp_apply(ta["mlp"], H.t(x)), JN.mlp_apply(actor["mlp"], x), 1e-6, 1e-7)
    _close(TN.actor_mean(ta, H.t(x)), JN.actor_mean(actor, x), 1e-6, 1e-7)
    mu = JN.actor_mean(actor, x[0])
    eps = jax.random.normal(k3, mu.shape)
    logits, logp = JN.actor_sample(actor, x[0], k3)
    tl, tlp = TN.actor_sample_eps(ta, H.t(x[0]), H.t(eps))
    _close(tl, logits, 1e-6, 1e-7)
    _close(tlp, logp, 1e-6)
    # the generator form draws its eps from the generator it is given
    drawn = TN.actor_sample(ta, H.t(x[0]), torch.Generator().manual_seed(4))
    eps4 = torch.randn(4, generator=torch.Generator().manual_seed(4))
    for got, want in zip(drawn, TN.actor_sample_eps(ta, H.t(x[0]), eps4)):
        assert torch.equal(got, want)
    std = jnp.exp(jnp.clip(actor["log_std"], -4.0, 1.0))
    _close(TN.gaussian_logp(H.t(logits), H.t(mu), H.t(std)),
           JN.gaussian_logp(logits, mu, std), 1e-6)
    critic = JN.critic_init(k4, 6)
    _close(TN.critic_value(_carry(critic), H.t(x)),
           JN.critic_value(critic, x), 1e-6, 1e-7)
    stack = jax.vmap(lambda k: JN.actor_init(k, 6, 4))(jax.random.split(k4, 3))
    xs = jax.random.normal(k2, (3, 5, 6))
    eps = jax.random.normal(k3, (3, 5, 4))
    ts = _carry(stack)
    want = jax.vmap(lambda p, s, e: JN.actor_mean(p, s)
                    + jnp.exp(jnp.clip(p["log_std"], -4.0, 1.0)) * e)(stack, xs, eps)
    _close(TN.actor_sample_eps(ts, H.t(xs), H.t(eps))[0], want, 1e-6, 1e-7)


@pytest.mark.parametrize("stacked", [False, True], ids=["one", "stacked"])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["clip-inactive", "clip-active"])
def test_adamw_update_matches_jax(stacked, grad_scale):
    """Three AdamW steps at 1e-6; a stack is held against jax.vmap, so each
    agent is clipped by its own norm (the agents' norms differ tenfold)."""
    cfg = JA.AdamWConfig(lr=3e-3, weight_decay=0.1, grad_clip=1.0)
    tcfg = TA.AdamWConfig(lr=3e-3, weight_decay=0.1, grad_clip=1.0)
    lead = (3,) if stacked else ()
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=lead + (4, 5)).astype(np.float32),
              "b": rng.normal(size=lead + (5,)).astype(np.float32)}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    init = jax.vmap(lambda p: JA.adamw_init(p, cfg)) if stacked else (
        lambda p: JA.adamw_init(p, cfg))
    upd = jax.vmap(lambda g, s, p: JA.adamw_update(g, s, p, cfg)[:2]) if stacked else (
        lambda g, s, p: JA.adamw_update(g, s, p, cfg)[:2])
    js = init(jp)
    tp = H.convert.tree_from_jax(params, device="cpu")
    ts = TA.adamw_init(tp, tcfg, lead)
    assert ts.step.shape == js.step.shape and ts.step.dtype == torch.int32
    for step in range(3):
        scale = grad_scale * (np.arange(1, 4) ** 2 if stacked else 1.0)
        grads = {k: (rng.normal(size=v.shape) * np.reshape(scale, lead + (1,) * (v.ndim - len(lead)))
                     ).astype(np.float32) for k, v in params.items()}
        jp, js = upd(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tp, ts, _ = TA.adamw_update(H.convert.tree_from_jax(grads, device="cpu"), ts, tp, tcfg)
        _close_trees(tp, jp, 1e-6, 1e-7)
        _close_trees(ts, js, 1e-6, 1e-7)


def test_adamw_quantized_moments_raise():
    """Quantized and bf16 moments train (ROADMAP A.11, held against JAX in
    tests/test_torch_optim.py); the solvers' stacked agents keep float32
    moments, and other moments raise there."""
    p = {"w": torch.zeros(3)}
    for cfg in (TA.AdamWConfig(quantize_moments=True), TA.AdamWConfig(moment_dtype="bfloat16")):
        mu = TA.adamw_init(p, cfg).mu["w"]
        assert (isinstance(mu, TA._QTensor) if cfg.quantize_moments
                else mu.dtype == torch.bfloat16)
        with pytest.raises(ValueError, match="float32"):
            TA.adamw_init({"w": torch.zeros(2, 3)}, cfg, (2,))


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------

TARGET = np.array([0.1, 0.5, 0.3, 0.1], np.float32)


def _j_reward(logits):
    return -jnp.sum((jax.nn.softmax(logits) - TARGET) ** 2)


def _t_reward(logits):  # (n, B, A) -> (n, B)
    return -torch.sum((torch.softmax(logits, dim=-1) - H.t(TARGET)) ** 2, dim=-1)


def _j_state(logits):
    return jax.nn.softmax(logits)


def _t_state(logits):
    return torch.softmax(logits, dim=-1)


def _ppo_start(key):
    k1, k2, k3 = jax.random.split(key, 3)
    agent = JP.agent_init(k1, 4, 4, PPO)
    state0 = jax.random.dirichlet(k2, jnp.ones((PPO.episodes, 4)))
    return agent, state0, k3


def test_rollout_and_gae_match_jax():
    """``_rollout`` with the reference's normal draws, then ``_gae``, at 1e-5."""
    agent, state0, key = _ppo_start(KEY)
    ro = JP._rollout(key, agent, state0, _j_state, _j_reward, PPO)
    eps = H.rollout_eps(key, PPO.horizon, PPO.episodes, 4)
    tro = TP._rollout(H.t(eps)[None], H.stack1(H.agents(agent)), H.t(state0)[None],
                      _t_state, _t_reward, PPO_T)
    for got, want in zip(tro, ro):
        _close(got[0], want, 1e-5, 1e-6)
    adv, ret = JP._gae(ro, PPO)
    tadv, tret = TP._gae(tro, PPO_T)
    _close(tadv[0], adv, 1e-5, 1e-5)
    _close(tret[0], ret, 1e-5, 1e-6)


def test_update_and_ppo_improve_match_jax():
    """The clipped update (3 epochs; in the first the ratio is 1 and the
    clip's two branches tie) and two ``ppo_improve`` iterations, at 1e-4."""
    agent, state0, key = _ppo_start(jax.random.PRNGKey(1))
    ro = JP._rollout(key, agent, state0, _j_state, _j_reward, PPO)
    adv, ret = JP._gae(ro, PPO)
    want, losses = JP._update(agent, ro, adv, ret, PPO)
    tro = JP.Rollout(*(H.t(x)[None] for x in ro))
    got, tl = TP._update(H.stack1(H.agents(agent)), TP.Rollout(*tro), H.t(adv)[None],
                         H.t(ret)[None], PPO_T)
    _close_agents(tree_map(lambda x: x[0], got), want, 1e-4, PPO.lr)
    _close(tl["actor_loss"][0], losses["actor_loss"], 1e-4, 1e-4)

    def state0_fn(k):
        return jax.random.dirichlet(k, jnp.ones((PPO.episodes, 4)))

    want, info = JP.ppo_improve(key, agent, state0_fn, _j_state, _j_reward, PPO)
    s0, eps = H.ppo_draws(key, state0_fn, PPO, 4)
    got, tinfo = TP.ppo_improve(H.stack1(H.agents(agent)), H.t(s0)[None], H.t(eps)[None],
                                _t_state, _t_reward, PPO_T)
    _close_agents(tree_map(lambda x: x[0], got), want, 1e-4, PPO.lr)
    _close(tinfo["mean_reward"][0], info["mean_reward"], 1e-5)
    assert tuple(TP.greedy_fractions(got, H.t(state0[:2])[None]).shape) == (1, 2, 4)


def test_average_agents_matches_jax():
    """Float leaves averaged, int32 step counters take the first copy."""
    stack = jax.vmap(lambda k: JP.agent_init(k, 4, 3, PPO))(jax.random.split(KEY, 3))
    stack = stack._replace(actor_opt=stack.actor_opt._replace(
        step=jnp.array([5, 5, 5], jnp.int32)))
    got = TP.average_agents(H.agents(stack))
    _close_trees(got, JP.average_agents(stack), 1e-6, 1e-7)
    assert got.actor_opt.step.dtype == torch.int32 and int(got.actor_opt.step) == 5


def test_dirichlet_from_gammas_has_the_dirichlet_moments():
    """The port's device-side Dirichlet (Marsaglia-Tsang tries, boosted):
    the mean and variance of Dirichlet(alpha) over 20,000 samples, for
    concentrations below and above 1, within 5 standard errors."""
    gen = torch.Generator().manual_seed(0)
    alpha = torch.tensor([0.3, 1.0, 2.5, 12.0])
    x = dirichlet(alpha, draw_gammas(gen, (20000, 4), "cpu")).double()
    a0 = float(alpha.sum())
    mean = alpha.double() / a0
    var = mean * (1 - mean) / (a0 + 1)
    assert torch.allclose(x.sum(-1), torch.ones(20000, dtype=torch.float64), atol=1e-6)
    assert torch.all((x.mean(0) - mean).abs() <= 5 * (var / 20000).sqrt())
    assert torch.all((x.var(0) - var).abs() <= 0.05 * var)
    injected = torch.full((2, 4), 0.25)
    assert dirichlet(alpha, injected) is injected and isinstance(
        draw_gammas(gen, (2, 4), "cpu"), Gammas)


# ---------------------------------------------------------------------------
# GT-DRL
# ---------------------------------------------------------------------------

def test_ctx_features_and_state_dim_match_jax():
    """Exact, for every player, routed and not, and with all-zero carbon,
    price and renewable fields (the reference's zero-denominator guard)."""
    dead = ENV._replace(carbon=jnp.zeros_like(ENV.carbon), eprice=jnp.zeros_like(ENV.eprice),
                        rp=jnp.zeros_like(ENV.rp))
    for jenv in (ENV, SHIFTED, dead):
        tenv = env_from_numpy({k: np.asarray(v) for k, v in jenv._asdict().items()},
                              device="cpu")
        for routed in (False, True):
            want = np.stack([np.asarray(JGT._ctx_features(jenv, jnp.int32(3), i, routed))
                             for i in range(JE.num_players(jenv))])
            got = TGT._ctx_features(tenv, 3, torch.arange(JE.num_players(jenv)), routed)
            assert np.array_equal(got.numpy(), want) and np.all(np.isfinite(want))
            assert np.array_equal(TGT._ctx_features(tenv, 3, 2, routed).numpy(), want[2])
            for mode in ("strategy", "env"):
                assert TGT.state_dim(tenv, mode, routed) == JGT.state_dim(jenv, mode, routed)


def _game(routed, objective="cost_sla", tau=9):
    jenv, tenv = (SHIFTED, T_SHIFTED)
    jctx = JG.GameContext(env=jenv, tau=jnp.int32(tau), objective=objective, routed=routed)
    tctx = TG.GameContext(env=tenv, tau=tau, objective=objective, routed=routed)
    joint = np.asarray(jax.random.dirichlet(jax.random.PRNGKey(7), jnp.ones(jctx.joint_shape())))
    peak = (0.5 * np.asarray(JE.dp_max_t(jenv, tau))).astype(np.float32)
    return jctx, tctx, joint, peak


def _hold_rows(tctx, joint, peak, got_joint, want_joint, rtol=1e-5):
    """Each player's objective with its adopted row, the others as in
    ``joint``: the same at ``rtol`` in both packages."""
    for i in range(tctx.num_players()):
        def value(fr):
            row = H.t(np.asarray(fr))[..., i, :]
            return float(TG.player_objective(tctx, H.t(joint), i, row, H.t(peak)))
        np.testing.assert_allclose(value(got_joint.numpy()), value(want_joint), rtol=rtol,
                                   err_msg=i)


@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
def test_one_player_round_matches_jax(routed):
    """Three players' PPO rounds, candidates and polish (batched in the port,
    ``jax.vmap`` in the reference) from the same agents and draws."""
    jctx, tctx, joint, peak = _game(routed)
    idx = np.array([0, 3, 8])  # players of either parity, in one batch
    jagents = jax.tree_util.tree_map(
        lambda x: x[idx], JGT.init_agents(KEY, jctx.env, H.FAST_GTDRL, routed))
    keys = jax.random.split(jax.random.PRNGKey(3), len(idx))
    want_agents, want_rows = jax.jit(lambda k, a, p, j: JGT._run_players(
        k, a, jnp.asarray(idx), jctx.env, jctx.tau, jctx.objective, p, j, H.FAST_GTDRL))(
        keys, jagents, jnp.asarray(peak), jnp.asarray(joint))
    per = [H.player_draws(k, joint, i, H.FAST_GTDRL, routed) for i, k in zip(idx, keys)]
    draws = TGT.PlayerDraws(*(H.t(np.stack(x)) for x in zip(*per)))
    got_agents, got_rows = TGT._run_players(draws, H.agents(jagents), H.t(idx), tctx.env,
                                            tctx.tau, tctx.objective, H.t(peak), H.t(joint),
                                            H.FAST_T)
    _close_agents(got_agents, want_agents, 1e-4, H.FAST_GTDRL.ppo.lr)
    for k, i in enumerate(idx):  # player i's objective with its adopted row
        def value(row):
            return float(TG.player_objective(tctx, H.t(joint), int(i), H.t(np.asarray(row)),
                                             H.t(peak)))
        np.testing.assert_allclose(value(got_rows[k].numpy()), value(want_rows[k]), rtol=1e-5)


@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
def test_half_update_matches_jax(routed):
    """One gathered half-update (parity 1): agents at 1e-4, the adopted rows
    by objective value at 1e-5, the held rows exactly."""
    jctx, tctx, joint, peak = _game(routed)
    jagents = JGT.init_agents(KEY, jctx.env, H.FAST_GTDRL, routed)
    key_r = jax.random.PRNGKey(11)
    want_agents, want_joint = jax.jit(lambda a, j, k, p: JGT.half_update(
        a, j, k, 1, jctx, p, H.FAST_GTDRL))(jagents, jnp.asarray(joint), key_r, jnp.asarray(peak))
    draws = H.half_draws(key_r, joint, jctx.env, H.FAST_GTDRL, routed)
    got_agents, got_joint = TGT.half_update(H.agents(jagents), H.t(joint), draws, 1, tctx,
                                            H.t(peak), H.FAST_T)
    _close_agents(got_agents, want_agents, 1e-4, H.FAST_GTDRL.ppo.lr)
    held = np.arange(JE.num_players(jctx.env)) % 2 == 0
    assert np.array_equal(got_joint.numpy()[..., held, :], joint[..., held, :])
    _hold_rows(tctx, joint, peak, got_joint, np.asarray(want_joint))


@pytest.mark.parametrize("state_mode", ["strategy", "env"])
@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
def test_gather_equals_masked_exactly(routed, state_mode):
    """The port's two half-update modes give the same agents and joint, bit
    for bit: each player computes from its own row of the same draws (and,
    in state_mode "env", its own context features)."""
    _, tctx, joint, peak = _game(routed, objective="carbon")
    cfg = dataclasses.replace(H.FAST_T, state_mode=state_mode)
    gen = torch.Generator().manual_seed(0)
    agents = TGT.init_agents(gen, tctx.env, cfg, routed)
    draws = TGT.draw_half(gen, tctx, cfg)
    out = {mode: TGT.half_update(agents, H.t(joint), draws, 0, tctx, H.t(peak),
                                 dataclasses.replace(cfg, half_update=mode))
           for mode in ("gather", "masked")}
    for a, b in zip(tree_leaves(out["gather"]), tree_leaves(out["masked"])):
        assert torch.equal(a, b)


def test_unknown_half_update_raises():
    _, tctx, joint, peak = _game(False)
    with pytest.raises(ValueError, match="unknown half_update 'bogus'"):
        TGT.half_update(None, H.t(joint), None, 0, tctx, H.t(peak),
                        dataclasses.replace(H.FAST_T, half_update="bogus"))


def test_solve_epoch_rewinds_diverged_rounds():
    """A NaN in one agent's weights makes every round's joint non-finite:
    each round is rewound and counted, and the epoch keeps its finite start.
    With healthy agents no round is counted."""
    tctx = TG.GameContext(env=T_ENV, tau=18, objective="carbon")
    gen = torch.Generator().manual_seed(0)
    agents = TGT.init_agents(gen, T_ENV, H.FAST_T)
    poisoned = agents._replace(actor={**agents.actor, "mlp": {
        **agents.actor["mlp"], "w0": agents.actor["mlp"]["w0"].clone().index_fill_(
            0, torch.tensor([3]), float("nan"))}})
    peak = torch.zeros(4)
    out, res = TGT.solve_epoch(gen, poisoned, tctx, peak, H.FAST_T)
    assert int(res.info["diverged_rounds"]) == H.FAST_T.rounds
    assert torch.equal(res.fractions, TG.uniform_fractions(tctx))
    assert torch.isnan(out.actor["mlp"]["w0"][3]).all()
    assert torch.isfinite(out.actor["mlp"]["w0"][torch.arange(10) != 3]).all()
    _, res = TGT.solve_epoch(gen, agents, tctx, peak, H.FAST_T)
    assert int(res.info["diverged_rounds"]) == 0 and torch.isfinite(res.fractions).all()
    assert float(res.info["best"]) < float(TG.cloud_objective(tctx, TG.uniform_fractions(tctx),
                                                              peak))


@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
def test_pretrain_matches_jax(routed):
    """One pretraining step (two contexts, every player) from the
    reference's draws: its init, hours, joint strategies and per-player
    keys. Agents at 1e-4 after averaging."""
    cfg = dataclasses.replace(H.FAST_GTDRL, pretrain_iters=2, pretrain_batch=2)
    jenv, tenv = SHIFTED, T_SHIFTED
    want = jax.jit(lambda k: JGT.pretrain(k, jenv, "cost", cfg, routed))(KEY)
    n, d = JE.num_players(jenv), JE.num_dcs(jenv)
    joint_shape = JGT._row_shape(jenv, routed)[:-1] + (n, d)
    taus, joints, players = [], [], []
    for key_t in jax.random.split(jax.random.split(KEY, 1)[0], 2):
        k1, k2, k3 = jax.random.split(key_t, 3)
        taus.append(int(jax.random.randint(k1, (), 0, 24)))
        joint = np.asarray(jax.random.dirichlet(k2, jnp.ones(joint_shape)))
        joints.append(joint)
        players.append(H.half_draws(k3, joint, jenv, cfg, routed))
    draws = TGT.PretrainDraws(tuple(taus), H.t(np.stack(joints)), TGT.PlayerDraws(
        *(torch.stack(x) for x in zip(*players))))
    agents = H.agents(JGT.init_agents(KEY, jenv, cfg, routed))
    got = TGT.pretrain_step(agents, draws, tenv, "cost", H.port_cfg(cfg, TGT.GTDRLConfig))
    _close_agents(got, want, 1e-4, cfg.ppo.lr)


def test_deploy_pretrains_or_starts_fresh():
    """``deploy`` pretrains on its generator (ceil(iters / batch) steps,
    each adding the PPO updates of one round to every agent), or returns the
    fixed seed-0 init; and the draws of a pretraining step have their shapes."""
    gen = torch.Generator().manual_seed(5)
    fresh = TGT.deploy(gen, T_ENV, "carbon", H.FAST_T, pretrain_agents=False)
    again = TGT.deploy(torch.Generator().manual_seed(6), T_ENV, "carbon", H.FAST_T,
                       pretrain_agents=False)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(fresh), tree_leaves(again)))
    trained = TGT.deploy(gen, T_ENV, "carbon", H.FAST_T)
    per_round = H.FAST_T.ppo.iters * H.FAST_T.ppo.update_epochs
    assert trained.actor_opt.step.tolist() == [per_round] * 10
    d = TGT.draw_pretrain(gen, T_SHIFTED, H.FAST_T, routed=True)
    assert len(d.taus) == 4 and all(0 <= x < 24 for x in d.taus)
    assert tuple(d.joints.shape) == (4, 4, 10, 4)
    assert tuple(d.players.cand.shape) == (4, 10, TGT.N_CAND, 16)

"""The port's game layer and solvers (``repro_torch.core``) against the JAX package, on the CPU.

Gradients: ``cloud_objective``'s gradient is held against ``jax.grad`` at rtol
1e-4, with an absolute floor of 1e-4 of the largest component: the objective
sums terms of ~1e6 $/h whose gradients cancel to ~1e1, so each component
carries float32 noise at the scale of the largest one. One case puts requests
exactly at their capacity, where the water-fill's bounds tie; JAX splits a
tie's gradient in half, and so must the port.

fd is held one iteration at a time from identical fractions: forces at rtol
1e-5 (floor 1e-5 of the largest), and the moves (``src``/``dst``) equal
wherever the two best candidates differ by more than that tolerance. nash's
best reply is held by the reply (rtol 1e-5) on the paper's env, and by the
player's objective value (rtol 1e-6) on an SLA-priced one, where the reply's
gradient comes from that cancellation and its direction drifts within a flat
valley of the objective.
"""
# ruff: noqa: E402
import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs torch; the imports below need the port (hence the E402 waiver)
torch = pytest.importorskip("torch")

from repro import scenarios as S
from repro.core import force_directed as JFD
from repro.core import game as JG
from repro.core import nash as JN
from repro.dcsim import env as JE
from repro_torch.convert import env_from_numpy
from repro_torch.core import force_directed as TFD
from repro_torch.core import game as TG
from repro_torch.core import nash as TN


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
# demand beyond two DCs' capacity, one DC half dark and one dark at hour 9:
# the water-fill caps cells
CAPPED = SHIFTED._replace(avail=SHIFTED.avail.at[1, 9].set(0.5).at[2, 9].set(0.0),
                          car=SHIFTED.car * 2.5)


def _carry(jenv):
    return env_from_numpy({k: np.asarray(v) for k, v in jenv._asdict().items()}, device="cpu")


ENVS = {"paper": (ENV, _carry(ENV)), "shifted": (SHIFTED, _carry(SHIFTED)),
        "capped": (CAPPED, _carry(CAPPED))}


def _ctxs(env_name, tau, objective, routed):
    jenv, tenv = ENVS[env_name]
    return (JG.GameContext(env=jenv, tau=jnp.int32(tau), objective=objective, routed=routed),
            TG.GameContext(env=tenv, tau=tau, objective=objective, routed=routed))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, floor):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * float(np.max(np.abs(want), initial=0.0)))


def _fractions(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]).astype(np.float32)


def _peak(jenv, tau):
    top = float(jnp.max(JE.dp_max_t(jenv, tau)))
    return (0.6 * top * np.linspace(0.0, 1.0, JE.num_dcs(jenv))).astype(np.float32)


# ---------------------------------------------------------------------------
# objective and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
@pytest.mark.parametrize("objective", ["carbon", "cost", "cost_sla"])
def test_cloud_objective_and_gradient_match_jax(objective, routed):
    jctx, tctx = _ctxs("shifted", 14, objective, routed)
    f = _fractions(jctx.joint_shape(), seed=7)
    peak = _peak(SHIFTED, 14)
    jv, jg = jax.value_and_grad(lambda x: JG.cloud_objective(jctx, x, peak))(f)
    tv, tg = TG.grad_of(lambda x: TG.cloud_objective(tctx, x, _t(peak)), _t(f))
    _close(tv, jv, rtol=1e-5, floor=0.0)
    _close(tg, jg, rtol=1e-4, floor=1e-4)


@pytest.mark.parametrize("objective", ["carbon", "cost_sla"])
def test_water_fill_gradient_matches_jax_where_it_caps(objective):
    """Fractions that pile every task onto a half-dark DC next to a dark one:
    the water-fill caps cells and moves their excess across the fleet."""
    jctx, tctx = _ctxs("capped", 9, objective, False)
    f = np.full(jctx.joint_shape(), 0.02, np.float32)
    f[:, 1] = 0.94
    cap = np.asarray(JE.capacity_at(CAPPED, 9))
    assert np.sum(np.asarray(JG.fractions_to_ar(jctx, f)) == cap) >= 5
    peak = np.zeros(4, np.float32)
    jg = jax.grad(lambda x: JG.cloud_objective(jctx, x, peak))(f)
    _, tg = TG.grad_of(lambda x: TG.cloud_objective(tctx, x, _t(peak)), _t(f))
    _close(tg, jg, rtol=1e-4, floor=1e-4)


def _on_the_cap(jenv, tau, d):
    """Fractions whose request on DC ``d`` equals its capacity exactly, in
    float32, for every task whose demand exceeds that capacity."""
    car, cap = np.asarray(jenv.car[:, tau]), np.asarray(JE.capacity_at(jenv, tau))
    f = np.full(tuple(jenv.er.shape), 0.25, np.float32)
    tied = 0
    for i in np.flatnonzero(cap[:, d] < car):
        x = np.float32(cap[i, d] / car[i])
        for _ in range(600):  # walk the ulps toward the exact product
            if np.float32(x * car[i]) == cap[i, d]:
                f[i] = (1 - x) / 3
                f[i, d] = x
                tied += 1
                break
            x = np.nextafter(x, np.float32(np.inf if x * car[i] < cap[i, d] else -np.inf),
                             dtype=np.float32)
    return f, tied


@pytest.mark.parametrize("objective", ["carbon", "cost", "cost_sla"])
def test_capped_cell_gradient_splits_the_tie_as_jax_does(objective):
    """Cells whose request equals their capacity exactly (a DC curtailed to 1%
    at hour 9): every bound of the water-fill ties there. JAX gives each side
    of a tie half the gradient, and so does the port; ``torch.clamp`` or
    ``relu`` in the water-fill move these gradients by 3-4% of the largest."""
    jenv = ENV._replace(avail=ENV.avail.at[1, 9].set(0.01))
    f, tied = _on_the_cap(jenv, 9, 1)
    assert tied >= 5
    ar = np.asarray(JE.project_feasible(jenv, f, 9))
    assert np.sum(ar == np.asarray(JE.capacity_at(jenv, 9))) >= tied
    tenv = _carry(jenv)
    jctx = JG.GameContext(env=jenv, tau=jnp.int32(9), objective=objective)
    tctx = TG.GameContext(env=tenv, tau=9, objective=objective)
    peak = np.zeros(4, np.float32)
    jg = jax.grad(lambda x: JG.cloud_objective(jctx, x, peak))(f)
    _, tg = TG.grad_of(lambda x: TG.cloud_objective(tctx, x, _t(peak)), _t(f))
    _close(tg, jg, rtol=1e-4, floor=1e-4)
    # and the projection alone, whose gradient is all tie structure
    w = _fractions(f.shape, seed=3)
    jp = jax.grad(lambda x: jnp.sum(JE.project_feasible(jenv, x, 9) * w))(f)
    _, tp = TG.grad_of(lambda x: torch.sum(TG.fractions_to_ar(tctx, x) * _t(w)), _t(f))
    _close(tp, jp, rtol=1e-4, floor=1e-4)


def test_strategy_helpers_match_jax():
    for routed in (False, True):
        jctx, tctx = _ctxs("shifted", 4, "carbon", routed)
        assert tctx.joint_shape() == jctx.joint_shape()
        assert tctx.is_routed() == routed
        _close(TG.uniform_fractions(tctx), JG.uniform_fractions(jctx), 0.0, 0.0)
        _close(TG.capacity_fractions(tctx), JG.capacity_fractions(jctx), 1e-6, 0.0)
        f = _fractions(jctx.joint_shape(), seed=1)
        row = _fractions(f[..., 2, :].shape, seed=2)
        _close(TG.replace_player(_t(f), 2, _t(row)), JG.replace_player(jnp.asarray(f), 2, row),
               0.0, 0.0)
        _close(TG.player_row(_t(f), 3), JG.player_row(f, 3), 0.0, 0.0)
        peak = _peak(SHIFTED, 4)
        _close(TG.player_objective(tctx, _t(f), 2, _t(row), _t(peak)),
               JG.player_objective(jctx, jnp.asarray(f), 2, row, peak), 1e-5, 0.0)
    # one source region: nothing to route, the routed game is the unrouted one
    agg = JE.aggregate_origin(SHIFTED)
    ctx = TG.GameContext(env=_carry(agg), tau=0, routed=True)
    assert not ctx.is_routed() and ctx.joint_shape() == (10, 4)


@pytest.mark.parametrize("env_name", ["paper", "shifted"])
def test_nash_residual_matches_jax(env_name):
    jctx, tctx = _ctxs(env_name, 18, "carbon", False)
    peak = np.zeros(4, np.float32)
    for f in (np.asarray(JG.uniform_fractions(jctx)), _fractions(jctx.joint_shape(), seed=4)):
        want = JG.nash_residual(jctx, jnp.asarray(f), peak, probe_steps=10)
        got = TG.nash_residual(tctx, _t(f), _t(peak), probe_steps=10)
        _close(got, want, rtol=1e-4, floor=0.0)


# ---------------------------------------------------------------------------
# fd
# ---------------------------------------------------------------------------

def _moves(force, f):
    src = np.argmax(np.where(f > 1e-6, force, -np.inf), axis=-1)
    dst = np.argmin(force, axis=-1)
    return src, dst


def _gap(force, f, tol):
    """Rows whose top-two candidates (for src and for dst) differ by more
    than ``tol`` of the largest force: there the move must agree."""
    scale = np.max(np.abs(force))
    hi = np.sort(np.where(f > 1e-6, force, -np.inf), axis=-1)
    lo = np.sort(force, axis=-1)
    return (hi[..., -1] - hi[..., -2] > tol * scale), (lo[..., 1] - lo[..., 0] > tol * scale)


@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
@pytest.mark.parametrize("objective", ["carbon", "cost_sla"])
def test_fd_one_iteration_at_a_time_matches_jax(objective, routed):
    """From the reference's own iterates, the port's forces and moves agree."""
    jctx, tctx = _ctxs("shifted", 20, objective, routed)
    peak = _peak(SHIFTED, 20)
    jgrad = jax.jit(jax.grad(lambda x: JG.cloud_objective(jctx, x, peak)))
    f = JG.uniform_fractions(jctx)
    for _ in range(12):
        fn = np.asarray(f)
        jf = np.asarray(jgrad(f))
        _, tf = TG.grad_of(lambda x: TG.cloud_objective(tctx, x, _t(peak)), _t(fn))
        tf = tf.numpy()
        _close(tf, jf, rtol=1e-5, floor=1e-5)
        (js, jd), (ts, td) = _moves(jf, fn), _moves(tf, fn)
        sure_src, sure_dst = _gap(jf, fn, 1e-5)
        assert np.array_equal(js[sure_src], ts[sure_src])
        assert np.array_equal(jd[sure_dst], td[sure_dst])
        # the reference's step
        move = 0.06 * np.take_along_axis(fn, js[..., None], axis=-1)[..., 0]
        eye = np.eye(fn.shape[-1], dtype=np.float32)
        f = fn - move[..., None] * eye[js] + move[..., None] * eye[jd]
        f = np.clip(f, 0.0, None)
        f = jnp.asarray(f / f.sum(-1, keepdims=True))


@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
def test_fd_solve_epoch_matches_jax(routed):
    cfg_j, cfg_t = JFD.FDConfig(iters=40), TFD.FDConfig(iters=40)
    jctx, tctx = _ctxs("shifted", 7, "carbon", routed)
    peak = _peak(SHIFTED, 7)
    jr = jax.jit(lambda c: JFD.solve_epoch(None, c, peak, cfg_j))(jctx)
    tr = TFD.solve_epoch(torch.Generator(), tctx, _t(peak), cfg_t)
    _close(tr.fractions, jr.fractions, rtol=1e-5, floor=1e-6)
    _close(tr.info["values"], jr.info["values"], rtol=1e-5, floor=0.0)
    _close(tr.info["best"], jr.info["best"], rtol=1e-6, floor=0.0)
    assert TFD.FDConfig() == TFD.FDConfig(iters=JFD.FDConfig().iters,
                                          quantum=JFD.FDConfig().quantum)


# ---------------------------------------------------------------------------
# nash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
def test_nash_best_reply_matches_jax(routed):
    jcfg, tcfg = JN.NashConfig(inner_steps=20), TN.NashConfig(inner_steps=20)
    jctx, tctx = _ctxs("paper", 18, "carbon", routed)
    peak = np.zeros(4, np.float32)
    f = _fractions(jctx.joint_shape(), seed=11)
    for i in (0, 5, 9):
        want = JN._best_reply(jctx, peak, jnp.asarray(f), i, jcfg)
        got = TN._best_reply(tctx, _t(peak), _t(f), i, tcfg)
        _close(got, want, rtol=1e-5, floor=1e-6)


@pytest.mark.parametrize("routed", [False, True], ids=["unrouted", "routed"])
def test_nash_best_reply_value_matches_jax_with_sla_priced(routed):
    jcfg, tcfg = JN.NashConfig(inner_steps=20), TN.NashConfig(inner_steps=20)
    jctx, tctx = _ctxs("shifted", 0, "cost_sla", routed)
    peak = np.zeros(4, np.float32)
    f = JG.uniform_fractions(jctx)
    for i in (0, 4):
        want = JG.player_objective(jctx, f, i, JN._best_reply(jctx, peak, f, i, jcfg), peak)
        got = TG.player_objective(tctx, _t(f), i,
                                  TN._best_reply(tctx, _t(peak), _t(f), i, tcfg), _t(peak))
        _close(got, want, rtol=1e-6, floor=0.0)


def test_nash_solve_epoch_matches_jax():
    jcfg, tcfg = JN.NashConfig(sweeps=2, inner_steps=15), TN.NashConfig(sweeps=2, inner_steps=15)
    jctx, tctx = _ctxs("paper", 18, "carbon", False)
    peak = np.zeros(4, np.float32)
    jr = JN.solve_epoch(None, jctx, peak, jcfg)
    tr = TN.solve_epoch(None, tctx, _t(peak), tcfg)
    _close(tr.fractions, jr.fractions, rtol=1e-5, floor=1e-6)
    _close(tr.info["sweep_values"], jr.info["sweep_values"], rtol=1e-5, floor=0.0)
    assert TN.NashConfig() == TN.NashConfig(**{k: getattr(JN.NashConfig(), k)
                                               for k in ("sweeps", "inner_steps", "lr")})


# ---------------------------------------------------------------------------
# the technique registry
# ---------------------------------------------------------------------------

def test_registry_names_the_ported_techniques():
    """The paper's six, in the reference's order, with its default configs."""
    assert TG.technique_names() == JG.technique_names() == (
        "fd", "ga", "nash", "ddpg", "ppo", "gt-drl")
    assert TG.get_technique("fd").default_cfg == TFD.FDConfig()
    assert TG.get_technique("nash").default_cfg == TN.NashConfig()
    assert TG.get_technique("gt-drl").stateful and not TG.get_technique("ga").stateful
    with pytest.raises(KeyError, match=r"registered: \('fd', 'ga', 'nash', 'ddpg', 'ppo', "
                                       r"'gt-drl'\)"):
        TG.get_technique("bogus")


def test_register_and_unregister_a_technique():
    def uniform(gen, ctx, peak, cfg=None):
        return TG.SolveResult(TG.uniform_fractions(ctx), {})

    t = TG.register_technique("uniform-test", uniform)
    try:
        assert TG.get_technique("uniform-test") is t and not t.stateful
        with pytest.raises(KeyError, match="already registered"):
            TG.register_technique("uniform-test", uniform)
        with pytest.raises(ValueError, match="exactly one"):
            TG.register_technique("other", uniform, step=lambda *a: None)
        _, tctx = _ctxs("paper", 0, "carbon", False)
        state, res = t.step(None, (), tctx, torch.zeros(4), None)
        assert state == () and tuple(res.fractions.shape) == (10, 4)
    finally:
        TG.unregister_technique("uniform-test")
    assert "uniform-test" not in TG.technique_names()

"""The port's fleet simulator (``repro_torch.dcsim``) against the JAX package, on the CPU.

Construction is host-side numpy with the reference's RNG streams, so every
``EnvParams`` field, capability bundle and RTT matrix is held *exactly* (float32
bit for bit). The simulator functions take the same inputs (the JAX env carried
across with ``env_from_numpy``, random simplex fractions from a numpy seed) and
are held at rtol 1e-5, with an absolute floor of 1e-5 of the largest magnitude
of each output: the two packages sum in another order, which moves float32
results by a few ulps, and an output that is a difference of large terms (a
violation, a peak delta) carries that noise at the scale of its terms.
"""
# ruff: noqa: E402
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

# the port needs torch; the imports below need the port (hence the E402 waiver)
torch = pytest.importorskip("torch")

from repro import scenarios as S
from repro.configs import get_config as jax_get_config
from repro.dcsim import capability as JC
from repro.dcsim import env as JE
from repro.dcsim import latency as JL
from repro.dcsim import workload as JW
from repro_torch.configs import get_config
from repro_torch.convert import env_from_numpy
from repro_torch.dcsim import capability as TC
from repro_torch.dcsim import env as TE
from repro_torch.dcsim import latency as TL
from repro_torch.dcsim import workload as TW
from repro_torch.launch.serve import ModelServer, Request

RTOL = 1e-5

ENV = JE.build_env(4, seed=0)
# SLA priced + WAN visible (tests/test_routing.py's construction), and its
# origins shifted toward region 0: every term of the model is live
SLA_ENV = S.make("wan_degradation", factor=3.0, extra_ms=30.0)(
    S.make("sla_tighten", tighten=0.6, price=1e-4)(ENV))
SHIFTED = S.make("origin_shift", toward=[0], weight=0.8)(SLA_ENV)
LLM_ARCHS = ("qwen2-7b", "qwen2-moe-a2.7b", "mistral-large-123b", "arctic-480b",
             "whisper-base")


def _carry(jenv):
    return env_from_numpy({k: np.asarray(v) for k, v in jenv._asdict().items()}, device="cpu")


T_SHIFTED = _carry(SHIFTED)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = 1e-5 * float(np.max(np.abs(want), initial=0.0))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _fields_equal(tenv, jenv):
    for name in JE.EnvParams._fields:
        want = np.asarray(getattr(jenv, name))
        got = getattr(tenv, name)
        assert got.dtype == torch.float32 and want.dtype == np.float32, name
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


# ---------------------------------------------------------------------------
# construction: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("num_dcs", [4, 8, 16])
@pytest.mark.parametrize("workload", ["aibench", "llm"])
def test_build_env_fields_equal_reference(workload, num_dcs, seed):
    """Every EnvParams field equals the JAX package's, float32 bit for bit."""
    _fields_equal(TE.build_env(num_dcs, seed=seed, workload=workload, device="cpu"),
                  JE.build_env(num_dcs, seed=seed, workload=workload))


@pytest.mark.parametrize("pattern", JW.PATTERNS)
def test_build_env_patterns_equal_reference(pattern):
    assert TW.PATTERNS == JW.PATTERNS
    kw = dict(seed=2, pattern=pattern, month=1, utilization=0.6, renewable_scale=0.5)
    _fields_equal(TE.build_env(8, device="cpu", **kw), JE.build_env(8, **kw))


def test_build_env_include_tpu_equal_reference():
    _fields_equal(TE.build_env(4, seed=1, include_tpu=True, device="cpu"),
                  JE.build_env(4, seed=1, include_tpu=True))


@pytest.mark.parametrize("num_dcs", [4, 8, 16])
@pytest.mark.parametrize("workload", ["aibench", "llm"])
def test_capability_bundles_equal_reference(workload, num_dcs):
    want = JC.get_workload(workload).capabilities(num_dcs, 5)
    got = TC.get_workload(workload).capabilities(num_dcs, 5)
    assert got.task_names == want.task_names
    for name in ("er", "it_idle", "it_dyn", "nn_total", "sizes", "sla_ms"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert set(got.meta) == set(want.meta)
    for k, v in want.meta.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got.meta[k], v, err_msg=k)
        else:
            assert got.meta[k] == v, k


def test_workload_registry_and_resolve():
    assert TC.workload_names() == JC.workload_names()
    with pytest.raises(KeyError, match="unknown workload"):
        TC.get_workload("nope")
    with pytest.raises(ValueError):
        TC.resolve("llm", include_tpu=True)
    assert isinstance(TC.resolve("aibench", include_tpu=True), TC.AIBenchWorkload)


@pytest.mark.parametrize("num_dcs", [4, 8, 16, 5])
def test_rtt_matrix_equal_reference(num_dcs):
    np.testing.assert_array_equal(TL.rtt_matrix(num_dcs=num_dcs), JL.rtt_matrix(num_dcs=num_dcs))
    env = JE.build_env(4, seed=0)
    np.testing.assert_array_equal(
        TL.default_sla_ms(np.asarray(env.er), np.asarray(env.nn_total)),
        JL.default_sla_ms(np.asarray(env.er), np.asarray(env.nn_total)))


@pytest.mark.parametrize("arch", ("llama3.2-1b",) + LLM_ARCHS)
def test_configs_and_param_count_equal_reference(arch):
    """The ``llm`` workload sizes its families by ``param_count``: the port's
    copies of the configs and of the count equal the JAX package's."""
    tcfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for active_only in (False, True):
        assert tcfg.param_count(active_only) == jcfg.param_count(active_only)


# the llm workload's model families, each sized on one of the registry's archs
@pytest.mark.parametrize("arch", [prof.arch for _, prof in TC.LLM_FAMILIES])
def test_model_server_serves_every_llm_family(arch):
    """A server of every family the scheduler dispatches to builds and
    generates on the CPU at smoke width."""
    cfg = get_config(arch).smoke()
    srv = ModelServer(cfg, batch_size=2, cache_len=32, device="cpu")
    outs = srv.generate([Request(0, torch.arange(1, 7, dtype=torch.int32), 3),
                         Request(1, torch.arange(2, 6, dtype=torch.int32), 2)])
    assert [len(outs[0]), len(outs[1])] == [3, 2]
    assert all(0 <= t < cfg.vocab_size for toks in outs.values() for t in toks)


def test_env_batch_helpers_equal_reference():
    envs = [JE.build_env(4, seed=s) for s in (0, 1)]
    tenvs = [_carry(e) for e in envs]
    _fields_equal(TE.stack_envs(tenvs), JE.stack_envs(envs))
    _fields_equal(TE.tile_env(tenvs[0], 3), JE.tile_env(envs[0], 3))
    _fields_equal(TE.pad_env_batch(TE.stack_envs(tenvs), 5),
                  JE.pad_env_batch(JE.stack_envs(envs), 5))
    with pytest.raises(ValueError):
        TE.pad_env_batch(TE.stack_envs(tenvs), 1)


def test_env_from_numpy_checks_fields_and_dtype():
    fields = {k: np.asarray(v) for k, v in ENV._asdict().items()}
    _fields_equal(env_from_numpy(fields, device="cpu"), ENV)
    with pytest.raises(ValueError, match="float32"):
        env_from_numpy({**fields, "car": fields["car"].astype(np.float64)}, device="cpu")
    with pytest.raises(ValueError, match="fields"):
        env_from_numpy({k: v for k, v in fields.items() if k != "rtt"}, device="cpu")


# ---------------------------------------------------------------------------
# latency model
# ---------------------------------------------------------------------------

def test_latency_functions_match_reference():
    rng = np.random.default_rng(0)
    er = np.asarray(SHIFTED.er)
    nn = np.asarray(SHIFTED.nn_total)
    rtt = np.asarray(SHIFTED.rtt)
    rho = rng.uniform(0.0, 1.2, er.shape[1]).astype(np.float32)
    rho[0] = 1.0  # the clip's upper side, and an exact 0 below
    rho[1] = 0.0

    def t(a):
        return torch.from_numpy(np.array(a))

    _close(TL.access_ms(t(rtt)), JL.access_ms(rtt))
    _close(TL.service_ms(t(er), t(nn)), JL.service_ms(er, nn))
    _close(TL.queue_factor(t(rho)), JL.queue_factor(rho))
    _close(TL.expected_latency_ms(t(er), t(nn), t(rho), t(rtt)),
           JL.expected_latency_ms(er, nn, rho, rtt))
    _close(TL.expected_latency_ms_routed(t(er), t(nn), t(rho), t(rtt)),
           JL.expected_latency_ms_routed(er, nn, rho, rtt))
    lat = rng.uniform(10.0, 500.0, er.shape).astype(np.float32)
    sla = np.asarray(SHIFTED.sla_ms)[:, None]
    _close(TL.sla_miss_prob(t(lat), t(sla)), JL.sla_miss_prob(lat, sla))
    with pytest.raises(ValueError):
        TL.access_ms(torch.zeros(4))


# ---------------------------------------------------------------------------
# the simulator: each function on random simplex fractions
# ---------------------------------------------------------------------------

def _fractions(shape, seed):
    """Random simplex rows over the DC axis, from numpy."""
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]).astype(np.float32)


def _peak(jenv, tau):
    """A monthly peak that some DCs' draw exceeds and others' does not."""
    d = JE.num_dcs(jenv)
    top = float(jnp.max(JE.dp_max_t(jenv, tau)))
    return (0.6 * top * np.linspace(0.0, 1.0, d)).astype(np.float32)


@pytest.mark.parametrize("tau", [3, 14, 20])
def test_unrouted_simulator_functions_match_reference(tau):
    jenv, tenv = SHIFTED, T_SHIFTED
    f = _fractions(tuple(jenv.er.shape), seed=tau)
    jar = JE.project_feasible(jenv, f, tau)
    tar = TE.project_feasible(tenv, torch.from_numpy(f), tau)
    _close(tar, jar)
    # from here both packages take the same allocation
    ar = np.array(jar)
    a = torch.from_numpy(ar)
    peak = _peak(jenv, tau)
    p = torch.from_numpy(peak)
    _close(TE.capacity_at(tenv, tau), JE.capacity_at(jenv, tau))
    _close(TE.crac_cap_t(tenv, tau), JE.crac_cap_t(jenv, tau))
    _close(TE.dp_max_t(tenv, tau), JE.dp_max_t(jenv, tau))
    _close(TE.power_cop(tenv), JE.power_cop(jenv))
    _close(TE.load_share(tenv, a, tau), JE.load_share(jenv, ar, tau))
    _close(TE.grid_power(tenv, a, tau), JE.grid_power(jenv, ar, tau))
    _close(TE.dp_est(tenv, a, tau), JE.dp_est(jenv, ar, tau))
    _close(TE.cet_est(tenv, a, tau), JE.cet_est(jenv, ar, tau))
    _close(TE.ce_est(tenv, a, tau), JE.ce_est(jenv, ar, tau))
    _close(TE.nc_est(tenv, a), JE.nc_est(jenv, ar))
    for got, want in zip(TE.peak_increase(tenv, a, tau, p),
                         JE.peak_increase(jenv, ar, tau, peak)):
        _close(got, want)
    _close(TE.cct_est(tenv, a, tau, p), JE.cct_est(jenv, ar, tau, peak))
    _close(TE.cc_est(tenv, a, tau, p), JE.cc_est(jenv, ar, tau, peak))
    _close(TE.latency_ms(tenv, a, tau), JE.latency_ms(jenv, ar, tau))
    _close(TE.sla_cost(tenv, a, tau), JE.sla_cost(jenv, ar, tau))
    _close(TE.sla_cost_est(tenv, a, tau), JE.sla_cost_est(jenv, ar, tau))
    _close(TE.feasible_violation(tenv, a, tau), JE.feasible_violation(jenv, ar, tau))
    for objective in TE.OBJECTIVES:
        _close(TE.player_reward(tenv, a, tau, p, objective),
               JE.player_reward(jenv, ar, tau, peak, objective))
    tpeak, tm = TE.step_epoch(tenv, p, a, tau)
    jpeak, jm = JE.step_epoch(jenv, peak, ar, tau)
    _close(tpeak, jpeak)
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k])


@pytest.mark.parametrize("tau", [5, 18])
def test_routed_simulator_functions_match_reference(tau):
    jenv, tenv = SHIFTED, T_SHIFTED
    s, i, d = (int(n) for n in jenv.origin.shape[:2] + jenv.er.shape[1:])
    f = _fractions((s, i, d), seed=100 + tau)
    jar3 = JE.project_feasible_routed(jenv, f, tau)
    _close(TE.project_feasible_routed(tenv, torch.from_numpy(f), tau), jar3)
    ar3 = np.array(jar3)
    a3 = torch.from_numpy(ar3)
    peak = _peak(jenv, tau)
    p = torch.from_numpy(peak)
    _close(TE.origin_at(tenv, tau), JE.origin_at(jenv, tau))
    _close(TE.source_rtt(tenv), JE.source_rtt(jenv))
    _close(TE.latency_ms_routed(tenv, a3, tau), JE.latency_ms_routed(jenv, ar3, tau))
    _close(TE.sla_cost_routed(tenv, a3, tau), JE.sla_cost_routed(jenv, ar3, tau))
    _close(TE.sla_cost_est_routed(tenv, a3, tau), JE.sla_cost_est_routed(jenv, ar3, tau))
    for objective in TE.OBJECTIVES:
        _close(TE.player_reward(tenv, a3, tau, p, objective),
               JE.player_reward(jenv, ar3, tau, peak, objective))
    tpeak, tm = TE.step_epoch(tenv, p, a3, tau)
    jpeak, jm = JE.step_epoch(jenv, peak, ar3, tau)
    _close(tpeak, jpeak)
    for k in jm:
        _close(tm[k], jm[k])


def test_water_fill_caps_and_outage_match_reference():
    """Fractions that overfill one DC, at an hour with that DC half dark: the
    water-fill caps cells at ER·avail and moves the rest."""
    jenv = SHIFTED._replace(avail=SHIFTED.avail.at[1, 9].set(0.5).at[2, 9].set(0.0),
                            car=SHIFTED.car * 2.5)
    tenv = _carry(jenv)
    f = np.zeros(tuple(jenv.er.shape), np.float32)
    f[:, 1] = 1.0
    jar = JE.project_feasible(jenv, f, 9)
    tar = TE.project_feasible(tenv, torch.from_numpy(f), 9)
    _close(tar, jar)
    cap = np.asarray(JE.capacity_at(jenv, 9))
    assert np.any(np.asarray(jar) == cap)  # some cells sit exactly at capacity
    assert np.all(tar.numpy() <= cap)
    _close(TE.latency_ms(tenv, tar, 9), JE.latency_ms(jenv, jar, 9))


def test_source_rtt_and_aggregate_origin():
    agg = TE.aggregate_origin(T_SHIFTED)
    assert tuple(agg.origin.shape) == (1, 10, 24)
    _close(TE.source_rtt(agg), JE.source_rtt(JE.aggregate_origin(SHIFTED)))
    bad = T_SHIFTED._replace(origin=torch.ones((3, 10, 24)) / 3.0)
    with pytest.raises(ValueError):
        TE.source_rtt(bad)
    with pytest.raises(ValueError, match="unknown objective"):
        TE.player_reward(T_SHIFTED, T_SHIFTED.er, 0, torch.zeros(4), "nope")


# ---------------------------------------------------------------------------
# the estimator prices what the simulator charges (tests/test_consistency.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau,seed", [(3, 0), (12, 1), (20, 2)])
def test_estimators_match_detailed_simulator(tau, seed):
    f = _fractions(tuple(T_SHIFTED.er.shape), seed=seed) * 0.9 + 0.1 / 4
    ar = TE.project_feasible(T_SHIFTED, torch.from_numpy(f.astype(np.float32)), tau)
    peak = torch.from_numpy(_peak(SHIFTED, tau))
    _, m = TE.step_epoch(T_SHIFTED, peak, ar, tau)
    detailed = m["energy_cost_usd"] + m["peak_cost_usd"] + m["network_cost_usd"]
    np.testing.assert_allclose(float(TE.cc_est(T_SHIFTED, ar, tau, peak)), float(detailed),
                               rtol=1e-5)
    np.testing.assert_allclose(float(TE.ce_est(T_SHIFTED, ar, tau)), float(m["carbon_kg"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(torch.sum(TE.sla_cost_est(T_SHIFTED, ar, tau))),
                               float(m["sla_miss_cost_usd"]), rtol=1e-5)

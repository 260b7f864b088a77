"""The port's scenario engine (``repro_torch.scenarios``) against the JAX
package, on the CPU at D = 4.

Every transform and every suite row is held field by field, exactly: the
masks are the reference's numpy, and each transform multiplies in the
precision the reference computes in (float64 rounded to float32, or float32),
so the fields are equal bit for bit. ``traffic_pattern`` and
``arrival_resample`` draw from the reference's numpy streams.
"""
# ruff: noqa: E402
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import scenarios as JS
from repro.dcsim import env as JE
from repro_torch import scenarios as TS
from repro_torch.dcsim import env as TE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, so intra-op threads only contend
    with the other test workers' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


J_BASE = JE.build_env(4, seed=0)
T_BASE = TE.build_env(4, seed=0, device="cpu")
# the paper's WAN and priced misses under the base, so every field is live
J_PRICED = JS.make("wan_degradation", factor=1.5, extra_ms=5.0)(
    JS.make("sla_tighten", tighten=0.9)(J_BASE))
T_PRICED = TS.make("wan_degradation", factor=1.5, extra_ms=5.0)(
    TS.make("sla_tighten", tighten=0.9)(T_BASE))

# each registered transform with parameters away from its defaults
CASES = {
    "identity": {},
    "flash_crowd": dict(start=22, duration=5, magnitude=2.5, tasks=(0, 3)),
    "dc_outage": dict(dc=2, start=20, duration=7),
    "demand_response": dict(dc=3, start=5, duration=9, curtail=0.35),
    "carbon_spike": dict(start=1, duration=4, magnitude=1.7, dcs=(1,)),
    "carbon_diurnal": dict(amplitude=0.5, trough_utc=13),
    "price_surge": dict(start=10, duration=3, magnitude=3.1, dcs=(0, 2)),
    "renewable_drought": dict(scale=0.05, start=6, duration=12),
    "traffic_pattern": dict(kind="bursty", seed=7, utilization=0.55),
    "sla_tighten": dict(tighten=0.55, price=3e-4, weight=0.7, tasks=(1, 2)),
    "wan_degradation": dict(factor=2.5, extra_ms=12.0),
    "origin_shift": dict(toward=(1, 3), weight=0.6, start=4, duration=10, tasks=(0,)),
    "arrival_resample": dict(seed=11, std=0.3),
    "workload_mix_shift": dict(toward=(2,), weight=0.4, start=3, duration=9),
    "context_length_surge": dict(factor=3.0, tasks=(0, 5)),
}


def _equal(tenv, jenv):
    assert tenv.er.device.type == "cpu"
    for name in JE.EnvParams._fields:
        got, want = getattr(tenv, name), np.asarray(getattr(jenv, name))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_registry_names_and_severity_knobs_match_jax():
    assert TS.names() == JS.names() == tuple(sorted(CASES))
    for name in TS.names():
        try:
            want = JS.severity_knob(name)
        except ValueError:
            with pytest.raises(ValueError):
                TS.severity_knob(name)
            continue
        assert TS.severity_knob(name) == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_jax(name):
    """The transform with non-default parameters, then with its defaults,
    on the priced base env: every field equal to the reference's."""
    for params in (CASES[name], {}):
        _equal(TS.make(name, **params)(T_PRICED), JS.make(name, **params)(J_PRICED))


def test_regional_flash_crowd_and_default_wan_match_jax():
    """The origin-tilting regional surge (a dip too), and a WAN degradation
    seeded from the canonical geometry on the paper-default zero RTT."""
    for mag in (3.0, 0.4):
        kw = dict(start=18, duration=4, magnitude=mag, sources=(1,))
        _equal(TS.make("flash_crowd", **kw)(T_BASE), JS.make("flash_crowd", **kw)(J_BASE))
    _equal(TS.make("wan_degradation")(T_BASE), JS.make("wan_degradation")(J_BASE))


@pytest.mark.parametrize("suite", sorted(JS.SUITES))
def test_suite_rows_match_jax(suite):
    got, want = TS.build_suite(suite, T_BASE), JS.build_suite(suite, J_BASE)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, tenv), (_, jenv) in zip(got, want):
        _equal(tenv, jenv)


def test_build_grid_and_month_match_jax():
    grid = {"wan_degradation": (1.0, 3.0),
            "origin_shift": (0.0, {"weight": 0.8, "toward": (0,)})}
    tpts, trows = TS.build_grid(T_BASE, grid, base=(TS.Scenario("sla_tighten", {"tighten": 0.7}),))
    jpts, jrows = JS.build_grid(J_BASE, grid, base=(JS.Scenario("sla_tighten", {"tighten": 0.7}),))
    assert tpts == jpts and [n for n, _ in trows] == [n for n, _ in jrows]
    for (_, tenv), (_, jenv) in zip(trows, jrows):
        _equal(tenv, jenv)
    got, want = TS.build_month(T_BASE, days=8, seed=3), JS.build_month(J_BASE, days=8, seed=3)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, tenv), (_, jenv) in zip(got, want):
        _equal(tenv, jenv)


def test_registry_compose_round_trip_and_errors():
    s = TS.Scenario("dc_outage", {"dc": 1, "start": 2, "duration": 3})
    _equal(s.apply(T_BASE), JS.Scenario("dc_outage", dict(s.params)).apply(J_BASE))
    f, g = TS.make("carbon_spike", magnitude=2.0), TS.make("price_surge", magnitude=1.5)
    _equal(TS.compose(f, g)(T_BASE), g(f(T_BASE)))
    _equal(TS.apply_all(T_BASE, [s, f]), f(s.apply(T_BASE)))
    assert TS.expand_grid({"wan_degradation": (1.0, 2.0)}) == JS.expand_grid(
        {"wan_degradation": (1.0, 2.0)})
    with pytest.raises(KeyError, match="unknown scenario transform"):
        TS.make("bogus")
    with pytest.raises(KeyError):
        TS.expand_grid({"bogus": (1.0,)})
    with pytest.raises(KeyError, match="unknown suite"):
        TS.build_suite("bogus", T_BASE)
    with pytest.raises(KeyError, match="already registered"):
        TS.register("identity")(lambda: None)
    # a transform is pure: the input env is untouched
    before = T_BASE.avail.clone()
    TS.make("dc_outage", dc=0, start=0, duration=24)(T_BASE)
    assert torch.equal(T_BASE.avail, before)

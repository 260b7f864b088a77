"""``repro_torch.lint`` against ``repro.lint``: the port lints clean beside the
reference, each of the reference's seeded regressions trips the same checker
with the same message on the port's counterpart line (``Project.overlay``:
the working tree is never touched), the torch-only hazards trip too, the
shared tables and parsers give the same answers, the runtime validators
agree on both packages' envs, and the port's engine keys behave as the
reference's do.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import lint as R  # noqa: E402
from repro.dcsim import env as JE  # noqa: E402
from repro.faults import trace as JT  # noqa: E402
from repro_torch import lint as L  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import ExperimentSpec, run  # noqa: E402
from repro_torch.core import experiment as X  # noqa: E402
from repro_torch.core.force_directed import FDConfig  # noqa: E402
from repro_torch.dcsim import env as E  # noqa: E402
from repro_torch.dcsim.capability import resolve  # noqa: E402
from repro_torch.faults import trace as T  # noqa: E402
from repro_torch.lint import bounds, project, pytrees, units  # noqa: E402
from repro.lint import bounds as Rbounds, project as Rproject  # noqa: E402
from repro.lint import pytrees as Rpytrees, units as Runits  # noqa: E402

PORT = L.Project.load(L.Project.default_root())
REF = R.Project.load(R.Project.default_root())

ENV = E.build_env(4, seed=0, device="cpu")
JENV = JE.build_env(4, seed=0)
FD_CFG = FDConfig(iters=40)
SPEC = ExperimentSpec(technique="fd", objective="carbon", hours=6, cfg=FD_CFG)


def _seed(proj, relpath: str, old: str, new: str):
    """Overlay one source edit; the anchor must exist exactly once so the
    seeded regression is the edit we think it is."""
    sf = proj.file(relpath)
    assert sf is not None, relpath
    assert sf.text.count(old) == 1, (relpath, old)
    return proj.overlay(relpath, sf.text.replace(old, new))


def _hits(lint, proj, check: str, needle: str, relpath: str):
    """The findings of ``check`` whose message holds ``needle``. Runs that
    checker alone (parse errors and pragma accounting read the seeded file
    only), which is what the full run reports for it."""
    if check == "parse":
        found = proj.parse_violations()
    elif check == "pragma":
        found = [v for v in proj.pragma_violations() if v.path == relpath]
    else:
        found = lint.CHECKERS[check](proj)
    return [v for v in found if v.check == check and needle in v.message]


# ---------------------------------------------------------------------------
# the tree is clean
# ---------------------------------------------------------------------------

def test_port_lints_clean_beside_the_reference():
    """No finding, so every pragma of the port is consumed (none stale);
    neither linter scans the other's package."""
    ours = L.lint_project(L.Project.load(L.Project.default_root()))
    assert ours == [], "\n".join(v.render() for v in ours)
    assert sum(len(sf.pragmas) for sf in PORT.sources.values()) >= 24
    theirs = R.lint_repo()
    assert theirs == [], "\n".join(v.render() for v in theirs)
    assert all(p.startswith("src/repro_torch/") for p in PORT.sources)
    assert not any(p.startswith("src/repro_torch/") for p in REF.sources)


# ---------------------------------------------------------------------------
# seeded regressions: (checker, needle, the reference's edit, the port's edit)
# ---------------------------------------------------------------------------

ENV_PY, FAIL_PY, EXP_PY, GT_PY = ("dcsim/env.py", "faults/failover.py", "core/experiment.py",
                                  "core/gt_drl.py")
SEEDED = {
    "static-key-drops-workload": (
        "compile-key", "workload",
        (EXP_PY, "self.routed, self.failover, self.guard, self.workload)",
         "self.routed, self.failover, self.guard)"),
        None),
    "tap-typo-undeclared": (
        "taps", "engine/huor",
        (EXP_PY, 'obs.tap("engine/hour"', 'obs.tap("engine/huor"'), None),
    "tap-typo-never-emitted": (
        "taps", "engine/hour",
        (EXP_PY, 'obs.tap("engine/hour"', 'obs.tap("engine/huor"'), None),
    "host-clock-in-root": (
        "purity", "time.time",
        (FAIL_PY, "    renv = realized_env(env, trace, tau)",
         "    import time\n    t0 = time.time()\n    renv = realized_env(env, trace, tau)"),
        None),
    "np-random-in-solver": (
        "purity", "numpy.random",
        (GT_PY, '    """Run the game for one epoch: rounds',
         '    _bad = np.random.rand()\n    """Run the game for one epoch: rounds'),
        (GT_PY, '    """``solve_drawn`` from an epoch\'s draws made on ``gen``."""',
         '    _bad = np.random.rand()\n'
         '    """``solve_drawn`` from an epoch\'s draws made on ``gen``."""')),
    "unclassified-spec-field": (
        "compile-key", "precision",
        (EXP_PY, '    technique: str = "fd"',
         '    precision: str = "f32"\n    technique: str = "fd"'), None),
    "syntax-error": ("parse", "syntax error", (GT_PY, None, "def broken(:\n"), None),
    "pragma-without-reason": (
        "pragma", "needs a justification",
        ("_seeded_pragma.py", None, "x = 1  # lint: host-ok()\n"), None),
    "unknown-pragma-directive": (
        "pragma", "unknown pragma directive",
        ("_seeded_pragma.py", None, "x = 1  # lint: hostok(typo'd directive)\n"), None),
    "stale-pragma": (
        "pragma", "stale pragma",
        ("_seeded_pragma.py", None, "x = 1  # lint: host-ok(nothing here needs it)\n"), None),
    "unit-mismatched-add": (
        "units", "unit mismatch",
        (ENV_PY, "de = env.carbon[:, tau] * dp / W_PER_KW",
         "de = (env.carbon[:, tau] + dp) / W_PER_KW"), None),
    "magic-factor": (
        "units", "magic scale factor",
        (ENV_PY, "energy_cost = env.eprice[:, tau] * a * dp / W_PER_KW",
         "energy_cost = env.eprice[:, tau] * a * dp / 1000.0"), None),
    "dropped-conversion": (
        "units", "`carbon_kg`",
        (ENV_PY, "de = env.carbon[:, tau] * dp / W_PER_KW", "de = env.carbon[:, tau] * dp"),
        None),
    "usd-key-carrying-kg": (
        "units", "`sla_miss_cost_usd`",
        (ENV_PY, '"sla_miss_cost_usd": jnp.sum(sla),', '"sla_miss_cost_usd": jnp.sum(de),'),
        (ENV_PY, '"sla_miss_cost_usd": torch.sum(sla),', '"sla_miss_cost_usd": torch.sum(de),')),
    "unit-table-drift": (
        "units", "drifted", (ENV_PY, "        eprice: USD/kWh\n", ""), None),
    "simplex-axis-flip": (
        "bounds", "axis",
        (FAIL_PY, "w = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), _EPS)",
         "w = w / jnp.maximum(jnp.sum(w, axis=0, keepdims=True), _EPS)"),
        (FAIL_PY, "w = w / ties.maximum(torch.sum(w, dim=-1, keepdim=True), _EPS)",
         "w = w / ties.maximum(torch.sum(w, dim=0, keepdim=True), _EPS)")),
    "unguarded-division": (
        "bounds", "not provably positive",
        (ENV_PY, "frac = ar / jnp.maximum(capacity_at(env, tau), 1e-9)",
         "frac = ar / capacity_at(env, tau)"),
        (ENV_PY, "frac = ar / ties.maximum(capacity_at(env, tau), 1e-9)",
         "frac = ar / capacity_at(env, tau)")),
    "stale-unit-ok": (
        "pragma", "stale pragma",
        ("_seeded_pragma.py", None, "x = 1  # lint: unit-ok(nothing here needs it)\n"), None),
}


def _apply(proj, prefix: str, edit):
    rel, old, new = edit
    relpath = f"{prefix}/{rel}"
    if old is None:
        return proj.overlay(relpath, new), relpath
    return _seed(proj, relpath, old, new), relpath


@pytest.mark.parametrize("case", list(SEEDED))
def test_seeded_regression_trips_the_same_checker(case):
    check, needle, ref_edit, port_edit = SEEDED[case]
    proj, rel = _apply(REF, "src/repro", ref_edit)
    assert _hits(R, proj, check, needle, rel), f"reference: {case}"
    proj, rel = _apply(PORT, "src/repro_torch", port_edit or ref_edit)
    assert _hits(L, proj, check, needle, rel), f"port: {case}"


TORCH_ONLY = {
    "global-rng-randn-in-solve-epoch": (
        "purity", "torch.randn` without generator=",
        ("core/force_directed.py", "    del gen\n",
         "    del gen\n    _noise = torch.randn((3,))\n")),
    "global-rng-method-in-solve-epoch": (
        "purity", "`.normal_()` without generator=",
        ("core/force_directed.py", "    del gen\n",
         "    del gen\n    _noise = torch.empty((3,)).normal_()\n")),
    "item-in-hours": (
        "purity", "`.item()`",
        (EXP_PY, "        res = solver(gen, ctx, peak)\n",
         "        res = solver(gen, ctx, peak)\n        _p = peak.sum().item()\n")),
    "cpu-in-batched-hour": (
        "purity", "`.cpu()`",
        (EXP_PY, "    keys[:] = list(m)\n", "    keys[:] = list(m)\n    _h = peak.cpu()\n")),
    "synchronize-in-execute-hour": (
        "purity", "torch.cuda.synchronize",
        (FAIL_PY, "    peak_state, m = E.step_epoch(renv, peak_state, ar_r, tau)\n",
         "    peak_state, m = E.step_epoch(renv, peak_state, ar_r, tau)\n"
         "    torch.cuda.synchronize()\n")),
    "manual-seed-in-solve-epoch": (
        "purity", "torch.manual_seed",
        ("core/force_directed.py", "    del gen\n", "    del gen\n    torch.manual_seed(0)\n")),
    "float-of-a-tensor-in-execute": (
        "purity", "`float()`",
        (EXP_PY, "    guard = spec.guard or trace is not None\n",
         "    guard = spec.guard or trace is not None\n    _p = float(peak.sum())\n")),
    "float-of-a-value-over-numel-in-hours": (
        "purity", "`float()`",
        (EXP_PY, "        res = solver(gen, ctx, peak)\n",
         "        res = solver(gen, ctx, peak)\n        _p = float(peak.sum() / peak.numel())\n")),
    "if-on-a-tensor-in-hours": (
        "purity", "truth test of a tensor",
        (EXP_PY, "        res = solver(gen, ctx, peak)\n",
         "        res = solver(gen, ctx, peak)\n        if (peak > 0).any():\n"
         "            pass\n")),
    "while-on-a-tensor-comparison-in-hours": (
        "purity", "truth test of a tensor",
        (EXP_PY, "        res = solver(gen, ctx, peak)\n",
         "        res = solver(gen, ctx, peak)\n        while peak.max() > 1e9:\n"
         "            break\n")),
    "not-and-on-a-tensor-in-execute": (
        "purity", "truth test of a tensor",
        (EXP_PY, "    guard = spec.guard or trace is not None\n",
         "    guard = spec.guard or trace is not None\n"
         "    _g = not torch.isfinite(peak).all() and guard\n")),
    "nonzero-in-execute": (
        "purity", "nonzero()",
        (EXP_PY, "    guard = spec.guard or trace is not None\n",
         "    guard = spec.guard or trace is not None\n    _idx = fractions.nonzero()\n")),
    "masked-read-in-execute": (
        "purity", "boolean-mask indexing",
        (EXP_PY, "    guard = spec.guard or trace is not None\n",
         "    guard = spec.guard or trace is not None\n    _pos = peak[peak > 0]\n")),
    "masked-write-in-execute": (
        "purity", "boolean-mask write",
        (EXP_PY, "    guard = spec.guard or trace is not None\n",
         "    guard = spec.guard or trace is not None\n"
         "    _late = peak > 0\n    peak[_late] = fractions.sum(0)[_late]\n")),
    "sum-dim-0-in-project-feasible": (
        "bounds", "axis 0",
        (ENV_PY, "w = head / ties.maximum(torch.sum(head, dim=1, keepdim=True), 1e-9)",
         "w = head / ties.maximum(head.sum(dim=0, keepdim=True), 1e-9)")),
    "positional-sum-axis-flip": (
        "bounds", "axis 0",
        (ENV_PY, "w = head / ties.maximum(torch.sum(head, dim=1, keepdim=True), 1e-9)",
         "w = head / ties.maximum(torch.sum(head, 0, keepdim=True), 1e-9)")),
}


@pytest.mark.parametrize("case", list(TORCH_ONLY))
def test_torch_only_hazard_trips(case):
    check, needle, edit = TORCH_ONLY[case]
    proj, rel = _apply(PORT, "src/repro_torch", edit)
    assert _hits(L, proj, check, needle, rel), case


def test_static_shape_casts_and_clamp_guards_stay_clean():
    """``int(np.prod(shape))`` over a shape, a branch on a shape, a scalar
    written through a mask (``masked_fill_``) and ``x.sum(1)`` along the
    contracted axis are what the port writes: none is a finding."""
    proj, rel = _apply(PORT, "src/repro_torch", (
        ENV_PY, "w = head / ties.maximum(torch.sum(head, dim=1, keepdim=True), 1e-9)",
        "w = head / torch.clamp(head.sum(1, keepdim=True), min=1e-9)"))
    assert L.CHECKERS["bounds"](proj) == []
    proj, rel = _apply(PORT, "src/repro_torch", (
        EXP_PY, "        res = solver(gen, ctx, peak)\n",
        "        res = solver(gen, ctx, peak)\n"
        "        _n = int(np.prod(env.er.shape)) + int(peak.numel()) + int(peak.dim())\n"
        "        if peak.dim() == 1 and len(rows) < spec.hours:\n"
        "            peak[peak < 0] = 0.0\n"))
    assert L.CHECKERS["purity"](proj) == []


# ---------------------------------------------------------------------------
# same inputs, same answers
# ---------------------------------------------------------------------------

PRAGMA_TEXTS = [
    "x = 1  # lint: host-ok(why)\n",
    "x = 1  #lint:unit( W/kW )\n",
    "s = '# lint: host-ok(in a string)'\n",
    '"""# lint: unit(ms) in a docstring"""\n',
    "x = 1  # lint: runtime-only()\n",
    "x = 1  # lint: hostok(typo)\n",
    "y = (1 +\n     2)  # lint: unit-ok(two lines)\n",
    "def broken(:\n  # lint: unit(ms)\n",
]


def test_pragmas_parse_alike():
    for text in PRAGMA_TEXTS:
        ours = project.SourceFile("x.py", text, None)
        theirs = Rproject.SourceFile("x.py", text, None)
        assert ours.pragmas == theirs.pragmas, text
        assert (ours.parse_error is None) == (theirs.parse_error is None), text


UNIT_TEXTS = ["1", "", "W", "kW", "kWh", "J", "USD/kWh", "kgCO2/kWh", "task/h", "W*s/J",
              "ms", "GB/task", "FLOP/s", "B/GiB", "node*ms/task", "USD/h", "kgCO2/h",
              "token*chip/s", "km/ms"]
BAD_UNITS = ["watts", "kg", "W/kw", "USD/MWh"]


def test_unit_algebra_agrees():
    for a in UNIT_TEXTS:
        assert repr(units.parse_unit(a)) == repr(Runits.parse_unit(a)), a
        for b in UNIT_TEXTS:
            ua, ub = units.parse_unit(a), units.parse_unit(b)
            ra, rb = Runits.parse_unit(a), Runits.parse_unit(b)
            assert repr(ua * ub) == repr(ra * rb)
            assert repr(ua / ub) == repr(ra / rb)
            assert (ua == ub) == (ra == rb)
        assert repr(units.parse_unit(a) ** 2) == repr(Runits.parse_unit(a) ** 2)
    for bad in BAD_UNITS:
        with pytest.raises(ValueError):
            units.parse_unit(bad)
        with pytest.raises(ValueError):
            Runits.parse_unit(bad)
    for decl in ("W, -", "@EnvParams", "USD, W", "task/h, task/h, task/h", "-"):
        assert repr(units.parse_unit_decl(decl)) == repr(Runits.parse_unit_decl(decl))
    assert units.ATOMS == Runits.ATOMS and units.COMPOUND == Runits.COMPOUND
    assert units.MAGIC_THRESHOLD == Runits.MAGIC_THRESHOLD
    assert {k: [repr(u) for u in v] for k, v in units.SUFFIX_UNITS.items()} == \
        {k: [repr(u) for u in v] for k, v in Runits.SUFFIX_UNITS.items()}
    assert {(m.replace("repro_torch.", "repro."), f): sig
            for (m, f), sig in units.SIGNATURES.items()} == Runits.SIGNATURES


CONST_EXPRS = ["1000.0", "-3", "2 ** 30", "3.6e6 / 1000", "1e9 * 2", "x", "1 + 2", "True",
               "2 ** 4000.0", "1 / 0", "+5", "f(3)"]


def test_const_fold_agrees():
    import ast
    for text in CONST_EXPRS:
        node = ast.parse(text, mode="eval").body
        assert units._const_fold(node) == Runits._const_fold(node), text


def test_schemas_and_bounds_tables_agree():
    assert set(pytrees.SCHEMAS) == set(Rpytrees.SCHEMAS)
    for cls, (module, schema) in pytrees.SCHEMAS.items():
        rmodule, rschema = Rpytrees.SCHEMAS[cls]
        assert module == rmodule.replace("repro.", "repro_torch.", 1)
        assert list(schema) == list(rschema), cls
        for f, spec in schema.items():
            assert (spec.dims, spec.kind) == (rschema[f].dims, rschema[f].kind), (cls, f)
    assert bounds.NONNEG_FIELDS == Rbounds.NONNEG_FIELDS
    assert bounds.SIMPLEX_FIELDS == Rbounds.SIMPLEX_FIELDS
    assert bounds.POSITIVE_CALLS == Rbounds.POSITIVE_CALLS
    assert [(m.replace("repro_torch.", "repro."), f, v, a)
            for m, f, v, a in bounds.SIMPLEX_SITES] == list(Rbounds.SIMPLEX_SITES)
    assert list(L.CHECKERS) == list(R.CHECKERS)
    assert set(L.__all__) == set(R.__all__)


# ---------------------------------------------------------------------------
# validate / validate_bounds side by side
# ---------------------------------------------------------------------------

def test_validators_green_on_both_packages():
    assert L.validate(ENV) is ENV
    assert R.validate(JENV) is JENV
    L.validate_bounds(ENV)
    R.validate_bounds(JENV)
    for ours, theirs in ((T.dc_crash(ENV, device="cpu"), JT.dc_crash(JENV)),
                         (T.random_trace(ENV, seed=3, device="cpu"), JT.random_trace(JENV, seed=3))):
        assert L.validate(ours) is ours
        assert R.validate(theirs) is theirs
        L.validate_bounds(ours)
        R.validate_bounds(theirs)
    bundle = resolve("aibench").capabilities(4, 0)
    assert L.validate(bundle) is bundle


CORRUPTIONS = {
    # name: (exception, field named, port edit, reference edit)
    "carbon-drops-a-dim": (TypeError, "carbon", lambda e: e._replace(carbon=e.carbon[:, 0]),
                           lambda e: e._replace(carbon=e.carbon[:, 0])),
    "axis-contradiction": (TypeError, "contradicts",
                           lambda e: e._replace(rtt=torch.zeros((5, 5))),
                           lambda e: e._replace(rtt=np.zeros((5, 5), np.float32))),
    "negative-eprice": (ValueError, "eprice", lambda e: e._replace(eprice=-e.eprice),
                        lambda e: e._replace(eprice=-e.eprice)),
    "origin-off-the-simplex": (ValueError, "origin", lambda e: e._replace(origin=2 * e.origin),
                               lambda e: e._replace(origin=2 * e.origin)),
}


@pytest.mark.parametrize("case", list(CORRUPTIONS))
def test_same_corruption_raises_in_both(case):
    exc, needle, ours, theirs = CORRUPTIONS[case]
    check, rcheck = ((L.validate, R.validate) if exc is TypeError
                     else (L.validate_bounds, R.validate_bounds))
    with pytest.raises(exc, match=needle):
        check(ours(ENV))
    with pytest.raises(exc, match=needle):
        rcheck(theirs(JENV))


def test_port_only_leaf_hazards_raise():
    with pytest.raises(TypeError, match="float64"):
        L.validate(ENV._replace(avail=ENV.avail.double()))
    # a leaf on another device (the meta device stands in for a card here)
    with pytest.raises(TypeError, match="more than one device"):
        L.validate(ENV._replace(avail=torch.empty((4, 24), device="meta")))
    bundle = resolve("aibench").capabilities(4, 0)
    with pytest.raises(TypeError, match="numpy"):
        L.validate(bundle._replace(er=torch.as_tensor(bundle.er)))
    with pytest.raises(TypeError, match="no pytree schema"):
        L.validate(object())
    with pytest.raises(TypeError, match="avail"):
        L.validate(ENV._replace(avail=torch.ones((4,))))


# ---------------------------------------------------------------------------
# engine keys and expect_compiles
# ---------------------------------------------------------------------------

STATIC_FORKS = [
    ("technique", "nash"),
    ("objective", "cost"),
    ("engine", "batched"),
    ("hours", 12),
    ("cfg", FDConfig(iters=41)),
    ("routed", True),
    ("guard", True),
    ("workload", "llm-mix"),
    ("taps", ("engine/hour",)),
]


@pytest.mark.parametrize("field,value", STATIC_FORKS, ids=[f for f, _ in STATIC_FORKS])
def test_static_field_forks_the_port_engine_key(field, value):
    assert X._engine_key(SPEC.replace(**{field: value})) != X._engine_key(SPEC)


RUNTIME_ONLY = [("seed", 7), ("seeds", (0, 1)), ("days", 3), ("pretrain", False)]


@pytest.mark.parametrize("field,value", RUNTIME_ONLY, ids=[f for f, _ in RUNTIME_ONLY])
def test_runtime_field_does_not_fork_the_port_engine_key(field, value):
    assert X._engine_key(SPEC.replace(**{field: value})) == X._engine_key(SPEC)


def test_failover_forks_the_port_key_only_when_faulted():
    alt = SPEC.replace(failover="spill_nearest")
    assert X._engine_key(alt) == X._engine_key(SPEC)
    assert X._engine_key(alt, faulted=True) != X._engine_key(SPEC, faulted=True)


@pytest.mark.parametrize("spec,envs", [
    (SPEC.replace(hours=2), ENV),
    (SPEC.replace(hours=2, engine="batched", seeds=(0, 1)), [ENV, ENV]),
    (SPEC.replace(hours=2, engine="month", days=2), ENV),
], ids=["scan", "batched", "month"])
def test_port_engine_dispatches_once_then_only_hits(spec, envs):
    obs.reset_stats()
    with L.expect_compiles(1):
        first = run(spec, envs)
    with L.expect_compiles(0) as info:
        again = run(spec, envs)
    assert info["hits"] == 1
    assert first["totals"].keys() == again["totals"].keys()
    assert L.trace_count(spec) is None  # the port has no jit cache to probe


def test_expect_compiles_names_the_forking_key():
    obs.reset_stats()
    with pytest.raises(AssertionError, match="keys that missed"):
        with L.expect_compiles(0):
            run(SPEC.replace(hours=1), ENV)

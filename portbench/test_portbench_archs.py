"""Architecture modules: a configuration names its module under ``"arch"``,
the benchmark resolves it by that name alone, and a second architecture is
served, checked and counted through ``harness.run`` by a module of its own,
with no file of the benchmark edited."""
import collections
import hashlib
import sys
import time
import types

import pytest

torch = pytest.importorskip("torch")

from portbench import _tiny as tiny, archs, harness, weights  # noqa: E402
from portbench.archs import qwen2  # noqa: E402

ROOT = tiny.CHECKOUT / "portbench"
TOY = "portbench.archs.toy"


def _files():
    """Every file of the benchmark with its contents' hash."""
    return {p.relative_to(ROOT).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(ROOT.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def toy(monkeypatch):
    """A second architecture, ``toy``, that exists only as a module object in
    ``sys.modules``: ``qwen2``'s functions, each counting its calls."""
    calls = collections.Counter()
    mod = types.ModuleType(TOY)

    def counted(name):
        fn = getattr(qwen2, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    for name in archs.FUNCTIONS:
        setattr(mod, name, counted(name))
    monkeypatch.setitem(sys.modules, TOY, mod)
    return calls


def test_a_second_architecture_is_served_checked_and_counted_by_its_module_alone(
        toy, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    before = _files()
    cell = tiny.cell("qwen2-moe-a2.7b")
    cell.config = dict(cell.config, arch="toy", name="toy-moe")
    cell.per_layer = [{"name": "mfu", "unit": "%"},
                      {"name": "decode_syncs_per_step", "unit": "syncs"}]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = harness.run(cell, 5, 0.0, True, t_start=time.perf_counter(), device="cpu",
                          port_cfg=tiny.port_cfg("qwen2-moe-a2.7b"), log=lambda msg: None)
    finally:
        torch.set_num_threads(threads)
    assert res["correct"] and res["failed"] == 0, res["check"]
    assert res["metrics"]["mfu"]["value"] > 0 and "decode_syncs_per_step" in res["metrics"]
    # the weights' layout, the port's config check, the reference and its
    # rows' coupling, and the model FLOPs all came from the toy module
    assert set(toy) == set(archs.FUNCTIONS), toy
    assert toy["forward"] >= 1 and toy["request_flops"] >= 1
    assert _files() == before and not (ROOT / "archs" / "toy.py").exists()


@pytest.mark.parametrize("how", ["without", "unknown", "not_a_name", "incomplete"])
@pytest.mark.parametrize("entry", ["archs.of", "weights.draw", "harness.port_config"])
def test_a_configuration_without_a_known_architecture_is_refused_by_name(
        how, entry, monkeypatch):
    cfg = dict(tiny.CONFIGS["qwen2-7b"], name="some-model")
    if how == "without":
        del cfg["arch"]
    elif how == "unknown":
        cfg["arch"] = "no_such_arch"
    elif how == "not_a_name":
        cfg["arch"] = "qwen2.layout"
    else:  # a module that lacks one of the functions
        mod = types.ModuleType(TOY)
        mod.layout = qwen2.layout
        monkeypatch.setitem(sys.modules, TOY, mod)
        cfg["arch"] = "toy"
    call = {"archs.of": archs.of,
            "weights.draw": lambda c: weights.draw(c, 0, "cpu"),
            "harness.port_config": lambda c: harness.port_config(c, tiny.port_cfg("qwen2-7b"))}
    with pytest.raises(ValueError, match=r"'some-model'.*'arch'"):
        call[entry](cfg)


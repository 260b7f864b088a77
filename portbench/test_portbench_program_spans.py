"""The program-span readings (``program_spans.py``): the reduction of the
program's ``repro_torch/`` ranges on synthetic profiler events, the five
readings on hand-made spans, and one CPU run of the tool on a tiny cell."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import _tiny as tiny, check, program_spans as ps, tracing, traffic  # noqa: E402
from portbench.test_portbench_harness import _Ev  # noqa: E402

SYNC = "cudaStreamSynchronize"


def _events():
    """One generate: a readback (a copy and its sync), a decode step whose
    attention half holds a norm, and their device-side copies."""
    return [
        _Ev("user_annotation", "repro_torch/serve.generate", 100, 500, corr=1),
        _Ev("user_annotation", "repro_torch/serve.readback", 110, 40, corr=2),
        _Ev("cuda_runtime", "cudaMemcpyAsync", 115, 5, corr=20),
        _Ev("kernel", "Memcpy DtoH", 118, 4, corr=20),
        _Ev("cuda_runtime", SYNC, 121, 20, corr=21),
        _Ev("user_annotation", "repro_torch/serve.decode", 200, 300, corr=3),
        _Ev("user_annotation", "portbench/decode_step", 205, 290, corr=4),
        _Ev("user_annotation", "repro_torch/block.attn", 210, 130, corr=5),
        _Ev("user_annotation", "repro_torch/norm", 220, 30, corr=6),
        _Ev("cpu_op", "aten::mul", 225, 10, corr=7),
        _Ev("cuda_runtime", "cudaLaunchKernel", 228, 2, corr=30, link=7),
        _Ev("kernel", "mul_kernel", 300, 50, corr=30, link=7),
        _Ev("cpu_op", "aten::mm", 320, 10, corr=8),
        _Ev("cuda_runtime", "cudaLaunchKernel", 322, 2, corr=31, link=8),
        _Ev("kernel", "gemm", 400, 20, corr=31, link=8),
        _Ev("gpu_user_annotation", "repro_torch/serve.decode", 300, 120, corr=3),
        _Ev("gpu_user_annotation", "repro_torch/norm", 300, 50, corr=6),
        _Ev("gpu_user_annotation", "portbench/decode_step", 300, 120, corr=4),
    ]


def test_the_program_reduction_attributes_launches_and_syncs_to_every_open_span():
    p = ps.reduce_program(_events(), (100, 700))
    assert p.row("serve.generate") == {"calls": 1, "host_s": 500e-9, "device_s": 74e-9,
                                       "ops": 3, "syncs": 1}
    assert p.row("serve.readback", "serve.readback")["syncs"] == 1
    assert p.row("serve.readback")["ops"] == 1  # the copy
    assert p.row("serve.decode", "serve.decode") == {"calls": 1, "host_s": 300e-9,
                                                     "device_s": 70e-9, "ops": 2, "syncs": 0}
    assert p.row("norm", "serve.decode") == {"calls": 1, "host_s": 30e-9, "device_s": 50e-9,
                                             "ops": 1, "syncs": 0}
    assert p.row("block.attn")["ops"] == 2 and p.row("rope") == ps._row()
    assert set(p.by_phase) == {("serve.generate", "serve.generate"),
                               ("serve.readback", "serve.readback"),
                               ("serve.decode", "serve.decode"), ("serve.decode", "block.attn"),
                               ("serve.decode", "norm")}
    # each gap names the spans and the benchmark's ranges open at its
    # middle, outermost first: 420-700, 122-300, 350-400, 100-118
    assert p.idle_gaps == [
        ("serve.generate > python (no op)", pytest.approx(280e-9)),
        ("serve.generate > serve.decode > portbench/decode_step > block.attn > python (no op)",
         pytest.approx(178e-9)),
        ("serve.generate > serve.decode > portbench/decode_step > python (no op)",
         pytest.approx(50e-9)),
        ("serve.generate > python (no op)", pytest.approx(18e-9))]  # before the readback


def test_the_benchmarks_reduction_is_unchanged_once_the_program_ranges_are_taken_out():
    """Every field of the accepted reduction reads as in a run that recorded
    no span; left in, the ranges' device-side copies count as device work."""
    evs = _events()
    bare = [ev for ev in evs if not ev.name().startswith("repro_torch/")]
    assert len(bare) < len(evs)
    assert tracing.reduce_events(ps.without_program(evs), (100, 700)) == \
        tracing.reduce_events(bare, (100, 700))
    as_is = tracing.reduce_events(evs, (100, 700))
    assert as_is.busy_s > tracing.reduce_events(bare, (100, 700)).busy_s
    assert as_is.device_events > len([ev for ev in bare if ev.dev])


def _served(prompts, max_new):
    b = traffic.Batch(0, [np.ones(n, np.int32) for n in prompts], list(max_new))
    return check.Served(b, [[1] * n for n in max_new], [], t_hand=0.0, prefill_start=0.0,
                        first_token=1.0, t_return=2.0)


def test_the_five_readings_on_hand_made_spans():
    row = lambda **kw: dict(ps._row(), **kw)  # noqa: E731
    p = ps.Program(
        by_name={"serve.readback": row(calls=4, syncs=4), "serve.decode": row(calls=3, syncs=2),
                 "moe.route": row(device_s=1e-3), "moe.aux": row(device_s=2e-3),
                 "moe.dispatch": row(device_s=3e-3), "moe.combine": row(device_s=4e-3),
                 "moe.experts": row(device_s=50e-3)},
        by_phase={("serve.decode", "serve.decode"): row(calls=3, host_s=0.03, ops=600),
                  ("serve.prefill", "norm"): row(device_s=4e-3),
                  ("serve.prefill", "rope"): row(device_s=1e-3),
                  ("serve.decode", "norm"): row(device_s=9.0)},
        idle_gaps=[])
    traced = [_served((100, 60), (4, 2))]  # 160 real prompt tokens, 3 decode steps
    dispatch = [{"tokens": 8, "routed": 16, "slots": 20, "keep": np.array([True] * 15 + [False])},
                {"tokens": 2, "routed": 4, "slots": 20, "keep": np.array([True] * 4)}]
    got = ps.readings(p, traced, dispatch)
    assert got["decode_host_us_per_launch"] == pytest.approx(0.03 * 1e6 / 600)
    assert got["decode_syncs_per_step"] == pytest.approx(6 / 4)
    assert got["norm_rope_ms_per_ktok"] == pytest.approx(5.0 / 0.16)
    assert got["moe_slot_fill"] == pytest.approx(100 * 19 / 40)
    # 2 rows x (100 padded prompt positions + 3 decode steps) = 206 tokens
    assert got["moe_routing_ms_per_ktok"] == pytest.approx(10.0 / 0.206)
    assert ps.readings(ps.Program({}, {}, []), traced, []) == {}


def test_a_cpu_run_of_the_tool_on_the_tiny_moe_cell(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cell = tiny.cell("qwen2-moe-a2.7b", trace_batches=2)
    cell.per_layer = [{"name": "launches_per_decode_step"}, {"name": "moe_device_ms_per_ktok"}]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = ps.measure(cell, 4, 0.0, device="cpu", port_cfg=tiny.port_cfg("qwen2-moe-a2.7b"))
    finally:
        torch.set_num_threads(threads)
    assert got["replay_equal"] and got["device"] == "cpu"
    assert {m: got["windows"][m]["batches"] for m in ("on", "off")} == {"on": 1, "off": 1}
    assert all(got["windows"][m]["tokens_per_s"] > 0 for m in ("on", "off"))
    d = got["dispatch"]
    assert d["events"] > 0 and 0 < d["kept"] <= min(d["routed"], d["slots"])
    assert got["program"]["moe_slot_fill"] == pytest.approx(100 * d["kept"] / d["slots"])
    assert got["program"]["decode_syncs_per_step"] == 0.0  # no CUDA runtime on the CPU
    calls = {k: r["calls"] for k, r in got["by_phase"].items()}
    assert calls["serve.generate | serve.generate"] == 2
    assert calls["serve.decode | moe.dispatch"] == calls["serve.decode | moe.experts"] > 0
    assert "serve.decode" in got["decode_self_ms"] and "norm" in got["decode_self_ms"]


def _tap_reader():
    """A per-layer metric that reads the program batch's ``moe/dispatch``
    tap: the share of the expert products' rows that hold a pair."""
    mod = types.ModuleType("moe_dispatch_reader")
    mod.RANGES, mod.PROGRAM, mod.TAPS = [], True, ["moe/dispatch"]

    def read(view):
        events = view.taps.get("moe/dispatch", [])
        slots = sum(int(v["slots"]) for v in events)
        return 100.0 * sum(int(np.sum(v["keep"])) for v in events) / slots if slots else None

    mod.read = read
    return mod


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b"])
def test_the_program_batch_leaves_the_other_metrics_readings_as_they_were(arch, monkeypatch):
    """A traced tiny run with and without metrics that read the program (the
    same seed, on a clock that ticks 1 ms a read): every other metric reads
    the same; the program batch's spans hold one ``serve.decode`` a decode
    step and one ``serve.readback`` a generated token, and its
    ``moe/dispatch`` tap one event a layer and pass, in the MoE."""
    import itertools
    import time

    from portbench import harness

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    views, made = [], harness.View
    monkeypatch.setattr(harness, "View", lambda *a, **k: views.append(made(*a, **k)) or views[-1])
    real, reader = harness.metric_module, _tap_reader()
    monkeypatch.setattr(harness, "metric_module",
                        lambda name: reader if name == "moe_dispatch_reader" else real(name))
    cell = tiny.cell(arch)
    accepted = [m for m in harness.load_cell(tiny.CELLS[arch], tiny.CHECKOUT).per_layer
                if not getattr(real(m["name"]), "PROGRAM", False)]
    program = [{"name": "decode_syncs_per_step", "unit": "syncs"},
               {"name": "moe_dispatch_reader", "unit": "%"}]
    results = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for per_layer in (accepted, accepted + program):
            ticks = itertools.count()
            monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 1e-3)
            cell.per_layer = per_layer
            results.append(harness.run(cell, 8, 0.0, True, t_start=time.perf_counter(),
                                       device="cpu", port_cfg=tiny.port_cfg(arch),
                                       log=lambda msg: None))
    finally:
        torch.set_num_threads(threads)
    without, with_program = results
    assert without["correct"] and with_program["correct"]
    others = {k: v for k, v in with_program["metrics"].items()
              if k not in {m["name"] for m in program}}
    assert others == without["metrics"] and {"decode_step_ms", "mfu"} <= set(others)
    a, b = views
    assert a.trace.range_calls == b.trace.range_calls and a.trace.range_calls
    assert {k: len(v) for k, v in a.notes.items()} == {k: len(v) for k, v in b.notes.items()}
    assert a.program is None and not a.program_served and not a.taps
    (served,) = b.program_served
    steps = served.batch.steps
    assert b.program.row("serve.decode", "serve.decode")["calls"] == steps - 1
    assert b.program.row("serve.readback")["calls"] == steps
    assert b.program.row("serve.generate")["calls"] == 1
    assert with_program["metrics"]["decode_syncs_per_step"]["value"] == 0.0  # no CUDA runtime
    events = b.taps["moe/dispatch"]
    if arch == "qwen2-7b":
        assert events == [] and "moe_dispatch_reader" not in with_program["metrics"]
        return
    assert len(events) == cell.config["num_hidden_layers"] * steps  # prefill and each decode step
    kept = sum(int(np.sum(v["keep"])) for v in events)
    slots = sum(int(v["slots"]) for v in events)
    assert 0 < kept <= min(sum(int(v["routed"]) for v in events), slots)
    assert with_program["metrics"]["moe_dispatch_reader"]["value"] == pytest.approx(
        100.0 * kept / slots)


def test_decode_syncs_per_step_reads_the_program_batch_or_nothing():
    from portbench import harness

    mod = harness.metric_module("decode_syncs_per_step")
    assert mod.PROGRAM and mod.TAPS == [] and mod.RANGES == []
    row = lambda **kw: dict(ps._row(), **kw)  # noqa: E731
    p = ps.Program(by_name={"serve.readback": row(calls=13, syncs=13),
                            "serve.decode": row(calls=12, syncs=0)}, by_phase={}, idle_gaps=[])
    assert mod.read(harness.View({}, 0.0, [], 0.0, program=p)) == 1.0
    p.by_name["serve.decode"]["syncs"] = 26  # two waits in each decode step
    assert mod.read(harness.View({}, 0.0, [], 0.0, program=p)) == 3.0
    assert mod.read(harness.View({}, 0.0, [], 0.0)) is None  # no program batch
    assert mod.read(harness.View({}, 0.0, [], 0.0, program=ps.Program({}, {}, []))) is None

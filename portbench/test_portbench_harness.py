"""The benchmark's data and its plumbing: every cell of BENCHMARK.json finds
its files, the port's configs hold to the configuration files, every
per-layer metric has a reader whose wrapped attributes exist, the trace
reduction attributes device time to ranges, the host-clock metrics read the
batches served without the profiler, and the runner refuses a machine
without a card."""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench import _tiny as tiny, harness, tracing  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_finds_its_files_and_the_port_holds_to_them(name):
    cell = harness.load_cell(name, CHECKOUT)
    harness.port_config(cell.config)
    assert cell.limit["compare"] and min(cell.limit["compare"].values()) > 0
    assert cell.limit["served_tokens"] >= 256
    assert {m["name"] for m in cell.end_to_end} == {"tokens_per_s", "ttft_p95_ms",
                                                    "request_p95_ms", "setup_s"}
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        mod = harness.metric_module(m["name"])
        assert callable(mod.read)
        for target, _, _ in mod.RANGES:
            module, attr = target.rsplit(".", 1)
            assert callable(getattr(importlib.import_module(module), attr))


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_the_drawn_weights_have_the_ports_layout_at_full_size(name):
    """Every leaf the benchmark draws has the path, shape and dtype of the
    tree the port's ``init`` would build (shapes only: nothing is drawn)."""
    from repro_torch.configs import param_specs_struct

    from portbench import archs, weights

    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((CHECKOUT / conf["file"]).read_text())
    mine = {p: (spec[1], spec[2]) for p, spec in weights._leaves(archs.of(cfg).layout(cfg))}
    port = {p: (tuple(t.shape), t.dtype)
            for p, t in weights._leaves(param_specs_struct(harness.port_config(cfg)))}
    assert mine == port


def test_every_configuration_file_is_what_its_entry_says():
    for conf in BENCH["configs"]:
        data = json.loads((CHECKOUT / conf["file"]).read_text())
        assert data["name"] == conf["name"] and data["source"] == conf["source"]
        assert data["torch_dtype"] == "bfloat16"


class _Ev:
    """A profiler event as torch 2.11 gives it: no activity type."""

    def __init__(self, kind, name, start, dur, corr=0, link=0):
        self.dev = kind in ("kernel", "gpu_user_annotation")
        self.n, self.s, self.d, self.c, self.lk = name, start, dur, corr, link

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.dev else torch.autograd.DeviceType.CPU

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.lk


def test_the_reduction_attributes_kernels_to_the_range_that_launched_them():
    evs = [
        _Ev("user_annotation", "portbench/flash_fwd", 100, 50, corr=1),
        _Ev("cpu_op", "aten::mm", 160, 10, corr=2),
        _Ev("cuda_runtime", "cudaLaunchKernel", 120, 2, corr=900, link=1),  # ctypes launch
        _Ev("kernel", "flash_fwd_kernel", 200, 30, corr=900, link=1),
        _Ev("cuda_runtime", "cudaLaunchKernel", 162, 2, corr=901, link=2),
        _Ev("kernel", "gemm", 240, 20, corr=901, link=2),
        _Ev("kernel", "gemm", 250, 40, corr=902, link=2),  # overlaps; no runtime event
        _Ev("gpu_user_annotation", "portbench/flash_fwd", 200, 30, corr=1),
    ]
    t = tracing.reduce_events(evs, (100, 400))
    assert t.range_kernels == {"flash_fwd": 1} and t.range_calls == {"flash_fwd": 1}
    assert t.range_device_s["flash_fwd"] == pytest.approx(30e-9)
    assert t.busy_s == pytest.approx(80e-9)  # 200-230, 240-290
    assert t.window_s == pytest.approx(300e-9) and t.device_events == 3 and t.unlinked == 0
    assert t.device_ops[0] == ("gemm", pytest.approx(60e-9))
    assert t.idle_gaps[0] == ("python (no op)", pytest.approx(110e-9))  # 290-400


def _served(t_hand, prefill_s, decode_s, prompts=(100, 60), max_new=(5, 3)):
    import numpy as np

    from portbench import check, traffic

    b = traffic.Batch(0, [np.ones(n, np.int32) for n in prompts], list(max_new))
    first = t_hand + 0.01 + prefill_s
    return check.Served(b, [[1] * n for n in max_new], [], t_hand=t_hand,
                        prefill_start=t_hand + 0.01, first_token=first,
                        t_return=first + decode_s)


def _cfg():
    return json.loads((CHECKOUT / BENCH["configs"][0]["file"]).read_text())


def test_end_to_end_metrics_count_delivered_tokens_over_whole_batches():
    # two batches of 2 requests (5 and 3 new tokens, padded to 5): 16 tokens
    # delivered, not the 20 padded ones, over the 10-s window they span
    served = [_served(0.0, 1.0, 3.0), _served(5.0, 2.0, 2.99)]
    view = harness.View(_cfg(), 12.5, served, served[-1].t_return - served[0].t_hand)
    read = {m["name"]: harness.metric_module(m["name"]).read(view) for m in BENCH["end_to_end"]}
    assert read["tokens_per_s"] == pytest.approx(16 / 10.0)
    assert read["ttft_p95_ms"] == pytest.approx(2010.0)  # the 4 requests: 1010, 1010, 2010, 2010
    assert read["request_p95_ms"] == pytest.approx(5000.0)
    assert read["setup_s"] == 12.5


def test_the_95th_percentile_is_over_requests():
    values = list(range(1, 101))
    assert harness.p95(values) == pytest.approx(95.95)  # statistics.quantiles, exclusive
    assert harness.p95([3.0, 1.0, 2.0]) == 3.0  # under 20 samples: the largest


def test_host_clock_metrics_read_the_window_served_without_the_profiler():
    from portbench import yardstick
    from portbench.archs import qwen2

    cfg = _cfg()
    trace = tracing.Trace(window_s=9.0, busy_s=3.0, range_device_s={}, range_kernels={},
                          range_calls={}, device_ops=[], idle_gaps=[], unlinked=0,
                          device_events=10)
    # without the profiler each batch takes 4 s (1 s prefill, 3 s for 4 decode
    # steps); under it 9 s, which the host-clock metrics do not read
    window = [_served(0.0, 1.0, 2.99), _served(4.0, 1.0, 2.99)]
    view = harness.View(cfg, 1.0, window, 8.0, traced=[_served(8.0, 1.0, 7.99)], trace=trace)
    read = {m: harness.metric_module(m).read(view)
            for m in ("idle_share", "decode_step_ms", "prefill_ms_per_ktok", "mfu")}
    assert read["idle_share"] == pytest.approx(25.0)  # 3 s busy of a 4-s batch
    assert read["decode_step_ms"] == pytest.approx(2 * 2.99e3 / 8)  # 2 batches x 4 steps
    assert read["prefill_ms_per_ktok"] == pytest.approx(2e3 / 0.32)  # 2 x 160 real tokens
    flops = 2 * (qwen2.request_flops(cfg, 100, 5) + qwen2.request_flops(cfg, 60, 3))
    assert read["mfu"] == pytest.approx(100 * flops / 8.0 / yardstick.PEAK_BF16_FLOPS)


def test_device_metrics_read_the_traced_batches_and_their_ranges():
    trace = tracing.Trace(window_s=9.0, busy_s=3.0,
                          range_device_s={"moe": 0.5, "flash_fwd": 2e-3, "decode_attn": 1e-3},
                          range_kernels={"decode_step": 80}, range_calls={"decode_step": 4},
                          device_ops=[], idle_gaps=[], unlinked=0, device_events=10)
    notes = {"flash_fwd": [dict(b=1, sq=4, skv=4, h=2, kvh=1, d=8, causal=True, window=0,
                                q_offset=0, elem=2)],
             "decode_attn": [dict(b=2, h=4, kvh=2, d=16, elem=2,
                                  lengths=torch.tensor([5, 7], dtype=torch.int32))]}
    traced = [_served(0.0, 1.0, 2.99)]
    view = harness.View(_cfg(), 1.0, traced, 4.0, traced=traced, trace=trace, notes=notes)
    read = {m: harness.metric_module(m).read(view)
            for m in ("launches_per_decode_step", "moe_device_ms_per_ktok",
                      "flash_fwd_roofline", "decode_attn_roofline")}
    assert read["launches_per_decode_step"] == 20
    # 2 rows x (100 padded prompt positions + 4 decode steps) = 208 tokens
    assert read["moe_device_ms_per_ktok"] == pytest.approx(500.0 / 0.208)
    from portbench import yardstick

    flops, nbytes = yardstick.flash_cost(1, 4, 4, 2, 1, 8, causal=True)
    assert read["flash_fwd_roofline"] == pytest.approx(
        100 * yardstick.bound_s(nbytes, flops) / 2e-3)
    flops, nbytes = yardstick.decode_cost(2, 4, 2, 16, [5, 7])
    assert read["decode_attn_roofline"] == pytest.approx(
        100 * yardstick.bound_s(nbytes, flops) / 1e-3)
    # a trace with nothing in a range reads nothing, never 0
    empty = tracing.Trace(window_s=1.0, busy_s=0.0, range_device_s={}, range_kernels={},
                          range_calls={}, device_ops=[], idle_gaps=[], unlinked=0,
                          device_events=0)
    view = harness.View(_cfg(), 1.0, traced, 4.0, traced=traced, trace=empty)
    for m in ("launches_per_decode_step", "moe_device_ms_per_ktok", "flash_fwd_roofline",
              "decode_attn_roofline", "idle_share"):
        assert harness.metric_module(m).read(view) is None, m


def test_the_window_closes_at_the_first_batch_boundary_after_its_seconds(monkeypatch):
    """Every batch the window starts is served whole and counted; none starts
    once the window's seconds have passed."""
    import time

    seen = {}
    made = harness.View
    monkeypatch.setattr(harness, "View", lambda *a, **k: seen.setdefault("view", made(*a, **k)))
    res = tiny.run("qwen2-7b", seed=3, seconds=0.6)
    view = seen["view"]
    w0 = view.served[-1].t_return - view.window_s
    assert view.window_s >= 0.6 and res["attempted"] == 4 * len(view.served)
    assert all(s.t_hand - w0 < 0.6 for s in view.served)
    assert all(len(out) == n for s in view.served for out, n in zip(s.outs, s.batch.max_new))
    assert res["metrics"]["tokens_per_s"]["value"] == pytest.approx(
        sum(sum(s.batch.max_new) for s in view.served) / view.window_s)


def test_a_traced_run_notes_the_calls_of_the_traced_batches_alone(monkeypatch):
    """The ranges' notes (the shapes a roofline's bound is counted from) and
    the trace's calls cover the same batches: the window served first is in
    neither."""
    import time

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    seen = {}
    made = harness.View
    monkeypatch.setattr(harness, "View", lambda *a, **k: seen.setdefault("view", made(*a, **k)))
    c = tiny.cell("qwen2-moe-a2.7b", trace_batches=2)
    c.per_layer = [m for m in BENCH["per_layer"]
                   if "workloads" not in m or "qwen2-moe-a2.7b.rag" in m["workloads"]]
    res = harness.run(c, 7, 0.0, True, t_start=time.perf_counter(), device="cpu",
                      port_cfg=tiny.port_cfg("qwen2-moe-a2.7b"), log=lambda msg: None)
    view = seen["view"]
    assert res["correct"] and len(view.served) == 1 and len(view.traced) == 2
    assert view.notes and {k: len(v) for k, v in view.notes.items()} == {
        k: view.trace.range_calls[k] for k in view.notes}
    assert res["metrics"]["decode_step_ms"]["value"] > 0
    assert set(res["device"]) >= {"busy_s", "window_s"} and "breakdown" in res


def test_a_range_is_opened_once_when_entered_again_inside_itself():
    import types

    mod = types.ModuleType("portbench_nested_calls")
    exec("def inner(x):\n    return x + 1\n\ndef outer(x):\n    return inner(x) * 2\n",
         mod.__dict__)
    sys.modules[mod.__name__] = mod
    ranges = tracing.Ranges()
    try:
        ranges.wrap(f"{mod.__name__}.outer", "both", lambda x: ("outer", x))
        ranges.wrap(f"{mod.__name__}.inner", "both", lambda x: ("inner", x))
        with pytest.raises(ValueError):
            ranges.wrap(f"{mod.__name__}.inner", "both")
        assert mod.outer(3) == 8 and mod.inner(5) == 6
    finally:
        ranges.remove()
        del sys.modules[mod.__name__]
    assert ranges.notes["both"] == [("outer", 3), ("inner", 5)]
    assert mod.outer.__name__ == "outer" and mod.inner.__name__ == "inner"


def test_the_runner_refuses_a_machine_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "3",
           "--seconds", "1", "--trace", "0"]
    res = subprocess.run(cmd, cwd=CHECKOUT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""
    # a directory that holds only BENCHMARK.json and the benchmark's files
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "BENCHMARK.json").write_text(json.dumps(BENCH))
    subprocess.run(["cp", "-r", str(CHECKOUT / "portbench"), str(bare / "portbench")],
                   check=True)
    res = subprocess.run(cmd, cwd=bare, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""

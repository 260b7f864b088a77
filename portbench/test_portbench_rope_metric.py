"""``rope_device_ms_per_ktok``: its range wraps an attribute the port has, and
it reads the range's device time over the traced batches' tokens, or nothing
where the trace holds none."""
import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

from portbench import check, harness, tracing, traffic  # noqa: E402

NAME = "rope_device_ms_per_ktok"


def _trace(range_device_s):
    return tracing.Trace(window_s=9.0, busy_s=3.0, range_device_s=range_device_s,
                         range_kernels={}, range_calls={}, device_ops=[], idle_gaps=[],
                         unlinked=0, device_events=10)


def _served(prompts, max_new):
    b = traffic.Batch(0, [np.ones(n, np.int32) for n in prompts], list(max_new))
    return check.Served(b, [[1] * n for n in max_new], [], t_hand=0.0, prefill_start=0.01,
                        first_token=1.0, t_return=3.0)


def test_the_range_wraps_the_ports_positional_step():
    mod = harness.metric_module(NAME)
    (target, name, note), = mod.RANGES
    module, attr = target.rsplit(".", 1)
    assert callable(getattr(importlib.import_module(module), attr))
    assert name == "rope" and note is None


def test_it_reads_the_ranges_device_time_over_the_traced_tokens():
    mod = harness.metric_module(NAME)
    # two batches: 2 rows x (100 padded prompt positions + 4 decode steps), and
    # 3 rows x (40 + 1): 208 + 123 = 331 tokens
    traced = [_served((100, 60), (5, 3)), _served((40, 40, 7), (2, 2, 1))]
    view = harness.View({}, 1.0, traced, 4.0, traced=traced,
                        trace=_trace({"rope": 0.25, "moe": 9.0}))
    assert mod.read(view) == pytest.approx(250.0 / 0.331)
    # nothing in the range, or no traced batch, reads nothing, never 0
    assert mod.read(harness.View({}, 1.0, traced, 4.0, traced=traced,
                                 trace=_trace({"moe": 9.0}))) is None
    assert mod.read(harness.View({}, 1.0, [], 4.0, traced=[], trace=_trace({"rope": 0.25}))) \
        is None

"""Device time of the rotary position embedding a thousand tokens: the device
time of every kernel launched inside the range around
``repro_torch.models.attention._apply_positional`` (RoPE of a layer's q and
k, at prefill and at each decode step), in the traced batches, over the
tokens the model processed there (each batch's padded prompts, and one a row
at each decode step, as ``moe_device_ms_per_ktok`` counts them). Moves
``ttft_p95_ms``."""

RANGES = [("repro_torch.models.attention._apply_positional", "rope", None)]


def read(view):
    tokens = sum(len(s.outs) * (s.batch.padded_len + s.batch.steps - 1) for s in view.traced)
    device_s = view.trace.range_device_s.get("rope", 0.0)
    if not tokens or device_s <= 0:
        return None
    return device_s * 1e3 / (tokens / 1e3)

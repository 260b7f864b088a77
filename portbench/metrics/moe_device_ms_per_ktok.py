"""Device time of the expert layer a thousand tokens: the device time of
every kernel launched inside the range around ``repro_torch.models.moe``'s
entry as ``models/transformer.py`` calls it (``moe_apply_ep``, and
``moe_apply`` beside it; the range is not opened again inside itself), in
the traced batches, over the tokens the model processed there (each batch's
padded prompts, and one a row at each decode step). Moves
``tokens_per_s``."""

RANGES = [("repro_torch.models.moe.moe_apply_ep", "moe", None),
          ("repro_torch.models.moe.moe_apply", "moe", None)]


def read(view):
    tokens = sum(len(s.outs) * (s.batch.padded_len + s.batch.steps - 1) for s in view.traced)
    device_s = view.trace.range_device_s.get("moe", 0.0)
    if not tokens or device_s <= 0:
        return None
    return device_s * 1e3 / (tokens / 1e3)

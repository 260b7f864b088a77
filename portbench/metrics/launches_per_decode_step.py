"""Device operations a decode step launches: every kernel, copy and set the
host launched inside the range around ``repro_torch.launch.serve
.decode_step`` (the step function ``generate`` calls), over the range's
calls, in the traced batches. A count that repeats exactly. Moves
``tokens_per_s``."""

RANGES = [("repro_torch.launch.serve.decode_step", "decode_step", None)]


def read(view):
    calls = view.trace.range_calls.get("decode_step", 0)
    launched = view.trace.range_kernels.get("decode_step", 0)
    if not calls or not launched:
        return None
    return launched / calls

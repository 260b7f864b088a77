"""The CUDA runtime's waits for the card a decode step: the calls of
``tracing.SYNCS`` that the host made inside the program's ``serve.decode``
and ``serve.readback`` spans, over the ``serve.readback`` calls (one a
generated token), in the program batch (a batch served under the profiler
with the program's spans recorded). A count that repeats exactly. A decode
step captured in a CUDA graph needs 0. Moves ``tokens_per_s``."""

RANGES = []
PROGRAM = True  # read the program's own spans
TAPS = []


def read(view):
    p = view.program
    if p is None:
        return None
    readback = p.row("serve.readback")
    if not readback["calls"]:
        return None
    return (readback["syncs"] + p.row("serve.decode")["syncs"]) / readback["calls"]

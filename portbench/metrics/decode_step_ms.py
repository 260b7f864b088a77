"""Decode time a step, over the whole window: from each batch's first token
(its prefill finished) until ``generate`` returned, summed, over the decode
steps the window's batches ran (a batch runs its longest ``max_new`` less
one). A mean of the window, not a median. Read from the window, served
without the profiler. Moves ``tokens_per_s``."""

RANGES = []


def read(view):
    steps = sum(s.batch.steps - 1 for s in view.served)
    if not steps:
        return None
    return sum(s.t_return - s.first_token for s in view.served) * 1e3 / steps

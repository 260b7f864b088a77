"""The card's idle share, in %: 1 less the device's busy seconds a batch
(the union of the intervals in which a kernel, copy or set ran, from the
profiler's trace of the traced batches) over the host's seconds a batch in
the window, served without the profiler. Every batch of a cell holds the
same sizes, so both count the same device work; the profiler's host cost a
launch stretches the traced batches, not the device's work. Moves
``tokens_per_s``."""

RANGES = []


def read(view):
    t = view.trace
    if t.device_events == 0 or not view.traced or not view.served or view.window_s <= 0:
        return None
    busy_a_batch = t.busy_s / len(view.traced)
    return 100.0 * (1.0 - busy_a_batch / (view.window_s / len(view.served)))

"""Generated tokens delivered in the window over the window's seconds, by
the host clock: each request counts the tokens it was served (its own
``max_new``), not the batch's padded ``b x max(max_new)``. The window holds
whole batches, from the first handed to ``generate`` until the last one
returned. End to end."""

RANGES = []


def read(view):
    if view.window_s <= 0:
        return None
    return sum(len(out) for s in view.served for out in s.outs) / view.window_s

"""The 95th percentile, over the window's requests, of the time from the
harness handing the request's batch to ``generate`` until ``generate``
returned the request's tokens (host clock): the task's completion time,
which the scheduler's SLA prices. End to end."""
from portbench import harness

RANGES = []


def read(view):
    times = [(s.t_return - s.t_hand) * 1e3 for s in view.served for _ in s.outs]
    return harness.p95(times) if times else None

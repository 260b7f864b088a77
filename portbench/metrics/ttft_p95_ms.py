"""The 95th percentile, over the window's requests, of the time from the
harness handing the request's batch to ``generate`` until the prefill that
produces its first token has finished on the card: the host clock read
after a synchronize at the harness's wrapper of ``serve.prefill_step``, so
that the card's queue counts. End to end."""
from portbench import harness

RANGES = []


def read(view):
    times = [(s.first_token - s.t_hand) * 1e3 for s in view.served for _ in s.outs]
    return harness.p95(times) if times else None

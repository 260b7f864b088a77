"""Prefill time a thousand real prompt tokens: the harness's host-clock span
of each ``serve.prefill_step`` call of the window (entered with the card's
queue empty, ended after a synchronize), summed, over the window's prompt
tokens without their padding. Read from the window, served without the
profiler. Moves ``ttft_p95_ms``."""

RANGES = []


def read(view):
    tokens = sum(len(p) for s in view.served for p in s.batch.prompts)
    if not tokens:
        return None
    return sum(s.first_token - s.prefill_start for s in view.served) * 1e3 / (tokens / 1e3)

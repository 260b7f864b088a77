"""The whole step's share of the card's peak, in %: the model FLOPs of the
window's requests over their own lengths (the configuration's architecture
module's ``request_flops``; ``archs/qwen2.py``'s: 2 a non-embedding
parameter a position through attention, MLP or the routed top-k and shared
experts, attention over each position's own prefix, the head for each
served token; padding and capacity slots not counted) over the window's
seconds by the host clock, as a share of 989 TFLOP/s (bf16 dense, H100 SXM
at 700 W). Read from the window, served without the profiler. Moves
``tokens_per_s``."""
from portbench import archs, yardstick

RANGES = []


def read(view):
    if view.window_s <= 0:
        return None
    request_flops = archs.of(view.cfg).request_flops
    flops = sum(request_flops(view.cfg, len(p), n)
                for s in view.served for p, n in zip(s.batch.prompts, s.batch.max_new))
    return 100.0 * flops / view.window_s / yardstick.PEAK_BF16_FLOPS

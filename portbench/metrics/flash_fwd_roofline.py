"""The prefill attention's share of its roofline, in %: the least time the
card could take for the calls (``yardstick.flash_cost``: two products over
the kept causal pairs, q k^T at q's width and p v at v's; q, k, v read and
the output written once; at 989 TFLOP/s bf16 or 3.35 TB/s) over the device
time of every kernel launched inside the range around
``repro_torch.kernels.ops.attention`` (the flash kernel of
``csrc/flash_attention.cu`` today), in the traced batches. Moves
``tokens_per_s``."""
from portbench import yardstick


def _shapes(q, k, v, *, causal=True, window=0, q_offset=0, **kwargs):
    return dict(b=q.shape[0], sq=q.shape[1], skv=k.shape[1], h=q.shape[2], kvh=k.shape[2],
                d=q.shape[3], dv=v.shape[3], causal=causal, window=window, q_offset=q_offset,
                elem=q.element_size())


RANGES = [("repro_torch.kernels.ops.attention", "flash_fwd", _shapes)]


def read(view):
    device_s = view.trace.range_device_s.get("flash_fwd", 0.0)
    calls = view.notes.get("flash_fwd", [])
    if device_s <= 0 or not calls:
        return None
    bound = 0.0
    for c in calls:
        flops, nbytes = yardstick.flash_cost(**c)
        bound += yardstick.bound_s(nbytes, flops)
    return 100.0 * bound / device_s

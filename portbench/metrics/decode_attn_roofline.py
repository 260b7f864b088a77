"""The decode attention's share of its roofline, in %: the least time the
card could take for the calls (``yardstick.decode_cost``: the keys and
values below each sequence's length read once, the query read and the
output written once, at 3.35 TB/s or 989 TFLOP/s) over the device time of
every kernel launched inside the range around ``repro_torch.kernels.ops
.decode_attention`` (``csrc/decode_attention.cu``'s split and combine
kernels today), in the traced batches. The lengths are read after the
batches. Moves ``tokens_per_s``."""
from portbench import yardstick


def _shapes(q, k_cache, v_cache, lengths, **kwargs):
    return dict(b=q.shape[0], h=q.shape[1], kvh=k_cache.shape[2], d=q.shape[2],
                elem=q.element_size(), lengths=lengths)


RANGES = [("repro_torch.kernels.ops.decode_attention", "decode_attn", _shapes)]


def read(view):
    device_s = view.trace.range_device_s.get("decode_attn", 0.0)
    calls = view.notes.get("decode_attn", [])
    if device_s <= 0 or not calls:
        return None
    bound = 0.0
    for c in calls:
        flops, nbytes = yardstick.decode_cost(c["b"], c["h"], c["kvh"], c["d"],
                                              c["lengths"].tolist(), c["elem"])
        bound += yardstick.bound_s(nbytes, flops)
    return 100.0 * bound / device_s

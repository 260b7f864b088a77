"""The benchmark's frozen arithmetic: the H100's peaks and the attention
kernels' operations and bytes. The model FLOPs of served tokens depend on
the block's equations and are each architecture module's
(``archs/<arch>.py`` ``request_flops``).

Copied from the port's ``launch/roofline.py`` (``Chip``'s H100 peaks) and
``chip_smoke.py`` (``bound``, ``attn_pairs``, the kernels' bytes), so that
a later change to the port cannot move the yardstick. It counts the work the inputs need: the kept
(query, key) pairs, each input byte read once and each output byte written
once, a decode row's keys only up to its length. Everything here reads
shapes and the configuration file's numbers, never the port.
"""
from __future__ import annotations

from typing import Optional, Sequence

# NVIDIA H100 SXM 80GB HBM3 at its 700 W power limit, NVIDIA's data sheet:
# dense bf16 without sparsity, and HBM3
PEAK_BF16_FLOPS = 989e12  # FLOP/s
PEAK_BYTES_PER_S = 3.35e12  # B/s


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: its bytes at HBM speed or its
    operations at the bf16 peak, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def attn_pairs(sq: int, skv: int, causal: bool, window: int, q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps, in closed form: query ``i`` sits at
    position ``q_offset + i`` and keeps the keys in ``[lo, hi]``."""
    if not causal and window <= 0:
        return sq * skv
    total = 0
    for i in range(sq) if window > 0 else ():
        qp = q_offset + i
        hi = min(skv - 1, qp) if causal else skv - 1
        lo = max(0, qp - window + 1)
        total += max(0, hi - lo + 1)
    if window > 0:
        return total
    # causal, no window: query i keeps min(skv, q_offset + i + 1) keys
    cut_rows = max(0, min(sq, skv - q_offset))  # queries whose row the diagonal cuts
    return sum_range(q_offset + 1, q_offset + cut_rows) + (sq - cut_rows) * skv


def sum_range(lo: int, hi: int) -> int:
    """lo + (lo + 1) + ... + hi (0 when hi < lo)."""
    return (lo + hi) * (hi - lo + 1) // 2 if hi >= lo else 0


def flash_cost(b: int, sq: int, skv: int, h: int, kvh: int, d: int, *, causal: bool,
               window: int = 0, q_offset: int = 0, elem: int = 2, dv: Optional[int] = None):
    """(FLOPs, bytes) of one forward attention call: two products over the
    kept pairs, q k^T at q and k's width ``d`` and p v at v's width ``dv``
    (``d`` where not given); q, k, v read once and the output (at ``dv``)
    written once."""
    dv = d if dv is None else dv
    flops = 2 * b * h * (d + dv) * attn_pairs(sq, skv, causal, window, q_offset)
    nbytes = elem * (b * sq * h * (d + dv) + b * skv * kvh * (d + dv))
    return flops, nbytes


def decode_cost(b: int, h: int, kvh: int, d: int, lengths: Sequence[int], elem: int = 2):
    """(FLOPs, bytes) of one decode attention call: the keys and values below
    each sequence's length read once, the query read and the output written
    once, the lengths read."""
    valid = int(sum(lengths))
    flops = 4 * h * d * valid
    nbytes = elem * (2 * b * h * d + 2 * valid * kvh * d) + 4 * b
    return flops, nbytes

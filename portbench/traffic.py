"""The one traffic generator: reads a mix file (``traffic/<mix>.json``) and
yields batches of requests drawn from ``--seed``.

A mix file gives the batch size, the cache length, and the prompt and
output (``max_new``) length distributions as ``{"dist": "lognormal",
"median", "sigma", "min", "max"}``. A batch's ``b`` prompt lengths are the
distribution's quantiles at ``(i + 0.5) / b``, clipped, and so are its
output lengths: every batch of every seed holds the same set of sizes, so
every run does the same work. The seed draws which request gets which
prompt and output length (in another order in every batch) and every token
id.

Token ids are uniform over ``[1, vocab)``: 0 is the serving engine's pad.
The same seed gives the same batches, one after another.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, Iterator, List

import numpy as np

# the streams one seed feeds: the served batches, and the warm-up batch
STREAM_SERVE, STREAM_WARMUP = 0, 1


@dataclasses.dataclass
class Batch:
    index: int
    prompts: List[np.ndarray]  # int32 token ids, one array per request
    max_new: List[int]

    @property
    def padded_len(self) -> int:
        return max(len(p) for p in self.prompts)

    @property
    def steps(self) -> int:
        """Decode positions the static batch runs: its longest ``max_new``."""
        return max(self.max_new)

    @property
    def useful_tokens(self) -> int:
        return sum(len(p) + n for p, n in zip(self.prompts, self.max_new))


def quantile(dist: Dict, q: float) -> int:
    """``dist``'s ``q`` quantile, rounded and clipped to ``[min, max]``."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"length distribution {dist['dist']!r} is not 'lognormal'")
    x = dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(q))
    return int(min(max(round(x), dist["min"]), dist["max"]))


def _lengths(dist: Dict, b: int, rng: np.random.Generator) -> List[int]:
    return [quantile(dist, (i + 0.5) / b) for i in rng.permutation(b)]


def batches(mix: Dict, vocab: int, seed: int, stream: int = STREAM_SERVE) -> Iterator[Batch]:
    """The seed's batches of ``mix``, without end."""
    rng = np.random.default_rng([seed, stream])
    b = mix["batch"]
    index = 0
    while True:
        plens = _lengths(mix["prompt"], b, rng)
        outs = _lengths(mix["output"], b, rng)
        prompts = [rng.integers(1, vocab, size=n, dtype=np.int32) for n in plens]
        yield Batch(index, prompts, outs)
        index += 1


def check_fits(mix: Dict) -> None:
    """Raise where a batch could outgrow the cache: the decode would then
    overwrite its last slot, which no served model does."""
    need = mix["prompt"]["max"] + mix["output"]["max"]
    if need > mix["cache_len"]:
        raise ValueError(f"a prompt of {mix['prompt']['max']} and {mix['output']['max']} new "
                         f"tokens outgrow the cache of {mix['cache_len']}")

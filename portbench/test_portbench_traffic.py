"""The traffic generator: the same batches for a seed, other token ids and
another order for another seed, and every batch of the same sizes."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

# the mixes of the benchmark, and one whose lengths spread, as a later mix's may
SPREAD = {"batch": 16, "cache_len": 6200,
          "prompt": {"dist": "lognormal", "median": 1500, "sigma": 0.8, "min": 128, "max": 6144},
          "output": {"dist": "lognormal", "median": 13, "sigma": 1.0, "min": 1, "max": 56}}
MIXES = [(p.stem, json.loads(p.read_text()))
         for p in sorted((Path(__file__).resolve().parent / "traffic").glob("*.json"))]
MIXES.append(("spread", SPREAD))


def _take(mix, seed, n=3, vocab=1000):
    gen = traffic.batches(mix, vocab, seed)
    return [next(gen) for _ in range(n)]


@pytest.mark.parametrize("name,mix", MIXES, ids=[m[0] for m in MIXES])
def test_a_seed_gives_the_same_batches(name, mix):
    a, b = _take(mix, 2 ** 31 + 17), _take(mix, 2 ** 31 + 17)
    for x, y in zip(a, b):
        assert x.max_new == y.max_new
        assert all(np.array_equal(p, q) for p, q in zip(x.prompts, y.prompts))


@pytest.mark.parametrize("name,mix", MIXES, ids=[m[0] for m in MIXES])
def test_seeds_differ_in_ids_and_order_not_in_sizes(name, mix):
    a, b = _take(mix, 11), _take(mix, 12)
    assert any(not np.array_equal(p[:8], q[:8]) for p, q in zip(a[0].prompts, b[0].prompts))
    if len({len(p) for p in a[0].prompts}) > 1:  # a mix with one size has no order
        assert [len(p) for p in a[0].prompts] != [len(p) for p in b[0].prompts]
    sizes = {(tuple(sorted(len(p) for p in x.prompts)), tuple(sorted(x.max_new)))
             for x in a + b}
    assert len(sizes) == 1  # every batch of every seed has the same sizes
    x = a[0]
    assert x.padded_len <= mix["prompt"]["max"] and x.steps <= mix["output"]["max"]
    assert all(1 <= int(p.min()) and int(p.max()) < 1000 for p in x.prompts)
    traffic.check_fits(mix)


def test_quantiles_follow_the_distribution_and_its_clip():
    dist = {"dist": "lognormal", "median": 1500, "sigma": 0.8, "min": 128, "max": 6144}
    assert traffic.quantile(dist, 0.5) == 1500
    assert traffic.quantile(dist, 0.999) == 6144
    assert traffic.quantile(dist, 1e-6) == 128
    assert traffic.quantile(dist, 0.75) == round(1500 * np.exp(0.8 * 0.6744897501960817))


def test_a_mix_that_outgrows_its_cache_is_refused():
    mix = {"batch": 8, "cache_len": 64,
           "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.5, "min": 4, "max": 48},
           "output": {"dist": "lognormal", "median": 4, "sigma": 0.5, "min": 1, "max": 16}}
    traffic.check_fits(mix)
    with pytest.raises(ValueError):
        traffic.check_fits(dict(mix, cache_len=63))

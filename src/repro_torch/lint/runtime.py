"""Runtime dispatch-count sanitizer, riding ``obs.cache_stats()``.

The port of ``repro.lint.runtime``. The static checkers prove the engine
key is complete; this module proves the *accounting behaves*: a block of
work dispatches under exactly the keys it should, and re-running it meets
only keys already seen.

- :func:`expect_compiles` watches the port's own accounting (``misses`` in
  ``obs.cache_stats()``, a key's first dispatch) — a miss delta above the
  expectation means a key started forking (e.g. an unhashed config leaked
  into the tuple), below means two programs share a key. The name is the
  reference's: a miss there is a compile, here it is the first dispatch a
  cache of captured hours would build for.
- :func:`trace_count` is the reference's probe of jit's own cache. The
  port has no such cache, so it answers ``None``.

Everything imports lazily so ``repro_torch.lint``'s static side stays
importable without torch.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional


@contextmanager
def expect_compiles(n: int) -> Iterator[dict]:
    """Assert the block dispatches under exactly ``n`` engine keys not seen
    before (``obs.cache_stats()``'s misses).

    Yields a dict filled on exit with ``before``/``after`` stats and the
    ``misses``/``hits`` deltas. Raises ``AssertionError`` on mismatch,
    naming every engine key that missed inside the block so the forking
    field is readable straight off the diff::

        with lint.expect_compiles(1):
            run(spec, env)       # first dispatch of the key: one miss
        with lint.expect_compiles(0):
            run(spec, env)       # identical spec: hits only
    """
    from .. import obs
    before = obs.cache_stats()
    info: dict = {"before": before}
    yield info
    after = obs.cache_stats()
    info["after"] = after
    info["misses"] = after["misses"] - before["misses"]
    info["hits"] = after["hits"] - before["hits"]
    if info["misses"] != n:
        prev = {k: s["misses"] for k, s in before["engines"].items()}
        fresh = [k for k, s in after["engines"].items()
                 if s["misses"] > prev.get(k, 0)]
        raise AssertionError(
            f"expected exactly {n} engine compile(s), saw {info['misses']} "
            f"(hits {info['hits']}); keys that missed: {fresh or 'none'}")


def trace_count(spec) -> Optional[int]:
    """How many programs have been built for this spec's engine key.

    The reference reads the size of ``jax.jit``'s cache for the spec's
    artifact, which sees a retrace *inside* one key that the key
    accounting cannot. The port builds no program: every hour runs eagerly,
    so there is no cache to read, and this returns ``None``, the
    reference's answer when it has no probe (the caller should skip, not
    fail: absence of the probe is not absence of the bug). A cache of
    captured CUDA graphs of the hour, keyed by ``_engine_key``, would give
    it one.
    """
    del spec
    return None

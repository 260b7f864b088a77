"""The port's mixture of experts (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

Parameters are drawn by the JAX package and carried over as numpy arrays;
inputs are drawn with numpy. Configurations are qwen2-moe-a2.7b's smoke
(8 experts, top 2, 2 shared experts) in fp32, held at 1e-5: the two packages
take the same routing, slots and drops, and differ only in the order of the
products' sums. Routing is held exactly (the selected experts, and which
(token, choice) pairs are kept).
"""
# ruff: noqa: E402
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe
from repro_torch.tree import tree_map

ARCH = "qwen2-moe-a2.7b"
TOL = 1e-5


def _cfgs(**kw):
    return (dataclasses.replace(jax_get_config(ARCH).smoke(), **kw),
            dataclasses.replace(get_config(ARCH).smoke(), **kw))


def _params(jcfg, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree_util.tree_map(
        np.asarray, jp))


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _dropped(tp, tcfg, x, cf):
    """How many (token, choice) pairs the capacity drops."""
    t = x.shape[0] * x.shape[1]
    cap = max(math.ceil(t * tcfg.num_experts_per_tok * cf / tcfg.num_experts), 1)
    _, sel, _ = tmoe._route(tp, tcfg, torch.from_numpy(x).reshape(t, -1))
    _, _, keep = tmoe._slots(sel, tcfg.num_experts, cap)
    return int((~keep).sum())


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shared", [2, 0], ids=["shared", "no_shared"])
@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("cf", [1.25, 2.0, 0.5], ids=["cf1.25", "cf2", "cf0.5_drops"])
def test_moe_apply_matches_jax(cf, impl, shared):
    jcfg, tcfg = _cfgs(num_shared_experts=shared)
    jp, tp = _params(jcfg)
    x = _x(2, 12, jcfg.d_model)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x), capacity_factor=cf, impl=impl)
    ty, taux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x), capacity_factor=cf, impl=impl)
    _close(ty, jy)
    _close(taux, jaux)
    assert ("shared" in tp) == bool(shared)
    if cf < 1:
        assert _dropped(tp, tcfg, x, cf) > 0  # the case holds the drops


def test_routing_and_slots_match_jax():
    """Top-k experts in descending order, and the exclusive count that decides
    each pair's slot, equal the reference's exactly."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    x = _x(3, 16, jcfg.d_model, seed=5).reshape(48, -1)
    jw, jsel, jprobs = jmoe._route(jp, jcfg, jnp.asarray(x))
    tw, tsel, tprobs = tmoe._route(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    _close(tw, jw)
    _close(tprobs, jprobs)
    cap = 7  # below the mean load 48 * 2 / 8 = 12: some pairs drop
    flat, pos, keep = tmoe._slots(tsel, tcfg.num_experts, cap)
    jflat = np.asarray(jsel).reshape(-1)
    onehot = np.eye(tcfg.num_experts, dtype=np.int64)[jflat]
    jpos = (np.cumsum(onehot, 0) - onehot)[np.arange(jflat.size), jflat]
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(keep.numpy(), jpos < cap)
    assert not keep.all()


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_moe_apply_ep_is_the_unmeshed_fallback(cf):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=2)
    x = _x(2, 8, jcfg.d_model, seed=3)
    jy, jaux = jmoe.moe_apply_ep(jp, jcfg, jnp.asarray(x), capacity_factor=cf)
    ty, taux = tmoe.moe_apply_ep(tp, tcfg, torch.from_numpy(x), capacity_factor=cf)
    _close(ty, jy)
    _close(taux, jaux)


def test_decode_capacity_drops_at_serving_batch():
    """At decode (capacity factor 2.0) a batch of 8 tokens gives each expert
    ceil(8 * 2 * 2 / 8) = 4 slots; a skewed router sends more pairs than that
    to one expert, and both packages drop the same ones."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=6)
    bias = np.zeros((jcfg.d_model, jcfg.num_experts), np.float32)
    bias[:, 3] = 0.5  # expert 3 favoured by every token
    jp["router"]["w"] = jp["router"]["w"] + bias
    tp["router"]["w"] = tp["router"]["w"] + torch.from_numpy(bias)
    x = np.abs(_x(8, 1, jcfg.d_model, seed=7))
    assert _dropped(tp, tcfg, x, 2.0) > 0
    jy, _ = jmoe.moe_apply(jp, jcfg, jnp.asarray(x), capacity_factor=2.0)
    ty, _ = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x), capacity_factor=2.0)
    _close(ty, jy)


def test_aux_load_balance_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    sel = np.argsort(-probs, axis=-1)[:, :2].astype(np.int32)
    want = jmoe.aux_load_balance(jnp.asarray(probs), jnp.asarray(sel), 8)
    got = tmoe.aux_load_balance(torch.from_numpy(probs), torch.from_numpy(sel).long(), 8)
    _close(got, want)

"""The port's mLSTM and sLSTM against the JAX package's, on the CPU.

Mirrors ``tests/test_mlstm_rglru.py``'s mLSTM cases: the chunkwise form
against the parallel form over several chunk sizes (with padding when the
chunk does not divide the sequence), the hand-off of its final state to
``mlstm_step``, property cases of ``mlstm_sequence``; and holds each piece
against the reference: the mLSTM block's prefill state and decode steps,
``slstm_cell``, ``slstm_apply``, ``slstm_decode`` and the sLSTM block's
prefill (the reference's ``_slstm_prefill``). Inputs are drawn with numpy,
parameters by the JAX package and carried over as numpy arrays. Tolerance:
1e-5 (relative and absolute) in fp32, where the two packages differ by
summation order alone.
"""
# ruff: noqa: E402
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _hyp_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtr
from repro.models import xlstm as jxl
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttr
from repro_torch.models import xlstm as txl
from repro_torch.tree import tree_map

ARCH = "xlstm-125m"
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _close_tree(t, j):
    assert set(t) == set(j)
    for k in t:
        _close(t[k], j[k])


def _mlstm_inputs(b, s, h, dh, seed=0):
    """q, k, v (B, S, H, dh), log_i and log_f (B, S, H), as the reference's tests draw them."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(3))
    log_i = (rng.standard_normal((b, s, h)) * 2).astype(np.float32)
    log_f = np.asarray(jax.nn.log_sigmoid(rng.standard_normal((b, s, h)).astype(np.float32)
                                          + 2))
    return q, k, v, log_i, log_f


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [_t(a) for a in arrays]


@pytest.mark.parametrize("chunk", [8, 24, 64])
@pytest.mark.parametrize("s", [64, 96])
def test_mlstm_chunkwise_equals_parallel(chunk, s):
    """chunk 24 and (at s = 96) 64 leave a partial last chunk: the pad."""
    jin, tin = _both(_mlstm_inputs(2, s, 4, 16))
    want_par = jxl.mlstm_parallel(*jin)
    want, want_state = jxl.mlstm_sequence(*jin, chunk=chunk)
    par = txl.mlstm_parallel(*tin)
    out, state = txl.mlstm_sequence(*tin, chunk=chunk)
    _close(par, want_par)
    _close(out, want)
    _close_tree(state, want_state)
    # the reference test's own bound between its two forms
    tol = 2e-4 * max(1.0, float(par.abs().max()))
    assert float((out - par).abs().max()) < tol


def test_mlstm_state_handoff_to_decode():
    """Chunkwise prefill state + one recurrent step == the parallel form on s + 1."""
    b, s, h, dh = 2, 48, 4, 16
    jin, tin = _both(_mlstm_inputs(b, s, h, dh))
    _, jstate = jxl.mlstm_sequence(*jin, chunk=16)
    _, tstate = txl.mlstm_sequence(*tin, chunk=16)
    rng = np.random.default_rng(7)
    one = [rng.standard_normal((b, h, dh)).astype(np.float32) for _ in range(3)]
    one += [rng.standard_normal((b, h)).astype(np.float32),
            np.asarray(jax.nn.log_sigmoid(rng.standard_normal((b, h)).astype(np.float32) + 2))]
    jone, tone = _both(one)
    jnew, jh = jxl.mlstm_step(jstate, *jone)
    tnew, th = txl.mlstm_step(tstate, *tone)
    _close(th, jh)
    _close_tree(tnew, jnew)
    full = txl.mlstm_parallel(*(torch.cat([a, o[:, None]], 1) for a, o in zip(tin, tone)))
    assert float((th - full[:, -1]).abs().max()) < 2e-4


@given(st.integers(1, 4), st.integers(2, 30))
@settings(max_examples=10, deadline=None)
def test_mlstm_sequence_property(b, s):
    jin, tin = _both(_mlstm_inputs(b, s, 2, 8, seed=s))
    out, state = txl.mlstm_sequence(*tin, chunk=8)
    assert out.shape == (b, s, 2, 8)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(state["C"]).all())
    want, want_state = jxl.mlstm_sequence(*jin, chunk=8)
    _close(out, want)
    _close_tree(state, want_state)


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config(ARCH).smoke(), get_config(ARCH).smoke()


def _carry(jp):
    return tree_map(_t, jax.tree_util.tree_map(np.asarray, jp))


def _x(b, s, d, seed):
    return (np.random.default_rng(seed).standard_normal((b, s, d)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("s", [2, 5, 40, 300],
                         ids=["shorter_than_conv", "one_chunk", "one_chunk_40", "two_chunks"])
def test_mlstm_block_prefill_then_decode_matches_jax(cfgs, s):
    """The block's output and decode state (the memory and the conv's tail),
    then four decode steps: from a prompt shorter than the conv's width, from
    one chunk, and from two (300 rows cross the 256-row chunk, so the memory is
    handed from chunk to chunk inside the block's prefill)."""
    jcfg, tcfg = cfgs
    jp = jxl.mlstm_init(jax.random.PRNGKey(0), jcfg)
    tp = _carry(jp)
    x = _x(2, s + 4, jcfg.d_model, seed=s)
    jy, jstate = jxl.mlstm_apply(jp, jcfg, jnp.asarray(x[:, :s]), return_state=True)
    ty, tstate = txl.mlstm_apply(tp, tcfg, _t(x[:, :s]), return_state=True)
    _close(ty, jy)
    _close_tree(tstate, jstate)
    for t in range(s, s + 4):
        jy, jstate = jxl.mlstm_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jstate)
        ty, tstate = txl.mlstm_decode(tp, tcfg, _t(x[:, t:t + 1]), tstate)
        _close(ty, jy)
        _close_tree(tstate, jstate)
    init = txl.mlstm_state_init(tcfg, 2, device="cpu")
    _close_tree(init, jxl.mlstm_state_init(jcfg, 2))


def _slstm_params(jcfg, seed=0):
    jp = jxl.slstm_init(jax.random.PRNGKey(seed), jcfg)
    # random recurrence bias and larger recurrent weights than the init's, so
    # that every gate and the stabilizer move
    rng = np.random.default_rng(seed)
    jp = dict(jp, b=jnp.asarray(rng.standard_normal(jp["b"].shape).astype(np.float32)),
              r={"w": jp["r"]["w"] * 10})
    return jp, _carry(jp)


def test_slstm_cell_matches_jax(cfgs):
    jcfg, tcfg = cfgs
    jp, tp = _slstm_params(jcfg)
    rng = np.random.default_rng(3)
    b, d = 3, jcfg.d_model
    gx = rng.standard_normal((b, 4 * d)).astype(np.float32)
    state = {"c": rng.standard_normal((b, d)), "n": np.abs(rng.standard_normal((b, d))) + 0.5,
             "h": rng.standard_normal((b, d)), "m": rng.standard_normal((b, d))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    want = jxl.slstm_cell(jp, jcfg, jnp.asarray(gx),
                          {k: jnp.asarray(v) for k, v in state.items()})
    got = txl.slstm_cell(tp, tcfg, _t(gx), {k: _t(v) for k, v in state.items()})
    _close_tree(got, want)
    _close_tree(txl.slstm_state_init(tcfg, b, device="cpu"), jxl.slstm_state_init(jcfg, b))


def test_slstm_apply_and_decode_match_jax(cfgs):
    jcfg, tcfg = cfgs
    jp, tp = _slstm_params(jcfg, seed=1)
    x = _x(2, 12, jcfg.d_model, seed=4)
    _close(txl.slstm_apply(tp, tcfg, _t(x)), jxl.slstm_apply(jp, jcfg, jnp.asarray(x)))
    jstate, tstate = jxl.slstm_state_init(jcfg, 2), txl.slstm_state_init(tcfg, 2, device="cpu")
    for t in range(4):
        jy, jstate = jxl.slstm_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jstate)
        ty, tstate = txl.slstm_decode(tp, tcfg, _t(x[:, t:t + 1]), tstate)
        _close(ty, jy)
        _close_tree(tstate, jstate)


def test_slstm_prefill_final_state_matches_jax(cfgs):
    """The sLSTM block's prefill (a step a token from the layer's empty state),
    against the reference's ``_slstm_prefill``: its output, and the final
    state that decode takes over."""
    jcfg, tcfg = cfgs
    jbp = jtr.block_init(jax.random.PRNGKey(2), jcfg, "slstm")
    tbp = _carry(jbp)
    x = _x(2, 16, jcfg.d_model, seed=5)
    jx, jfinal = jtr._slstm_prefill(jbp, jcfg, jnp.asarray(x), jxl.slstm_state_init(jcfg, 2))
    tx, tfinal = ttr.block_prefill(tbp, tcfg, "slstm", _t(x), None,
                                   txl.slstm_state_init(tcfg, 2, device="cpu"))
    _close(tx, jx)
    _close_tree(tfinal, jfinal)
    # and the state equals that of stepping slstm_decode's cell through the prompt
    h = ttr.apply_norm(tbp["norm1"], _t(x), tcfg.norm)
    state = txl.slstm_state_init(tcfg, 2, device="cpu")
    for t in range(x.shape[1]):
        _, state = txl.slstm_decode(tbp["slstm"], tcfg, h[:, t:t + 1], state)
    _close_tree(state, tfinal)

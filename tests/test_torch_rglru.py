"""The port's RG-LRU block and conv helpers against the JAX package's, on the CPU.

The scan is held against ``jax.lax.associative_scan`` at S = 1, 7 and 64,
with and without an entering state, in fp32 at 1e-5 relative (both are
log-depth trees of the same (a, b) combine, taken in another order). The
block is held through a prefill with its final state, then steps of
``rglru_decode``; the conv helpers exactly up to summation order.
Parameters are drawn by the JAX package and carried over as numpy arrays.
"""
# ruff: noqa: E402
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.models import rglru as jrg
from repro.models import xlstm as jxl
from repro_torch.configs import get_config
from repro_torch.models import rglru as trg
from repro_torch.models import xlstm as txl
from repro_torch.tree import tree_map

ARCH = "recurrentgemma-9b"
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _scan_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    log_a = -np.abs(rng.standard_normal((b, s, w))).astype(np.float32) * 0.3
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return log_a, x, h0


@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("s", [1, 7, 64])
def test_rglru_scan_matches_associative_scan(s, with_h0):
    log_a, x, h0 = _scan_inputs(2, s, 16, seed=s)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = _t(h0) if with_h0 else None
    want = jrg.rglru_scan(jnp.asarray(log_a), jnp.asarray(x), h0=jh0)
    got = trg.rglru_scan(_t(log_a), _t(x), h0=th0)
    _close(got, want)
    # and the plain recurrence
    h = h0 if with_h0 else np.zeros_like(h0)
    for i in range(s):
        h = np.exp(log_a[:, i]) * h + x[:, i]
    _close(got[:, -1], h, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def block():
    jcfg, tcfg = jax_get_config(ARCH).smoke(), get_config(ARCH).smoke()
    jp = jrg.rglru_init(jax.random.PRNGKey(0), jcfg)
    tp = tree_map(_t, jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("s", [1, 7, 12])
def test_rglru_prefill_then_decode_matches_jax(block, s):
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(10 + s)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    jy, jstate = jrg.rglru_apply(jp, jcfg, jnp.asarray(x), return_state=True)
    ty, tstate = trg.rglru_apply(tp, tcfg, _t(x), return_state=True)
    _close(ty, jy)
    _close(tstate["h"], jstate["h"])
    _close(tstate["conv_buf"], jstate["conv_buf"])
    assert tstate["h"].dtype == torch.float32
    for _ in range(4):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jstate = jrg.rglru_decode(jp, jcfg, jnp.asarray(xt), jstate)
        ty, tstate = trg.rglru_decode(tp, tcfg, _t(xt), tstate)
        _close(ty, jy)
        _close(tstate["h"], jstate["h"])
        _close(tstate["conv_buf"], jstate["conv_buf"])


def test_rglru_apply_from_a_state_matches_jax(block):
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    h = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    jy = jrg.rglru_apply(jp, jcfg, jnp.asarray(x), state={"h": jnp.asarray(h)})
    ty = trg.rglru_apply(tp, tcfg, _t(x), state={"h": _t(h)})
    _close(ty, jy)


def test_rglru_state_init_matches_jax():
    jcfg, tcfg = jax_get_config(ARCH).smoke(), get_config(ARCH).smoke()
    want = jrg.rglru_state_init(jcfg, 3, jnp.bfloat16)
    got = trg.rglru_state_init(tcfg, 3, torch.bfloat16, device="cpu")
    assert got["h"].dtype == torch.float32 and got["conv_buf"].dtype == torch.bfloat16
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def test_rglru_init_keeps_the_reference_layout():
    """The port's own draws have the reference's tree, shapes and dtypes, and
    a^c in (0.9, 0.999) as the paper's init gives."""
    jcfg, tcfg = (dataclasses.replace(c.smoke(), param_dtype="bfloat16")
                  for c in (jax_get_config(ARCH), get_config(ARCH)))
    want = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                  jrg.rglru_init(jax.random.PRNGKey(0), jcfg))
    tp = trg.rglru_init(torch.Generator().manual_seed(0), tcfg)
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), tp)
    assert got == want
    a_c = torch.exp(-trg.A_SCALE * torch.nn.functional.softplus(tp["lambda"]))
    assert bool(((a_c > 0.9 - 1e-4) & (a_c < 0.999 + 1e-4)).all())


@pytest.mark.parametrize("s", [1, 2, 3, 10])
def test_conv_helpers_match_jax(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    buf = rng.standard_normal((2, 3, 6)).astype(np.float32)
    _close(txl._causal_conv(_t(x), _t(w)), jxl._causal_conv(jnp.asarray(x), jnp.asarray(w)))
    _close(txl.conv_tail_buffer(_t(x), 4), jxl.conv_tail_buffer(jnp.asarray(x), 4))
    tout, tbuf = txl._conv_step(_t(x[:, 0]), _t(w), _t(buf))
    jout, jbuf = jxl._conv_step(jnp.asarray(x[:, 0]), jnp.asarray(w), jnp.asarray(buf))
    _close(tout, jout)
    _close(tbuf, jbuf)

"""The port's differentiable attention against the JAX package, on the CPU.

``kernels/flash_vjp.py`` (the plain version of the CUDA backward) against
``repro.kernels.flash_vjp.flash_attention_jnp`` on the ``[kernel-bwd]``
cases of ``chip_smoke.py`` that fit a CPU, inputs and output cotangents drawn
with numpy: the forward at 1e-5 and the q, k, v gradients at 1e-4 (fp32;
the two packages sum in other orders, ~1e-6 at these sizes). The CUDA
wrapper, given CPU tensors, runs ``attention_ref`` and autograd gives its
gradients; ``ops.attention(impl="chunked")`` runs ``flash_vjp``.
"""
# ruff: noqa: E402
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_vjp import flash_attention_jnp
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import flash_vjp, ops
from repro_torch.kernels import ref as tref

FWD_TOL, GRAD_TOL = 1e-5, 1e-4

# (b, sq, skv, h, kvh, d, causal, window, softcap, q_offset, chunk): those of
# tests/test_kernels.py::test_flash_vjp_gradients (softcap 0 and 30), window
# with GQA, q_offset with Sq < Skv, non-causal Sq != Skv, D = 16 and 256, and
# a padded last chunk
CASES = [
    (1, 256, 256, 4, 2, 32, True, 0, 0.0, 0, 64),
    (1, 256, 256, 4, 2, 32, True, 0, 30.0, 0, 64),
    (1, 192, 192, 4, 2, 64, True, 64, 0.0, 0, 64),
    (1, 96, 320, 4, 1, 32, True, 64, 25.0, 224, 64),
    (2, 64, 192, 4, 2, 64, True, 0, 0.0, 128, 512),
    (1, 64, 100, 4, 2, 32, False, 0, 0.0, 0, 64),
    (2, 40, 72, 4, 2, 16, True, 0, 0.0, 0, 512),
    (1, 70, 70, 2, 1, 256, True, 0, 0.0, 0, 32),
]


def _inputs(case, seed=0):
    b, sq, skv, h, kvh, d = case[:6]
    rng = np.random.default_rng(seed)
    shapes = [(b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d), (b, sq, h, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _kw(case):
    causal, window, softcap, q_offset = case[6:10]
    return dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)


def _torch_grads(fn, q, k, v, g):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fn(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_vjp_matches_jax(case):
    q, k, v, g = _inputs(case)
    kw = dict(_kw(case), chunk=case[10])
    jout, jvjp = jax.vjp(lambda *a: flash_attention_jnp(*a, **kw), q, k, v)
    jgrads = jvjp(jnp.asarray(g))
    out, grads = _torch_grads(lambda *a: flash_vjp.flash_attention_torch(*a, **kw), q, k, v, g)
    np.testing.assert_allclose(out, np.asarray(jout), atol=FWD_TOL, rtol=FWD_TOL)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(want), atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("case", CASES[:4], ids=str)
def test_plain_forward_and_backward_are_the_autograd_function(case):
    """``flash_fwd`` / ``flash_bwd`` (what the kernels are held against) are
    the function's forward and backward, and the CUDA wrappers' CPU paths."""
    q, k, v, g = (torch.tensor(a) for a in _inputs(case, seed=1))
    kw = _kw(case)
    d, skv = q.shape[3], k.shape[1]
    out, lse = flash_vjp.flash_fwd(q, k, v, scale=d ** -0.5, chunk=min(512, skv), **kw)
    grads = flash_vjp.flash_bwd(q, k, v, out, lse, g, scale=d ** -0.5, chunk=min(512, skv),
                                **kw)
    wout, wgrads = _torch_grads(lambda *a: flash_vjp.flash_attention_torch(*a, **kw),
                                *(x.numpy() for x in (q, k, v, g)))
    np.testing.assert_array_equal(out.numpy(), wout)
    for got, want in zip(grads, wgrads):
        np.testing.assert_array_equal(got.numpy(), want)
    wout2, wlse = tflash.flash_attention_fwd(q, k, v, sm_scale=None, **kw)
    np.testing.assert_array_equal(wout2.numpy(), out.numpy())
    np.testing.assert_array_equal(wlse.numpy(), lse.numpy())
    for got, want in zip(tflash.flash_attention_bwd(q, k, v, out, lse, g, sm_scale=None, **kw),
                         grads):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_cuda_wrapper_on_cpu_gives_attention_ref_grads(case):
    q, k, v, g = _inputs(case, seed=2)
    kw = _kw(case)
    got = _torch_grads(lambda *a: tflash.flash_attention(*a, **kw), q, k, v, g)
    want = _torch_grads(lambda *a: tref.attention_ref(*a, **kw), q, k, v, g)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    # and attention_ref's gradients are the reference's oracle's
    jout, jvjp = jax.vjp(lambda *a: jax_attention_ref(*a, **kw), q, k, v)
    for a, b in zip(got[1], jvjp(jnp.asarray(g))):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_ops_attention_dispatches_by_impl():
    case = CASES[1]
    q, k, v, g = _inputs(case, seed=3)
    kw = _kw(case)
    for impl, fn in (("chunked", flash_vjp.flash_attention_torch),
                     ("ref", tref.attention_ref), ("auto", tref.attention_ref)):
        got = _torch_grads(lambda *a: ops.attention(*a, impl=impl, **kw), q, k, v, g)
        want = _torch_grads(lambda *a: fn(*a, **kw), q, k, v, g)
        for a, b in zip([got[0], *got[1]], [want[0], *want[1]]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="impl"):
        ops.attention(*(torch.tensor(a) for a in (q, k, v)), impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention(torch.zeros(1, 4, 32), torch.zeros(1, 8, 2, 32),
                             torch.zeros(1, 8, 2, 32), torch.ones(1, dtype=torch.int32),
                             impl="chunked")


def test_fully_masked_row_follows_the_reference():
    """A query row no key is visible to (q_offset past the window): the plain
    version gives what the reference's flash_vjp gives, the mean of V over the
    padded chunk and a non-zero dv; the CUDA kernels give zeros there
    (ROADMAP C, pinned on the card by tests/test_torch_cuda.py)."""
    case = (1, 8, 8, 2, 2, 16, True, 2, 0.0, 20, 8)
    q, k, v, g = _inputs(case, seed=4)
    kw = dict(_kw(case), chunk=case[10])
    jout, jvjp = jax.vjp(lambda *a: flash_attention_jnp(*a, **kw), q, k, v)
    out, grads = _torch_grads(lambda *a: flash_vjp.flash_attention_torch(*a, **kw), q, k, v, g)
    np.testing.assert_allclose(out, np.asarray(jout), atol=FWD_TOL)
    np.testing.assert_allclose(out[0, :, 0], np.broadcast_to(v[0, :, 0].mean(0), (8, 16)),
                               atol=FWD_TOL)
    np.testing.assert_allclose(grads[2], np.asarray(jvjp(jnp.asarray(g))[2]), atol=GRAD_TOL)
    assert np.abs(grads[2]).max() > 0.1

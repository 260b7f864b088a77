"""The port's training step against the JAX package, on the CPU, for every
architecture of the reference's registry at smoke width (fp32).

Both packages start from the same state (``convert.train_state_from_jax``
of the reference's ``init_train_state``, its step set to 10 so that the
warmup's learning rate is not 0) and take one step on the same batch (the
reference's ``make_batch``). Held: loss, ce and aux at rtol 1e-5; the grad
norm and every leaf's gradient at 1e-4, and the parameters and moments after
the step at 1e-4 (rtol and atol: the two packages' CPU products and
reductions run in other orders, ~1e-7 here, and Adam's normalized update
turns a gradient's last bits into ~1e-5 of its step). The reference takes
its gradients through the chunked flash backward (``impl="auto"`` on a CPU
is ``"chunked"`` there), the port through ``attention_ref`` and autograd;
the reference's gradients are read back from its first moment after the
step (from zero moments it is (1 - b1) x clip x g).
"""
# ruff: noqa: E402
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS
from repro.configs import get_config as jax_get_config
from repro.data.tokens import make_batch as jax_make_batch
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import _dequantize as jax_dequantize
from repro.optim.adamw import _QTensor as JaxQTensor
from repro.train import step as jax_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.tokens import make_batch
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as torch_model
from repro_torch.optim.adamw import AdamWConfig, _dequantize, _QTensor
from repro_torch.train import step as tstep
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

LOSS_RTOL, TOL = 1e-5, 1e-4
LR = 5e-3
B, S = 2, 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch_np(jcfg):
    return _np(jax_make_batch(jcfg, seed=3, step=0, batch=B, seq=S))


def _close_trees(got, want, tol=TOL):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def stepped(request):
    """Both packages' one step of ``arch``: (port cfg, port state before, port
    batch, port (state, metrics), port grads, JAX's (state, metrics) and
    grads as port trees)."""
    arch = request.param
    jcfg, tcfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jopt = JaxAdamWConfig(lr=LR)
    js = jax_step.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    js = js._replace(opt=js.opt._replace(step=jnp.asarray(10, jnp.int32)))
    batch = _batch_np(jcfg)

    jnew, jmetrics = jax.jit(lambda s, b: jax_step.train_step(s, b, cfg=jcfg, opt_cfg=jopt))(
        js, batch)
    state = convert.train_state_from_jax(_np(js), tcfg, device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    _, _, grads = tstep.loss_and_grads(state.params, tcfg, tbatch)
    new, metrics = tstep.train_step(state, tbatch, cfg=tcfg, opt_cfg=AdamWConfig(lr=LR))
    want = convert.train_state_from_jax(_np(jnew), tcfg, device="cpu")
    # the reference's gradients, read back from its first moment: from zero
    # moments, mu = (1 - b1) clip g, clip = min(1, grad_clip / (|g| + 1e-9))
    clip = min(1.0, jopt.grad_clip / (float(jmetrics["grad_norm"]) + 1e-9))
    want_grads = tree_map(lambda m: m / ((1 - jopt.b1) * clip), want.opt.mu)
    return arch, tcfg, state, tbatch, (new, metrics), grads, (want, _np(jmetrics)), want_grads


def test_train_step_matches_jax(stepped):
    arch, cfg, state, _, (new, metrics), grads, (want, wmetrics), want_grads = stepped
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(metrics[key]), float(wmetrics[key]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=f"{arch} {key}")
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(wmetrics["grad_norm"]),
                               rtol=TOL)
    np.testing.assert_allclose(float(metrics["lr"]), float(wmetrics["lr"]), rtol=1e-6)
    assert int(metrics["step"]) == int(wmetrics["step"]) == 11
    _close_trees(grads, want_grads)
    _close_trees(new.params, want.params)
    _close_trees(new.opt.mu, want.opt.mu)
    _close_trees(new.opt.nu, want.opt.nu)
    # the step leaves its input state as it was
    assert int(state.opt.step) == 10


def test_unused_leaves_get_zero_grads_and_weight_decay(stepped):
    """xlstm-125m's mLSTM ``wv`` is created but never read (in both packages):
    its gradient is zeros, as jax.grad gives, and AdamW still decays it."""
    arch, cfg, state, batch, (new, metrics), grads, _, _ = stepped
    leaves = tree_leaves(state.params)
    fresh = [p.detach().requires_grad_(True) for p in leaves]
    loss, _ = tstep.loss_fn(tree_unflatten(state.params, fresh), cfg, batch)
    raw = torch.autograd.grad(loss, fresh, allow_unused=True)
    unused = [i for i, g in enumerate(raw) if g is None]
    if arch != "xlstm-125m":
        assert unused == []
        return
    mlstm = [lp["mlstm"]["wv"]["w"] for lp in state.params["stack"]["layers"] if "mlstm" in lp]
    assert len(unused) == len(mlstm) == 7
    assert {id(leaves[i]) for i in unused} == {id(w) for w in mlstm}
    lr = float(metrics["lr"])
    wd = AdamWConfig().weight_decay
    for i in unused:
        assert not tree_leaves(grads)[i].any()
        before, after = leaves[i], tree_leaves(new.params)[i]
        np.testing.assert_allclose(after.numpy(), (before - lr * wd * before).numpy(),
                                   rtol=1e-6, atol=1e-9)
        assert not torch.equal(after, before)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_decrease_loss(arch):
    """tests/test_arch_smoke.py's eight steps on one batch, on the port."""
    cfg = get_config(arch).smoke()
    opt = AdamWConfig(lr=LR)
    state = tstep.init_train_state(cfg, opt, seed=0, device="cpu")
    step = tstep.make_train_step(cfg, opt)
    batch = make_batch(cfg, seed=3, step=0, batch=B, seq=S, device="cpu")
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]), (arch, losses)
    assert losses[-1] < losses[0], (arch, losses)


@pytest.mark.parametrize("s, masked", [(700, 0.1), (37, 0.3), (512, 0.0)])
def test_chunked_ce_matches_jax(s, masked):
    """S not a multiple of the 512-token chunk (the pad path), -1 labels."""
    rng = np.random.default_rng(s)
    b, d, v = 2, 16, 64
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    table = rng.standard_normal((v, d)).astype(np.float32) * 0.3
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < masked] = -1
    jfn = lambda h, w: jax_step._chunked_ce({"w": w}, h, jnp.asarray(labels))
    jloss, (jdh, jdw) = jax.value_and_grad(jfn, argnums=(0, 1))(hidden, table)
    th = torch.tensor(hidden, requires_grad=True)
    tw = torch.tensor(table, requires_grad=True)
    loss = tstep._chunked_ce({"w": tw}, th, torch.from_numpy(labels))
    dh, dw = torch.autograd.grad(loss, (th, tw))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=1e-6, rtol=TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=1e-6, rtol=TOL)


def test_chunked_ce_all_masked_is_zero():
    loss = tstep._chunked_ce({"w": torch.ones(8, 4)}, torch.ones(1, 5, 4),
                             torch.full((1, 5), -1, dtype=torch.int32))
    assert float(loss) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_equal_grads(arch):
    """remat none / full / dots: the same gradients, bit for bit; full and
    dots run each attention block's forward again in backward. The
    encoder-decoder's stack takes no remat, in the reference as here."""
    base = get_config(arch).smoke()
    params = tstep.init_train_state(base, AdamWConfig(), seed=1, device="cpu").params
    batch = make_batch(base, seed=5, step=0, batch=B, seq=S, device="cpu")
    calls = []
    apply = attn_mod.attn_apply

    def counted(*a, **k):
        calls.append(1)
        return apply(*a, **k)

    out = {}
    attn_mod.attn_apply = counted
    try:
        for remat in ("none", "full", "dots"):
            calls.clear()
            cfg = dataclasses.replace(base, remat=remat)
            loss, _, grads = tstep.loss_and_grads(params, cfg, batch)
            out[remat] = (loss, grads, len(calls))
    finally:
        attn_mod.attn_apply = apply
    for remat in ("full", "dots"):
        assert float(out[remat][0]) == float(out["none"][0])
        for a, b in zip(tree_leaves(out[remat][1]), tree_leaves(out["none"][1])):
            assert torch.equal(a, b), (arch, remat)
    n = out["none"][2]
    if not base.is_encoder_decoder:
        assert out["full"][2] == out["dots"][2] == 2 * n
        with pytest.raises(ValueError, match="remat"):
            tstep.loss_and_grads(params, dataclasses.replace(base, remat="some"), batch)


def test_hidden_forward_refuses_an_encoder_decoder():
    cfg = get_config("whisper-base").smoke()
    with pytest.raises(ValueError, match="encoder-decoder"):
        torch_model.hidden_forward({}, cfg, {})


def test_train_state_from_jax_quantized_moments():
    """int8 moments carry over dequantized, laid out as the port's per-layer
    stack and quantized again: the same values within a block's rounding."""

    jcfg, tcfg = jax_get_config("llama3.2-1b").smoke(), get_config("llama3.2-1b").smoke()
    jopt = JaxAdamWConfig(lr=LR, quantize_moments=True)
    js = jax_step.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    js, _ = jax.jit(lambda s, b: jax_step.train_step(s, b, cfg=jcfg, opt_cfg=jopt))(
        js, _batch_np(jcfg))
    state = convert.train_state_from_jax(_np(js), tcfg, device="cpu")
    assert int(state.opt.step) == 1
    is_q = lambda x: isinstance(x, _QTensor)
    jmu = jax.tree_util.tree_map(
        lambda m, p: np.asarray(jax_dequantize(m.q, m.scale, p.shape)), js.opt.mu, js.params,
        is_leaf=lambda x: isinstance(x, JaxQTensor))
    jmu = convert.params_from_jax(jmu, tcfg, device="cpu")
    for m, w in zip(tree_leaves(state.opt.mu, is_q), tree_leaves(jmu)):
        assert is_q(m)
        got = _dequantize(m.q, m.scale, w.shape)
        bound = float(w.abs().max()) / 127.0 + 1e-12
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=bound)

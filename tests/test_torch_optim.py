"""The port's optimizer, schedules and gradient compression against the JAX
package, on the CPU; and ``tests/test_optim.py``'s properties on the port.

Inputs are drawn with numpy and handed to both packages. The int8 codes of a
quantized moment are held equal; parameters and fp32 moments after an update
at 1e-6 (fp32 arithmetic of the same formula). bf16 moments round the same
products op by op in both, but the clip factor comes from a norm summed in
another order (1 ulp apart), which can move a moment across a bf16 rounding
boundary: they are held at one bf16 ulp (2^-8 relative), and all but 0.1%
bit for bit, and parameters at lr x 2^-8 beside them. The schedules are
held to one float32 ulp of 1, absolute (torch's cos and XLA's differ in the
last bit of its O(1) output).
"""
# ruff: noqa: E402
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _hyp_compat import given, st

torch = pytest.importorskip("torch")

from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim.schedules import constant as jconstant
from repro.optim.schedules import warmup_cosine as jwarmup_cosine
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim.adamw import (AdamWConfig, OptState, _dequantize, _QTensor, _quantize,
                                     adamw_init, adamw_update, global_norm)
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.tree import tree_leaves, tree_map

TOL = 1e-6
BF16_ULP = 2.0 ** -8
F32_ULP = 2.0 ** -23
MOMENTS = {"float32": dict(), "bfloat16": dict(moment_dtype="bfloat16"),
           "int8": dict(quantize_moments=True)}


def _rosenbrock_params():
    return {"x": torch.tensor([-1.2, 1.0, 0.5]), "y": {"z": torch.tensor([2.0, -0.3])}}


def _loss(p):
    return torch.sum((p["x"] - 1.0) ** 2) + 3.0 * torch.sum(p["y"]["z"] ** 2)


@pytest.mark.parametrize("moments", list(MOMENTS))
def test_adamw_converges(moments):
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, **MOMENTS[moments])
    p = _rosenbrock_params()
    state = adamw_init(p, cfg)
    for _ in range(300):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
        q = {"x": leaves[0], "y": {"z": leaves[1]}}
        gx, gz = torch.autograd.grad(_loss(q), leaves)
        p, state, _ = adamw_update({"x": gx, "y": {"z": gz}}, state, p, cfg)
    assert float(_loss(p)) < 1e-2


def test_grad_clip_limits_update_norm():
    cfg = AdamWConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0)
    p = {"x": torch.ones(4)}
    _, _, m = adamw_update({"x": torch.full((4,), 1e6)}, adamw_init(p, cfg), p, cfg)
    assert float(m["grad_norm"]) > 1e5  # reported raw


@given(st.lists(st.floats(-100, 100), min_size=3, max_size=64))
def test_quantize_roundtrip_bounded_error(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    back = _dequantize(*_quantize(x), x.shape)
    blockmax = float(x.abs().max()) or 1.0
    assert float((back - x).abs().max()) <= blockmax / 127.0 + 1e-6


def test_global_norm():
    t = {"a": torch.ones(3), "b": torch.full((4,), 2.0)}
    assert abs(float(global_norm(t)) - np.sqrt(3 + 16)) < 1e-5


def test_quantize_matches_jax_codes():
    """Blocks of 256 with a ragged last one, ties at .5 (round half to even)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype(np.float32) * 3
    x[:256] = np.arange(-128, 128, dtype=np.float32) + 0.5  # absmax 127.5: codes at .5
    q, s = _quantize(torch.from_numpy(x))
    jq, js = jadamw._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_dequantize(q, s, x.shape).numpy(),
                                  np.asarray(jadamw._dequantize(jq, js, x.shape)))


def _tree(rng):
    return {"w": rng.standard_normal((300, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)},
            "e": rng.standard_normal((256,)).astype(np.float32)}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _moment_leaves(m):
    return [np.concatenate([np.asarray(x.q, np.float32).ravel(), np.asarray(x.scale).ravel()])
            if isinstance(x, (_QTensor, jadamw._QTensor)) else np.asarray(
                x.float() if torch.is_tensor(x) else x.astype(jnp.float32))
            for x in jax.tree_util.tree_leaves(m, is_leaf=lambda y: isinstance(y, jadamw._QTensor))]


@pytest.mark.parametrize("moments", list(MOMENTS))
def test_adamw_update_matches_jax(moments):
    """Three steps from the same params and grads, with a schedule's lr
    scale: params, moments (int8 codes exactly) and metrics."""
    rng = np.random.default_rng(1)
    kw = dict(lr=3e-2, grad_clip=1.0, **MOMENTS[moments])
    jcfg, tcfg = jadamw.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(rng))
    tp = _to_torch(_tree(np.random.default_rng(1)))
    js, ts = jadamw.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for i in range(3):
        g = _tree(rng)
        scale = 0.5 + 0.25 * i
        jp, js, jm = jadamw.adamw_update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, jcfg,
                                         jnp.float32(scale))
        tp, ts, tm = adamw_update(_to_torch(g), ts, tp, tcfg, torch.tensor(scale))
        atol = TOL + (kw["lr"] * BF16_ULP if moments == "bfloat16" else 0.0)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=TOL)
        for tm_, jm_ in ((ts.mu, js.mu), (ts.nu, js.nu)):
            t_leaves = tree_leaves(tm_, lambda x: isinstance(x, _QTensor))
            j_leaves = jax.tree_util.tree_leaves(jm_, is_leaf=lambda y: isinstance(
                y, jadamw._QTensor))
            for a, b in zip(t_leaves, j_leaves):
                if moments == "int8":
                    np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q))
                    np.testing.assert_allclose(a.scale.numpy(), np.asarray(b.scale), rtol=TOL)
                elif moments == "bfloat16":
                    assert a.dtype == torch.bfloat16
                    got, want = a.float().numpy(), np.asarray(b.astype(jnp.float32))
                    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=TOL)
                    assert np.mean(got != want) <= 1e-3
                else:
                    assert a.dtype == torch.float32
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
        assert int(ts.step) == int(js.step) == i + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=TOL)


def test_stacked_agents_keep_float32_moments():
    with pytest.raises(ValueError, match="float32"):
        adamw_init({"w": torch.zeros(2, 3)}, AdamWConfig(quantize_moments=True), (2,))


def test_schedules_match_jax():
    steps = np.arange(0, 1200, 7)
    for kw in (dict(), dict(warmup=100, total=1000, floor=0.1), dict(warmup=0, total=50)):
        np.testing.assert_allclose(warmup_cosine(torch.from_numpy(steps), **kw).numpy(),
                                   np.asarray(jwarmup_cosine(jnp.asarray(steps), **kw)),
                                   rtol=0, atol=F32_ULP)
    s = warmup_cosine(torch.arange(0, 1000), warmup=100, total=1000, floor=0.1).numpy()
    assert s[0] == 0.0 and abs(s[100] - 1.0) < 0.02 and s[-1] <= 0.2 and np.all(s >= 0)
    assert float(constant(torch.tensor(5))) == float(jconstant(5)) == 1.0
    assert warmup_cosine(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32


def test_ef_compress_matches_jax():
    rng = np.random.default_rng(2)
    grads = [{"w": rng.standard_normal(300).astype(np.float32),
              "v": {"u": rng.standard_normal((3, 100)).astype(np.float32)}} for _ in range(5)]
    terr = tgc.init_error(_to_torch(grads[0]))
    jerr = jgc.init_error(jax.eval_shape(lambda: jax.tree_util.tree_map(jnp.asarray, grads[0])))
    for g in grads:
        tapprox, terr = tgc.ef_compress_tree(_to_torch(g), terr)
        japprox, jerr = jgc.ef_compress_tree(jax.tree_util.tree_map(jnp.asarray, g), jerr)
        for a, b in zip(tree_leaves((tapprox, terr)), jax.tree_util.tree_leaves((japprox, jerr))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_error_feedback_is_lossless_over_time():
    """EF property: sum of compressed grads + final error == sum of raw grads."""
    gen = torch.Generator().manual_seed(0)
    grads = [{"w": torch.randn(64, generator=gen)} for _ in range(20)]
    err = tgc.init_error(grads[0])
    sent = torch.zeros(64)
    for g in grads:
        approx, err = tgc.ef_compress_tree(g, err)
        sent = sent + approx["w"]
    total = sum(g["w"] for g in grads)
    assert float((sent + err["w"] - total).abs().max()) < 1e-3


def test_compress_decompress_error_shrinks_signal():
    x = torch.randn(256, generator=torch.Generator().manual_seed(1))
    approx, err = tgc.compress_decompress(x)
    assert float(err.norm()) < 0.05 * float(x.norm())
    assert approx.dtype == err.dtype == x.dtype


def test_compressed_psum_without_a_group_is_the_identity():
    """Without a group ``x`` comes back; over a group of one rank the sum is
    its own int8 round trip (more ranks: ``tests/test_torch_mesh.py``)."""
    import torch.distributed as dist

    x = torch.randn(300)
    assert tgc.compressed_psum(x) is x
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        got = tgc.compressed_psum(x, group=dist.group.WORLD)
    finally:
        if started:
            dist.destroy_process_group()
    assert torch.equal(got, tgc.compress_decompress(x)[0])


def test_opt_state_fields_match_jax():
    assert OptState._fields == jadamw.OptState._fields
    assert _QTensor._fields == jadamw._QTensor._fields
    assert AdamWConfig() == AdamWConfig(**{f: getattr(jadamw.AdamWConfig(), f)
                                           for f in AdamWConfig.__dataclass_fields__})

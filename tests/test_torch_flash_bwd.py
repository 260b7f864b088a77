"""The flash backward's plan, its determinism contract and its CPU path, on the CPU.

``kernels/flash_attention.py`` ``_bwd_plan`` (how the CUDA backward splits
each kv head's GQA group over blocks, and the grid and scratch that follow)
at every ``[kernel-bwd]`` case of ``chip_smoke.py`` and llama3.2-1b's
training shape, in both dtypes; the source of ``csrc/flash_attention_bwd.cu``
read for atomics (it has none, so two runs give the same bits); and the
wrapper's CPU path, which is ``kernels/flash_vjp.py``'s plain backward,
against the JAX package's ``repro.kernels.flash_vjp`` on the cases that
exercise the split (fp32, inputs drawn with numpy, gradients at 1e-4: the two
packages sum in other orders).
"""
# ruff: noqa: E402
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke
from repro.kernels.flash_vjp import flash_attention_jnp
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import flash_vjp

DTYPES = [torch.float32, torch.bfloat16]
PLAN_CASES = chip_smoke.BWD_CASES + [chip_smoke.TRAIN_ATTN_CASE]
# the MQA case, arctic-480b's group of 7, recurrentgemma-9b's of 16 at D = 256
SPLIT_CASES = [chip_smoke.MQA_BWD_CASE, *chip_smoke.BWD_CASES[-2:]]
GRAD_TOL = 1e-4


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_bwd_plan_splits_the_group_within_the_grid(case, dtype):
    """The split divides the group and is the smallest divisor that gives the
    dk/dv grid a block for each of 132 SMs (the group where none does); the
    grid lies within CUDA's limits; the scratch holds one fp32 dk and dv per
    split, and there is none without a split."""
    b, sq, skv, h, kvh, d = case[:6]
    group = h // kvh
    plan = tflash._bwd_plan(b, sq, skv, h, kvh, d, dtype)
    key_tiles = -(-skv // tflash._bwd_key_tile(d, dtype))
    assert group % plan.splits == 0
    assert plan.grid == (b * kvh * plan.splits, key_tiles)
    assert 0 < plan.grid[0] <= tflash.CUDA_GRID_X and 0 < plan.grid[1] <= tflash.CUDA_GRID_Y
    filling = [s for s in range(1, group + 1)
               if group % s == 0 and b * kvh * s * key_tiles >= tflash.H100_SMS]
    assert plan.splits == (filling[0] if filling else group)
    if plan.splits == 1:
        assert plan.scratch is None
    else:
        assert plan.scratch == (2, plan.splits, b, skv, kvh, d)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bwd_plan_keeps_the_training_shape_whole_and_splits_mqa(dtype):
    """llama3.2-1b's training shape fills the card unsplit; the MQA case (8
    heads over one kv head, 200 keys) and recurrentgemma-9b's group of 16
    split over their whole group; arctic-480b's group of 7 can only be 1 or 7."""
    def splits(case):
        return tflash._bwd_plan(*case[:6], dtype).splits

    assert splits(chip_smoke.TRAIN_ATTN_CASE) == 1
    assert splits(chip_smoke.MQA_BWD_CASE) == 8
    assert splits((1, 256, 256, 14, 2, 128)) == 7
    assert splits((1, 256, 256, 16, 1, 256)) == 16


def test_backward_source_has_no_atomics():
    """The determinism contract: every output element of the backward is
    written by one block, and a sum across blocks is a pass in a fixed order,
    so the source has no atomic operation (nor PTX's ``red``)."""
    src = (Path(tflash.__file__).parent / "csrc" / "flash_attention_bwd.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)  # the notes may name what the code avoids
    assert "atomic" not in code.lower()
    assert not re.search(r"\bred\.", code)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_cpu_path_is_the_plain_backward_and_the_reference(case):
    """On CPU tensors ``flash_attention_fwd`` / ``flash_attention_bwd`` are
    ``flash_vjp.flash_fwd`` / ``flash_bwd`` bit for bit, and their gradients
    are the JAX package's (``jax.vjp`` of ``flash_attention_jnp``)."""
    b, sq, skv, h, kvh, d, causal, window, softcap, q_offset = case
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d), (b, sq, h, d)))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = tflash.flash_attention_fwd(tq, tk, tv, sm_scale=None, **kw)
    got = tflash.flash_attention_bwd(tq, tk, tv, out, lse, tg, sm_scale=None, **kw)
    chunk = min(512, skv)
    pout, plse = flash_vjp.flash_fwd(tq, tk, tv, scale=d ** -0.5, chunk=chunk, **kw)
    want = flash_vjp.flash_bwd(tq, tk, tv, pout, plse, tg, scale=d ** -0.5, chunk=chunk, **kw)
    assert torch.equal(out, pout) and torch.equal(lse, plse)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    _, jvjp = jax.vjp(lambda *a: flash_attention_jnp(*a, **kw, chunk=chunk), q, k, v)
    for a, w in zip(got, jvjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL)

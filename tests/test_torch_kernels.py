"""The port's attention kernels against the JAX package.

On the CPU: the plain versions (``repro_torch.kernels.ref``) against the
Pallas kernels in interpret mode and against ``repro.kernels.ref``, on the
cases of ``tests/test_kernels.py`` plus softcap and ``q_offset`` cases; the
``ops`` dispatch seam. (The hand-written kernels are held against their
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.) Inputs are drawn with numpy and handed to both packages. Tolerances are those of ``tests/test_kernels.py``: 2e-5 in
fp32 (summation order differs), 2e-2 in bf16 (one bf16 rounding of O(1)
outputs, 2^-8, plus the order).
"""
# ruff: noqa: E402
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

# the port needs torch; the imports below need the port (hence the E402 waiver)
torch = pytest.importorskip("torch")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke
from test_kernels import DECODE_CASES, FLASH_CASES

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (b, sq, skv, h, kvh, d, causal, window, softcap, q_offset)
FLASH_PARAMS = [(b, s, s, h, kvh, d, causal, window, 0.0, 0)
                for b, s, h, kvh, d, causal, window in FLASH_CASES] + [
    (1, 128, 128, 4, 2, 64, True, 0, 30.0, 0),     # softcap
    (2, 64, 192, 4, 2, 64, True, 0, 0.0, 128),     # q_offset: the last 64 rows of 192
    (1, 96, 320, 4, 1, 32, True, 64, 25.0, 224),   # q_offset + window + softcap, MQA
    (1, 100, 100, 4, 2, 64, True, 0, 0.0, 0),      # Sq, Skv not multiples of 16
    (1, 128, 200, 4, 2, 128, False, 0, 0.0, 0),    # non-causal, D=128, partial KV tile
    # non-causal with one or four query rows over a partial KV tile: the cross
    # attention of an encoder-decoder at decode and over its prompt
    (2, 1, 100, 4, 4, 64, False, 0, 0.0, 0),
    (3, 4, 150, 8, 2, 64, False, 0, 0.0, 0),
    (2, 1, 70, 8, 1, 128, False, 0, 0.0, 0),
]
# (b, s, h, kvh, d, softcap)
DECODE_PARAMS = [case + (0.0,) for case in DECODE_CASES] + [(2, 512, 8, 2, 64, 25.0)]
# explicit lengths: 0, S, on a split boundary, one past a split
# (b, s, h, kvh, d, softcap, lengths)
DECODE_LENGTH_PARAMS = [
    (5, 300, 8, 2, 64, 0.0, (0, 300, 128, 65, 129)),
    (4, 256, 4, 1, 128, 25.0, (0, 256, 64, 129)),
    (3, 192, 14, 2, 32, 0.0, (192, 0, 65)),     # group 7
]
# splits of the plain split algorithm: the kernel's, and the Pallas kernel's
# block_k of these tests
SPLITS = (tdecode.SPLIT, 128)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(arrays, dtype):
    """The same numpy inputs as JAX arrays and torch tensors of ``dtype``."""
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrays],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrays])


def _err(torch_out, jax_out) -> float:
    return float(np.max(np.abs(torch_out.float().numpy()
                               - np.asarray(jax_out.astype(jnp.float32)))))


def _flash_inputs(case, seed=0):
    b, sq, skv, h, kvh, d, causal, window, softcap, q_offset = case
    rng = np.random.default_rng(seed)
    arrays = (_normal(rng, (b, sq, h, d)), _normal(rng, (b, skv, kvh, d)),
              _normal(rng, (b, skv, kvh, d)))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    return arrays, kw


def _decode_inputs(case, seed=0):
    b, s, h, kvh, d, softcap = case
    rng = np.random.default_rng(seed)
    arrays = (_normal(rng, (b, h, d)), _normal(rng, (b, s, kvh, d)),
              _normal(rng, (b, s, kvh, d)))
    lengths = rng.integers(1, s + 1, size=(b,)).astype(np.int32)
    return arrays, lengths, softcap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_PARAMS)
def test_flash_plain_matches_jax(case, dtype):
    arrays, kw = _flash_inputs(case)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    pallas = pallas_flash(jq, jk, jv, block_q=128, block_k=128, interpret=True, **kw)
    oracle = jref.attention_ref(jq, jk, jv, **kw)
    # chunk=64 makes the streaming version walk several chunks on every case
    for out in (tref.attention_ref(tq, tk, tv, **kw),
                tref.attention_chunked(tq, tk, tv, chunk=64, **kw)):
        assert out.dtype == TDT[dtype] and tuple(out.shape) == tuple(pallas.shape)
        assert _err(out, pallas) < TOL[dtype]
        assert _err(out, oracle) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_PARAMS)
def test_decode_plain_matches_jax(case, dtype):
    arrays, lengths, softcap = _decode_inputs(case)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(lengths), softcap=softcap,
                           block_k=128, interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths), softcap=softcap)
    out = tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lengths), softcap=softcap)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == tuple(pallas.shape)
    assert _err(out, pallas) < TOL[dtype]
    assert _err(out, oracle) < TOL[dtype]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_PARAMS)
def test_decode_split_plain_matches_jax(case, dtype, split):
    """The split-KV algorithm of the decode kernel (partials per split, then
    the combine) in plain torch, against the Pallas kernel and the JAX oracle."""
    arrays, lengths, softcap = _decode_inputs(case)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(lengths), softcap=softcap,
                           block_k=128, interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths), softcap=softcap)
    out = tref.decode_attention_split_ref(tq, tk, tv, torch.from_numpy(lengths), split=split,
                                          softcap=softcap)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == tuple(pallas.shape)
    assert _err(out, pallas) < TOL[dtype]
    assert _err(out, oracle) < TOL[dtype]
    plain = tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lengths), softcap=softcap)
    assert float((out.float() - plain.float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_LENGTH_PARAMS)
def test_decode_split_plain_explicit_lengths(case, dtype, split):
    """Empty splits and the edges of a split: length 0 gives zeros, as the
    Pallas kernel does; rows of length > 0 also match ``decode_attention_ref``
    (which averages V over a row of length 0)."""
    *shape, lengths = case
    arrays, _, softcap = _decode_inputs(tuple(shape))
    lengths = np.asarray(lengths, dtype=np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(lengths), softcap=softcap,
                           block_k=128, interpret=True)
    out = tref.decode_attention_split_ref(tq, tk, tv, torch.from_numpy(lengths), split=split,
                                          softcap=softcap)
    assert _err(out, pallas) < TOL[dtype]
    assert not out[torch.from_numpy(lengths == 0)].float().abs().any()
    rows = torch.from_numpy(lengths > 0)
    plain = tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lengths), softcap=softcap)
    assert float((out[rows].float() - plain[rows].float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES_D16)
def test_flash_plain_head_dim_16_matches_jax(case):
    """Head dim 16 (the smoke configs'), fp32: the cases the card holds its
    fp32 kernel to, here the plain versions against Pallas and the oracle."""
    test_flash_plain_matches_jax(case, "float32")


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", chip_smoke.DECODE_CASES_D16)
def test_decode_plain_head_dim_16_matches_jax(case, split):
    test_decode_plain_matches_jax(case, "float32")
    test_decode_split_plain_matches_jax(case, "float32", split)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", chip_smoke.DECODE_LENGTH_CASES_D16)
def test_decode_plain_head_dim_16_explicit_lengths(case, split):
    test_decode_split_plain_explicit_lengths(case, "float32", split)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES_D256)
def test_flash_plain_head_dim_256_matches_jax(case, dtype):
    """Head dim 256 (recurrentgemma-9b's MQA), both dtypes: the cases the card
    holds both kernels to, here the plain versions against Pallas."""
    test_flash_plain_matches_jax(case, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.DECODE_CASES_D256)
def test_decode_plain_head_dim_256_matches_jax(case, dtype):
    test_decode_plain_matches_jax(case, dtype)
    test_decode_split_plain_matches_jax(case, dtype, tdecode.SPLIT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.DECODE_LENGTH_CASES_D256)
def test_decode_plain_head_dim_256_explicit_lengths(case, dtype):
    test_decode_split_plain_explicit_lengths(case, dtype, tdecode.SPLIT)


def test_chip_smoke_holds_the_same_cases():
    """chip_smoke.py, which cannot import the JAX tests, keeps a copy of these cases."""
    assert chip_smoke.FLASH_CASES == FLASH_PARAMS
    assert chip_smoke.DECODE_CASES == DECODE_PARAMS
    assert chip_smoke.DECODE_LENGTH_CASES == DECODE_LENGTH_PARAMS
    assert {str(k).split(".")[-1]: v for k, v in chip_smoke.TOL.items()} == TOL


def test_ops_seam_takes_plain_path_on_cpu():
    """auto and ref on a CPU tensor both run the plain version; no kernel is
    launched, and an unknown impl is refused."""
    arrays, kw = _flash_inputs((1, 96, 600, 4, 2, 32, True, 0, 0.0, 504))
    q, k, v = (torch.from_numpy(a) for a in arrays)
    darrays, lengths, _ = _decode_inputs((2, 257, 14, 2, 64, 0.0))
    dq, dk, dv = (torch.from_numpy(a) for a in darrays)
    lens = torch.from_numpy(lengths)
    launches = (tflash.KERNEL.launches, tdecode.KERNEL.launches)

    assert torch.equal(ops.attention(q, k, v, **kw), tref.attention_ref(q, k, v, **kw))
    assert torch.equal(ops.attention(q, k, v, impl="ref", **kw), tref.attention_ref(q, k, v, **kw))
    assert torch.equal(ops.decode_attention(dq, dk, dv, lens),
                       tref.decode_attention_ref(dq, dk, dv, lens))
    assert torch.equal(ops.decode_attention(dq, dk, dv, lens, impl="ref"),
                       tref.decode_attention_ref(dq, dk, dv, lens))
    assert (tflash.KERNEL.launches, tdecode.KERNEL.launches) == launches
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention(dq, dk, dv, lens, impl="chunked")


def test_wrappers_refuse_a_device_that_is_neither_cpu_nor_cuda():
    """Only a CPU tensor takes the plain version: any other tensor launches or raises."""
    q = torch.empty((1, 8, 4, 64), device="meta")
    k = torch.empty((1, 8, 2, 64), device="meta")
    launches = (tflash.KERNEL.launches, tdecode.KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, k, k)
    lens = torch.ones((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.decode_attention(q[:, 0], k, k, lens)
    assert (tflash.KERNEL.launches, tdecode.KERNEL.launches) == launches

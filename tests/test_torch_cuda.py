"""The hand-written CUDA kernels against their plain versions, on the card.

The cases are ``chip_smoke.py``'s: those of ``tests/test_kernels.py`` plus
softcap, ``q_offset``, ragged-tile, one-query-row and explicit-length cases,
head dims 16 (fp32) and 256 (both dtypes; recurrentgemma-9b's MQA), and
whisper-base's non-causal shapes at its serving batch
(``tests/test_torch_kernels.py`` checks that the copies agree); the
backward kernel against ``kernels/flash_vjp.py`` on ``[kernel-bwd]``'s
cases (two of its calls bit-equal at the training shape and the MQA case),
and a smoke train step through both kernels against ``impl="ref"``; the
RoPE kernel (``csrc/rope.cu``) bit-equal to its plain version forward and
backward at ``chip_smoke.ROPE_CASES``, and a smoke ``generate`` of
qwen2-7b making one RoPE launch a layer and step, its tokens those of the
plain RoPE.
This file imports no JAX, so it runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere every test skips. Tolerances: 2e-5 in fp32 (summation order), 2e-2
in bf16 (one bf16 rounding of O(1) outputs, 2^-8, plus the order).
"""
# ruff: noqa: E402
import sys
from pathlib import Path

import pytest

# the port needs torch; the imports below need the port (hence the E402 waiver)
torch = pytest.importorskip("torch")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import flash_vjp as tflash_vjp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rope as trope
from repro_torch.models.layers import apply_rope

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, skv, h, kvh, d, causal, window, softcap, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, (b, sq, h, d), dtype, cuda)
    k, v = (_randn(gen, (b, skv, kvh, d), dtype, cuda) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    launches = tflash.KERNEL.launches
    out = tflash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tflash.KERNEL.launches == launches + 1
    want = tref.attention_ref(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == want.shape
    assert float((out.float() - want.float()).abs().max()) < chip_smoke.TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, case, dtype):
    b, s, h, kvh, d, softcap = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, (b, h, d), dtype, cuda)
    k, v = (_randn(gen, (b, s, kvh, d), dtype, cuda) for _ in range(2))
    lens = torch.randint(1, s + 1, (b,), generator=gen, device=cuda, dtype=torch.int32)
    launches = tdecode.KERNEL.launches
    out = tdecode.decode_attention(q, k, v, lens, softcap=softcap)
    torch.cuda.synchronize()
    assert tdecode.KERNEL.launches == launches + 1
    want = tref.decode_attention_ref(q, k, v, lens, softcap=softcap)
    assert out.dtype == dtype and out.shape == want.shape
    assert float((out.float() - want.float()).abs().max()) < chip_smoke.TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.DECODE_LENGTH_CASES)
def test_decode_kernel_explicit_lengths(cuda, case, dtype):
    """Length 0 (zeros, as the split algorithm and the Pallas kernel give), S,
    a split boundary and one past a split."""
    b, s, h, kvh, d, softcap, lengths = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, (b, h, d), dtype, cuda)
    k, v = (_randn(gen, (b, s, kvh, d), dtype, cuda) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    launches = tdecode.KERNEL.launches
    out = tdecode.decode_attention(q, k, v, lens, softcap=softcap)
    torch.cuda.synchronize()
    assert tdecode.KERNEL.launches == launches + 1
    want = tref.decode_attention_split_ref(q, k, v, lens, split=tdecode.SPLIT, softcap=softcap)
    assert float((out.float() - want.float()).abs().max()) < chip_smoke.TOL[dtype]
    rows = lens > 0
    plain = tref.decode_attention_ref(q, k, v, lens, softcap=softcap)
    assert float((out[rows].float() - plain[rows].float()).abs().max()) < chip_smoke.TOL[dtype]


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 48), device=cuda)  # head dim 48
    k = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(q, k, k)
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    k = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tflash.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash.flash_attention(torch.zeros(1 + q.numel(), device=cuda)[1:].view(q.shape), k, k)
    lens = torch.ones((1,), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        tdecode.decode_attention(q[:, 0], k, k, lens)
    # head dim 16 runs in fp32 only; bf16 at 16 is refused, never served plain
    q = torch.zeros((1, 8, 4, 16), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="B.1"):
        tflash.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="B.1"):
        tdecode.decode_attention(q[:, 0], k, k, torch.ones((1,), dtype=torch.int32,
                                                            device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES_D16)
def test_flash_kernel_head_dim_16_fp32(cuda, case):
    test_flash_kernel_matches_plain(cuda, case, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.DECODE_CASES_D16)
def test_decode_kernel_head_dim_16_fp32(cuda, case):
    test_decode_kernel_matches_plain(cuda, case, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.DECODE_LENGTH_CASES_D16)
def test_decode_kernel_head_dim_16_explicit_lengths(cuda, case):
    test_decode_kernel_explicit_lengths(cuda, case, torch.float32)


@pytest.mark.cuda
def test_default_fleet_serves_on_the_card(cuda):
    """``Fleet([arch], 2)`` at its defaults (cfg.smoke(): head dim 16, fp32)
    serves through both kernels, its logits those of ``impl="ref"``."""
    chip_smoke.fleet_smoke_phase(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES_D256)
def test_flash_kernel_head_dim_256(cuda, case, dtype):
    test_flash_kernel_matches_plain(cuda, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.DECODE_CASES_D256)
def test_decode_kernel_head_dim_256(cuda, case, dtype):
    test_decode_kernel_matches_plain(cuda, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.DECODE_LENGTH_CASES_D256)
def test_decode_kernel_head_dim_256_explicit_lengths(cuda, case, dtype):
    test_decode_kernel_explicit_lengths(cuda, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES_WHISPER)
def test_flash_kernel_whisper_shapes(cuda, case, dtype):
    """whisper-base's encoder and cross attention at its serving batch: non-causal,
    Skv = 1500 (not a multiple of the key tile), one or four query rows or 1500."""
    test_flash_kernel_matches_plain(cuda, case, dtype)


@pytest.mark.cuda
def test_smoke_whisper_fleet_serves_on_the_card(cuda):
    """``Fleet(["whisper-base"], 2)`` at smoke width through both kernels (the
    cross attention's flash call with one query row at decode), its logits
    those of ``impl="ref"``."""
    chip_smoke.fleet_smoke_phase(cuda, "whisper-base")


@pytest.mark.cuda
def test_three_arch_fleet_serves_on_the_card(cuda):
    """The reference's serve_fleet.py loop on the card: GT-DRL's split to a
    dense, an MoE and a hybrid arch (smoke widths) through both kernels, every
    server's logits those of ``impl="ref"``."""
    chip_smoke.serve_fleet_phase(cuda)


def _grads(fn, q, k, v, g):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    return (out, *torch.autograd.grad(out, (q, k, v), g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.BWD_CASES + [chip_smoke.TRAIN_ATTN_CASE])
def test_flash_bwd_kernel_matches_plain(cuda, case, dtype):
    """dq, dk, dv through the forward kernel (with lse) and the backward
    kernel against flash_vjp's plain forward and backward: fp32 max abs,
    bf16 relative norm (chip_smoke.BWD_TOL)."""
    b, sq, skv, h, kvh, d, causal, window, softcap, q_offset = case
    if d == 16 and dtype != torch.float32:
        pytest.skip("head dim 16 is fp32 only")
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, (b, sq, h, d), dtype, cuda)
    k, v = (_randn(gen, (b, skv, kvh, d), dtype, cuda) for _ in range(2))
    g = _randn(gen, (b, sq, h, d), dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    launches = (tflash.KERNEL.launches, tflash.BWD_KERNEL.launches)
    got = _grads(lambda *a: tflash.flash_attention(*a, **kw), q, k, v, g)
    torch.cuda.synchronize()
    assert (tflash.KERNEL.launches, tflash.BWD_KERNEL.launches) == (launches[0] + 1,
                                                                    launches[1] + 1)
    want = _grads(lambda *a: tflash_vjp.flash_attention_torch(*a, **kw), q, k, v, g)
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == dtype and a.shape == w.shape
        err = (float((a.float() - w.float()).abs().max()) if dtype == torch.float32
               else float((a.float() - w.float()).norm() / w.float().norm()))
        assert err < chip_smoke.BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.BWD_SPLIT_CASES)
def test_flash_bwd_kernel_is_deterministic(cuda, case, dtype):
    """Two backward calls on the same inputs give bit-equal dq, dk and dv (the
    kernels have no atomics; the MQA case's head split is summed in a fixed
    order): the trainer's bit-equal resume relies on it."""
    b, sq, skv, h, kvh, d, causal, window, softcap, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, g = (_randn(gen, (b, sq, h, d), dtype, cuda) for _ in range(2))
    k, v = (_randn(gen, (b, skv, kvh, d), dtype, cuda) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset, sm_scale=None)
    out, lse = tflash.flash_attention_fwd(q, k, v, **kw)
    first = tflash.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    second = tflash.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(first, second))


@pytest.mark.cuda
def test_fully_masked_row_gives_zeros_and_zero_grads(cuda):
    """ROADMAP C: a query row no key is visible to (q_offset past the window)
    outputs zeros through the forward kernel and gets zero gradients from the
    backward kernel; its lse is the finite NEG_INF (-0.7 of the largest
    float32). The reference's jnp path
    (flash_vjp, as tests/test_torch_flash_vjp.py pins) averages V there."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_randn(gen, (1, 8, 2, 32), torch.float32, cuda) for _ in range(3))
    kw = dict(causal=True, window=2, softcap=0.0, q_offset=20)
    out, dq, dk, dv = _grads(lambda *a: tflash.flash_attention(*a, **kw), q, k, v,
                             torch.ones_like(q))
    _, lse = tflash.flash_attention_fwd(q, k, v, sm_scale=None, **kw)
    torch.cuda.synchronize()
    assert not out.any() and not dq.any() and not dk.any() and not dv.any()
    assert bool((lse < -1e38).all())
    plain = tflash_vjp.flash_attention_torch(q, k, v, **kw)
    assert float(plain.abs().max()) > 0.1


@pytest.mark.cuda
def test_train_step_through_the_kernels(cuda):
    """One smoke train step of llama3.2-1b and of whisper-base (fp32, head dim
    16) through both flash kernels against impl="ref" on the card: loss at
    rtol 1e-5, every gradient at 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, loss_and_grads
    from repro_torch.tree import tree_leaves

    for arch in ("llama3.2-1b", "whisper-base"):
        cfg = get_config(arch).smoke()
        params = init_train_state(cfg, AdamWConfig(), seed=0, device=cuda).params
        batch = make_batch(cfg, seed=3, step=0, batch=2, seq=32, device=cuda)
        bwd = tflash.BWD_KERNEL.launches
        loss, _, grads = loss_and_grads(params, cfg, batch)
        assert tflash.BWD_KERNEL.launches > bwd
        want_loss, _, want = loss_and_grads(params, cfg, batch, impl="ref")
        assert abs(float(loss) / float(want_loss) - 1) < 1e-5
        for a, w in zip(tree_leaves(grads), tree_leaves(want)):
            assert torch.allclose(a, w, rtol=1e-4, atol=1e-4)


def _rope_inputs(case, dtype, device, requires_grad=False):
    b, s, h, kvh, d, lo, hi = case
    gen = torch.Generator(device=device).manual_seed(0)
    q, k = _randn(gen, (b, s, h, d), dtype, device), _randn(gen, (b, s, kvh, d), dtype, device)
    pos = chip_smoke.rope_positions(b, s, lo, hi, device, gen)
    return q.requires_grad_(requires_grad), k.requires_grad_(requires_grad), pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.ROPE_CASES)
def test_rope_kernel_matches_plain_bit_for_bit(cuda, case, dtype):
    """q and k rotated in one launch, each element equal to ``apply_rope``'s
    on the card (the same inverse frequencies, precise sinf / cosf, every
    product and sum rounded on its own)."""
    q, k, pos = _rope_inputs(case, dtype, cuda)
    launches = trope.KERNEL.launches
    got = ops.rope(q, k, pos, chip_smoke.ROPE_THETA)
    torch.cuda.synchronize()
    assert trope.KERNEL.launches == launches + 1
    for g, x in zip(got, (q, k)):
        want = apply_rope(x, pos, chip_smoke.ROPE_THETA)
        assert g.dtype == dtype and g.shape == want.shape and g.is_contiguous()
        assert torch.equal(g, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.ROPE_CASES)
def test_rope_kernel_backward_matches_autograd_bit_for_bit(cuda, case, dtype):
    """The backward (the kernel by -angle, one launch) against autograd
    through the plain version, bit for bit."""
    q, k, pos = _rope_inputs(case, dtype, cuda, requires_grad=True)
    gen = torch.Generator(device=cuda).manual_seed(1)
    gq, gk = _randn(gen, q.shape, dtype, cuda), _randn(gen, k.shape, dtype, cuda)
    launches = trope.KERNEL.launches
    qr, kr = ops.rope(q, k, pos, chip_smoke.ROPE_THETA)
    got = torch.autograd.grad((qr, kr), (q, k), (gq, gk))
    torch.cuda.synchronize()
    assert trope.KERNEL.launches == launches + 2
    want = torch.autograd.grad(ops.rope(q, k, pos, chip_smoke.ROPE_THETA, impl="ref"),
                               (q, k), (gq, gk))
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_rope_kernel_takes_strides_and_int64_positions(cuda):
    """q and k as views into wider buffers (heads strided, last dim
    contiguous) and positions int64, transposed: the same bits as the plain
    version on contiguous copies."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    qkv = _randn(gen, (3, 19, 12, 64), torch.bfloat16, cuda)
    q, k = qkv[:, :, :8], qkv[:, :, 8:10]
    pos = torch.randint(0, 131072, (19, 3), generator=gen, device=cuda).t()
    got = ops.rope(q, k, pos, 1e4)
    for g, x in zip(got, (q, k)):
        assert torch.equal(g, apply_rope(x.contiguous(), pos.contiguous(), 1e4))


@pytest.mark.cuda
def test_rope_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((2, 4, 4, 16), device=cuda)
    k = torch.zeros((2, 4, 2, 16), device=cuda)
    pos = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="last dim is not contiguous"):
        trope.rope(q.transpose(2, 3).contiguous().transpose(2, 3), k, pos, 1e4)
    with pytest.raises(ValueError, match="positions"):
        trope.rope(q, k, pos[..., None].expand(2, 4, 3), 1e4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trope.rope(q.half(), k.half(), pos, 1e4)
    with pytest.raises(ValueError, match="odd"):
        trope.rope(q[..., :15], k[..., :15], pos, 1e4)
    with pytest.raises(ValueError, match="CUDA device"):
        trope.rope(q, k.cpu(), pos, 1e4)


@pytest.mark.cuda
def test_smoke_generate_makes_one_rope_launch_a_layer_and_step(cuda, monkeypatch):
    """qwen2-7b at smoke width (fp32, head dim 16) through ``generate``: one
    RoPE launch per layer at prefill and at each decode step, and the tokens
    of the same server with RoPE's plain version in place of the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ModelServer, Request

    cfg = get_config("qwen2-7b").smoke()
    srv = ModelServer(cfg, batch_size=4, cache_len=64, seed=0)
    gen = torch.Generator().manual_seed(0)
    reqs = [Request(i, torch.randint(1, cfg.vocab_size, (20,), generator=gen,
                                     dtype=torch.int32), 6) for i in range(4)]
    launches = trope.KERNEL.launches
    got = srv.generate(reqs)
    torch.cuda.synchronize()
    assert trope.KERNEL.launches - launches == cfg.num_layers * 6
    monkeypatch.setattr(ops, "_rope_kernel",
                        lambda q, k, pos, theta: (apply_rope(q, pos, theta),
                                                  apply_rope(k, pos, theta)))
    launches = trope.KERNEL.launches
    want = srv.generate(reqs)
    assert trope.KERNEL.launches == launches
    assert got == want

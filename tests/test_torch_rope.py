"""RoPE's dispatch seam and its kernel's wrapper, on the CPU.

``ops.rope`` on CPU tensors is the plain version (``models/layers.py``
``apply_rope``) bit for bit; the kernel's backward (the rotation by -angle,
the sine negated) is autograd's gradient through the plain version bit for
bit; the wrapper refuses what the kernel does not take before any launch,
picks its loads and its split of heads from the inputs, keeps its inverse
frequencies, and imports without ``nvcc``; under a mesh the per-shard path
rotates each shard's local tensors at its own rows. (The kernel itself is
held against the plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.) This file imports no JAX.
"""
# ruff: noqa: E402
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops
from repro_torch.kernels import rope as trope
from repro_torch.models.layers import apply_rope, rope_freqs

ROOT = Path(__file__).resolve().parents[1]
DTYPES = [torch.float32, torch.bfloat16]
THETA = 1e6


def _inputs(b, s, h, kvh, d, dtype, hi=131072, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=gen).to(dtype)
    k = torch.randn((b, s, kvh, d), generator=gen).to(dtype)
    pos = torch.randint(0, hi, (b, s), generator=gen, dtype=torch.int32)
    pos[0, 0] = hi - 1  # the highest position, 131,071 by default
    return q, k, pos


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("heads", [(28, 4), (16, 16)], ids=["gqa28-4", "mha16"])
@pytest.mark.parametrize("s", [1, 37])
def test_ops_rope_on_the_cpu_is_the_plain_version(dtype, d, heads, s):
    q, k, pos = _inputs(2, s, *heads, d, dtype)
    got = ops.rope(q, k, pos, THETA)
    for g, x in zip(got, (q, k)):
        assert g.dtype == dtype and torch.equal(g, apply_rope(x, pos, THETA))


def test_impls():
    q, k, pos = _inputs(2, 5, 4, 2, 16, torch.float32)
    got = ops.rope(q, k, pos, THETA, impl="ref")
    assert all(torch.equal(g, apply_rope(x, pos, THETA)) for g, x in zip(got, (q, k)))
    with pytest.raises(ValueError, match="impl 'chunked' not in"):
        ops.rope(q, k, pos, THETA, impl="chunked")
    with pytest.raises(ValueError, match="impl 'pallas' not in"):
        ops.rope(q, k, pos, THETA, impl="pallas")


def _kernel_backward(g, pos, theta):
    """What the kernel's backward computes, in torch's CPU ops: the forward's
    arithmetic with the sine negated."""
    d = g.shape[-1]
    ang = pos[..., None].float() * rope_freqs(d, theta, g.device)
    sin, cos = -torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    g1, g2 = torch.chunk(g.float(), 2, dim=-1)
    return torch.cat([g1 * cos - g2 * sin, g2 * cos + g1 * sin], dim=-1).to(g.dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [(2, 37, 28, 4, 128), (3, 1, 16, 16, 64), (2, 9, 4, 1, 16)])
def test_the_backward_by_minus_angle_is_autograds_to_the_bit(dtype, case):
    q, k, pos = _inputs(*case, dtype)
    q.requires_grad_()
    k.requires_grad_()
    gen = torch.Generator().manual_seed(1)
    gq, gk = (torch.randn(t.shape, generator=gen).to(dtype) for t in (q, k))
    want = torch.autograd.grad(ops.rope(q, k, pos, THETA), (q, k), (gq, gk))
    for g, w in zip((_kernel_backward(gq, pos, THETA), _kernel_backward(gk, pos, THETA)), want):
        assert w.dtype == dtype and torch.equal(g, w)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, pos = _inputs(2, 4, 4, 2, 16, torch.float32)
    with pytest.raises(ValueError, match="q's last dim is not contiguous"):
        trope.rope_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, pos, THETA)
    with pytest.raises(ValueError, match="positions must be"):
        trope.rope_fwd(q, k, pos[..., None].expand(2, 4, 3), THETA)
    with pytest.raises(ValueError, match="positions must be"):
        trope.rope_fwd(q, k, pos.float(), THETA)
    with pytest.raises(ValueError, match="odd"):
        trope.rope_fwd(q[..., :15], k[..., :15], pos, THETA)
    with pytest.raises(ValueError, match=r"are not \(B, S, H, D\)"):
        trope.rope_fwd(q, k[:, :3], pos, THETA)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trope.rope_fwd(q.half(), k.half(), pos, THETA)
    with pytest.raises(ValueError, match="one CUDA device"):
        trope.rope_fwd(q, k, pos, THETA)
    assert trope.KERNEL.launches == 0


def test_loads_and_the_split_of_heads_follow_the_inputs():
    x = torch.zeros((2, 3, 4, 128), dtype=torch.bfloat16)
    assert trope._vec(128, (x,)) == 8
    assert trope._vec(128, (x.float(),)) == 4
    assert trope._vec(10, (x[..., :10].contiguous(),)) == 1  # 5-lane halves
    assert trope._vec(64, (x.view(-1)[1:1 + 2 * 3 * 4 * 64].view(2, 3, 4, 64),)) == 1
    assert trope._vec(128, (x[:, :, 1:3],)) == 8  # a slice of heads keeps 16-byte strides
    # qwen2-7b.rag's prefill (96,000 tokens, 8 threads a head) fills a wave:
    # a thread rotates all 32 heads; its decode (64 rows) splits them to one
    assert trope.heads_a_thread(64 * 1500, 8, 32) == 32
    assert trope.heads_a_thread(64, 8, 32) == 1
    assert trope.heads_a_thread(2048, 4, 40) == 2  # llama3.2-1b training, 8 x 256


def test_the_inverse_frequencies_are_computed_once_and_are_the_plain_ones():
    inv = trope.inv_freqs(128, THETA, torch.device("cpu"))
    assert trope.inv_freqs(128, THETA, torch.device("cpu")) is inv
    assert torch.equal(inv, rope_freqs(128, THETA, "cpu"))


def test_the_module_imports_and_serves_the_cpu_without_nvcc(tmp_path):
    code = ("import torch\n"
            "from repro_torch.kernels import ops, rope\n"
            "q, k = torch.ones(1, 2, 2, 16), torch.ones(1, 2, 1, 16)\n"
            "ops.rope(q, k, torch.zeros(1, 2, dtype=torch.int32), 1e4)\n"
            "assert rope.KERNEL._lib is None and rope.KERNEL.launches == 0\n")
    env = {**os.environ, "PATH": str(tmp_path), "CUDA_HOME": str(tmp_path),
           "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=300)


@pytest.fixture(scope="module")
def host_mesh():
    """The (1, 1) mesh on the CPU, over a world of one that ends with the module."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    started = not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


def test_per_shard_rotates_each_shards_rows(host_mesh):
    """``_rope_per_shard`` on DTensors (batch sharded over "data", heads over
    "model"), through the kernel's wrapper (its plain version on the CPU):
    the values and gradients of the unsharded call; the positions may be a
    plain tensor or a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    q, k, pos = _inputs(2, 5, 4, 2, 16, torch.float32)
    place = [Shard(0), Shard(2)]
    qd, kd = (distribute_tensor(t.clone().requires_grad_(), host_mesh, place) for t in (q, k))
    for p in (pos, distribute_tensor(pos, host_mesh, [Replicate(), Replicate()])):
        got = ops._rope_per_shard(qd, kd, p, THETA)
        assert all(isinstance(g, DTensor) and g.placements == tuple(place) for g in got)
        for g, x in zip(got, (q, k)):
            assert torch.equal(g.full_tensor(), apply_rope(x, pos, THETA))
    gq, gk = torch.randn(q.shape), torch.randn(k.shape)
    (got_q, got_k) = ops._rope_per_shard(qd, kd, pos, THETA)
    grads = torch.autograd.grad((got_q, got_k), (qd, kd),
                                (distribute_tensor(gq, host_mesh, place),
                                 distribute_tensor(gk, host_mesh, place)))
    q0, k0 = q.clone().requires_grad_(), k.clone().requires_grad_()
    want = torch.autograd.grad((apply_rope(q0, pos, THETA), apply_rope(k0, pos, THETA)),
                               (q0, k0), (gq, gk))
    for g, w in zip(grads, want):
        assert torch.equal(g.full_tensor(), w)
    with pytest.raises(ValueError, match="head dim"):
        ops._rope_per_shard(qd, distribute_tensor(k, host_mesh, [Shard(0), Shard(3)]), pos, THETA)

"""The port's dry run (``repro_torch.launch.dryrun``) and what it reads: cells
traced on fake tensors in a fake world, the decode cache sharded by sequence,
and int8 moments over sharded parameters.

* Dry-run cells at smoke width on a fake (2, 2) mesh (a fake process group of
  four started and destroyed by each test): a train, a prefill and a decode
  cell come out OK, with ``argument_bytes_per_device`` equal to the local
  shard bytes the partition rules give, computed here from the specs; a
  quadratic-attention cell at long_500k is SKIP with the reference's reason;
  a cell whose per-rank head dim the CUDA kernels refuse is FAIL with the
  kernels' reason; the depth probes extrapolate to the full-depth count.
* On gloo ranks (``tests/_torch_dist.py``): the plain decode attention with
  the cache sharded by sequence over a 2-wide "model" dim equals the
  unsharded call and the reference's ``decode_attention_ref``; two decode
  steps of a smoke model, whose cache slots fall on either rank, equal the
  unsharded steps; AdamW with int8 moments over a (2, 2) mesh equals the
  unsharded int8 run bit for bit, and ``train_loop(mesh=...,
  quantize_moments=True)`` trains.
"""
import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, _moment_read, adamw_init,  # noqa: E402
                                    adamw_update)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


@pytest.fixture
def mesh22():
    with TD.fake_world(4):
        yield make_mesh((2, 2), ("data", "model"), device="cpu")


def _smoke(arch, **over):
    return dataclasses.replace(TC.get_config(arch).smoke(), **over)


def _local_bytes(tree, specs, mesh, itemsize=None) -> int:
    """Local bytes of each leaf under its spec (at ``itemsize`` bytes an
    element, else its own): every named dim divided by the product of its
    mesh dims' sizes (the rules shard only dims that divide)."""
    total = 0
    for t, spec in zip(tree_leaves(tree), tree_leaves(specs, lambda x: isinstance(x, tuple))):
        n = t.numel()
        for dim, axes in zip(t.shape, spec):
            if axes is not None:
                assert dim % shd.axis_size(mesh, axes) == 0
                n //= shd.axis_size(mesh, axes)
        total += n * (itemsize or t.element_size())
    return total


def _expected_argument_bytes(cfg, shape, mesh) -> int:
    """The step's arguments' local bytes, from the specs alone: parameters
    (with two fp32 moments and the int32 step to train), inputs, caches."""
    kind, specs = TC.input_specs(cfg, shape)
    params = TC.param_specs_struct(cfg)
    pspecs = shd.param_specs(params, mesh, cfg=cfg)
    out = _local_bytes(params, pspecs, mesh)
    b = shape.global_batch
    if kind == "train":
        out += 2 * _local_bytes(params, pspecs, mesh, itemsize=4) + 4
    if kind == "decode":
        inputs = {k: specs[k] for k in ("token", "positions")}
        cache = [{k: v for k, v in layer.items() if k != "pos"} for layer in specs["cache"]]
        return (out + _local_bytes(inputs, shd.batch_specs_tree(inputs, mesh, b), mesh)
                + _local_bytes(cache, shd.cache_specs_tree(cache, mesh, b), mesh))
    batch = specs["batch"]
    return out + _local_bytes(batch, shd.batch_specs_tree(batch, mesh, b), mesh)


@pytest.mark.parametrize("arch, shape_name", [("qwen2-moe-a2.7b", "train_4k"),
                                              ("llama3.2-1b", "prefill_32k"),
                                              ("qwen2-moe-a2.7b", "decode_32k")])
def test_cells_run_on_the_fake_mesh(mesh22, arch, shape_name):
    cfg = _smoke(arch)
    rec = TD.run_cell(arch, shape_name, mesh22, cfg=cfg, probe=False)
    assert rec["status"] == "OK", rec.get("error")
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert rec["argument_bytes_per_device"] == \
        _expected_argument_bytes(cfg, TC.SHAPES[shape_name], mesh22)
    for key in ("flops_per_device", "bytes_per_device", "temp_bytes_per_device",
                "output_bytes_per_device", "model_flops"):
        assert rec[key] > 0, key
    assert math.isfinite(rec["useful_ratio"]) and rec["useful_ratio"] > 0
    assert rec["attention_shapes"]
    if shape_name == "decode_32k":  # the caches are written in place, never gathered
        assert rec["alias_bytes_per_device"] > 0
        assert rec["collectives"]["all-gather"] < rec["alias_bytes_per_device"]


def test_a_quadratic_cell_at_long_500k_is_skipped(mesh22):
    rec = TD.run_cell("llama3.2-1b", "long_500k", mesh22, cfg=_smoke("llama3.2-1b"))
    want = TC.shape_applicable(_smoke("llama3.2-1b"), TC.SHAPES["long_500k"])
    assert (rec["status"], rec["reason"]) == ("SKIP", want[1])


def test_a_head_dim_the_kernels_refuse_fails(mesh22):
    rec = TD.run_cell("llama3.2-1b", "decode_32k", mesh22, cfg=_smoke("llama3.2-1b",
                                                                      head_dim=24))
    assert rec["status"] == "FAIL"
    assert "decode_attention: head dim 24" in rec["error"], rec["error"]


def test_depth_probes_extrapolate_to_the_full_count(mesh22):
    cfg = _smoke("llama3.2-1b", num_layers=5)
    shape = TC.SHAPES["decode_32k"]
    full = TD._costs(TD._trace_step(cfg, shape, mesh22))
    assert TD.probe_costs(cfg, shape, mesh22) == pytest.approx(full, rel=1e-12)


# ---------------------------------------------------------------------------
# gloo ranks: the seq-sharded decode cache, int8 moments over sharded leaves
# ---------------------------------------------------------------------------

# clipping off: the global norm's sum over shards rounds in another order
# than one process's, and a last-ulp change of the clip factor can move an
# int8 code across a rounding boundary; what is held is the quantization of
# sharded leaves (train_loop below runs with the default clip)
INT8 = AdamWConfig(lr=1e-2, quantize_moments=True, grad_clip=0.0)


def _int8_inputs():
    cfg = TC.get_config("qwen2-moe-a2.7b").smoke()
    params = TM.init(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    grads = [tree_map(lambda p: torch.randn(p.shape, generator=gen).to(p.dtype), params)
             for _ in range(3)]
    return {"cfg": cfg, "opt": INT8, "params": params, "grads": grads}


def _decode_inputs():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 8, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 32, 2, 16)).astype(np.float32) for _ in range(2))
    lengths = np.array([32, 19], dtype=np.int32)
    cfg = TC.get_config("llama3.2-1b").smoke()
    params = TM.init(cfg, seed=2, device="cpu")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 15)).astype(np.int32))
    _, cache = TM.prefill(params, cfg, {"tokens": tokens}, 32, impl="ref")
    steps = [(torch.full((2, 1), t, dtype=torch.int32), torch.full((2, 1), p, dtype=torch.int32))
             for t, p in ((5, 15), (7, 16))]  # slots 15 (rank 0's span) and 16 (rank 1's)
    return {"numpy": (q, k, v, lengths),
            "attention": tuple(map(torch.from_numpy, (q, k, v, lengths))),
            "cfg": cfg, "params": params, "cache": cache, "token": tokens, "steps": steps}


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Both jobs at once, each world on a store of its own."""
    inputs = {"int8": _int8_inputs(), "decode": _decode_inputs()}
    work = {job: str(tmp_path_factory.mktemp(job)) for job in ("int8", "seqdecode")}
    for job in work:
        torch.save(inputs, os.path.join(work[job], "port_inputs.pt"))
    procs = {"int8": _torch_dist.start(4, "int8", work["int8"]),
             "seqdecode": _torch_dist.start(2, "seqdecode", work["seqdecode"])}
    for ranks in procs.values():
        _torch_dist.wait(ranks, timeout=300)

    def load(job, n):
        return [torch.load(os.path.join(work[job], f"{job}_rank{r}.pt"), weights_only=False)
                for r in range(n)]

    return inputs, load("int8", 4), load("seqdecode", 2)


def test_seq_sharded_decode_attention(gloo_runs):
    from torch.distributed.tensor import Shard

    inputs, _, ranks = gloo_runs
    q, k, v, lengths = inputs["decode"]["attention"]
    plain = ops.decode_attention(q, k, v, lengths, impl="ref")
    ref = np.asarray(jref.decode_attention_ref(*map(jnp.asarray, inputs["decode"]["numpy"])))
    for out in (r["attention"] for r in ranks):
        assert float((out - plain).abs().max()) < 1e-6
        assert float(np.abs(out.numpy() - ref).max()) < 1e-6
    assert ranks[0]["placements"] == [(Shard(0), Shard(1))]  # batch over data, seq over model


def test_seq_sharded_decode_steps_write_their_own_shard(gloo_runs):
    inputs, _, ranks = gloo_runs
    d = inputs["decode"]
    cache = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, d["cache"])
    want = []
    for token, positions in d["steps"]:
        logits, cache = TM.decode_step(d["params"], d["cfg"], token, positions, cache,
                                       impl="ref")
        want.append(logits)
    for r in ranks:
        for got, w in zip(r["logits"], want):
            assert float((got - w).abs().max()) < 1e-5
        for got, layer, before in zip(r["k"], cache, d["cache"]):
            # slots 15 and 16 written, each by its own rank; nothing else moved
            assert torch.equal(got[:, :15], before["k"][:, :15])
            assert float((got[:, 15:17] - layer["k"][:, 15:17]).abs().max()) < 1e-5
            assert float(got[:, 15:17].abs().min()) > 0
            assert torch.equal(got[:, 17:], before["k"][:, 17:])


def test_int8_moments_over_sharded_parameters(gloo_runs):
    inputs, ranks, _ = gloo_runs
    d = inputs["int8"]
    params, state = d["params"], adamw_init(d["params"], INT8)
    for g in d["grads"]:
        params, state, _ = adamw_update(g, state, params, INT8)
    want = {k: tree_map(lambda p, m: _moment_read(m, p), params, getattr(state, k))
            for k in ("mu", "nu")}
    for r in ranks:
        # bit-equal: each step quantizes the same whole leaves to the same codes
        for got, w in zip(tree_leaves(r["params"]), tree_leaves(params)):
            assert torch.equal(got, w)
        for k in ("mu", "nu"):
            for got, w in zip(tree_leaves(r[k]), tree_leaves(want[k])):
                assert torch.equal(got, w), k
        assert len(r["losses"]) == 2 and all(math.isfinite(x) for x in r["losses"])
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)

"""The port's partition rules (``repro_torch.distributed.sharding``) against
``repro.distributed.sharding``, leaf by leaf.

Every registered config's parameter tree comes from ``jax.eval_shape`` of the
reference's ``init`` (no memory, so arctic-480b and mistral-large-123b cost
nothing) and is laid out as the port keeps it (a list of per-layer dicts
under ``stack/layers``); the production meshes are stand-ins that carry only
dim names and sizes, on both sides. Cache and batch specs are held on the
reference's own cache and input trees.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


class RefMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.zeros(shape)


def _meshes(key):
    names, shape = MESHES[key]
    return RefMesh(names, shape), SimpleNamespace(mesh_dim_names=names, shape=shape)


def _norm(spec):
    """A spec as a tuple, singleton name tuples as the bare name."""
    out = []
    for a in tuple(spec):
        if isinstance(a, (tuple, list)):
            a = tuple(a)
            a = a[0] if len(a) == 1 else a
        out.append(a)
    return tuple(out)


def _shape(x):
    return SimpleNamespace(shape=tuple(x.shape))


def _port_layout(tree, cfg):
    """The reference's parameter tree (of shapes) in the port's layout:
    ``stack/layers`` becomes a list of per-layer dicts, from the scanned
    stack's depth dim or from ``stack/blocks/<i>``."""
    shapes = jax.tree_util.tree_map(_shape, tree)
    if cfg.is_encoder_decoder:
        return shapes
    stack = shapes.pop("stack")
    if "blocks" in stack:
        layers = [stack["blocks"][str(i)] for i in range(cfg.num_layers)]
    else:
        layers = [jax.tree_util.tree_map(lambda s: SimpleNamespace(shape=s.shape[1:]),
                                         stack["layers"])
                  for _ in range(cfg.num_layers)]
    return {**shapes, "stack": {"layers": layers}}


def _ref_specs_in_port_layout(ref_specs, cfg):
    """The reference's spec tree, its depth entries dropped, in the port's layout."""
    if cfg.is_encoder_decoder:
        return ref_specs
    ref_specs = dict(ref_specs)
    stack = ref_specs.pop("stack")
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    if "blocks" in stack:
        layers = [stack["blocks"][str(i)] for i in range(cfg.num_layers)]
    else:
        one = jax.tree_util.tree_map(lambda p: tuple(p)[1:], stack["layers"], is_leaf=is_p)
        layers = [one] * cfg.num_layers
    return {**ref_specs, "stack": {"layers": layers}}


def _pairs(port, ref):
    """(path, port spec, reference spec) over the port tree."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref)
        for k in port:
            for path, a, b in _pairs(port[k], ref[k]):
                yield f"{k}/{path}", a, b
    elif isinstance(port, list):
        assert len(port) == len(ref)
        for i, (a, b) in enumerate(zip(port, ref)):
            for path, x, y in _pairs(a, b):
                yield f"{i}/{path}", x, y
    else:
        yield "", port, ref


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_param_specs_match_the_reference(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    tree = JC.param_specs_struct(jcfg)
    port_tree = _port_layout(tree, tcfg)
    n = 0
    for key in MESHES:
        ref_mesh, port_mesh = _meshes(key)
        for fsdp in (False, True):
            ref = _ref_specs_in_port_layout(JS.param_specs(tree, ref_mesh, fsdp), tcfg)
            got = TS.param_specs(port_tree, port_mesh, fsdp, cfg=tcfg)
            for path, a, b in _pairs(got, ref):
                assert _norm(a) == _norm(b), (arch, key, fsdp, path, a, b)
                n += 1
    assert n > 0


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_port_layout_is_the_ports_tree(arch):
    """The layout the rules are held on is the port's own tree: at smoke width
    the port's ``init`` has the same leaves, paths and shapes."""
    jcfg, tcfg = JC.get_config(arch).smoke(), TC.get_config(arch).smoke()
    want = _port_layout(JC.param_specs_struct(jcfg), tcfg)
    got = TM.init(tcfg, seed=0, device="cpu")
    for path, a, b in _pairs(got, want):
        assert tuple(a.shape) == tuple(b.shape), (arch, path)


def test_stacked_rule_reads_the_reference_path():
    """A port per-layer leaf is translated before the rule reads it: read as
    it is, ``stack/layers/0/attn/wo/w`` would be taken for a scanned leaf, its
    first dim dropped, and its input dim left unsharded."""
    _, mesh = _meshes("16x16")
    cfg = TC.get_config("qwen2-7b")
    leaf = {"stack": {"layers": [{"attn": {"wo": {"w": SimpleNamespace(shape=(3584, 3584))}}}]}}
    spec = TS.param_specs(leaf, mesh, cfg=cfg)["stack"]["layers"][0]["attn"]["wo"]["w"]
    assert spec == ("model", None)
    naive = TS._param_spec(mesh, "stack/layers/0/attn/wo/w", (3584, 3584), False)
    assert naive == (None, None)  # the silent misread the translation avoids
    with pytest.raises(ValueError, match="cfg"):
        TS.param_specs(leaf, mesh)


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_cache_and_batch_specs_match_the_reference(arch):
    jcfg = JC.get_config(arch)
    b, s = 32, 4096
    cache = JC.cache_specs(jcfg, b, s)
    batch = JC.batch_specs(jcfg, b, s, with_labels=True)
    for key in MESHES:
        ref_mesh, port_mesh = _meshes(key)
        is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)
        for tree, ref_fn, port_fn in ((cache, JS.cache_specs_tree, TS.cache_specs_tree),
                                      (batch, JS.batch_specs_tree, TS.batch_specs_tree)):
            ref = jax.tree_util.tree_leaves(ref_fn(tree, ref_mesh, b), is_leaf=is_p)
            plain = jax.tree_util.tree_map(_shape, tree)
            got = jax.tree_util.tree_leaves(port_fn(plain, port_mesh, b),
                                            is_leaf=lambda x: isinstance(x, tuple))
            assert len(got) == len(ref) > 0
            for a, r in zip(got, ref):
                assert _norm(a) == _norm(r), (arch, key, a, r)


@pytest.mark.parametrize("batch", [256, 16, 1])
def test_batch_spec_drops_pod_first(batch):
    ref_mesh, port_mesh = _meshes("2x16x16")
    assert _norm(TS.batch_spec(port_mesh, batch, 1)) == _norm(JS.batch_spec(ref_mesh, batch, 1))


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    _, mesh = _meshes("2x16x16")
    assert TS.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert TS.to_placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="two tensor dims"):
        TS.to_placements(("model", "model"), mesh)
    cfg = TC.get_config("llama3.2-1b")
    tree = {"embed": {"w": SimpleNamespace(shape=(128256, 2048))}}
    assert TS.param_shardings(tree, mesh, cfg=cfg) == {"embed": {"w": (Replicate(), Replicate(),
                                                                      Shard(1))}}


@pytest.mark.parametrize("heads,kv_heads,size", [(32, 8, 4), (32, 8, 16), (4, 1, 2),
                                                (12, 3, 2), (12, 4, 3)])
def test_each_shard_reads_its_own_kv_heads(heads, kv_heads, size):
    """A head shard's call on its q heads and the kv heads
    ``kv_heads_of_shard`` gathers equals those heads of the whole call: the
    kernel's GQA map pairs each local q head with its own kv head, whether
    the shard's heads split into whole groups or not."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(heads + size)
    q = torch.randn(2, 8, heads, 16, generator=g)
    k, v = (torch.randn(2, 8, kv_heads, 16, generator=g) for _ in "kv")
    want = ref.attention_ref(q, k, v, causal=True)
    local = heads // size
    for r in range(size):
        idx = torch.tensor(ops.kv_heads_of_shard(heads, kv_heads, r, size))
        got = ref.attention_ref(q[:, :, r * local:(r + 1) * local], k.index_select(2, idx),
                                v.index_select(2, idx), causal=True)
        torch.testing.assert_close(got, want[:, :, r * local:(r + 1) * local], rtol=0, atol=0)


def test_constrain_is_the_identity_unmeshed():
    x = torch.ones(4, 8)
    assert TS.active_mesh() is None
    assert TS.constrain(x, ("pod", "data"), "model") is x
    assert TS.constrain_batch(x) is x

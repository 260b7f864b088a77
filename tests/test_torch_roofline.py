"""The port's shape cells, input specs and roofline analyzer (``repro_torch.configs``,
``repro_torch.launch.roofline``) against the reference's (``repro.configs``,
``repro.launch.roofline``).

The arithmetic is held equal: ``SHAPES``, ``shape_applicable``, ``all_cells``,
every applicable cell's input specs leaf for leaf, ``active_param_count`` of
every registered config at full width (on shape-only trees, nothing
allocated), ``model_flops``, ``probe_extrapolate`` and ``analyze``'s terms
on the reference's chip constants. The per-device counting has no reference
(the reference reads XLA): it is held on cases whose answer is known, in a
fake world of four ranks.
"""
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from types import SimpleNamespace  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_sharding import _port_layout  # noqa: E402

DTYPES = {torch.bfloat16: np.dtype(jax.numpy.bfloat16), torch.float32: np.dtype(np.float32),
          torch.int32: np.dtype(np.int32)}


def test_shape_cells_match_the_reference():
    assert {k: vars(v) for k, v in TC.SHAPES.items()} == \
        {k: vars(v) for k, v in JC.SHAPES.items()}
    assert TC.all_cells() == JC.all_cells()
    assert TC.VISION_TOKENS == JC.VISION_TOKENS
    for arch in JC.ARCHS:
        jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
        assert tcfg.is_subquadratic() == jcfg.is_subquadratic()
        assert tcfg.has_decode() == jcfg.has_decode()
        for s in JC.SHAPES:
            assert TC.shape_applicable(tcfg, TC.SHAPES[s]) == \
                JC.shape_applicable(jcfg, JC.SHAPES[s])


def _spec(x):
    """(shape, numpy dtype) of a port meta tensor, a reference ShapeDtypeStruct,
    or the port's Python cache position (the reference's int32 scalar)."""
    if isinstance(x, int):
        return (), np.dtype(np.int32)
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), DTYPES[x.dtype]
    return tuple(x.shape), np.dtype(x.dtype)


def _cache_in_port_layout(ref_cache, cfg):
    """The reference's decode cache (a scanned stack's leaves with a leading
    depth dim, or one entry a layer) in the port's list of per-layer dicts,
    through the parameter trees' translation: shapes only."""
    if cfg.is_encoder_decoder:
        return _port_layout(ref_cache, cfg)
    stack = ({"layers": ref_cache} if isinstance(ref_cache, dict)
             else {"blocks": {str(i): c for i, c in enumerate(ref_cache)}})
    return _port_layout({"stack": stack}, cfg)["stack"]["layers"]


def _compare(port, ref, where):
    """Leaf for leaf: shapes, and dtypes where ``ref`` has them."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), where
        for k in port:
            _compare(port[k], ref[k], f"{where}/{k}")
    elif isinstance(port, list):
        assert len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            _compare(a, b, f"{where}/{i}")
    elif hasattr(ref, "dtype"):
        assert _spec(port) == _spec(ref), where
    else:
        assert _spec(port)[0] == tuple(ref.shape), where


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_input_specs_match_the_reference(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    n = 0
    for name, shape in JC.SHAPES.items():
        if not JC.shape_applicable(jcfg, shape)[0]:
            with pytest.raises(ValueError, match="skipped"):
                TC.input_specs(tcfg, TC.SHAPES[name])
            continue
        jkind, jspecs = JC.input_specs(jcfg, shape)
        tkind, tspecs = TC.input_specs(tcfg, TC.SHAPES[name])
        assert tkind == jkind
        if "cache" in jspecs:
            ref, port = jspecs.pop("cache"), tspecs.pop("cache")
            _compare(port, _cache_in_port_layout(ref, tcfg), f"{arch}/{name}/cache")
            # dtypes in flattening order: a scanned stack's keys repeat a layer
            ref_dt = [np.dtype(x.dtype) for x in jax.tree_util.tree_leaves(ref)]
            port_dt = [_spec(x)[1] for x in tree_leaves(port)]
            assert port_dt == ref_dt * (tcfg.num_layers if isinstance(ref, dict) else 1)
        _compare(tspecs, jspecs, f"{arch}/{name}")
        n += 1
    assert n >= 3


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_active_param_count_matches_the_reference(arch):
    """On the full-width trees, which neither side allocates: the port's
    leaves are meta tensors."""
    tree = TC.param_specs_struct(TC.get_config(arch))
    leaves = tree_leaves(tree)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    want = JR.active_param_count(JC.param_specs_struct(JC.get_config(arch)))
    assert TR.active_param_count(tree) == want


def test_param_specs_struct_is_the_tree_init_builds():
    from repro_torch.models import model as TM

    cfg = TC.get_config("qwen2-moe-a2.7b").smoke()
    got, want = TC.param_specs_struct(cfg), TM.init(cfg, device="cpu")
    assert [(tuple(a.shape), a.dtype) for a in tree_leaves(got)] == \
        [(tuple(b.shape), b.dtype) for b in tree_leaves(want)]


# the cases of tests/test_roofline_sharding.py
@pytest.mark.parametrize("c1, c2, period, layers", [
    ((16.0, 16.0, 16.0), (22.0, 22.0, 22.0), 2, 10),
    ((1e12, 3e9, 5e8), (1.5e12, 4e9, 9e8), 8, 12),
    ((5.0, 5.0, 5.0), (4.0, 1.0, 5.0), 1, 30),
])
def test_probe_extrapolate_matches_the_reference(c1, c2, period, layers):
    assert TR.probe_extrapolate(c1, c2, period, layers) == \
        JR.probe_extrapolate(c1, c2, period, layers)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_matches_the_reference(kind):
    cfg = SimpleNamespace(num_experts=0)
    shape = SimpleNamespace(global_batch=8, seq_len=128, kind=kind)
    assert TR.model_flops(cfg, shape, 1_000_000) == JR.model_flops(cfg, shape, 1_000_000)


@pytest.mark.parametrize("arch, shape_name", [("qwen2-moe-a2.7b", "train_4k"),
                                              ("llama3.2-1b", "decode_32k"),
                                              ("arctic-480b", "prefill_32k")])
def test_analyze_matches_the_reference_on_its_chip(arch, shape_name):
    """The same FLOPs, bytes and collective bytes through both analyzers,
    the port's on the reference's chip record."""
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    flops, byts, coll = 3.1e14, 2.7e12, 4.4e10
    kw = dict(arch=arch, shape_name=shape_name, mesh_name="16x16", chips=256,
              flops=flops, byts=byts, coll=coll)
    want = JR.analyze(cfg=jcfg, shape=JC.SHAPES[shape_name],
                      params_tree=JC.param_specs_struct(jcfg), **kw)
    got = TR.analyze(cfg=tcfg, shape=TC.SHAPES[shape_name],
                     params_tree=TC.param_specs_struct(tcfg), chip=TR.REFERENCE_CHIP, **kw)
    assert got.bottleneck == want.bottleneck
    for field in ("compute_s", "memory_s", "collective_s", "model_flops", "useful_ratio"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=1e-12)
    assert set(got.as_dict()) == set(want.as_dict())
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.ICI_BW) == (JR.PEAK_FLOPS, JR.HBM_BW, JR.ICI_BW)


def test_analyze_defaults_to_the_card():
    cfg = TC.get_config("llama3.2-1b")
    rep = TR.analyze(arch=cfg.name, shape_name="train_4k", mesh_name="1x1", chips=1, cfg=cfg,
                     shape=TC.SHAPES["train_4k"], params_tree=TC.param_specs_struct(cfg),
                     flops=989e12, byts=3.35e12, coll=0.0,
                     memory={"argument_bytes_per_device": 10, "temp_bytes_per_device": 20,
                             "output_bytes_per_device": 5})
    assert rep.compute_s == rep.memory_s == 1.0
    assert rep.memory_lb_s == 35 / TR.H100.hbm_bw
    assert math.isclose(rep.memory_per_device_gb, 30e-9)


# ---------------------------------------------------------------------------
# per-device counts below DTensor, in a fake world of four ranks
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh4():
    from torch.distributed.device_mesh import init_device_mesh

    with TD.fake_world(4):
        yield init_device_mesh("cpu", (4,), mesh_dim_names=("model",))


def _fake_dtensor(mesh, shape, placement, dtype=torch.float32):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.empty(shape, dtype=dtype), mesh, [placement])


def test_a_column_sharded_product_counts_its_shard(mesh4):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    global_flops = 2 * 256 * 1024 * 512
    with FakeTensorMode():
        a = _fake_dtensor(mesh4, (256, 1024), Replicate())
        for placement, share in ((Shard(1), 4), (Replicate(), 1), (Shard(1), 4)):
            w = _fake_dtensor(mesh4, (1024, 512), placement)
            with TR.count_step((a, w)) as c:
                y = a @ w
            assert c.flops == global_flops // share, placement
            assert c.collective_bytes == 0
            mem = c.memory((a, w), y)
            assert mem["argument_bytes_per_device"] == (256 * 1024 + 1024 * 512 // share) * 4
            assert mem["output_bytes_per_device"] == mem["temp_bytes_per_device"] == \
                256 * 512 // share * 4
            assert mem["alias_bytes_per_device"] == 0


def test_a_gather_counts_its_result_bytes(mesh4):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    with FakeTensorMode():
        x = _fake_dtensor(mesh4, (256, 1024), Shard(0), torch.bfloat16)
        with TR.count_step(x) as c:
            full = x.redistribute(mesh4, [Replicate()])
        assert c.collective == {"all-gather": 256 * 1024 * 2, "all-reduce": 0,
                                "reduce-scatter": 0, "all-to-all": 0}
        assert c.flops == 0
        assert c.memory(x, full)["argument_bytes_per_device"] == 64 * 1024 * 2


def test_an_in_place_write_is_an_alias(mesh4):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard

    with FakeTensorMode():
        x = _fake_dtensor(mesh4, (8, 64), Shard(1))
        with TR.count_step(x) as c:
            x.mul_(2.0)
        assert c.memory(x, x) == {"argument_bytes_per_device": 8 * 16 * 4,
                                  "temp_bytes_per_device": 0,
                                  "output_bytes_per_device": 8 * 16 * 4,
                                  "alias_bytes_per_device": 8 * 16 * 4}

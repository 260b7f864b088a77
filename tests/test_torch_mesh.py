"""The port's mesh (``launch/mesh.py``, ``distributed/sharding.py``) and the paths
it shards, held against the reference's sharded runs.

One module fixture starts, side by side, the reference's runs on a forced
four-device CPU platform (``tests/_jax_mesh.py``, a process of its own) and
four gloo ranks of the port (``tests/_torch_dist.py``) on a (data 2, model 2)
mesh, from the same initial states and batches (the reference's, carried
over). Held:

* llama3.2-1b and qwen2-moe-a2.7b (``act_shard="seq"``, expert parallel) at
  smoke width, and llama3.2-1b with one kv head, 3 steps of 4 x 32: losses
  at rtol 1e-5, parameters at 1e-4, every rank's losses equal;
* expert parallel with padded experts (6 on a 4-wide "model" dim) through
  the DTensor path, against the reference's ``shard_map``; and at model 3 the
  rank-order sum of ``ep_shard``, which pins ROADMAP C.7: its capacity over
  the padded count drops pairs ``moe_apply`` keeps at cf 1.25, not at cf 16;
* ``compressed_psum`` over two ranks against the reference's over two
  devices;
* checkpoints across meshes, both ways.

In this process: every arch trains on the (1, 1) host mesh as it does
un-meshed, and the batched engine splits its rows over two devices.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.tokens import TokenPipeline as JaxPipeline  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.step import init_train_state as jax_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ExperimentSpec, run  # noqa: E402
from repro_torch.core import experiment as TX  # noqa: E402
from repro_torch.core import genetic as TGA  # noqa: E402
from repro_torch.dcsim import env as TE  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TRAIN = {"llama": ("llama3.2-1b", {}), "qwen2moe": ("qwen2-moe-a2.7b", {}),
         "gqa1": ("llama3.2-1b", {"num_kv_heads": 1})}
EP = {"m3_cf1.25": (8, 3, 1.25), "m3_cf16": (8, 3, 16.0), "m4_e6": (6, 4, 1.25)}
CKPT_KW = dict(arch="llama3.2-1b", batch=4, seq=32, save_every=2, log_every=100,
               device="cpu")


def _ep_cfg(experts, which=get_config):
    return dataclasses.replace(which("qwen2-moe-a2.7b").smoke(), num_experts=experts)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference's sharded runs and the port's four ranks together;
    return (reference results, each rank's results, the inputs)."""
    work = str(tmp_path_factory.mktemp("mesh"))
    ref_in = {"ep_cases": EP, "ep_params": {}, "psum_x": None}
    port_in = {"train": {}, "ep": {}}
    for name, (arch, over) in TRAIN.items():
        jcfg = dataclasses.replace(jax_get_config(arch).smoke(), **over)
        tcfg = dataclasses.replace(get_config(arch).smoke(), **over)
        state = jax_init(jax.random.PRNGKey(0), jcfg, JaxAdamWConfig(lr=1e-3))
        pipe = JaxPipeline(jcfg, seed=1, batch=4, seq=32)
        batches = [_t(jax.tree_util.tree_map(np.asarray, pipe.next())) for _ in range(3)]
        port_state = convert.train_state_from_jax(jax.tree_util.tree_map(np.asarray, state),
                                                  tcfg, device="cpu")
        port_in["train"][name] = (tcfg, port_state, batches)
    x = np.random.default_rng(5).normal(size=(4, 16, 64)).astype(np.float32)
    ref_in["ep_x"] = x
    for experts in (8, 6):
        ref_in["ep_params"][experts] = jax.tree_util.tree_map(
            np.asarray, jmoe.moe_init(jax.random.PRNGKey(3), _ep_cfg(experts, jax_get_config)))
    port_in["ep"]["m4_e6"] = (_ep_cfg(6), _t(ref_in["ep_params"][6]), torch.from_numpy(x), 1.25)
    port_in["ep8"] = _t(ref_in["ep_params"][8])
    ref_in["psum_x"] = np.random.default_rng(6).normal(size=(300,)).astype(np.float32)
    port_in["psum_x"] = torch.from_numpy(ref_in["psum_x"])
    port_in["ckpt_from_one"] = os.path.join(work, "from_one")
    port_in["ckpt_to_one"] = os.path.join(work, "to_one")
    # a one-process checkpoint at step 2, which the mesh resumes
    train_loop(steps=2, ckpt_dir=port_in["ckpt_from_one"], **CKPT_KW)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(ref_in, f)
    torch.save(port_in, os.path.join(work, "port_inputs.pt"))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"), os.environ.get("PYTHONPATH", "")]))
    ref_proc = subprocess.Popen([sys.executable, os.path.join(HERE, "_jax_mesh.py"), work],
                                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        _torch_dist.wait(_torch_dist.start(4, "mesh4", work), timeout=400)
        _, err = ref_proc.communicate(timeout=400)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    assert ref_proc.returncode == 0, err.decode(errors="replace")[-3000:]
    with open(os.path.join(work, "reference.pkl"), "rb") as f:
        ref = pickle.load(f)
    ranks = [torch.load(os.path.join(work, f"mesh4_rank{r}.pt"), weights_only=False)
             for r in range(4)]
    return ref, ranks, port_in


@pytest.mark.parametrize("case", list(TRAIN))
def test_mesh_training_matches_the_reference(runs, case):
    ref, ranks, port_in = runs
    want, got = ref[f"train/{case}"], ranks[0][f"train/{case}"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    cfg = port_in["train"][case][0]
    want_p = convert.params_from_jax(want["params"], cfg, device="cpu")
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(want_p)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4
    for r in ranks[1:]:  # every rank reads the same loss
        assert r[f"train/{case}"]["losses"] == got["losses"]


def test_expert_parallel_with_padded_experts_matches_the_reference(runs):
    ref, ranks, _ = runs
    y, aux = ranks[0]["ep/m4_e6"]
    want_y, want_aux = ref["ep/m4_e6"]
    np.testing.assert_allclose(y.numpy(), want_y, atol=2e-6)
    assert abs(aux - want_aux) <= 1e-6


@pytest.mark.parametrize("cf", [1.25, 16.0])
def test_ep_capacity_over_padded_experts(runs, cf):
    """ROADMAP C.7: at model 3 the 8 experts pad to 9 and the capacity is
    sized over 9. The rank-order sum of ``ep_shard`` is the reference's
    padded ``shard_map`` output; at cf 1.25 it drops pairs ``moe_apply``
    keeps (largest gap ~0.72), at cf 16 nothing drops and the two agree."""
    ref, _, port_in = runs
    cfg = _ep_cfg(8)
    p, x = port_in["ep8"], port_in["ep"]["m4_e6"][2]
    y = sum(tmoe.ep_shard(p, cfg, x, r, 3, capacity_factor=cf)[0] for r in range(3))
    y = y + tmoe.mlp_apply(p["shared"], cfg, x)
    want_y, _ = ref[f"ep/m3_cf{cf:g}"]
    np.testing.assert_allclose(y.numpy(), want_y, atol=2e-6)
    gap = float((y - tmoe.moe_apply(p, cfg, x, capacity_factor=cf)[0]).abs().max())
    if cf == 1.25:
        assert gap > 0.1
    else:
        assert gap < 1e-5


def test_compressed_psum_matches_the_reference(runs):
    ref, ranks, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["psum"].numpy(), ref["psum"], rtol=1e-6, atol=1e-7)


def test_checkpoints_cross_meshes(runs, tmp_path):
    """The mesh resumed a one-process checkpoint, and one process resumes
    the mesh's: both continue as a run that never stopped."""
    _, ranks, port_in = runs
    whole = train_loop(steps=4, **CKPT_KW)["losses"]
    np.testing.assert_allclose(ranks[0]["resumed"], whole[2:], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["written"], whole[:2], rtol=1e-5)
    resumed = train_loop(steps=4, ckpt_dir=port_in["ckpt_to_one"], **CKPT_KW)["losses"]
    np.testing.assert_allclose(resumed, whole[2:], rtol=1e-5)


@pytest.mark.parametrize("arch", _torch_dist.WIDE_ARCHS)
def test_other_archs_train_on_the_wide_mesh(runs, arch):
    """The hybrids (their recurrences run on each rank's rows), the
    encoder-decoder and M-RoPE, 2 steps on the
    (2, 2) mesh against one process."""
    _, ranks, _ = runs
    want = train_loop(arch=arch, steps=2, batch=4, seq=16, log_every=100,
                      device="cpu")["losses"]
    for r in ranks:
        np.testing.assert_allclose(r[f"wide/{arch}"], want, rtol=1e-5)


# ---------------------------------------------------------------------------
# in this process: the (1, 1) host mesh, and the batched engine's split
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_mesh():
    """The (1, 1) mesh on the CPU, over a world of one that ends with the module."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    mesh = mesh_lib.make_host_mesh(device="cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_on_the_host_mesh_is_unmeshed(host_mesh, arch):
    kw = dict(arch=arch, steps=2, batch=2, seq=16, log_every=100, device="cpu")
    plain, meshed = train_loop(**kw), train_loop(mesh=host_mesh, **kw)
    np.testing.assert_allclose(meshed["losses"], plain["losses"], rtol=1e-6)
    for a, b in zip(tree_leaves(meshed["state"].params), tree_leaves(plain["state"].params)):
        assert shd.is_dtensor(a)
        np.testing.assert_allclose(a.full_tensor().numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_a_production_mesh_needs_its_world(host_mesh):
    with pytest.raises(ValueError, match="256 ranks; this world has 1"):
        mesh_lib.make_production_mesh(device="cpu")


@pytest.mark.parametrize("technique", ["fd", "ga"])
def test_batched_rows_split_over_devices(technique):
    """Three rows over two devices: padded to four with a copy of the last
    row, each half run alone, the pad dropped; equal to ``shard=False``."""
    envs = [TE.build_env(4, seed=s, device="cpu") for s in range(3)]
    cfg = TGA.GAConfig(population=8, generations=12) if technique == "ga" else None
    spec = ExperimentSpec(technique=technique, hours=2, engine="batched", cfg=cfg)
    want = run(spec, envs)
    got = TX._run_batched(spec, envs, None, True, devices=["cpu", "cpu"])
    for k, v in want["per_epoch"].items():
        assert got["per_epoch"][k].shape == v.shape == (3, 2)
        np.testing.assert_array_equal(got["per_epoch"][k], v, err_msg=k)

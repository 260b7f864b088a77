"""The reference's sharded runs for ``tests/test_torch_mesh.py``, in a process of
its own: JAX on a forced four-device CPU platform (the flag must be set before
JAX starts, so it cannot share the test process).

    python tests/_jax_mesh.py WORKDIR

reads ``WORKDIR/inputs.pkl`` (the parent's numpy inputs) and writes
``WORKDIR/reference.pkl``:

* ``train/<case>``: the losses and final parameters of ``repro.launch.train.
  train_loop`` on a (data 2, model 2) mesh, 3 steps of 4 x 32 (llama3.2-1b
  and qwen2-moe-a2.7b at smoke width; llama3.2-1b with one kv head);
* ``ep/<model>/<cf>``: ``moe_apply_ep`` of a qwen2-moe smoke layer under a
  (1, model) mesh, its experts padded to a multiple of ``model``;
* ``psum``: ``compressed_psum`` over a two-device "pod" mesh.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.distributed import sharding as shd  # noqa: E402
from repro.launch import mesh as mesh_lib  # noqa: E402
from repro.launch import train as train_lib  # noqa: E402
from repro.models import moe  # noqa: E402
from repro.optim.grad_compress import compressed_psum  # noqa: E402

TRAIN = {"llama": ("llama3.2-1b", {}), "qwen2moe": ("qwen2-moe-a2.7b", {}),
         "gqa1": ("llama3.2-1b", {"num_kv_heads": 1})}


def _mesh(shape, names, n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def train_case(arch, overrides):
    build = train_lib.build

    def patched(arch_, smoke, lr, quantize_moments):
        cfg, opt_cfg = build(arch_, smoke, lr, quantize_moments)
        return dataclasses.replace(cfg, **overrides), opt_cfg

    train_lib.build = patched
    try:
        res = train_lib.train_loop(arch=arch, steps=3, batch=4, seq=32, log_every=100,
                                   mesh=mesh_lib._mesh((2, 2), ("data", "model")))
    finally:
        train_lib.build = build
    return {"losses": res["losses"],
            "params": jax.tree_util.tree_map(np.asarray, res["state"].params)}


def main(workdir):
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {f"train/{name}": train_case(*case) for name, case in TRAIN.items()}

    for key, (experts, model, cf) in inputs["ep_cases"].items():
        cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").smoke(), num_experts=experts)
        p = jax.tree_util.tree_map(jax.numpy.asarray, inputs["ep_params"][experts])
        x = jax.numpy.asarray(inputs["ep_x"])
        with shd.use_mesh(_mesh((1, model), ("data", "model"), model)):
            y, aux = jax.jit(lambda p, x: moe.moe_apply_ep(p, cfg, x, capacity_factor=cf))(p, x)
        out[f"ep/{key}"] = (np.asarray(y), float(aux))

    pod = _mesh((2,), ("pod",), 2)
    out["psum"] = np.asarray(compressed_psum(jax.numpy.asarray(inputs["psum_x"]), pod, "pod"))
    with open(os.path.join(workdir, "reference.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])

"""Mesh definitions: the reference's production and host meshes as DeviceMeshes.

The port of ``repro.launch.mesh``. The single-pod mesh is 16 x 16 = 256
cards, dims ("data", "model"); the multi-pod mesh adds a leading "pod" dim,
2 x 16 x 16 = 512. Dim roles:

  pod   -- pure data parallelism across pods (the gradient compression path,
           ``optim/grad_compress.py``, targets it),
  data  -- data parallelism (+ FSDP parameter storage, flag-gated),
  model -- tensor / expert parallelism.

A mesh is built over the default process group, which the caller starts
(``torch.distributed.init_process_group`` with its own address, world size
and rank): a production mesh needs a world of exactly its size. The host
mesh is (1, 1) on one device; with no process group it starts a world of
one on an in-memory store (NCCL on the card, gloo on the CPU).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from ..models.model import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(shape: Sequence[int], names: Sequence[str], *, device="cuda"):
    """A DeviceMesh of ``shape`` with dim ``names`` over the default process
    group, on the card unless the caller asks for the CPU; raises unless the
    world's size is the mesh's."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    size = math.prod(shape)
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(f"a {tuple(shape)} mesh needs a process group of {size} ranks; "
                               "none is started")
        dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"a {tuple(shape)} mesh needs a world of {size} ranks; "
                         f"this world has {world}")
    if device.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape, names = PRODUCTION[multi_pod]
    return make_mesh(shape, names, device=device)


def make_host_mesh(device="cuda"):
    """The (1, 1) ("data", "model") mesh on one device."""
    return make_mesh((1, 1), ("data", "model"), device=device)

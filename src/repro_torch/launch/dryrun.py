"""Multi-pod dry run (the port of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell: start a fake world of the
mesh's size in this process, build the production mesh (16 x 16 single pod /
2 x 16 x 16 multi-pod, ``launch/mesh.py``), place fake parameters, optimizer
state, batch and caches by the partition rules (``distributed/sharding.py``
``param_shardings`` / ``place_cache``, ``launch/train.py`` ``shard_batch``),
run the right step function (``train_step`` / ``prefill_step`` /
``decode_step``) once, and record what one rank does: its FLOPs, bytes and
collective bytes and its memory (``launch/roofline.py`` ``StepCounter``),
and the roofline terms.

Nothing is allocated and no kernel runs. Every tensor is a fake tensor
(``FakeTensorMode``: shapes, dtypes and devices, no storage), and the fake
process group (``torch.testing._internal.distributed.fake_pg``, a private
torch module) returns from every collective at once. Rank 0 runs its part of
the step; DTensor gives it its local shards. The attention layers take the
plain path (``impl="chunked"`` for full sequences, ``"ref"`` for decode), as
the reference's ``impl="auto"`` does off the TPU: fake tensors have no data
for the CUDA kernels. Each attention call's per-rank shape is held to the
kernels' limits instead (``kernels/_build.py`` ``shape_error``: head dims,
the grid's y limit; the backward kernel's are the forward's): a cell the
kernels would refuse is a ``FAIL`` with the reason.

Memory per device, under the reference's ``memory_analysis()`` keys:

* ``argument_bytes_per_device``: the local shard bytes of the step's
  arguments (state, or parameters, inputs and caches), exactly;
* ``temp_bytes_per_device``: the peak of the live bytes of the local tensors
  the step creates, above its arguments (storages tracked as each local op
  returns them, freed when the last reference goes);
* ``output_bytes_per_device``: the local bytes of what the step returns;
* ``alias_bytes_per_device``: the part of those that are the arguments' own
  storage, updated in place (the decode caches; a train step returns a new
  state, where the reference donates the old one).

The FLOP and byte counts come from torch's op counts, not from a compiler:
they are not comparable with the reference's (``launch/roofline.py``).
Importing this module starts no process group and sets no environment
variable: the fake world starts inside :func:`run_cells`.

Usage:
    python -m repro_torch.launch.dryrun --all [--multipod | --multipod-too] [--out DIR] \\
        [--no-probe]
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --multipod
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import ARCHS, SHAPES, get_config, input_specs
from ..configs.base import ModelConfig, ShapeConfig, shape_applicable
from ..distributed import sharding as shd
from ..kernels import _build, ops
from ..models import model as model_lib
from ..optim.adamw import AdamWConfig, OptState
from ..train import step as step_lib
from ..tree import tree_map
from . import roofline
from .mesh import make_production_mesh
from .train import shard_batch

FSDP_THRESHOLD = 5_000_000_000  # params; larger models shard storage over "data"


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    # 480B params + f32 moments exceed one pod's HBM: store moments in bf16.
    if cfg.param_count() > 3e11:
        return AdamWConfig(moment_dtype="bfloat16")
    return AdamWConfig()


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks in this process, as rank 0: its
    collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake world; this process already "
                           "has a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _replicated(mesh):
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def state_shardings(params, mesh, fsdp: bool, cfg: ModelConfig) -> step_lib.TrainState:
    """The placements of a train state: the parameters and both moments by
    the partition rules (``fsdp``: storage also over "data"), ``step``
    replicated. (``opt_config_for`` never picks int8 moments.)"""
    pl = shd.param_shardings(params, mesh, fsdp, cfg=cfg)
    return step_lib.TrainState(params=pl, opt=OptState(step=_replicated(mesh), mu=pl, nu=pl))


def _place(tree, placements, mesh):
    """Distribute the tensors of ``tree`` (the same on every rank) by a
    mirroring tree of placement tuples."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=None),
                    tree, placements)


def _materialize(specs):
    """Fake zeros of the specs' shapes and dtypes (inside ``FakeTensorMode``);
    a cache's Python ``pos`` as it is."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype)
                    if isinstance(s, torch.Tensor) else s, specs)


@dataclasses.dataclass
class Trace:
    """What one traced step gave: its kind, the parameter tree (fake), the
    per-device counts, the memory record and the attention calls' shapes."""
    kind: str
    params: Any
    counter: roofline.StepCounter
    memory: Dict[str, int]
    attention: list


def _trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Trace:
    """Run one step function on fake tensors placed on ``mesh``, counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fsdp = cfg.param_count() >= FSDP_THRESHOLD
    kind, specs = input_specs(cfg, shape)
    with FakeTensorMode(), shd.use_mesh(mesh):
        if kind == "train":
            opt_cfg = opt_config_for(cfg)
            state = step_lib.init_train_state(cfg, opt_cfg, device="cpu")
            state = _place(state, state_shardings(state.params, mesh, fsdp, cfg), mesh)
            params, batch = state.params, shard_batch(_materialize(specs["batch"]), mesh)
            args = (state, batch)

            def run():
                return step_lib.train_step(state, batch, cfg=cfg, opt_cfg=opt_cfg,
                                           impl="chunked")
        else:
            params = model_lib.init(cfg, device="cpu")
            params = _place(params, shd.param_shardings(params, mesh, fsdp, cfg=cfg), mesh)
            if kind == "prefill":
                batch = shard_batch(_materialize(specs["batch"]), mesh)
                args = (params, batch)

                def run():
                    return step_lib.prefill_step(params, batch, cfg=cfg,
                                                 cache_len=shape.seq_len, impl="chunked")
            else:
                inputs = shard_batch(_materialize({"token": specs["token"],
                                                   "positions": specs["positions"]}), mesh)
                cache = shd.place_cache(_materialize(specs["cache"]), shape.global_batch)
                args = (params, inputs, cache)

                def run():
                    return step_lib.decode_step(params, inputs["token"], inputs["positions"],
                                                cache, cfg=cfg, impl="ref")
        with ops.record_calls() as calls, roofline.count_step(args) as counter:
            out = run()
        memory = counter.memory(args, out)
        del out
    return Trace(kind, params, counter, memory, calls)


def kernel_refusals(trace: Trace) -> list:
    """Why the CUDA kernels would refuse the traced step's attention calls
    (one reason per distinct shape); empty when they take every call."""
    seen, out = set(), []
    for name, shape in trace.attention:
        key = (name, tuple(shape.items()))
        if key in seen:
            continue
        seen.add(key)
        err = _build.shape_error(name, **shape)
        if err is not None:
            out.append(err)
    return out


def _probe_cfg(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    return dataclasses.replace(
        cfg, num_layers=n_layers, scan_layers=False,
        num_encoder_layers=min(cfg.num_encoder_layers, 2))


def _costs(trace: Trace) -> Tuple[float, float, float]:
    c = trace.counter
    return float(c.flops), float(c.bytes), float(c.collective_bytes)


def probe_costs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Tuple[float, float, float]:
    """Per-device (flops, bytes, collective bytes), extrapolated linearly in
    depth from two small probes (L=p and L=2p), as the reference's. The eager
    count of the full-depth step sees every op already; the probes give the
    same numbers from less work where a cell's cost is linear in depth."""
    p = max(len(cfg.pattern_period()), 1)
    costs_p = _costs(_trace_step(_probe_cfg(cfg, p), shape, mesh))
    costs_2p = _costs(_trace_step(_probe_cfg(cfg, 2 * p), shape, mesh))
    return roofline.probe_extrapolate(costs_p, costs_2p, p, cfg.num_layers)


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    mesh=None,
    cfg_override: Optional[ModelConfig] = None,
    probe: bool = True,
    shape_override: Optional[ShapeConfig] = None,
) -> Dict[str, Any]:
    """Trace one cell on ``mesh`` (default: the production mesh, in a fake
    world of its own); return its record. Raises when the cell is skipped or
    the kernels would refuse one of its attention calls. ``shape_override``
    traces another input shape than ``SHAPES[shape_name]`` (a card's own
    training shape)."""
    cfg = cfg_override or get_config(arch)
    shape = shape_override or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"skipped cell: {why}")
    if mesh is None:
        size = 512 if multi_pod else 256
        with fake_world(size):
            return lower_cell(arch, shape_name, multi_pod, make_production_mesh(
                multi_pod=multi_pod, device="cpu"), cfg_override, probe, shape_override)

    t0 = time.perf_counter()
    trace = _trace_step(cfg, shape, mesh)
    trace_s = time.perf_counter() - t0
    refused = kernel_refusals(trace)
    if refused:
        raise ValueError("the CUDA kernels refuse this cell's per-rank attention: "
                         + "; ".join(refused))
    flops, byts, coll = probe_costs(cfg, shape, mesh) if probe else _costs(trace)

    report = roofline.analyze(
        arch=arch, shape_name=shape_name, mesh_name=mesh_name(mesh), chips=mesh.size(),
        cfg=cfg, shape=shape, params_tree=trace.params, flops=flops, byts=byts, coll=coll,
        memory=trace.memory)
    return {
        **report.as_dict(),
        "kind": trace.kind,
        "fsdp": cfg.param_count() >= FSDP_THRESHOLD,
        "trace_s": round(trace_s, 2),
        **trace.memory,
        "collectives": dict(trace.counter.collective),
        "attention_shapes": sorted({f"{n} b={s['b']} sq={s['sq']} skv={s['skv']} h={s['h']} "
                                    f"d={s['d']}" for n, s in trace.attention}),
    }


def run_cells(cells, multipods, out_dir: Optional[str], probe: bool = True):
    """Every (arch, shape) cell of ``cells`` on each mesh of ``multipods``
    (False: 16 x 16, True: 2 x 16 x 16), each mesh in a fake world of its own;
    a record per cell and mesh (:func:`run_cell`)."""
    results = []
    for mp in multipods:
        with fake_world(512 if mp else 256):
            mesh = make_production_mesh(multi_pod=mp, device="cpu")
            for arch, shape_name in cells:
                results.append(run_cell(arch, shape_name, mesh, out_dir=out_dir, probe=probe))
    return results


def run_cell(arch: str, shape_name: str, mesh, *, cfg: Optional[ModelConfig] = None,
             out_dir: Optional[str] = None, probe: bool = True) -> Dict[str, Any]:
    """One cell on ``mesh`` (``cfg`` in place of the arch's registered config):
    its record with ``status`` OK, SKIP (with the reason ``shape_applicable``
    gives) or FAIL (with the error), printed and, with ``out_dir``, written as
    ``<arch>__<shape>__<mesh>.json``."""
    ok, why = shape_applicable(cfg or get_config(arch), SHAPES[shape_name])
    tag = f"{arch}__{shape_name}__{mesh_name(mesh)}"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh)}
    if not ok:
        rec = {**base, "status": "SKIP", "reason": why}
        print(f"[SKIP] {tag}: {why}", flush=True)
    else:
        try:
            rec = lower_cell(arch, shape_name, len(mesh.shape) == 3, mesh=mesh,
                             cfg_override=cfg, probe=probe)
            rec["status"] = "OK"
            hbm = (rec["argument_bytes_per_device"] + rec["temp_bytes_per_device"]) / 1e9
            print(f"[OK]   {tag}: trace={rec['trace_s']}s mem/dev={hbm:.2f}GB "
                  f"bottleneck={rec['bottleneck']} useful={rec['useful_ratio']:.2f}", flush=True)
        except Exception as e:  # a failed cell is recorded; the others still run
            rec = {**base, "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:200]}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true", help="only the 512-chip mesh")
    ap.add_argument("--multipod-too", action="store_true", help="both meshes")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-probe", action="store_true",
                    help="count the full-depth step only (no depth probes)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape (or --all)")
    multipods = [True] if args.multipod else ([False, True] if args.multipod_too else [False])
    t0 = time.perf_counter()
    results = run_cells(cells, multipods, args.out, probe=not args.no_probe)
    n_ok = sum(r.get("status") == "OK" for r in results)
    n_skip = sum(r.get("status") == "SKIP" for r in results)
    n_fail = sum(r.get("status") == "FAIL" for r in results)
    print(f"\n=== dry-run: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
          f"({time.perf_counter() - t0:.1f} s) ===")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end trainer.

The port of ``repro.launch.train``: config registry -> model init on the
card -> deterministic data pipeline -> train step -> checkpoint manager
(atomic, resumable, the last ``checkpoint.manager.KEEP`` steps kept) ->
fault-tolerant loop (restores and replays bitwise-identically after a
failure: the batches are a function of (seed, step), and the kernels use no
atomics).

On the card (the default):
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --full \\
        --steps 10
On the CPU, at smoke width:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/run1 --device cpu
Resume after interruption is automatic (same command).

Over a mesh (``launch/mesh.py``): ``train_loop(mesh=...)`` places the
parameters and moments by the partition rules (``distributed/sharding.py``,
FSDP off, as the reference's launcher), each batch by ``batch_spec``, and
runs the step under ``use_mesh``; every rank starts the same process group
and calls it alike, and every rank's loss is the same. On the CPU, four gloo
ranks of a (2, 2) mesh under ``torch.multiprocessing.spawn``::

    def worker(rank):
        torch.distributed.init_process_group(
            "gloo", init_method="tcp://127.0.0.1:29500", rank=rank, world_size=4)
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        train_loop(arch="qwen2-moe-a2.7b", steps=3, batch=4, seq=32, mesh=mesh,
                   device="cpu")
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional


from ..checkpoint.manager import CheckpointManager
from ..configs import get_config
from ..data.tokens import TokenPipeline
from ..distributed import sharding as shd
from ..distributed.fault_tolerance import HeartbeatMonitor
from ..models.model import resolve_device
from ..optim.adamw import AdamWConfig, OptState, _is_q
from ..train.step import TrainState, init_train_state, make_train_step
from ..tree import tree_leaves, tree_map


def build(arch: str, smoke: bool, lr: float, quantize_moments: bool):
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    opt_cfg = AdamWConfig(lr=lr, quantize_moments=quantize_moments)
    return cfg, opt_cfg


def shard_state(state: TrainState, mesh, cfg) -> TrainState:
    """The parameters and both moments of ``state`` (the same full tensors on
    every rank) distributed by the partition rules; int8 moments, the codes of
    whole leaves, replicated (``optim/adamw.py``); ``step`` stays whole."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    def put(tree):
        if any(map(_is_q, tree_leaves(tree, _is_q))):
            return tree_map(lambda t: distribute_tensor(t, mesh, [Replicate()] * mesh.ndim), tree)
        return shd.apply_shardings(tree, mesh, cfg=cfg)

    return TrainState(put(state.params), OptState(state.opt.step, put(state.opt.mu),
                                                  put(state.opt.nu)))


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Each input's leading batch dim over as much of the batch axes as divides."""
    from torch.distributed.tensor import distribute_tensor

    return {k: distribute_tensor(
        x, mesh, shd.to_placements(shd.batch_spec(mesh, x.shape[0], x.ndim - 1), mesh))
        for k, x in batch.items()}


def _is_writer() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def train_loop(
    *,
    arch: str = "llama3.2-1b",
    smoke: bool = True,
    steps: int = 200,
    batch: int = 8,
    seq: int = 256,
    lr: float = 1e-3,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    save_every: int = 50,
    log_every: int = 10,
    mesh=None,
    fail_at: Optional[int] = None,  # simulate a failure at this step (tests)
    quantize_moments: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """Train ``steps`` steps (from the latest checkpoint in ``ckpt_dir``, if
    any). Returns the final state, each step's loss and host seconds (the
    step ends when its loss is read back), and the stragglers. The moments
    are fp32, as the reference launcher's, or int8 with ``quantize_moments``."""
    device = resolve_device(device)
    cfg, opt_cfg = build(arch, smoke, lr, quantize_moments=quantize_moments)
    state = init_train_state(cfg, opt_cfg, seed=seed, device=device)
    if mesh is not None:
        state = shard_state(state, mesh, cfg)
    pipe = TokenPipeline(cfg, seed=seed + 1, batch=batch, seq=seq, device=device)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None

    start_step = 0
    if mgr is not None:
        latest = mgr.restore_latest({"params": state.params, "opt": state.opt})
        if latest is not None:
            start_step, restored, extra = latest
            state = TrainState(restored["params"], restored["opt"])
            pipe.restore(extra["data"])
            print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg)
    monitor = HeartbeatMonitor(num_workers=1)
    losses, step_s = [], []
    with shd.use_mesh(mesh):
        for step in range(start_step, steps):
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"simulated failure at step {step}")
            t0 = time.perf_counter()
            batch = pipe.next()
            state, metrics = step_fn(state, batch if mesh is None else shard_batch(batch, mesh))
            loss = float(metrics["loss"])  # waits for the step
            step_s.append(time.perf_counter() - t0)
            monitor.record(0, step_s[-1])
            losses.append(loss)
            if step % log_every == 0 and _is_writer():
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} ({step_s[-1]:.2f}s)")
            if mgr is not None and (step + 1) % save_every == 0:
                _save(mgr, step + 1, state, pipe, mesh)
    return {"state": state, "losses": losses, "step_s": step_s, "final_step": steps,
            "stragglers": monitor.stragglers()}


def _save(mgr: CheckpointManager, step: int, state: TrainState, pipe, mesh) -> None:
    """Save a step's state whole: over a mesh every rank gathers its leaves
    (a collective) and rank 0 writes, so that any mesh restores it."""
    full = {"params": tree_map(shd.full, state.params), "opt": tree_map(shd.full, state.opt)}
    if _is_writer():
        mgr.save(step, full, extra={"data": pipe.state()})
        mgr.prune()
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = train_loop(arch=args.arch, smoke=args.smoke, steps=args.steps,
                     batch=args.batch, seq=args.seq, lr=args.lr,
                     seed=args.seed, ckpt_dir=args.ckpt_dir,
                     save_every=args.save_every, device=args.device)
    print(f"[train] done. first loss {res['losses'][0]:.4f} -> last {res['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()

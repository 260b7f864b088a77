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
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional


from ..checkpoint.manager import CheckpointManager
from ..configs import get_config
from ..data.tokens import TokenPipeline
from ..distributed.fault_tolerance import HeartbeatMonitor
from ..models.model import resolve_device
from ..optim.adamw import AdamWConfig
from ..train.step import TrainState, init_train_state, make_train_step


def build(arch: str, smoke: bool, lr: float, quantize_moments: bool):
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    opt_cfg = AdamWConfig(lr=lr, quantize_moments=quantize_moments)
    return cfg, opt_cfg


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
    device="cuda",
) -> Dict[str, Any]:
    """Train ``steps`` steps (from the latest checkpoint in ``ckpt_dir``, if
    any). Returns the final state, each step's loss and host seconds (the
    step ends when its loss is read back), and the stragglers."""
    if mesh is not None:
        raise NotImplementedError("training over a mesh of cards: ROADMAP.md A.12")
    device = resolve_device(device)
    cfg, opt_cfg = build(arch, smoke, lr, quantize_moments=False)
    state = init_train_state(cfg, opt_cfg, seed=seed, device=device)
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
    for step in range(start_step, steps):
        if fail_at is not None and step == fail_at:
            raise RuntimeError(f"simulated failure at step {step}")
        t0 = time.perf_counter()
        state, metrics = step_fn(state, pipe.next())
        loss = float(metrics["loss"])  # waits for the step
        step_s.append(time.perf_counter() - t0)
        monitor.record(0, step_s[-1])
        losses.append(loss)
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({step_s[-1]:.2f}s)")
        if mgr is not None and (step + 1) % save_every == 0:
            mgr.save(step + 1, {"params": state.params, "opt": state.opt},
                     extra={"data": pipe.state()})
            mgr.prune()
    return {"state": state, "losses": losses, "step_s": step_s, "final_step": steps,
            "stragglers": monitor.stragglers()}


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

"""Gloo workers for the port's multi-process mesh tests (``tests/test_torch_mesh.py``).

``start(world, job, workdir)`` starts ``world`` processes of this file; each
joins a gloo process group through a ``file://`` store under ``workdir`` (so
concurrent test workers never share a port), runs ``JOBS[job]`` and leaves
the group. The jobs read their inputs from ``workdir/port_inputs.pt``, which
the test writes, and each rank writes ``workdir/<job>_rank<r>.pt``. They
import torch and the port only.
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def start(world: int, job: str, workdir: str):
    """Start the ranks; :func:`wait` collects them."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r), str(world), workdir],
                              env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
             for r in range(world)]
    return procs


def wait(procs, timeout: float = 300.0):
    """Wait for every rank (``timeout`` seconds each at most); raise with the
    failed ranks' error output, after killing any rank still running."""
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errors.append(err.decode(errors="replace")[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise RuntimeError("a gloo rank failed:\n" + "\n---\n".join(errors))


# ---------------------------------------------------------------------------
# jobs (run inside a rank)
# ---------------------------------------------------------------------------

def _mesh4(rank, world, workdir):
    """Everything the 4-rank tests need, on one process group."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import shard_batch, shard_state, train_loop
    from repro_torch.models import moe
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.grad_compress import compressed_psum
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_map

    inputs = torch.load(os.path.join(workdir, "port_inputs.pt"), weights_only=False)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    # the reference's train_loop steps, from its own initial state and batches
    for name, (cfg, state, batches) in inputs["train"].items():
        state = shard_state(state, mesh, cfg)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3))
        losses = []
        with shd.use_mesh(mesh):
            for b in batches:
                state, metrics = step(state, shard_batch(b, mesh))
                losses.append(float(metrics["loss"]))
        out[f"train/{name}"] = {"losses": losses,
                                "params": tree_map(shd.full, state.params)}

    # expert parallel with padded experts, through the DTensor path
    mesh14 = make_mesh((1, 4), ("data", "model"), device="cpu")
    for key, (cfg, p, x, cf) in inputs["ep"].items():
        dp = shd.apply_shardings({"moe": p}, mesh14)["moe"]
        xd = shard_batch({"x": x}, mesh14)["x"]
        with shd.use_mesh(mesh14):
            y, aux = moe.moe_apply_ep(dp, cfg, xd, capacity_factor=cf)
        out[f"ep/{key}"] = (y.full_tensor(), float(aux.full_tensor()))

    # a compressed all-reduce over the two ranks of each "data" group
    out["psum"] = compressed_psum(inputs["psum_x"], mesh.get_group("data"))

    # checkpoints across meshes: this mesh resumes the one-process run's
    # checkpoint, and writes one that a single process resumes
    kw = dict(arch="llama3.2-1b", batch=4, seq=32, save_every=2, log_every=100, device="cpu")
    out["resumed"] = train_loop(steps=4, ckpt_dir=inputs["ckpt_from_one"], mesh=mesh,
                                **kw)["losses"]
    out["written"] = train_loop(steps=2, ckpt_dir=inputs["ckpt_to_one"], mesh=mesh,
                                **kw)["losses"]
    # the archs whose recurrences run by rows, the encoder-decoder, M-RoPE
    for arch in WIDE_ARCHS:
        out[f"wide/{arch}"] = train_loop(arch=arch, steps=2, batch=4, seq=16, mesh=mesh,
                                         log_every=100, device="cpu")["losses"]
    torch.save(out, os.path.join(workdir, f"mesh4_rank{rank}.pt"))


WIDE_ARCHS = ("recurrentgemma-9b", "xlstm-125m", "whisper-base", "qwen2-vl-72b")


def _int8_moments(rank, world, workdir):
    """AdamW with int8 moments over parameters sharded on a (2, 2) mesh, from
    the inputs the test ran in one process; then ``train_loop`` with them."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.adamw import _moment_read, adamw_init, adamw_update
    from repro_torch.tree import tree_map

    from torch.distributed.tensor import distribute_tensor

    inputs = torch.load(os.path.join(workdir, "port_inputs.pt"), weights_only=False)["int8"]
    cfg, opt = inputs["cfg"], inputs["opt"]
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")

    def put(tree):  # every rank holds the same inputs: each keeps its shard, no collective
        return tree_map(lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=None), tree,
                        shd.param_shardings(tree, mesh, cfg=cfg))

    params = put(inputs["params"])
    state = adamw_init(params, opt)
    with shd.use_mesh(mesh):
        for g in inputs["grads"]:
            params, state, _ = adamw_update(put(g), state, params, opt)
        moments = {k: tree_map(lambda p, m: _moment_read(m, p).full_tensor(), params,
                               getattr(state, k)) for k in ("mu", "nu")}
    out = {"params": tree_map(shd.full, params), **moments,
           "losses": train_loop(arch="llama3.2-1b", steps=2, batch=4, seq=16, mesh=mesh,
                                quantize_moments=True, log_every=100, device="cpu")["losses"]}
    torch.save(out, os.path.join(workdir, f"int8_rank{rank}.pt"))


def _seq_decode(rank, world, workdir):
    """Decode with the cache sharded by sequence over a 2-wide "model" dim:
    the plain decode attention, and two decode steps of a smoke model whose
    slots fall on either rank."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as model_lib

    inputs = torch.load(os.path.join(workdir, "port_inputs.pt"), weights_only=False)["decode"]
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    q, k, v, lengths = inputs["attention"]
    rep, seq = [Replicate(), Replicate()], [Replicate(), Shard(1)]
    with shd.use_mesh(mesh):
        out = {"attention": ops.decode_attention(
            distribute_tensor(q, mesh, rep), distribute_tensor(k, mesh, seq),
            distribute_tensor(v, mesh, seq), lengths, impl="ref").full_tensor()}
        cfg = inputs["cfg"]
        params = shd.apply_shardings(inputs["params"], mesh, cfg=cfg)
        cache = shd.place_cache(inputs["cache"], inputs["token"].shape[0])
        out["placements"] = [tuple(cache[0]["k"].placements)]
        logits = []
        for token, positions in inputs["steps"]:
            step_logits, cache = model_lib.decode_step(
                params, cfg, distribute_tensor(token, mesh, rep),
                distribute_tensor(positions, mesh, rep), cache, impl="ref")
            logits.append(step_logits.full_tensor())
        out["logits"] = logits
        out["k"] = [c["k"].full_tensor() for c in cache]
    torch.save(out, os.path.join(workdir, f"seqdecode_rank{rank}.pt"))


JOBS = {"mesh4": _mesh4, "int8": _int8_moments, "seqdecode": _seq_decode}


def _main(job, rank, world, workdir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
                            rank=rank, world_size=world)
    try:
        JOBS[job](rank, world, workdir)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

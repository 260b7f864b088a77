"""The port's token pipeline, checkpoints and trainer, on the CPU:
``tests/test_checkpoint_data.py`` and the trainer tests of
``tests/test_fault_tolerance.py`` on the port, and the pipeline held against
the JAX package's.

``torch.Generator`` cannot give ``jax.random``'s draws, so batches are held
by structure (keys, shapes, dtypes, the label shift, the M-RoPE streams) and
the token marginal by distribution: over 2^18 draws each, the two empirical
CDFs are within 0.01 of each other and of the analytic one, P(id < k) =
(k / V)^(1/3) (sampling noise is ~0.003 at that count).
"""
# ruff: noqa: E402
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS
from repro.configs import get_config as jax_get_config
from repro.data.tokens import make_batch as jax_make_batch
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.train.step import init_train_state as jax_init
from repro_torch.checkpoint.manager import KEEP, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.data.tokens import TokenPipeline, make_batch
from repro_torch.launch.train import train_loop
from repro_torch.optim.adamw import AdamWConfig, _QTensor
from repro_torch.train.step import TrainState, init_train_state, make_train_step
from repro_torch.tree import tree_leaves

CFG = get_config("llama3.2-1b").smoke()
OPT = AdamWConfig(lr=1e-2)
CDF_BAND = 0.01


def _mk_state(seed=0, opt=OPT):
    return init_train_state(CFG, opt, seed=seed, device="cpu")


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_match_the_reference_structure(arch):
    """Every arch's batch: the reference's keys, shapes and dtypes, labels
    the tokens shifted left, the modality inputs' scale and M-RoPE streams."""
    cfg = get_config(arch).smoke()
    got = make_batch(cfg, seed=0, step=0, batch=2, seq=16, device="cpu")
    want = jax_make_batch(jax_get_config(arch).smoke(), seed=0, step=0, batch=2, seq=16)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == tuple(w.shape), key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
    toks = got["tokens"]
    assert torch.equal(got["labels"], torch.cat([toks[:, 1:], toks[:, :1]], dim=1))
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    if "positions" in got:
        np.testing.assert_array_equal(got["positions"].numpy(), np.asarray(want["positions"]))
    for key in ("frames", "vision_embeds"):
        if key in got:
            assert 0.015 < float(got[key].std()) < 0.025
    assert "labels" not in make_batch(cfg, 0, 0, 2, 16, with_labels=False, device="cpu")


def test_token_marginal_matches_the_reference():
    vocab = 256
    cfg = get_config("llama3.2-1b").smoke()
    assert cfg.vocab_size == vocab
    n_rows = 2 ** 18 // 512
    got = make_batch(cfg, seed=0, step=0, batch=n_rows, seq=512, device="cpu")["tokens"]
    want = jax_make_batch(jax_get_config("llama3.2-1b").smoke(), seed=0, step=0,
                          batch=n_rows, seq=512)["tokens"]
    k = np.arange(1, vocab + 1)
    cdf = lambda t: np.searchsorted(np.sort(np.asarray(t).ravel()), k, side="left") / t.size
    analytic = np.minimum((k / vocab) ** (1 / 3), 1.0)
    assert np.abs(cdf(got.numpy()) - cdf(np.asarray(want))).max() < CDF_BAND
    assert np.abs(cdf(got.numpy()) - analytic).max() < CDF_BAND


def test_batches_are_a_function_of_seed_and_step():
    a = make_batch(CFG, seed=4, step=6, batch=2, seq=16, device="cpu")
    b = make_batch(CFG, seed=4, step=6, batch=2, seq=16, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    for seed, step in ((4, 7), (5, 6)):
        assert not torch.equal(a["tokens"], make_batch(CFG, seed, step, 2, 16,
                                                       device="cpu")["tokens"])


def test_pipeline_skip_ahead_determinism():
    p1 = TokenPipeline(CFG, seed=4, batch=2, seq=16, device="cpu")
    for _ in range(7):
        b_seq = p1.next()
    p2 = TokenPipeline(CFG, seed=4, batch=2, seq=16, device="cpu")
    p2.restore({"step": 6, "seed": 4})
    assert torch.equal(b_seq["tokens"], p2.next()["tokens"])
    assert p2.state() == {"step": 7, "seed": 4}


def test_pipeline_seed_mismatch_rejected():
    p = TokenPipeline(CFG, seed=4, batch=2, seq=16, device="cpu")
    with pytest.raises(AssertionError):
        p.restore({"step": 3, "seed": 5})


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _mk_state()
    mgr.save(7, {"params": state.params, "opt": state.opt}, extra={"k": 1})
    template = _mk_state(seed=1)
    step, restored, extra = mgr.restore_latest({"params": template.params,
                                                "opt": template.opt})
    assert step == 7 and extra == {"k": 1}
    _equal_trees(restored["params"], state.params)
    _equal_trees(restored["opt"], state.opt)


@pytest.mark.parametrize("opt", [AdamWConfig(quantize_moments=True),
                                 AdamWConfig(moment_dtype="bfloat16")], ids=["int8", "bf16"])
def test_save_restore_quantized_and_bf16_moments(tmp_path, opt):
    mgr = CheckpointManager(str(tmp_path))
    state = _mk_state(opt=opt)
    step = make_train_step(CFG, opt)
    state, _ = step(state, make_batch(CFG, 0, 0, 2, 16, device="cpu"))
    state, _ = step(state, make_batch(CFG, 0, 1, 2, 16, device="cpu"))
    mgr.save(2, {"opt": state.opt})
    _, restored, _ = mgr.restore_latest({"opt": _mk_state(seed=3, opt=opt).opt})
    is_q = lambda x: isinstance(x, _QTensor)
    assert all(is_q(m) == opt.quantize_moments for m in tree_leaves(restored["opt"].mu, is_q))
    _equal_trees(restored["opt"], state.opt)
    if not opt.quantize_moments:
        assert tree_leaves(restored["opt"].mu)[0].dtype == torch.bfloat16


def test_torn_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"params": _mk_state().params})
    torn = tmp_path / "step_000000009"
    torn.mkdir()
    (torn / "params.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 5
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest({}) is None


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _mk_state()
    path = mgr.save(3, {"params": state.params})
    f = os.path.join(path, "params.npz")
    data = bytearray(open(f, "rb").read())
    data[100] ^= 0xFF
    open(f, "wb").write(bytes(data))
    with pytest.raises(IOError, match="sha256"):
        mgr.restore(3, {"params": state.params})


def test_retention_keeps_the_last_three(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    params = _mk_state().params
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, {"params": params})
    assert mgr.steps() == [1, 2, 3, 4, 5]  # save keeps every step (the sweep journal)
    mgr.prune()
    assert KEEP == 3 and mgr.steps() == [3, 4, 5]


def test_restart_bitwise_determinism(tmp_path):
    """Crash + restore + replay == uninterrupted run, bit for bit."""
    mgr = CheckpointManager(str(tmp_path))
    step_fn = make_train_step(CFG, OPT)
    state = _mk_state()
    pipe = TokenPipeline(CFG, seed=9, batch=2, seq=32, device="cpu")
    for i in range(10):
        state, m = step_fn(state, pipe.next())
        if i == 4:
            mgr.save(5, {"params": state.params, "opt": state.opt},
                     extra={"data": pipe.state()})
    template = _mk_state(seed=1)
    _, restored, extra = mgr.restore_latest({"params": template.params, "opt": template.opt})
    state_b = TrainState(restored["params"], restored["opt"])
    pipe_b = TokenPipeline(CFG, seed=9, batch=2, seq=32, device="cpu")
    pipe_b.restore(extra["data"])
    for _ in range(5):
        state_b, mb = step_fn(state_b, pipe_b.next())
    assert float(mb["loss"]) == float(m["loss"])
    _equal_trees(state_b, state)


def test_train_loop_crash_resume_identical(tmp_path):
    """The whole trainer: run 30 steps; run again with a crash at 17 + resume; the
    final losses must match exactly (deterministic pipeline + checkpoint),
    and the last KEEP checkpoints stay."""
    kw = dict(arch="llama3.2-1b", smoke=True, batch=2, seq=32, lr=1e-3,
              seed=3, save_every=10, log_every=1000, device="cpu")
    ref = train_loop(steps=30, ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(RuntimeError, match="simulated failure"):
        train_loop(steps=30, ckpt_dir=str(tmp_path / "b"), fail_at=17, **kw)
    resumed = train_loop(steps=30, ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(ref["losses"]) == 30 and len(resumed["losses"]) == 20
    assert resumed["losses"][-1] == ref["losses"][-1]
    assert resumed["losses"] == ref["losses"][10:]
    _equal_trees(resumed["state"], ref["state"])
    assert CheckpointManager(str(tmp_path / "b")).steps() == [10, 20, 30]
    assert len(ref["step_s"]) == 30 and ref["stragglers"] == []


def test_train_loop_refuses_a_mesh():
    """``train_loop`` takes a mesh of its world: a production mesh is refused
    by a world of one, naming both sizes; the (1, 1) host mesh trains as no
    mesh does."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    started = not dist.is_initialized()
    try:
        mesh = make_host_mesh(device="cpu")
        with pytest.raises(ValueError, match="512 ranks; this world has 1"):
            train_loop(steps=1, mesh=make_production_mesh(multi_pod=True, device="cpu"),
                       device="cpu")
        kw = dict(steps=2, batch=2, seq=16, log_every=100, device="cpu")
        assert train_loop(mesh=mesh, **kw)["losses"] == train_loop(**kw)["losses"]
    finally:
        if started:
            dist.destroy_process_group()


def test_training_entry_points_default_to_the_card():
    """Without a card, each entry point of training raises at its default
    device instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jcfg = jax_get_config("llama3.2-1b").smoke()
    jstate = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg,
                                                         JaxAdamWConfig()))
    calls = [lambda: make_batch(CFG, 0, 0, 2, 16),
             lambda: TokenPipeline(CFG, 0, 2, 16),
             lambda: init_train_state(CFG, OPT),
             lambda: train_loop(steps=1),
             lambda: train_state_from_jax(jstate, CFG)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

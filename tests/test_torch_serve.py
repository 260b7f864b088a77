"""The port's serving slice against the JAX package, on the CPU.

JAX parameters are carried over with ``params_from_jax``; tokens are drawn
with numpy and handed to both packages. Configurations are the smoke
llama3.2-1b (4 query heads over 4 kv heads, group 1) and a GQA variant with
2 kv heads (group 2), and the smoke llama3.2-3b, qwen2-7b (untied head),
qwen2-moe-a2.7b (mixture of experts with shared experts) and
recurrentgemma-9b (RG-LRU and windowed attention, window 8, embeddings
scaled), all in fp32. Logits are held at atol = rtol = 1e-4: the two
packages take the CPU matrix products and sin/cos in another order and with
other libraries, which moves fp32 results by ~1e-6 per layer. Greedy tokens
are held exactly.
"""
# ruff: noqa: E402
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs torch; the imports below need the port (hence the E402 waiver)
torch = pytest.importorskip("torch")

from repro import configs as jax_config_registry
from repro.configs import get_config as jax_get_config
from repro.launch.serve import Fleet as JaxFleet
from repro.launch.serve import ModelServer as JaxServer
from repro.launch.serve import Request as JaxRequest
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro_torch import configs as config_registry
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import Fleet, ModelServer, Request
from repro_torch.models import model as torch_model
from repro_torch.models import moe as torch_moe

ARCH = "llama3.2-1b"
# the archs beyond llama3.2-1b: dense, dense with an untied head, MoE, hybrid,
# xLSTM, encoder-decoder, vision-language (M-RoPE), MoE with a dense residual.
# mistral-large-123b needs no code of its own; it is held at smoke width only
NEW_ARCHS = ["llama3.2-3b", "qwen2-7b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
             "mistral-large-123b", "xlstm-125m", "whisper-base", "qwen2-vl-72b",
             "arctic-480b"]
# the reference's examples/serve_fleet.py fleet: dense, MoE, hybrid
FLEET_ARCHS = ["llama3.2-1b", "qwen2-moe-a2.7b", "recurrentgemma-9b"]
ATOL = RTOL = 1e-4


def _close(torch_out, jax_out):
    np.testing.assert_allclose(torch_out.float().numpy(), np.asarray(jax_out, np.float32),
                               atol=ATOL, rtol=RTOL)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=[4, 2], ids=["group1", "group2"])
def pair(request):
    """(jax cfg, port cfg, jax params, port params) of one smoke configuration."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).smoke(), num_kv_heads=request.param)
    tcfg = dataclasses.replace(get_config(ARCH).smoke(), num_kv_heads=request.param)
    jparams = jax_model.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(_numpy_tree(jparams), tcfg, device="cpu")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_copy_matches_jax(smoke):
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    if smoke:
        jcfg, tcfg = jcfg.smoke(), tcfg.smoke()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert list(config_registry._ARCH_MODULES) == list(jax_config_registry.ARCHS)
    with pytest.raises(KeyError, match="no-such-arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(param_dtype):
    """Every per-layer weight equals the JAX slice bit for bit, fp32 and bf16."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).smoke(), param_dtype=param_dtype)
    tcfg = dataclasses.replace(get_config(ARCH).smoke(), param_dtype=param_dtype)
    tree = _numpy_tree(jax_model.init(jax.random.PRNGKey(3), jcfg))
    params = params_from_jax(tree, tcfg, device="cpu")
    want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]

    def same(t, a):
        assert t.dtype == want_dtype and tuple(t.shape) == a.shape
        bits = np.int16 if param_dtype == "bfloat16" else np.int32
        torch_bits = torch.int16 if param_dtype == "bfloat16" else torch.int32
        np.testing.assert_array_equal(t.view(torch_bits).numpy(), a.view(bits))

    same(params["embed"]["w"], tree["embed"]["w"])
    same(params["final_norm"]["scale"], tree["final_norm"]["scale"])
    layers = tree["stack"]["layers"]
    assert len(params["stack"]["layers"]) == tcfg.num_layers
    for i, lp in enumerate(params["stack"]["layers"]):
        for name in ("wq", "wk", "wv", "wo"):
            same(lp["attn"][name]["w"], layers["attn"][name]["w"][i])
        for name in ("w_in", "w_gate", "w_out"):
            same(lp["mlp"][name]["w"], layers["mlp"][name]["w"][i])
        for name in ("norm1", "norm2"):
            same(lp[name]["scale"], layers[name]["scale"][i])


def test_forward_matches_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jlogits, _ = jax_model.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    tlogits, _ = torch_model.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens)})
    _close(tlogits, jlogits)


def test_prefill_and_decode_match_jax(pair):
    """Prefill logits and cache, then ten decode steps' logits and the cache."""
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(2)
    b, s, cache_len = 2, 10, 32
    tokens = rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    jdecode = jax.jit(lambda p, t, pos, c: jax_model.decode_step(p, jcfg, t, pos, c))
    jlogits, jcache = jax_model.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, cache_len)
    tlogits, tcache = torch_model.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)},
                                          cache_len)
    _close(tlogits, jlogits)

    def same_cache():
        for i, layer in enumerate(tcache):
            _close(layer["k"], jcache["k"][i])
            _close(layer["v"], jcache["v"][i])
            assert layer["pos"] == int(jcache["pos"][i])

    same_cache()
    for step in range(10):
        token = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
        pos = np.full((b, 1), s + step, np.int32)
        jlogits, jcache = jdecode(jparams, jnp.asarray(token), jnp.asarray(pos), jcache)
        tlogits, tcache = torch_model.decode_step(tparams, tcfg, torch.from_numpy(token),
                                                  torch.from_numpy(pos), tcache)
        _close(tlogits, jlogits)
    same_cache()


@pytest.mark.parametrize("lens,max_new,cache_len", [
    ((8, 8, 8), (6, 6, 6), 32),
    ((5, 9, 12), (6, 3, 5), 32),   # ragged prompts: right-padded with token 0
    ((12, 7), (5, 5), 8),          # prompt longer than the cache: ring roll, clamped slot
], ids=["even", "ragged", "ring"])
def test_generate_matches_jax(pair, lens, max_new, cache_len):
    jcfg, tcfg, _, tparams = pair
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(1, tcfg.vocab_size, (n,)).astype(np.int32) for n in lens]
    jsrv = JaxServer(jcfg, batch_size=3, cache_len=cache_len, seed=0)  # = pair's params
    tsrv = ModelServer(tcfg, batch_size=3, cache_len=cache_len, device="cpu")
    tsrv.params = tparams
    jout = jsrv.generate([JaxRequest(i, jnp.asarray(p), m)
                          for i, (p, m) in enumerate(zip(prompts, max_new))])
    tout = tsrv.generate([Request(i, torch.from_numpy(p), m)
                          for i, (p, m) in enumerate(zip(prompts, max_new))])
    assert tout == jout
    assert [len(tout[i]) for i in range(len(lens))] == list(max_new)


def test_model_server_greedy_matches_forward():
    """Server generation (prefill + decode) == argmax of teacher-forced forward."""
    cfg = get_config(ARCH).smoke()
    srv = ModelServer(cfg, batch_size=1, cache_len=64, seed=5, device="cpu")
    prompt = torch.arange(3, 19, dtype=torch.int32)  # 16 tokens
    outs = srv.generate([Request(0, prompt, max_new=3)])
    toks = prompt.tolist()
    for _ in range(3):
        logits, _ = torch_model.forward(srv.params, cfg,
                                        {"tokens": torch.tensor([toks], dtype=torch.int32)})
        toks.append(int(torch.argmax(logits[0, -1])))
    assert outs[0] == toks[16:], (outs[0], toks[16:])
    assert srv.tokens_per_second() > 0


def test_stats_count_each_requests_delivered_tokens():
    """``stats["tokens"]`` counts what each request was served (its own
    ``max_new``), not the batch's padded ``b x max(max_new)``."""
    cfg = get_config(ARCH).smoke()
    srv = ModelServer(cfg, batch_size=3, cache_len=32, seed=5, device="cpu")
    outs = srv.generate([Request(i, torch.arange(3, 3 + n, dtype=torch.int32), m)
                         for i, (n, m) in enumerate([(8, 4), (5, 1), (6, 2)])])
    assert [len(outs[i]) for i in range(3)] == [4, 1, 2]
    assert srv.stats["tokens"] == 7 and srv.stats["requests"] == 3


@pytest.mark.parametrize("ar,want", [([[10.0, 0.0]], (0, 0)), ([[0.0, 10.0]], (0, 1))])
def test_fleet_routes_by_assignment(ar, want):
    fleet = Fleet([ARCH], 2, smoke=True, batch_size=2, cache_len=32, device="cpu")
    report = fleet.route(np.asarray(ar), requests_per_unit=1, prompt_len=8, max_new=2)
    assert report["total"] > 0
    assert set(report["dispatched"]) == {want}
    assert set(report["per_server_tps"]) == {want}


def test_model_server_without_cuda_raises(monkeypatch):
    """The server runs on the card; it never carries on on the CPU unasked."""
    monkeypatch.setattr(serve_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelServer(get_config(ARCH).smoke())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Fleet([ARCH], 1)


def test_model_entry_points_without_cuda_raise(monkeypatch):
    """init and params_from_jax put the model on the card unless asked for the
    CPU; without a card they raise instead of running the plain path."""
    cfg = get_config(ARCH).smoke()
    tree = _numpy_tree(jax_model.init(jax.random.PRNGKey(0), jax_get_config(ARCH).smoke()))
    monkeypatch.setattr(torch_model.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_model.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, cfg)
    assert torch_model.init(cfg, device="cpu")["embed"]["w"].device.type == "cpu"
    assert params_from_jax(tree, cfg, device="cpu")["embed"]["w"].device.type == "cpu"


# ---------------------------------------------------------------------------
# the other archs of the registry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_pair(request):
    """(jax cfg, port cfg, jax params, port params) of one new arch's smoke config."""
    jcfg, tcfg = jax_get_config(request.param).smoke(), get_config(request.param).smoke()
    jparams = jax_model.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(_numpy_tree(jparams), tcfg, device="cpu")


VISION_GRID = 2  # the smoke vlm's patch grid: 2 x 2 patches lead the prompt


def _mrope_positions(b, s, grid=VISION_GRID):
    """Distinct M-RoPE streams: patch i of the grid at (0, i // grid, i % grid),
    the text after the patches at grid + j on all three streams."""
    n = grid * grid
    pos = np.empty((s, 3), np.int32)
    pos[:n] = np.stack([np.zeros(n), np.arange(n) // grid, np.arange(n) % grid], -1)
    pos[n:] = (grid + np.arange(s - n))[:, None]
    return np.broadcast_to(pos, (b, s, 3)).copy()


def _inputs(cfg, tokens, rng):
    """A model batch as numpy arrays: random frames for the encoder-decoder,
    patch embeddings and distinct M-RoPE streams for the vlm."""
    b, s = tokens.shape
    batch = {"tokens": tokens}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "vision_stub":
        batch["vision_embeds"] = rng.standard_normal(
            (b, VISION_GRID ** 2, cfg.d_model)).astype(np.float32)
    if cfg.rope_mode == "mrope":
        batch["positions"] = _mrope_positions(b, s)
    return batch


def _decode_positions(cfg, b, pos):
    """(B, 1) positions of a decode step, or (B, 1, 3) under M-RoPE; after the
    patches the streams are equal, so the step's position is grid + its index."""
    if cfg.rope_mode == "mrope":
        return np.full((b, 1, 3), pos - VISION_GRID ** 2 + VISION_GRID, np.int32)
    return np.full((b, 1), pos, np.int32)


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_config_copy_matches_jax(arch, smoke):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if smoke:
        jcfg, tcfg = jcfg.smoke(), tcfg.smoke()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-base", "qwen2-vl-72b", "arctic-480b"])
def test_init_and_generate_serve_the_last_four_archs(arch):
    """The four archs the model code took last initialize and serve on the CPU."""
    cfg = get_config(arch).smoke()
    srv = ModelServer(cfg, batch_size=2, cache_len=32, seed=1, device="cpu")
    leaves = jax.tree_util.tree_leaves(srv.params)
    assert leaves and all(t.device.type == "cpu" and torch.isfinite(t).all() for t in leaves)
    outs = srv.generate([Request(0, torch.arange(1, 9, dtype=torch.int32), 4),
                         Request(1, torch.arange(3, 8, dtype=torch.int32), 3)])
    assert [len(outs[0]), len(outs[1])] == [4, 3]
    assert all(0 <= t < cfg.vocab_size for toks in outs.values() for t in toks)


def test_new_arch_forward_matches_jax(arch_pair):
    jcfg, tcfg, jparams, tparams = arch_pair
    rng = np.random.default_rng(1)
    batch = _inputs(tcfg, rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32), rng)
    jlogits, jaux = jax_model.forward(jparams, jcfg, _jax_batch(batch))
    tlogits, taux = torch_model.forward(tparams, tcfg, _torch_batch(batch))
    _close(tlogits, jlogits)
    _close(taux, jaux)


def _layer_caches(jcache, cfg):
    """The reference's caches as one dict per layer (the scanned stack's are stacked)."""
    if isinstance(jcache, dict):
        return [{k: v[i] for k, v in jcache.items()} for i in range(cfg.num_layers)]
    return jcache


def _same_cache(tcache, jcache):
    """A layer's cache, key by key: ``pos`` exactly, tensors at the tolerance;
    an encoder-decoder layer's self cache is a nested dict."""
    assert set(tcache) == set(jcache)
    for name, t in tcache.items():
        if isinstance(t, dict):
            _same_cache(t, jcache[name])
        elif name == "pos":
            assert t == int(jcache[name])
        else:
            assert t.dtype == torch.float32
            _close(t, jcache[name])


def test_new_arch_prefill_and_decode_match_jax(arch_pair):
    """Prefill logits and caches, then eight decode steps' logits and the caches.
    A 12-token prompt is longer than recurrentgemma's window of 8, so its
    attention caches hold the rolled ring and decode writes around it; it is
    longer than the conv of the recurrent blocks; whisper's frames are random,
    and qwen2-vl's prompt starts with patch embeddings at distinct positions."""
    jcfg, tcfg, jparams, tparams = arch_pair
    rng = np.random.default_rng(2)
    b, s, cache_len = 2, 12, 32
    batch = _inputs(tcfg, rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32), rng)
    jdecode = jax.jit(lambda p, t, pos, c: jax_model.decode_step(p, jcfg, t, pos, c))
    jlogits, jcache = jax_model.prefill(jparams, jcfg, _jax_batch(batch), cache_len)
    tlogits, tcache = torch_model.prefill(tparams, tcfg, _torch_batch(batch), cache_len)
    _close(tlogits, jlogits)

    def same_cache():
        jlayers = _layer_caches(jcache, jcfg)
        assert len(tcache) == len(jlayers) == tcfg.num_layers
        for tl, jl in zip(tcache, jlayers):
            _same_cache(tl, jl)

    same_cache()
    if tcfg.attn_window:
        assert tcache[2]["k"].shape[1] == tcfg.attn_window < s  # the ring roll was taken
    for step in range(8):
        token = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
        pos = _decode_positions(tcfg, b, s + step)
        jlogits, jcache = jdecode(jparams, jnp.asarray(token), jnp.asarray(pos), jcache)
        tlogits, tcache = torch_model.decode_step(tparams, tcfg, torch.from_numpy(token),
                                                  torch.from_numpy(pos), tcache)
        _close(tlogits, jlogits)
    same_cache()


@pytest.mark.parametrize("lens,max_new", [((12, 9, 5), (6, 4, 6))], ids=["ragged"])
def test_new_arch_generate_matches_jax(arch_pair, lens, max_new):
    """Greedy tokens equal; recurrentgemma's 12-token prompt is past its window."""
    jcfg, tcfg, _, tparams = arch_pair
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(1, tcfg.vocab_size, (n,)).astype(np.int32) for n in lens]
    jsrv = JaxServer(jcfg, batch_size=3, cache_len=32, seed=0)  # = arch_pair's params
    tsrv = ModelServer(tcfg, batch_size=3, cache_len=32, device="cpu")
    tsrv.params = tparams
    jout = jsrv.generate([JaxRequest(i, jnp.asarray(p), m)
                          for i, (p, m) in enumerate(zip(prompts, max_new))])
    tout = tsrv.generate([Request(i, torch.from_numpy(p), m)
                          for i, (p, m) in enumerate(zip(prompts, max_new))])
    assert tout == jout


def _last_pair(arch, seed=0):
    jcfg, tcfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jparams = jax_model.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(_numpy_tree(jparams), tcfg, device="cpu")


def test_whisper_prefill_leaves_the_self_caches_empty():
    """The reference's encoder-decoder prefill fills only the cross attention's
    k, v: every self cache comes back at ``pos`` 0 and zero, so the first
    decode step attends to itself alone (ROADMAP C.6). The port does the same,
    and its logits of that step are the reference's."""
    jcfg, tcfg, jparams, tparams = _last_pair("whisper-base", seed=4)
    rng = np.random.default_rng(4)
    b, s = 2, 6
    batch = _inputs(tcfg, rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32), rng)
    _, jcache = jax_model.prefill(jparams, jcfg, _jax_batch(batch), 16)
    _, tcache = torch_model.prefill(tparams, tcfg, _torch_batch(batch), 16)
    for layer in tcache:
        assert layer["self"]["pos"] == 0
        assert not layer["self"]["k"].any() and not layer["self"]["v"].any()
        assert layer["cross_k"].shape == (b, tcfg.encoder_seq, tcfg.num_kv_heads, tcfg.hd())
    token, pos = np.full((b, 1), 3, np.int32), np.full((b, 1), s, np.int32)
    jlogits, jcache = jax_model.decode_step(jparams, jcfg, jnp.asarray(token), jnp.asarray(pos),
                                            jcache)
    tlogits, tcache = torch_model.decode_step(tparams, tcfg, torch.from_numpy(token),
                                              torch.from_numpy(pos), tcache)
    _close(tlogits, jlogits)
    assert all(layer["self"]["pos"] == 1 for layer in tcache)


def test_qwen2_vl_streams_and_patches_reach_the_logits():
    """qwen2-vl with patch embeddings and distinct M-RoPE streams matches the
    reference (above); here each of the two moves the logits, so the sections
    and the overwrite are exercised, not passed over."""
    jcfg, tcfg, jparams, tparams = _last_pair("qwen2-vl-72b", seed=5)
    rng = np.random.default_rng(5)
    batch = _inputs(tcfg, rng.integers(0, tcfg.vocab_size, (2, 10)).astype(np.int32), rng)
    equal = dict(batch, positions=np.broadcast_to(np.arange(10, dtype=np.int32)[None, :, None],
                                                  (2, 10, 3)).copy())
    text = {k: v for k, v in batch.items() if k != "vision_embeds"}
    out = {}
    for name, bt in (("vlm", batch), ("equal_streams", equal), ("text_only", text)):
        jlogits, _ = jax_model.forward(jparams, jcfg, _jax_batch(bt))
        out[name], _ = torch_model.forward(tparams, tcfg, _torch_batch(bt))
        _close(out[name], jlogits)
    for name in ("equal_streams", "text_only"):
        assert float((out[name] - out["vlm"]).abs().max()) > 1e-3


def test_arctic_dense_residual_under_ep_matches_jax():
    """arctic's MoE layers carry the dense residual MLP beside the experts and
    prefill on the expert-parallel path (here un-meshed, as the reference's
    fallback); the block's output is the reference's, and without the residual
    it is not."""
    jcfg, tcfg, jparams, tparams = _last_pair("arctic-480b", seed=6)
    assert tcfg.moe_impl == "ep" and tcfg.moe_dense_residual
    layer = tparams["stack"]["layers"][0]["moe"]
    assert layer["dense"]["w_in"]["w"].shape == (tcfg.d_model, tcfg.moe_dense_d_ff)
    x = np.random.default_rng(6).standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jparams["stack"]["layers"]["moe"])
    jy, jaux = jax_moe.moe_apply_ep(jlayer, jcfg, jnp.asarray(x))
    ty, taux = torch_moe.moe_apply_ep(layer, tcfg, torch.from_numpy(x))
    _close(ty, jy)
    _close(taux, jaux)
    bare, _ = torch_moe.moe_apply_ep({k: v for k, v in layer.items() if k != "dense"}, tcfg,
                                     torch.from_numpy(x))
    assert float((bare - ty).abs().max()) > 1e-3


def test_moe_serving_drops_pairs_as_jax(monkeypatch):
    """A batch of one repeated token routes every pair of a layer to the same
    experts, past their capacity at prefill (1.25) and at decode (2.0): the
    dropped pairs are the reference's, and so are the logits."""
    arch = "qwen2-moe-a2.7b"
    jcfg, tcfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jparams = jax_model.init(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(_numpy_tree(jparams), tcfg, device="cpu")
    dropped = []
    slots = torch_moe._slots

    def counting(sel, num_experts, cap):
        out = slots(sel, num_experts, cap)
        dropped.append(int((~out[2]).sum()))
        return out

    monkeypatch.setattr(torch_moe, "_slots", counting)
    b, s = 2, 12
    tokens = np.full((b, s), 7, np.int32)
    jlogits, jcache = jax_model.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, 32)
    tlogits, tcache = torch_model.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)}, 32)
    _close(tlogits, jlogits)
    assert min(dropped) > 0
    dropped.clear()
    token, pos = np.full((b, 1), 7, np.int32), np.full((b, 1), s, np.int32)
    jlogits, _ = jax_model.decode_step(jparams, jcfg, jnp.asarray(token), jnp.asarray(pos), jcache)
    tlogits, _ = torch_model.decode_step(tparams, tcfg, torch.from_numpy(token),
                                         torch.from_numpy(pos), tcache)
    _close(tlogits, jlogits)
    assert min(dropped) > 0


def test_three_arch_fleet_dispatches_as_jax():
    """The reference's serve_fleet.py fleet (dense, MoE, hybrid x 2 DCs, smoke)
    dispatches an arrival-rate matrix as the reference's Fleet does."""
    ar = np.array([[5.0, 1.0], [2.0, 0.0], [0.5, 3.0]], np.float32)
    kw = dict(requests_per_unit=2, prompt_len=12, max_new=3)
    jrep = JaxFleet(FLEET_ARCHS, 2, smoke=True, batch_size=4, cache_len=32).route(
        jnp.asarray(ar), **kw)
    trep = Fleet(FLEET_ARCHS, 2, smoke=True, batch_size=4, cache_len=32, device="cpu").route(
        ar, **kw)
    assert trep["dispatched"] == jrep["dispatched"]
    assert trep["total"] == jrep["total"]
    assert set(trep["per_server_tps"]) == set(jrep["per_server_tps"]) == set(trep["dispatched"])


def _same_bits(t, a):
    bits, torch_bits = ((np.int16, torch.int16) if a.dtype.name == "bfloat16"
                        else (np.int32, torch.int32))
    assert tuple(t.shape) == a.shape
    np.testing.assert_array_equal(t.view(torch_bits).numpy(), a.view(bits))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b", "recurrentgemma-9b"],
                         ids=["untied_head", "stacked_moe", "unrolled_blocks"])
def test_params_from_jax_round_trip_new_trees(arch, param_dtype):
    """The untied head, the scanned stack's stacked MoE leaves ((L, E, d, f)
    experts, an fp32 router) and the hybrid's unrolled blocks, each equal to
    the JAX leaf bit for bit, fp32 and bf16."""
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), param_dtype=param_dtype)
    tcfg = dataclasses.replace(get_config(arch).smoke(), param_dtype=param_dtype)
    tree = _numpy_tree(jax_model.init(jax.random.PRNGKey(3), jcfg))
    params = params_from_jax(tree, tcfg, device="cpu")
    assert set(params) == set(tree)
    for name in set(tree) - {"stack"}:
        jax.tree_util.tree_map(_same_bits, params[name], tree[name])
    layers = params["stack"]["layers"]
    assert len(layers) == tcfg.num_layers
    if "blocks" in tree["stack"]:
        for i, lp in enumerate(layers):
            jax.tree_util.tree_map(_same_bits, lp, tree["stack"]["blocks"][str(i)])
    else:
        for i, lp in enumerate(layers):
            jax.tree_util.tree_map(lambda t, a, i=i: _same_bits(t, a[i]), lp,
                                   tree["stack"]["layers"])
    if arch == "qwen2-moe-a2.7b":
        experts = tree["stack"]["layers"]["moe"]["experts"]["w_in"]["w"]
        assert experts.shape == (tcfg.num_layers, tcfg.num_experts, tcfg.d_model, tcfg.d_ff)
        assert layers[0]["moe"]["router"]["w"].dtype == torch.float32
    if arch == "recurrentgemma-9b":
        assert layers[0]["recur"]["lambda"].dtype == torch.float32


def test_params_from_jax_refuses_other_trees():
    cfg = get_config("recurrentgemma-9b").smoke()
    tree = _numpy_tree(jax_model.init(jax.random.PRNGKey(0),
                                      jax_get_config("recurrentgemma-9b").smoke()))
    for bad in ({**tree, "extra": tree["final_norm"]},
                {**tree, "stack": {**tree["stack"], "layers": {}}},
                {**tree, "stack": {"blocks": {k: v for k, v in tree["stack"]["blocks"].items()
                                              if k != "1"}}},
                {k: v for k, v in tree.items() if k != "final_norm"}):
        with pytest.raises(ValueError, match="expected a decoder parameter tree"):
            params_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["whisper-base", "xlstm-125m", "arctic-480b"],
                         ids=["encoder_decoder", "xlstm_blocks", "moe_dense_residual"])
def test_params_from_jax_round_trip_last_trees(arch, param_dtype):
    """The encoder-decoder tree (kept as the reference lays it out), the
    unrolled mLSTM and sLSTM blocks (the sLSTM's per-head recurrence r and
    its fp32 bias b), and the scanned MoE's dense residual, each equal to the
    JAX leaf bit for bit, fp32 and bf16."""
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), param_dtype=param_dtype)
    tcfg = dataclasses.replace(get_config(arch).smoke(), param_dtype=param_dtype)
    tree = _numpy_tree(jax_model.init(jax.random.PRNGKey(3), jcfg))
    params = params_from_jax(tree, tcfg, device="cpu")
    assert set(params) == set(tree)
    if tcfg.is_encoder_decoder:
        jax.tree_util.tree_map(_same_bits, params, tree)
        assert params["pos_embed"]["w"].shape == (4096, tcfg.d_model)
        assert sorted(params["enc"]) == ["0", "1"] and sorted(params["dec"]) == ["0", "1"]
        assert "bias" in params["dec"]["0"]["norm_x"]  # LayerNorm
        return
    layers = params["stack"]["layers"]
    assert len(layers) == tcfg.num_layers
    if "blocks" in tree["stack"]:
        for i, lp in enumerate(layers):
            jax.tree_util.tree_map(_same_bits, lp, tree["stack"]["blocks"][str(i)])
        slstm = layers[tcfg.pattern().index("slstm")]["slstm"]
        dh = tcfg.d_model // tcfg.num_heads
        assert slstm["r"]["w"].shape == (tcfg.num_heads, dh, 4 * dh)
        assert slstm["b"].dtype == torch.float32 and slstm["b"].shape == (4 * tcfg.d_model,)
    else:
        for i, lp in enumerate(layers):
            jax.tree_util.tree_map(lambda t, a, i=i: _same_bits(t, a[i]), lp,
                                   tree["stack"]["layers"])
        assert layers[0]["moe"]["dense"]["w_in"]["w"].shape == (tcfg.d_model,
                                                               tcfg.moe_dense_d_ff)


def test_params_from_jax_refuses_malformed_encdec_trees():
    cfg = get_config("whisper-base").smoke()
    tree = _numpy_tree(jax_model.init(jax.random.PRNGKey(0),
                                      jax_get_config("whisper-base").smoke()))
    dec0 = tree["dec"]["0"]
    for bad in ({**tree, "stack": {}},
                {k: v for k, v in tree.items() if k != "pos_embed"},
                {**tree, "enc": {k: v for k, v in tree["enc"].items() if k != "1"}},
                {**tree, "dec": {**tree["dec"], "0": {k: v for k, v in dec0.items()
                                                      if k != "cross_attn"}}}):
        with pytest.raises(ValueError, match="expected an encoder-decoder parameter tree"):
            params_from_jax(bad, cfg, device="cpu")

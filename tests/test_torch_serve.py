"""The port's serving slice (llama3.2-1b) against the JAX package, on the CPU.

JAX parameters are carried over with ``params_from_jax``; tokens are drawn
with numpy and handed to both packages. Configurations are the smoke
llama3.2-1b (4 query heads over 4 kv heads, group 1) and a GQA variant with
2 kv heads (group 2), in fp32. Logits are held at atol = rtol = 1e-4: the two
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

from repro.configs import get_config as jax_get_config
from repro.launch.serve import ModelServer as JaxServer
from repro.launch.serve import Request as JaxRequest
from repro.models import model as jax_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import Fleet, ModelServer, Request
from repro_torch.models import model as torch_model

ARCH = "llama3.2-1b"
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
    with pytest.raises(KeyError, match=ARCH):
        get_config("llama3.2-3b")


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

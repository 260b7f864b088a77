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

from repro.configs import get_config as jax_get_config
from repro.launch.serve import Fleet as JaxFleet
from repro.launch.serve import ModelServer as JaxServer
from repro.launch.serve import Request as JaxRequest
from repro.models import model as jax_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.serve import Fleet, ModelServer, Request
from repro_torch.models import model as torch_model
from repro_torch.models import moe as torch_moe

ARCH = "llama3.2-1b"
# the archs this slice adds: dense, dense with an untied head, MoE, hybrid
# mistral-large-123b needs no code of its own; it is held at smoke width only
NEW_ARCHS = ["llama3.2-3b", "qwen2-7b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
             "mistral-large-123b"]
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
    with pytest.raises(KeyError, match=ARCH):
        get_config("xlstm-125m")


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


# ---------------------------------------------------------------------------
# the MoE, hybrid and untied-head archs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_pair(request):
    """(jax cfg, port cfg, jax params, port params) of one new arch's smoke config."""
    jcfg, tcfg = jax_get_config(request.param).smoke(), get_config(request.param).smoke()
    jparams = jax_model.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(_numpy_tree(jparams), tcfg, device="cpu")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_config_copy_matches_jax(arch, smoke):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if smoke:
        jcfg, tcfg = jcfg.smoke(), tcfg.smoke()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch,item", [
    ("xlstm-125m", "A.10.6"), ("whisper-base", "A.10.7"), ("qwen2-vl-72b", "A.10.8"),
    ("arctic-480b", "A.10.8")])
def test_init_refuses_what_the_port_does_not_run(arch, item):
    """Each arch the model code does not run yet is refused, naming its ROADMAP item."""
    jcfg = jax_get_config(arch).smoke()
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    with pytest.raises(NotImplementedError, match=item):
        torch_model.init(cfg, device="cpu")


def test_new_arch_forward_matches_jax(arch_pair):
    jcfg, tcfg, jparams, tparams = arch_pair
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jlogits, jaux = jax_model.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    tlogits, taux = torch_model.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens)})
    _close(tlogits, jlogits)
    _close(taux, jaux)


def _layer_caches(jcache, cfg):
    """The reference's caches as one dict per layer (the scanned stack's are stacked)."""
    if isinstance(jcache, dict):
        return [{k: v[i] for k, v in jcache.items()} for i in range(cfg.num_layers)]
    return jcache


def test_new_arch_prefill_and_decode_match_jax(arch_pair):
    """Prefill logits and caches, then eight decode steps' logits and the caches.
    A 12-token prompt is longer than recurrentgemma's window of 8, so its
    attention caches hold the rolled ring and decode writes around it."""
    jcfg, tcfg, jparams, tparams = arch_pair
    rng = np.random.default_rng(2)
    b, s, cache_len = 2, 12, 32
    tokens = rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    jdecode = jax.jit(lambda p, t, pos, c: jax_model.decode_step(p, jcfg, t, pos, c))
    jlogits, jcache = jax_model.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, cache_len)
    tlogits, tcache = torch_model.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)},
                                          cache_len)
    _close(tlogits, jlogits)

    def same_cache():
        jlayers = _layer_caches(jcache, jcfg)
        assert len(tcache) == len(jlayers) == tcfg.num_layers
        for tl, jl in zip(tcache, jlayers):
            assert set(tl) == set(jl)
            for name, t in tl.items():
                if name == "pos":
                    assert t == int(jl[name])
                else:
                    assert t.dtype == torch.float32
                    _close(t, jl[name])

    same_cache()
    if tcfg.attn_window:
        assert tcache[2]["k"].shape[1] == tcfg.attn_window < s  # the ring roll was taken
    for step in range(8):
        token = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
        pos = np.full((b, 1), s + step, np.int32)
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

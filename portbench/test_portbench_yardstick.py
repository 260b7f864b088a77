"""The frozen arithmetic against hand counts, and ``attn_pairs`` against
``chip_smoke.py``'s loop."""
import json
from pathlib import Path

import pytest

from portbench import yardstick

CONFIGS = Path(__file__).resolve().parent / "configs"


def _pairs_by_loop(sq, skv, causal, window, q_offset):
    """``chip_smoke.py``'s ``attn_pairs``, as it is there."""
    total = 0
    for i in range(sq):
        qp = q_offset + i
        hi = min(skv - 1, qp) if causal else skv - 1
        lo = max(0, qp - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


@pytest.mark.parametrize("shape", [(4, 4, True, 0, 0), (5, 9, True, 0, 4), (3, 10, True, 0, 2),
                                   (6, 6, True, 3, 0), (4, 7, False, 0, 0), (7, 3, True, 0, 0)])
def test_kept_pairs_match_a_loop(shape):
    assert yardstick.attn_pairs(*shape) == _pairs_by_loop(*shape)


def test_flash_and_decode_costs_by_hand():
    # b 1, sq = skv = 4, 2 heads over 1 kv head, d 8, causal: 10 kept pairs
    flops, nbytes = yardstick.flash_cost(1, 4, 4, 2, 1, 8, causal=True)
    assert flops == 4 * 2 * 8 * 10
    assert nbytes == 2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8)
    # b 2, sq 3, skv 5, q_offset 2 (keys 3, 4, 5 kept), fp32
    flops, nbytes = yardstick.flash_cost(2, 3, 5, 4, 2, 16, causal=True, q_offset=2, elem=4)
    assert flops == 4 * 2 * 4 * 16 * (3 + 4 + 5)
    assert nbytes == 4 * (2 * 2 * 3 * 4 * 16 + 2 * 2 * 5 * 2 * 16)
    flops, nbytes = yardstick.decode_cost(2, 4, 2, 16, [5, 7])
    assert flops == 4 * 4 * 16 * 12
    assert nbytes == 2 * (2 * 2 * 4 * 16 + 2 * 12 * 2 * 16) + 4 * 2
    assert yardstick.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert yardstick.bound_s(1.0, 989e12) == pytest.approx(1.0)


def test_active_parameters_and_request_flops_by_hand():
    from portbench.archs import qwen2

    cfg = json.loads((CONFIGS / "qwen2-7b.json").read_text())
    attn = 2 * 3584 * 3584 + 2 * 3584 * 512 + 3584 + 2 * 512
    layer = attn + 3 * 3584 * 18944 + 2 * 3584
    assert qwen2.active_params_per_token(cfg) == 28 * layer + 3584
    moe = json.loads((CONFIGS / "qwen2-moe-a2.7b.json").read_text())
    attn = 4 * 2048 * 2048 + 3 * 2048
    layer = attn + 2048 * 60 + 4 * 3 * 2048 * 1408 + 3 * 2048 * 5632 + 2 * 2048
    assert qwen2.active_params_per_token(moe) == 24 * layer + 2048
    # one request of 3 prompt tokens and 2 new: 4 positions, 2 head rows
    n = qwen2.active_params_per_token(cfg)
    want = 2 * n * 4 + 4 * 28 * 128 * (1 + 2 + 3 + 4) * 28 + 2 * 152064 * 3584 * 2
    assert qwen2.request_flops(cfg, 3, 2) == want


@pytest.mark.parametrize("name", ["qwen2-7b", "qwen2-moe-a2.7b"])
def test_active_parameters_agree_with_the_ports_count(name):
    pytest.importorskip("torch")
    from repro_torch.configs import get_config

    from portbench.archs import qwen2

    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    port = get_config(name)
    embed = 2 * port.vocab_size * port.d_model
    assert qwen2.active_params_per_token(cfg) == port.param_count(active_only=True) - embed


def test_flash_cost_counts_v_at_its_own_width():
    # qk 192 and v 128 (latent attention's prefill): b 2, sq = skv = 4, 3
    # heads over 3 kv heads, causal: 10 kept pairs a head
    flops, nbytes = yardstick.flash_cost(2, 4, 4, 3, 3, 192, causal=True, dv=128)
    assert flops == 2 * 2 * 3 * 10 * (192 + 128)
    assert nbytes == 2 * (2 * 4 * 3 * (192 + 128) + 2 * 4 * 3 * (192 + 128))
    # v at q's width is the count without dv, exactly
    for shape, kw in (((1, 4, 4, 2, 1, 8), dict(causal=True)),
                      ((2, 3, 5, 4, 2, 16), dict(causal=True, q_offset=2, elem=4))):
        assert yardstick.flash_cost(*shape, dv=shape[-1], **kw) == \
            yardstick.flash_cost(*shape, **kw)

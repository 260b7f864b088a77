"""The plain reference against the port at the smoke widths on the CPU, and
the check and its control on a tiny closed-loop run."""
import pytest

torch = pytest.importorskip("torch")

from portbench import reference as ref  # noqa: E402
from portbench.archs import qwen2  # noqa: E402
from portbench import _tiny as tiny  # noqa: E402
from portbench import check, weights  # noqa: E402

ARCHS = ["qwen2-7b", "qwen2-moe-a2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_logits_match_the_ports_forward_in_fp32(arch):
    from repro_torch.models import model as model_lib

    cfg = dict(tiny.CONFIGS[arch], torch_dtype="float32")
    params = weights.draw(cfg, 7, "cpu")
    pc = tiny.port_cfg(arch, "float32")
    toks = torch.randint(1, 256, (3, 21), generator=torch.Generator().manual_seed(1))
    want, _ = model_lib.forward(params, pc, {"tokens": toks.to(torch.int32)}, impl="ref")
    got = {}
    qwen2.forward(cfg, params, toks, [list(range(21))] * 3,
                  lambda i, lg: got.__setitem__(i, lg))
    got = torch.stack([got[i] for i in range(3)])
    assert torch.allclose(got, want.float(), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_of_an_fp32_run_sit_on_the_references_best(arch):
    import time

    from portbench import harness

    c = tiny.cell(arch)
    c.config = dict(c.config, torch_dtype="float32")
    res = harness.run(c, 9, 0.0, False, t_start=time.perf_counter(), device="cpu",
                      port_cfg=tiny.port_cfg(arch, "float32"), log=lambda m: None)
    assert res["correct"] and res["failed"] == 0
    assert res["_numbers"]["max_logit_gap"] < 1e-4
    assert res["_numbers"]["tokens_checked"] >= c.limit["served_tokens"]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_bf16_program_passes_and_the_fp8_control_fails(arch):
    """The control: the reference in float8 e4m3 at each served position,
    judged by the cell's own limits as a run judges the program, comes out
    not correct on every seed; the bf16 program comes out correct."""
    c = tiny.cell(arch, **tiny.LONGER)
    for seed in (21, 22, 23):
        res = tiny.run(arch, seed=seed, deep=True, others=("fp8",))
        assert res["correct"], res["check"]
        checks = check.control_verdict(res["_numbers"], c.limit)
        assert not check.within(checks), checks


def test_capacity_keeps_the_first_pairs_of_an_expert_in_token_choice_order():
    sel = torch.tensor([[0, 1], [0, 2], [0, 1], [2, 0]])  # 8 pairs over 3 experts
    keep = ref.capacity_keep(sel, 3, 1.0)  # capacity ceil(8 / 3) = 3
    assert keep.tolist() == [[True, True], [True, True], [True, True], [True, False]]


def test_fp8_rounds_to_three_mantissa_bits_under_one_scale():
    x = torch.tensor([448.0, 1.0, 1.0625, -3.3])
    assert ref.fp8(x).tolist() == [448.0, 1.0, 1.0, -3.25]

"""A run with the timed path broken underneath comes out not correct: for
each fault a served cell can have on one card (there is no exchange
between chips to leave out)."""
import pytest

torch = pytest.importorskip("torch")

from portbench import _tiny as tiny, faults  # noqa: E402

ARCHS = ["qwen2-7b", "qwen2-moe-a2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(arch, fault):
    with faults.planted(fault):
        res = tiny.run(arch, seed=31, deep=True)
    assert not res["correct"]
    compared = tiny.cell(arch).limit["compare"]
    assert any(res["check"][n]["value"] > res["check"][n]["limit"] for n in compared)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_same_run_unbroken_is_correct(arch):
    res = tiny.run(arch, seed=31, deep=True)
    assert res["correct"], res["check"]

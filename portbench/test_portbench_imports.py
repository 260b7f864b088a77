"""Nothing a run loads has ``jax``, ``jaxlib``, ``flax`` or ``repro`` as its
top-level module name (compared whole: ``repro_torch`` is the port), and the
reference and every architecture module import nothing of the port."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[1]
BENCH = CHECKOUT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    bad = [(f.name, m) for f in files for m in _imported(f) if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_the_reference_imports_nothing_of_the_port():
    files = [BENCH / "reference.py", *sorted((BENCH / "archs").glob("*.py"))]
    assert len(files) >= 3
    for f in files:
        assert not [m for m in _imported(f) if m.split(".")[0] == "repro_torch"], f.name
    modules = ["portbench.reference"] + [
        "portbench.archs" + ("" if f.stem == "__init__" else f".{f.stem}") for f in files[1:]]
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            + "".join(f"import {m}\n" for m in modules)
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'jax', 'repro'}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_a_whole_run_loads_no_jax():
    pytest.importorskip("torch")
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from portbench import harness\n"
            "from portbench import _tiny as tiny\n"
            "res = tiny.run('qwen2-moe-a2.7b', seed=4)\n"
            "assert res['correct'], res['check']\n"
            "print(harness.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_that_loaded_the_jax_package_prints_no_result(monkeypatch, capsys):
    import types

    pytest.importorskip("torch")
    from portbench import run
    from portbench import _tiny as tiny

    result = tiny.run("qwen2-7b", seed=4)
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    assert run.emit(dict(result)) == 3
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(run.harness, "forbidden_modules", lambda: [])
    assert run.emit(dict(result)) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "check" and line["correct"]
    assert err.strip().splitlines()[-1].startswith("check fed_token_mismatches 0")

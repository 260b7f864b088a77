"""The port stands alone: it imports neither ``jax`` nor ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the port, and what runs on a GPU machine that may have no JAX
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "time_attention.py", ROOT / "count_launches.py",
    ROOT / "tests" / "test_torch_cuda.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_the_port_loads_no_jax_and_no_repro():
    pytest.importorskip("torch")
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 54  # every module of the port was imported


def test_importing_the_dry_run_starts_no_process_group():
    """The dry run starts its fake world inside ``run_cells``: its import
    starts no process group and sets no environment variable (the
    reference's sets XLA_FLAGS at import)."""
    pytest.importorskip("torch")
    code = (
        "import os\n"
        "import torch.distributed as dist\n"
        "before = dict(os.environ)\n"
        "import repro_torch.launch.dryrun\n"
        "assert not dist.is_initialized()\n"
        "assert dict(os.environ) == before\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py", "time_attention.py", "count_launches.py"])
def test_card_scripts_exit_nonzero_without_a_card(script):
    """Without a CUDA device the scripts print no result and fail."""
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(ROOT / script)], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "ms" not in res.stdout


# what a solver's step runs, hour after hour, on the card
SOLVER_FILES = [ROOT / "src" / "repro_torch" / "optim" / "adamw.py"] + [
    ROOT / "src" / "repro_torch" / "core" / f"{m}.py"
    for m in ("game", "force_directed", "nash", "networks", "draws", "ppo", "gt_drl", "genetic",
              "ppo_joint", "ddpg")] + [
    ROOT / "src" / "repro_torch" / "dcsim" / f"{m}.py" for m in ("env", "latency", "ties")] + [
    ROOT / "src" / "repro_torch" / "faults" / f"{m}.py" for m in ("failover", "guard")]


@pytest.mark.parametrize("path", SOLVER_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_solver_steps_read_nothing_back_from_the_device(path):
    """No read back to the host in a solver's code: each would stall the
    card's queue every step. (chip_smoke.py also runs a gt-drl half-update
    under CUDA's sync debug mode, which fails on a synchronizing call.)"""
    src = path.read_text()
    for read in (".item(", ".tolist(", ".cpu(", ".numpy(", "synchronize("):
        assert read not in src, f"{path.relative_to(ROOT)} calls {read}"


# telemetry: its taps keep device tensors, and one function of obs/tap.py
# (``flush``) moves a run's values to the host after the run
OBS_FILES = sorted((ROOT / "src" / "repro_torch" / "obs").glob("*.py"))


def test_obs_reads_the_device_in_one_place():
    """Of the telemetry modules only ``obs/tap.py`` reads back to the host,
    once (``flush``); the solver files it taps read nothing back."""
    readers = {p.name: [r for r in (".item(", ".cpu(", ".numpy(", "synchronize(")
                        if r in p.read_text()] for p in OBS_FILES}
    assert {n: r for n, r in readers.items() if r} == {"tap.py": [".cpu(", ".numpy("]}
    assert (ROOT / "src" / "repro_torch" / "obs" / "tap.py") not in SOLVER_FILES
    assert (ROOT / "src" / "repro_torch" / "obs" / "tap.py") in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"

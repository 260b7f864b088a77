"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C entry
point, compiled for ``sm_90a`` (Hopper) into ``build/kernels/`` at the root
of the checkout, which ``.gitignore`` lists. A library's file name carries a
hash of its sources and flags, so an edited source is rebuilt at its next use
and an unchanged one is loaded as it is. Nothing is built when this module is
imported: a kernel is built at its first launch, or by :func:`build` for
several kernels at once, one ``nvcc`` process each, all started together.

The C entry points take pointers and the stream as ``void*`` and return the
launch's ``cudaError_t``; :meth:`CudaKernel.launch` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
# head dims that only the fp32 (CUDA-core) paths take: 16, cfg.smoke()'s
FP32_HEAD_DIMS = (16,)
CUDA_GRID_Y = 65535  # a launch grid's y limit


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME")


def library_path(source: str) -> Path:
    """The library built from ``csrc/<source>`` with the current sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: Iterable[str]) -> Dict[str, float]:
    """Build the libraries of ``sources`` that are missing, in parallel.

    Returns the seconds each build took (0.0 for one already built). The
    compiler's resource report (registers, shared memory, spills) is kept
    beside each library as ``<library>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    seconds: Dict[str, float] = {}
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            seconds[source] = 0.0
            continue
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started.append((source, lib, tmp, proc, time.perf_counter()))
    failures: List[str] = []
    for source, lib, tmp, proc, t0 in started:
        out, _ = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {source} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build of the same source is harmless
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


class CudaKernel:
    """One C entry point of a library built from ``csrc/<source>``.

    ``launches`` counts the launches that returned no error; the library is
    built and loaded at the first launch.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence[type]):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None

    def load(self):
        if self._fn is None:
            build([self.source])
            lib = ctypes.CDLL(str(library_path(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream (appended as the last argument)."""
        fn = self.load()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            msg = self._lib.kernel_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def check_cuda_inputs(name: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Raise on what the attention kernels do not take: another device than
    one CUDA card, a dtype other than fp32 / bf16 (the same for all), a
    non-contiguous tensor, one not 16-byte aligned (the kernels load 16 bytes
    a lane). Shapes are :func:`shape_error`'s."""
    first = next(iter(tensors.values()))
    for arg, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name}: {arg} is on {t.device}; the kernel takes tensors on "
                             "one CUDA device (CPU tensors take the plain version)")
        if t.dtype != first.dtype or t.dtype not in DTYPE_CODES:
            raise ValueError(f"{name}: {arg} is {t.dtype}; the kernel takes float32 or "
                             "bfloat16, the same for every input")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")


def shape_error(name: str, *, b: int, sq: int, skv: int, h: int, d: int,
                dtype: torch.dtype) -> Optional[str]:
    """Why the attention kernel ``name`` ("flash_attention", "flash_attention_bwd"
    or "decode_attention") refuses a call of these shapes, or None.

    These are the checks that read shapes alone, so that the kernels' wrappers
    and the dry run (``launch/dryrun.py``, which holds every cell's per-rank
    attention shapes to them) share one rule: a head dim other than 32, 64,
    128 or 256 (16 too in fp32), and a grid whose y axis exceeds
    ``CUDA_GRID_Y``. The flash grids put b * h (fp32: query tiles, b * h),
    64-row query tiles and the backward's 32- or 64-key tiles on y; decode
    puts the batch there.
    """
    if d not in HEAD_DIMS and not (d in FP32_HEAD_DIMS and dtype == torch.float32):
        return (f"{name}: head dim {d} not in {HEAD_DIMS} for {dtype} ({FP32_HEAD_DIMS} in "
                "float32 only); other head dims are ROADMAP.md B.1")
    if name == "decode_attention":
        if b > CUDA_GRID_Y:
            return f"{name}: batch {b} over the grid's y limit {CUDA_GRID_Y}"
    elif sq == 0 or max(b * h, -(-sq // 64), -(-skv // 32)) > CUDA_GRID_Y:
        return f"{name}: grid of {sq} query rows, {skv} keys x {b * h} heads out of range"
    return None


def check_shapes(name: str, **shape) -> None:
    """Raise :func:`shape_error`'s reason, if any."""
    err = shape_error(name, **shape)
    if err is not None:
        raise ValueError(err)

#!/usr/bin/env python3
"""Time the port's two attention kernels at llama3.2-1b's serving shapes.

    python3 time_attention.py [--src DIR]

Times ``flash_attention`` (q (8,256,32,64), causal) and ``decode_attention``
(q (8,32,64), cache (8,1024,8,64), lengths 257-287) in bf16 from the
``repro_torch`` package under ``DIR`` (default: this checkout's ``src``),
with ``chip_smoke.time_ms``: CUDA events around calls queued behind a spin
kernel, warm and with L2 flushed. The inputs come from seed 0, the same for
every ``DIR``, so the kernels of two commits are compared by one method:
unpack the other commit into a directory ``.gitignore`` lists (``git
archive``) and run parent, change, change, parent in one session on the card.
Each kernel is held against this checkout's plain version first. Prints one
JSON line; exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the directory that holds the repro_torch package to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 1
    src = args.src.resolve()
    # the kernels under test come from src; chip_smoke (the timer, the
    # bounds) and the plain versions from this checkout
    sys.path.insert(0, str(src))
    from repro_torch.kernels import decode_attention as dec_mod
    from repro_torch.kernels import flash_attention as flash_mod
    for mod in (dec_mod, flash_mod):
        if not Path(mod.__file__).resolve().is_relative_to(src):
            raise SystemExit(f"time_attention: {mod.__name__} came from {mod.__file__}")
    sys.path.insert(1, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke

    ref = _plain_versions()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    batch, prompt, new, cache, h, kvh, d = 8, 256, 32, 1024, 32, 8, 64
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    out = {"src": str(src)}

    q, k, v = randn(batch, prompt, h, d), randn(batch, prompt, kvh, d), randn(batch, prompt, kvh, d)
    kernel = lambda: flash_mod.flash_attention(q, k, v, causal=True)
    err = chip_smoke.max_err(kernel(), ref.attention_ref(q, k, v, causal=True))
    if not err < chip_smoke.TOL[bf16]:
        raise SystemExit(f"time_attention: flash_attention max err {err}")
    out["flash_attention"] = dict(max_abs_err=err, ms=chip_smoke.time_ms(kernel),
                                  ms_cold_l2=chip_smoke.time_ms(kernel, flush=flush))

    q = randn(batch, h, d)
    kc, vc = randn(batch, cache, kvh, d), randn(batch, cache, kvh, d)
    lens = torch.randint(prompt + 1, prompt + new, (batch,), generator=gen, device=dev,
                         dtype=torch.int32)
    kernel = lambda: dec_mod.decode_attention(q, kc, vc, lens)
    err = chip_smoke.max_err(kernel(), ref.decode_attention_ref(q, kc, vc, lens))
    if not err < chip_smoke.TOL[bf16]:
        raise SystemExit(f"time_attention: decode_attention max err {err}")
    out["decode_attention"] = dict(
        lengths=lens.tolist(), max_abs_err=err, ms=chip_smoke.time_ms(kernel, iters=100),
        ms_cold_l2=chip_smoke.time_ms(kernel, iters=100, flush=flush))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out["card"] = smi.stdout.strip()
    print(json.dumps(out))
    return 0


def _plain_versions():
    """This checkout's ``repro_torch.kernels.ref``, loaded by path: the package
    name is taken by the kernels under test."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_plain_ref", ROOT / "src" / "repro_torch" / "kernels" / "ref.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


if __name__ == "__main__":
    sys.exit(main())

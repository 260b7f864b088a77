#!/usr/bin/env python3
"""Time the port's two attention kernels at llama3.2-1b's serving shapes.

    python3 time_attention.py [--src DIR] [--decode-d256 | --bwd]

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

With ``--decode-d256`` it times ``decode_attention`` instead at
recurrentgemma-9b's decode shape (q (8,16,256), cache (8,2048,1,256),
lengths 2048, bf16) beside two controls that split its cost. The kernel
gives a block 4 query heads of a group, so the group of 16 takes 4 blocks,
each reading the same kv head. "one block" (H = 4) keeps each block's work
and drops 3 of the 4 blocks; "gqa" (H = 16, KVH = 4) keeps the grid and each
block's work and gives every block a kv head of its own, 4x the distinct
bytes.

With ``--bwd`` it times ``flash_attention_bwd`` instead, the backward kernel
alone from the forward kernel's ``out`` and ``lse``, at llama3.2-1b's
training shape (q (8,256,32,64), k/v (8,256,8,64), causal) and the MQA case
(q (1,200,8,256), k/v (1,200,1,256), causal), bf16 and fp32, warm and with
L2 flushed, and each of its kernels' device time (``chip_smoke.bwd_kernel_ms``,
torch.profiler), after holding it against this checkout's plain backward
(``kernels/flash_vjp.py``) at ``chip_smoke.BWD_TOL``.
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
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--decode-d256", action="store_true",
                      help="time decode at recurrentgemma-9b's shape and its controls")
    mode.add_argument("--bwd", action="store_true",
                      help="time the flash backward at the training shape and the MQA case")
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

    ref = _plain_versions("ref")
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    batch, prompt, new, cache, h, kvh, d = 8, 256, 32, 1024, 32, 8, 64
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    out = {"src": str(src)}
    if args.decode_d256:
        out["decode_attention_d256"] = _decode_d256(chip_smoke, ref, dec_mod, randn, flush)
        print(json.dumps(out | {"card": _card()}))
        return 0
    if args.bwd:
        out["flash_attention_bwd"] = _bwd(chip_smoke, flash_mod, gen, flush)
        print(json.dumps(out | {"card": _card()}))
        return 0

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

    out["card"] = _card()
    print(json.dumps(out))
    return 0


def _decode_d256(chip_smoke, ref, dec_mod, randn, flush) -> dict:
    """decode_attention at (H, KVH) = (16, 1), recurrentgemma-9b's, and the
    controls (4, 1) and (16, 4): batch 8, 2048 cached keys, head dim 256."""
    batch, cache, d = 8, 2048, 256
    lens = torch.full((batch,), cache, dtype=torch.int32, device=flush.device)
    res = {}
    for name, h, kvh in (("mqa", 16, 1), ("one block", 4, 1), ("gqa", 16, 4)):
        q, kc, vc = randn(batch, h, d), randn(batch, cache, kvh, d), randn(batch, cache, kvh, d)
        kernel = lambda: dec_mod.decode_attention(q, kc, vc, lens)
        err = chip_smoke.max_err(kernel(), ref.decode_attention_ref(q, kc, vc, lens))
        if not err < chip_smoke.TOL[torch.bfloat16]:
            raise SystemExit(f"time_attention: decode_attention {name} max err {err}")
        res[name] = dict(q=list(q.shape), cache=list(kc.shape), max_abs_err=err,
                         cache_bytes=2 * kc.numel() * kc.element_size(),
                         ms=chip_smoke.time_ms(kernel, iters=100),
                         ms_cold_l2=chip_smoke.time_ms(kernel, iters=100, flush=flush))
    return res


def _bwd(chip_smoke, flash_mod, gen, flush) -> list:
    """flash_attention_bwd at chip_smoke.BWD_SPLIT_CASES in bf16 and fp32."""
    vjp = _plain_versions("flash_vjp")
    dev = flush.device
    rows = []
    for case in chip_smoke.BWD_SPLIT_CASES:
        b, sq, skv, h, kvh, d, causal, window, softcap, q_offset = case
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g = (torch.randn(s, generator=gen, device=dev).to(dtype)
                          for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d),
                                    (b, sq, h, d)))
            o, lse = flash_mod.flash_attention_fwd(q, k, v, sm_scale=None, **kw)
            kernel = lambda: flash_mod.flash_attention_bwd(q, k, v, o, lse, g, sm_scale=None,
                                                           **kw)
            po, plse = vjp.flash_fwd(q, k, v, scale=d ** -0.5, chunk=min(512, skv), **kw)
            want = vjp.flash_bwd(q, k, v, po, plse, g, scale=d ** -0.5, chunk=min(512, skv),
                                 **kw)
            got = kernel()
            err = max((chip_smoke.max_err if dtype == torch.float32 else chip_smoke.rel_norm)(a, w)
                      for a, w in zip(got, want))
            if not err < chip_smoke.BWD_TOL[dtype]:
                raise SystemExit(f"time_attention: flash_attention_bwd {case} {dtype} err {err}")
            rows.append(dict(case=list(case), dtype=str(dtype)[6:], grad_err=err,
                             ms=chip_smoke.time_ms(kernel),
                             ms_cold_l2=chip_smoke.time_ms(kernel, flush=flush),
                             **chip_smoke.bwd_kernel_ms(kernel)))
    return rows


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip()


def _plain_versions(name: str):
    """This checkout's ``repro_torch.kernels.<name>`` (``ref`` or
    ``flash_vjp``), loaded by path: the package name is taken by the kernels
    under test."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_plain_{name}", ROOT / "src" / "repro_torch" / "kernels" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


if __name__ == "__main__":
    sys.exit(main())

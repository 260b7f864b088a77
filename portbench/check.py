"""How ``correct`` is decided: the served tokens against the plain reference.

After the window, a sample of the finished requests drawn from the seed,
with the one that served the most tokens in it, is run through the float32
reference of the configuration's architecture (``archs/<arch>.py``
``forward``) teacher-forced: each row is its request's padded prompt and the
tokens the engine fed back to its decode steps, as the timed path ran them.
For each served token, the gap by which its reference logit lies below the
reference's best at that position is read; the numbers the cell's limit
file (``limits/<cell>.json``) names under ``compare`` (the widest gap, or
the mean and the share over ``FAR``) are held to their limits. Served
tokens are greedy, so a sound engine's gap is rounding alone.

Where serving couples no rows (the architecture's ``couples_rows``: a
dense model), requests are sampled one by one. Where it does (an MoE's
capacity slots), the sample is whole batches: the one that holds the
longest request, then others.

The control (``others=("fp8",)``, run by ``calibrate.py`` and the tests,
never by the benchmark's runs): the same reference in float8 e4m3 at each of
the same positions; the gap of the token it puts first is read in the
float32 reference. The bf16 witness (``"bf16"``) reads the same of the
reference rounded as the served path rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import archs


@dataclasses.dataclass
class Served:
    """One batch as the window served it, with its host-clock times (s)."""

    batch: object  # traffic.Batch
    outs: List[List[int]]  # served tokens, in the batch's row order
    fed: List[torch.Tensor]  # the (rows, 1) int tokens each decode step took
    t_hand: float  # the batch handed to generate
    prefill_start: float  # prefill_step entered
    first_token: float  # prefill_step returned and the card finished it
    t_return: float  # generate returned every request's tokens

    def fed_matrix(self) -> torch.Tensor:
        """(rows, steps - 1) tokens the decode steps took, on the host."""
        if not self.fed:
            return torch.zeros((len(self.outs), 0), dtype=torch.int64)
        return torch.cat(self.fed, dim=1).cpu().to(torch.int64)


def sample(served: Sequence[Served], cfg: Dict, min_tokens: int, seed: int):
    """[(index into served, rows)]: the requests the check reruns."""
    rng = np.random.default_rng([seed, 2])
    reqs = [(i, r, len(s.outs[r])) for i, s in enumerate(served) for r in range(len(s.outs))]
    longest = max(reqs, key=lambda x: x[2])
    if archs.of(cfg).couples_rows(cfg):
        order = [longest[0]] + [int(i) for i in rng.permutation(len(served))
                                if i != longest[0]]
        picked, total = [], 0
        for i in order:
            picked.append((i, list(range(len(served[i].outs)))))
            total += sum(len(o) for o in served[i].outs)
            if total >= min_tokens:
                break
        return picked
    chosen = {(longest[0], longest[1])}
    total = longest[2]
    for j in rng.permutation(len(reqs)):
        if total >= min_tokens:
            break
        i, r, n = reqs[j]
        if (i, r) not in chosen:
            chosen.add((i, r))
            total += n
    by_batch: Dict[int, List[int]] = {}
    for i, r in sorted(chosen):
        by_batch.setdefault(i, []).append(r)
    return sorted(by_batch.items())


def _rows(s: Served, rows: List[int], whole: bool):
    """(token rows (R, T), logit positions per row, served tokens per row)."""
    b = s.batch
    pad = b.padded_len
    fed = s.fed_matrix()
    lens = [pad + (fed.shape[1] if whole else len(s.outs[r]) - 1) for r in rows]
    toks = torch.zeros((len(rows), max(lens)), dtype=torch.int64)
    for j, r in enumerate(rows):
        p = torch.from_numpy(b.prompts[r].astype(np.int64))
        toks[j, : len(p)] = p
        n = lens[j] - pad
        toks[j, pad: pad + n] = fed[r, :n]
    positions = [list(range(pad - 1, pad - 1 + len(s.outs[r]))) for r in rows]
    return toks, positions, [s.outs[r] for r in rows]


def fed_mismatches(served: Sequence[Served]) -> int:
    """Served tokens that differ from the tokens the engine fed back for them."""
    bad = 0
    for s in served:
        fed = s.fed_matrix().tolist()
        for r, out in enumerate(s.outs):
            n = min(len(out), len(fed[r]))
            bad += sum(int(a != b) for a, b in zip(out[:n], fed[r][:n]))
    return bad


def judge(served: Sequence[Served], cfg: Dict, params: Dict, min_tokens: int, seed: int, *,
          device, others: Sequence[str] = ()) -> Dict[str, float]:
    """The check's numbers: the widest, the mean and the 99th percentile
    logit gap of the served tokens, the tokens it read, the share of them
    that are the reference's best and the share whose gap is over ``FAR``.
    For each precision of ``others`` ("fp8": the control; "bf16": the
    witness of rounding alone), the same numbers of the tokens the reference
    in that precision puts first at the same positions, under its name."""
    arch = archs.of(cfg)
    whole = arch.couples_rows(cfg)
    gaps: Dict[str, List[float]] = {name: [] for name in ("", *others)}
    for i, rows in sample(served, cfg, min_tokens, seed):
        toks, positions, outs = _rows(served[i], rows, whole)
        toks = toks.to(device)
        prefill = served[i].batch.padded_len if whole else None
        picks: Dict[str, Dict[int, torch.Tensor]] = {"": {}}
        for j, out in enumerate(outs):
            picks[""][j] = torch.as_tensor(out, device=device)
        for prec in others:
            picks[prec] = {}
            arch.forward(cfg, params, toks, positions,
                         lambda j, lg, into=picks[prec]: into.__setitem__(j, lg.argmax(-1)),
                         prefill_len=prefill, precision=prec)

        def reduce(j: int, logits: torch.Tensor) -> None:
            best = logits.max(-1).values
            for name, chosen in picks.items():
                tok = chosen[j].to(logits.device)
                gaps[name].extend((best - logits.gather(1, tok[:, None])[:, 0]).tolist())

        arch.forward(cfg, params, toks, positions, reduce, prefill_len=prefill)
    out: Dict[str, float] = {"tokens_checked": len(gaps[""])}
    for name, g in gaps.items():
        out.update(_spread(f"{name}_" if name else "", g))
    return out


# the gap over which a served token counts as far from the reference's best
FAR = 1.0


def _spread(prefix: str, gaps: List[float]) -> Dict[str, float]:
    g = np.asarray(gaps)
    out = {f"{prefix}max_logit_gap": float(g.max()),
           f"{prefix}mean_logit_gap": float(g.mean()),
           f"{prefix}p99_logit_gap": float(np.quantile(g, 0.99)),
           f"{prefix}agree_share": float((g == 0.0).mean())}
    out[f"{prefix}share_gap_over_{FAR:g}"] = float((g > FAR).mean())
    return out


def control_verdict(numbers: Dict[str, float], limit: Dict,
                    name: str = "fp8") -> Dict[str, Dict[str, float]]:
    """``verdict`` of the numbers the precision ``name`` of ``judge``'s
    ``others`` read, as though they were the program's: the control has to
    come out not ``within``."""
    mine = {k[len(name) + 1:]: v for k, v in numbers.items() if k.startswith(f"{name}_")}
    mine["tokens_checked"] = numbers["tokens_checked"]
    return verdict(mine, limit, 0)


def verdict(numbers: Dict[str, float], limit: Dict,
            mismatches: int) -> Dict[str, Dict[str, float]]:
    """The compared numbers, each with its limit: those the cell's limit file
    names under ``compare`` (at most their limit), the tokens read (at least
    the file's ``served_tokens``) and the fed-back mismatches (none)."""
    out = {name: {"value": numbers[name], "limit": lim}
           for name, lim in limit["compare"].items()}
    out["tokens_checked"] = {"value": numbers["tokens_checked"], "limit": limit["served_tokens"]}
    out["fed_token_mismatches"] = {"value": mismatches, "limit": 0}
    return out


def within(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] >= c["limit"] if name == "tokens_checked" else c["value"] <= c["limit"]
               for name, c in checks.items())


def check_lines(checks: Dict[str, Dict[str, float]], readings: Dict[str, float]) -> str:
    """The lines standard error ends with: what the check read besides, then
    each compared number beside its limit, last."""
    lines = [f"read {name} {v!r}" for name, v in readings.items()]
    for name, c in checks.items():
        rel = ">=" if name == "tokens_checked" else "<="
        lines.append(f"check {name} {c['value']!r} {rel} {c['limit']!r}")
    return "\n".join(lines)

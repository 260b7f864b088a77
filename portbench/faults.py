"""Faults planted under the timed path, for the tests and for
``calibrate.py``'s readings at a cell's own size: each breaks one of
``serve``'s step functions the way a wrong program could, and a run with it
planted has to come out not correct. There is no exchange between chips to
leave out on one card."""
import contextlib
import importlib

import torch

TARGET = "repro_torch.launch.serve"


def _altered_token(orig):
    """Decode step 2 hands row 1 a token that is not its best."""
    calls = []

    def step(params, token, positions, cache, **kw):
        logits, cache = orig(params, token, positions, cache, **kw)
        calls.append(1)
        if len(calls) == 2:
            logits = logits.clone()
            worst = logits[1, 0].argmin()
            logits[1, 0, worst] = logits[1, 0].max() + 1.0
        return logits, cache
    return step


def _state_unchanged(orig):
    """Every decode step hands back the cache it was given, its position not
    advanced."""
    def step(params, token, positions, cache, **kw):
        logits, _ = orig(params, token, positions, cache, **kw)
        return logits, cache
    return step


def _half_batch(orig):
    """Prefill runs the first half of the batch and gives its rows to the rest."""
    def prefill(params, batch, **kw):
        b = batch["tokens"].shape[0]
        half = {k: v[: b // 2] for k, v in batch.items()}
        logits, cache = orig(params, half, **kw)
        rep = lambda t: torch.cat([t, t[: b - b // 2]], dim=0)
        cache = [{k: (rep(v) if torch.is_tensor(v) else v) for k, v in c.items()}
                 for c in cache]
        return rep(logits), cache
    return prefill


FAULTS = {"token_altered": ("decode_step", _altered_token),
          "state_unchanged": ("decode_step", _state_unchanged),
          "half_batch_left_out": ("prefill_step", _half_batch)}


@contextlib.contextmanager
def planted(name: str):
    """``serve``'s step function broken by the fault ``name`` while inside."""
    attr, make = FAULTS[name]
    mod = importlib.import_module(TARGET)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)

"""Fault-tolerant checkpointing: atomic, resumable, device-agnostic.

The port of ``repro.checkpoint.manager`` for the port's trees (nested dicts,
lists, tuples and NamedTuples, ``repro_torch.tree``) of torch tensors and
numpy arrays. Its files are the port's own; they follow the reference's
layout:

  * one directory per step: ``ckpt_dir/step_000123/``;
  * each top-level state field is an ``.npz`` of its leaves in
    ``tree_leaves`` order, written into ``step_*.tmp`` and renamed into
    place once the step is complete;
  * a ``MANIFEST.json`` (with per-file sha256) is written *last* — a
    checkpoint without a manifest is treated as torn and ignored by
    ``steps`` (crash-consistent restore);
  * leaves are saved from the host, so a checkpoint written from the card
    restores onto the CPU or another card: restore puts each leaf on the
    device and dtype of its template (a bfloat16 leaf is saved as its bits,
    int16, since numpy has no bfloat16);
  * a DTensor leaf is saved whole (``full_tensor``, a collective every rank
    of its mesh joins) and restored onto its template's mesh and placements,
    so a checkpoint written over one mesh restores over another, or none.

``save`` keeps every step (the sweep journal, ``faults/resume.py``, needs
them all); the trainer calls ``prune`` after each save, which keeps the last
``KEEP`` complete steps for rollback, the reference's default retention.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..distributed.sharding import full, is_dtensor
from ..tree import tree_leaves, tree_unflatten

_STEP_RE = re.compile(r"^step_(\d{9})$")
KEEP = 3  # complete steps ``prune`` keeps


def _to_host(x: Any) -> np.ndarray:
    if torch.is_tensor(x):
        x = full(x).detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _like(template: Any, arr: np.ndarray) -> Any:
    """``arr`` on the device and dtype of a tensor or array ``template``;
    any other template leaf takes the array as saved."""
    if torch.is_tensor(template):
        t = torch.from_numpy(arr)
        if template.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        t = t.to(device=template.device, dtype=template.dtype)
        if is_dtensor(template):
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(t, template.device_mesh, template.placements)
        return t
    if isinstance(template, np.ndarray):
        return arr.astype(template.dtype, copy=False)
    return arr


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def save(self, step: int, state: Dict[str, Any], extra: Optional[dict] = None) -> str:
        """Atomically write a checkpoint for ``step``: ``state`` maps a field
        name to a tree of tensors and arrays."""
        final = self.step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "files": {}, "extra": extra or {}}
        for name, tree in state.items():
            fpath = os.path.join(tmp, f"{name}.npz")
            np.savez(fpath, *(_to_host(x) for x in tree_leaves(tree)))
            manifest["files"][name] = {"sha256": _sha256(fpath)}
        # manifest is last: its presence marks the checkpoint complete
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final

    def steps(self):
        """The complete (manifested) steps, in order."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def prune(self) -> None:
        """Delete all but the last ``KEEP`` complete steps."""
        for step in self.steps()[:-KEEP]:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.step_dir(step), "MANIFEST.json")) as f:
            return json.load(f)

    def restore(self, step: int, templates: Dict[str, Any],
                verify: bool = True) -> Tuple[Dict[str, Any], dict]:
        """``templates``-shaped trees, each field sha256-checked against the
        manifest and each leaf on its template's device and dtype, and the
        step's ``extra``."""
        manifest = self.manifest(step)
        out = {}
        for name, template in templates.items():
            fpath = os.path.join(self.step_dir(step), f"{name}.npz")
            if verify and manifest["files"][name]["sha256"] != _sha256(fpath):
                raise IOError(f"checkpoint {self.step_dir(step)} field {name}: "
                              "sha256 mismatch (corrupt)")
            want = tree_leaves(template)
            with np.load(fpath) as data:
                leaves = [_like(t, data[f"arr_{i}"]) for i, t in enumerate(want)]
            out[name] = tree_unflatten(template, leaves)
        return out, manifest.get("extra", {})

    def restore_latest(self, templates: Dict[str, Any],
                       verify: bool = True) -> Optional[Tuple[int, Dict[str, Any], dict]]:
        """(step, trees, extra) of the latest complete step, or None."""
        step = self.latest_step()
        if step is None:
            return None
        state, extra = self.restore(step, templates, verify)
        return step, state, extra

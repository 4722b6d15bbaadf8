"""Fault-tolerant checkpointing, in ``repro``'s layout.

Layout: ``<dir>/step_<n:08d>/`` with one ``.npy`` per leaf plus
``manifest.json`` (the step, a timestamp, each leaf's shape and dtype).
A leaf's file is named by its path in the tree (``repro_torch._tree``), the
keys joined by ``__``: a tuple's or list's position ``i`` as ``idx<i>``, a
dict's key, a named tuple's field, and the children of the port's
registered types by position as ``repro``'s pytree registrations number
them (a :class:`~repro_torch.pack.PackedArray`: ``0`` its payload, ``1``
its splits; a :class:`~repro_torch.precision.SiteTracker`: ``0`` its
RangeTracker). So a checkpoint of ``(state, tracker)`` names its files as
``repro``'s does, and one written by either package restores in the other.

Writes go to ``step_<n>.tmp`` and are renamed when complete, so a crash
mid-write never corrupts the latest checkpoint; :func:`latest_step` trusts
only complete directories. :func:`restore` loads each leaf on the host and
puts it on a device (the caller's, or its ``like`` leaf's).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import _tree

__all__ = ["save", "restore", "latest_step", "available_steps"]

_SEP = "__"


def _flatten(tree):
    """Each leaf with its file name, in ``repro``'s order."""
    return [(_SEP.join(path), leaf) for path, leaf in _tree.flatten(tree)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(tree, ckpt_dir: str, step: int) -> str:
    """Atomic checkpoint write. Returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "time": time.time(), "leaves": {}}
    for name, leaf in _flatten(tree):
        arr = _host(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def available_steps(ckpt_dir: str):
    """The steps of the complete checkpoints under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                steps.append(int(d[len("step_"):]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(like, ckpt_dir: str, step: int, device=None):
    """Load a checkpoint into the structure of ``like``: each leaf a tensor
    of its saved shape, in the dtype of ``like``'s leaf, on ``device``
    (None: the device of ``like``'s leaf). The bits are the saved ones."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    flat = _flatten(like)
    missing = [n for n, _ in flat if n not in manifest["leaves"]]
    if missing:
        raise ValueError(f"checkpoint at {path} missing leaves: {missing[:5]}...")

    def load(name, leaf):
        t = torch.from_numpy(np.load(os.path.join(path, name + ".npy")))
        if isinstance(leaf, torch.Tensor):
            return t.to(device=leaf.device if device is None else device, dtype=leaf.dtype)
        return t if device is None else t.to(device)

    return _tree.unflatten(like, iter([load(n, leaf) for n, leaf in flat]))

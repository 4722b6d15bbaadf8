"""Shared bench timing with an explicit compile/execute split.

:func:`measure` times a callable in two parts:

* the **first call** is timed separately and reported as ``compile_us``:
  for the port this is where a kernel's library loads (and builds, on a
  machine that has not built it yet) and its launch plan is computed, the
  figure the service plane's ``compile_seconds`` metric tracks;
* the remaining ``iters`` calls are averaged into ``us_per_call``, the
  steady-state figure.

A CUDA launch returns before its kernel ends, so on a CUDA device every call
is followed by ``torch.cuda.synchronize`` before the clock is read: without
it the times would be those of the launches, not of the work.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

__all__ = ["Timing", "measure", "sync"]


class Timing(NamedTuple):
    compile_us: float  # first call: load + plan + execute
    us_per_call: float  # steady-state mean over `iters` calls
    iters: int
    result: Any  # last call's output


def sync(out, device=None):
    """Wait for the work behind ``out`` (a tensor or a tree of them), or on
    ``device``, when it is a CUDA device; returns ``out``."""
    import torch

    from repro_torch import _tree

    devices = {leaf.device for _, leaf in _tree.flatten(out) if isinstance(leaf, torch.Tensor)}
    if device is not None:
        devices.add(torch.device(device))
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return out


def measure(fn, *args, iters: int = 3, **kw) -> Timing:
    """Time ``fn(*args, **kw)``: one first call, then the mean of ``iters``
    steady-state calls (see module docstring)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    t0 = time.perf_counter()
    out = sync(fn(*args, **kw))
    compile_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    for _ in range(iters):
        out = sync(fn(*args, **kw))
    us = (time.perf_counter() - t0) * 1e6 / iters
    return Timing(compile_us=compile_us, us_per_call=us, iters=iters, result=out)

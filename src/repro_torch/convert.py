"""Carry ``repro``'s values into the port.

``repro`` hands its values over as numpy arrays or plain dicts (this module
imports neither JAX nor ``repro``):

    state_from_numpy(np.asarray(jax_state), device="cpu")
    tracker_from_numpy(names, k, hi_ema, lo_ema, overflow_steps, shrink_steps)
    precision_from_dict(dataclasses.asdict(jax_prec))
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.flexformat import FlexFormat
from repro_torch.core.policy import PrecisionConfig, RangeTracker
from repro_torch.precision.sites import SiteTracker

__all__ = ["state_from_numpy", "tracker_from_numpy", "precision_from_dict"]


def state_from_numpy(x, *, device="cpu") -> torch.Tensor:
    """An f32 state array as a tensor on ``device`` (bits unchanged)."""
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(device)


def tracker_from_numpy(names, k, hi_ema, lo_ema, overflow_steps, shrink_steps, *, device="cpu") -> SiteTracker:
    """A SiteTracker from the five per-site arrays of a RangeTracker."""

    def t(v, dtype):
        return torch.from_numpy(np.array(v, dtype=dtype, copy=True).reshape(-1)).to(device)

    state = RangeTracker(
        hi_ema=t(hi_ema, np.float32),
        lo_ema=t(lo_ema, np.float32),
        k=t(k, np.int32),
        overflow_steps=t(overflow_steps, np.int32),
        shrink_steps=t(shrink_steps, np.int32),
    )
    return SiteTracker(tuple(names), state)


def _tuple(v):
    if isinstance(v, Sequence) and not isinstance(v, str):
        return tuple(_tuple(x) for x in v)
    return v


def precision_from_dict(d: Mapping) -> PrecisionConfig:
    """A PrecisionConfig from a config's fields (``dataclasses.asdict``
    output, with the format as a dict or an ``(eb, mb, fx)`` triple)."""
    d = dict(d)
    fmt = d.get("fmt")
    if isinstance(fmt, Mapping):
        d["fmt"] = FlexFormat(**fmt)
    elif fmt is not None and not isinstance(fmt, FlexFormat):
        d["fmt"] = FlexFormat(*fmt)
    for key in ("fixed_em", "kernel_blocks", "k_bounds"):
        if d.get(key) is not None:
            d[key] = _tuple(d[key])
    return PrecisionConfig(**d)

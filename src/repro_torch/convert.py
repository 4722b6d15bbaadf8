"""Carry ``repro``'s values into the port.

``repro`` hands its values over as numpy arrays or plain dicts (this module
imports neither JAX nor ``repro``):

    state_from_numpy(np.asarray(jax_state), device="cpu")
    tracker_from_numpy(names, k, hi_ema, lo_ema, overflow_steps, shrink_steps)
    precision_from_dict(dataclasses.asdict(jax_prec))
    params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")
    packed_from_numpy(np.asarray(pa.payload), np.asarray(pa.k), (pa.fmt.eb, pa.fmt.mb, pa.fmt.fx), pa.shape, pa.block)
    packed_to_numpy(packed)  # the same five fields back, for repro.pack.PackedArray
    mamba_state_from_numpy(st.h, st.conv)  # and mlstm_state_from_numpy(C, n), slstm_state_from_numpy(c, h)
    caches_from_numpy(cfg.pattern, jax.tree_util.tree_map(np.asarray, jax_caches))
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.flexformat import FlexFormat
from repro_torch.core.policy import PrecisionConfig, RangeTracker
from repro_torch.models.attention import KVCache
from repro_torch.models.config import parse_entry
from repro_torch.models.ssm import MambaState
from repro_torch.models.xlstm import MLSTMState, SLSTMState
from repro_torch.pack import PackedArray, payload_dtype
from repro_torch.precision.sites import SiteTracker

__all__ = [
    "state_from_numpy", "tracker_from_numpy", "precision_from_dict", "params_from_numpy", "packed_from_numpy",
    "packed_to_numpy", "mamba_state_from_numpy", "mlstm_state_from_numpy", "slstm_state_from_numpy",
    "caches_from_numpy",
]


def state_from_numpy(x, *, device="cpu") -> torch.Tensor:
    """An f32 state array as a tensor on ``device`` (bits unchanged)."""
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(device)


def tracker_from_numpy(names, k, hi_ema, lo_ema, overflow_steps, shrink_steps, *, device="cpu") -> SiteTracker:
    """A SiteTracker from the five per-site arrays of a RangeTracker: rows of
    ``(n_sites,)``, or ``(members, n_sites)`` for an ensemble's stacked
    tracker (``repro``'s ``run_ensemble`` tracker)."""

    def t(v, dtype):
        a = np.array(v, dtype=dtype, copy=True)
        return torch.from_numpy(a if a.ndim == 2 else a.reshape(-1)).to(device)

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


def params_from_numpy(tree, *, device="cpu"):
    """A parameter tree (nested dicts, tuples and lists of arrays, as
    ``repro``'s ``model_init`` returns) as tensors on ``device``, with the
    same layout, dtypes and bits."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, device=device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def packed_from_numpy(payload, k, fmt, shape, block, *, device="cpu") -> PackedArray:
    """A packed carry: the numpy children of a ``repro.pack.PackedArray``
    (its payload and splits) and its static fields (the format as a
    FlexFormat or ``(eb, mb, fx)``, the logical shape, the storage block),
    with the payload in the format's payload dtype and the bits unchanged."""
    fmt = fmt if isinstance(fmt, FlexFormat) else FlexFormat(*fmt)
    pay = torch.from_numpy(np.array(payload, dtype=np.int64, copy=True)).to(payload_dtype(fmt))
    splits = torch.from_numpy(np.array(k, dtype=np.int32, copy=True))
    return PackedArray(pay.to(device), splits.to(device), fmt, tuple(shape), tuple(block))


def packed_to_numpy(pa: PackedArray):
    """The five fields ``repro.pack.PackedArray(payload, k, fmt, shape,
    block)`` takes, as numpy arrays (payload in its unsigned dtype, k int32)
    and tuples, the format as ``(eb, mb, fx)``."""
    return (
        pa.payload.cpu().numpy().copy(), pa.k.cpu().numpy().astype(np.int32), (pa.fmt.eb, pa.fmt.mb, pa.fmt.fx),
        pa.shape, pa.block,
    )


def _tensor(x, device):
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def mamba_state_from_numpy(h, conv, *, device="cpu") -> MambaState:
    """A mamba mixer's carried state: ``h`` (..., B, d_inner, state) and the
    rolling conv window ``conv`` (..., B, conv_k - 1, d_inner), bits unchanged."""
    return MambaState(h=_tensor(h, device), conv=_tensor(conv, device))


def mlstm_state_from_numpy(C, n, *, device="cpu") -> MLSTMState:
    """An mLSTM cell's carried state: ``C`` (..., B, H, dk, dv), ``n`` (..., B, H, dk)."""
    return MLSTMState(C=_tensor(C, device), n=_tensor(n, device))


def slstm_state_from_numpy(c, h, *, device="cpu") -> SLSTMState:
    """An sLSTM cell's carried state: ``c`` and ``h``, (..., B, lstm_inner) each."""
    return SLSTMState(c=_tensor(c, device), h=_tensor(h, device))


_STATES = {"attn": KVCache, "mamba": mamba_state_from_numpy, "mlstm": mlstm_state_from_numpy,
           "slstm": slstm_state_from_numpy}


def caches_from_numpy(pattern, caches, *, device="cpu"):
    """A decode state (one cache a pattern position, each stacked over
    groups, as ``repro``'s ``prefill`` and ``init_decode_state`` return it,
    with numpy leaves) as the port's: a KVCache at attention positions (its
    dtype kept, bf16 included), the mixer's state NamedTuple elsewhere."""
    out = []
    for entry, c in zip(pattern, caches):
        make = _STATES[parse_entry(entry)[0]]
        if make is KVCache:
            out.append(KVCache(*(_kv_tensor(t, device) for t in c)))
        else:
            out.append(make(*c, device=device))
    return tuple(out)


def _kv_tensor(a, device):
    a = np.asarray(a)
    t = _tensor(a.astype(np.float32), device)
    return t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t

"""Shared neural-net layers (functional; params are nested dicts of tensors).

Every matmul routes through the ``repro_torch.precision`` engine API, so
the precision policy applies uniformly. Initializers draw from an explicit
``torch.Generator`` on ``device``, with ``lead`` leading dims (the stacked
groups); values are f32 at rest.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.precision import PrecisionConfig, dot

__all__ = ["normal", "dense_init", "embed_init", "rmsnorm_init", "rmsnorm", "silu", "mlp_init", "mlp_apply", "rope"]


def normal(generator, shape, scale: float, *, device) -> torch.Tensor:
    """Standard normal draws times ``scale``, scaled in place."""
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32, device=device).mul_(scale)


def dense_init(generator, d_in: int, d_out: int, scale: Optional[float] = None, *, lead=(), device):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    return normal(generator, (*lead, d_in, d_out), scale, device=device)


def embed_init(generator, vocab: int, d: int, *, device):
    return normal(generator, (vocab, d), 0.02, device=device)


def rmsnorm_init(d: int, *, lead=(), device):
    return torch.ones((*lead, d), dtype=torch.float32, device=device)


def rmsnorm(x, w, eps: float = 1e-5):
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)) * w


def silu(x):
    return x * torch.sigmoid(x)


def mlp_init(generator, d: int, d_ff: int, act: str, *, lead=(), device):
    p = {"down": dense_init(generator, d_ff, d, lead=lead, device=device)}
    if act == "swiglu":
        p["gate"] = dense_init(generator, d, d_ff, lead=lead, device=device)
    p["up"] = dense_init(generator, d, d_ff, lead=lead, device=device)
    return p


def mlp_apply(p, x, act: str, prec: PrecisionConfig):
    if act == "swiglu":
        h = silu(dot(x, p["gate"], prec, site="mlp.gate")) * dot(x, p["up"], prec, site="mlp.up")
    else:
        h = torch.nn.functional.gelu(dot(x, p["up"], prec, site="mlp.up"), approximate="tanh")
    return dot(h, p["down"], prec, site="mlp.down")


def rope(x, positions, theta: float):
    """Rotary embedding on the last (head) dim. x: (..., S, n, hd);
    positions: (..., S) integers broadcastable."""
    hd = x.shape[-1]
    half = hd // 2
    neg_log = torch.tensor(-math.log(theta), dtype=torch.float32, device=x.device)
    freqs = torch.exp(neg_log * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

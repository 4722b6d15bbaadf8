"""The port's one f32 reciprocal square root: correctly rounded.

``torch.rsqrt`` is not correctly rounded on the CPU (it differs from the
correctly rounded value by up to one ulp in about a quarter of the inputs),
so nothing on the card could reproduce it bit for bit. The precision
engines, the ALU and the fused planes take every rsqrt through :func:`rsqrt`
instead: IEEE ``rSqrt`` rounded to nearest even,
which on the card is ``__frsqrt_rn`` (``csrc/r2f2_device.cuh::family_rsqrt``)
and here a route in f64 with an exact last step:

1. the candidate ``y``: ``1 / sqrt(x)`` in f64, rounded to f32, within one
   ulp of the exact value;
2. the midpoints ``m`` between ``y`` and its two f32 neighbours (25 bits,
   exact in f64) decide it: ``m < 1/sqrt(x)`` exactly when ``m*m*x < 1``.
   ``m*m`` is exact in f64 (50 bits); split into a 26-bit head and a 24-bit
   tail, each product with ``x`` is exact, the head's product lies in
   ``[1/2, 2]`` so subtracting 1 is exact, and the one rounding of the sum
   keeps its sign. A midpoint is never hit: ``M*M*X`` is a power of two only
   for ``M`` a power of two.

f32 subnormal inputs read as zeros of their sign, as the kernels' ``-ftz=true``
and XLA read them: ``rsqrt(±sub) = ±inf``. ``rsqrt(±0) = ±inf``,
``rsqrt(+inf) = +0``, negatives and NaN give NaN (whose bits differ between
the CPU and the card).
"""

from __future__ import annotations

import torch

__all__ = ["rsqrt"]

_HEAD_MASK = ~((1 << 27) - 1)  # keeps 26 of an f64's 53 significand bits


def _above(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The sign of ``m*m*x - 1`` (f64 ``m`` of 25 bits, f64 ``x`` of 24), exactly."""
    m2 = m * m
    head = (m2.view(torch.int64) & _HEAD_MASK).view(torch.float64)
    tail = m2 - head
    return torch.sign((head * x - 1.0) + tail * x)


def rsqrt(x) -> torch.Tensor:
    """Correctly rounded f32 ``1 / sqrt(x)`` of an f32 tensor, on any device."""
    x = torch.as_tensor(x).to(torch.float32)
    bits = x.contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    x = torch.where((mag != 0) & (mag < 0x00800000), (bits & torch.iinfo(torch.int32).min).view(torch.float32), x)
    d = x.to(torch.float64)
    y = (1.0 / torch.sqrt(d)).to(torch.float32)
    up = torch.nextafter(y, torch.full_like(y, torch.inf))
    down = torch.nextafter(y, torch.zeros_like(y))
    yd = y.to(torch.float64)
    fix = torch.where(_above((yd + up.to(torch.float64)) * 0.5, d) < 0, up, y)
    fix = torch.where(_above((yd + down.to(torch.float64)) * 0.5, d) > 0, down, fix)
    return torch.where((x > 0) & torch.isfinite(x), fix, y)

"""Exact single-rounding ``a * b + c`` in f32.

The reference runs compiled by XLA, whose CPU backend lets LLVM contract a
multiply feeding an add into one fused multiply-add. Where it does, the
reference's f32 result is rounded once, so the port computes those
expressions with :func:`fma` (and the CUDA kernels with ``__fmaf_rn``).

PyTorch has no f32 fma, so this emulates it in f64: the product of two f32
values is exact in f64, the sum is formed with an error-free two-sum and
rounded to odd, and round-to-odd at 53 bits followed by RNE to 24 bits is
the correctly rounded result. When the product is NaN its NaN is returned,
as the compiled reference's fused op returns the multiplicand's NaN before
the addend's.
"""

from __future__ import annotations

import torch

__all__ = ["fma"]


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (all arguments f32 tensors)."""
    p = a.to(torch.float64) * b.to(torch.float64)  # exact: 24 + 24 bits
    c = torch.as_tensor(c).to(torch.float64)
    s = p + c
    # two-sum: s + err == p + c exactly
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    # round to odd: an inexact sum with an even last bit moves one ulp toward the error
    odd = (s.view(torch.int64) & 1) == 1
    fix = (err != 0) & ~odd & torch.isfinite(s)
    s = torch.where(fix, torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf).to(s)), s)
    return torch.where(torch.isnan(p), p, s).to(torch.float32)

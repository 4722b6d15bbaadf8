"""Per-block R2F2 primitives: the plain PyTorch form of the device math in
``csrc/r2f2_device.cuh``.

Each ``rr_*_block`` helper picks ONE split for a block pair from the op's
exponent envelope (the paper's same-format rule), floors it at ``k_min`` or
pins it at ``k_fixed``, and rounds operands and result to
``E(EB+k)M(MB+FX-k)``; products also get the FX-tail truncation.
"""

from __future__ import annotations

import torch

from repro_torch.core.flexformat import quantize_em
from repro_torch.core.r2f2 import _finite_max_exp, product_guard_bits, select_k, select_k_op

__all__ = ["block_max_exp", "rr_mul_block", "rr_add_block", "rr_div_block", "rr_rsqrt_block"]


def block_max_exp(t: torch.Tensor) -> torch.Tensor:
    """Max unbiased exponent over one block's finite values; -127 for a
    block of zeros."""
    return _finite_max_exp(t)


def _split(k_select, k_min, k_fixed):
    if k_fixed is not None:
        return torch.as_tensor(k_fixed).to(torch.int64)
    k = k_select()
    if k_min is not None:
        k = torch.maximum(k, torch.as_tensor(k_min, device=k.device).to(torch.int64))
    return k


def rr_mul_block(a, b, fmt, tail_approx, *, exps=None, k_min=None, k_fixed=None):
    """Shared-split R2F2 product of two blocks. ``exps`` passes
    already-reduced ``(a_max_exp, b_max_exp)``; ``k_min`` floors the split
    at a carried tracker value; ``k_fixed`` multiplies at exactly that split."""

    def pick():
        ae, be = exps if exps is not None else (block_max_exp(a), block_max_exp(b))
        return select_k(ae, be, fmt)

    k = _split(pick, k_min, k_fixed)
    e_b, m_b = fmt.eb + k, fmt.mb + fmt.fx - k
    guard = product_guard_bits(fmt, k) if tail_approx else None
    return quantize_em(quantize_em(a, e_b, m_b) * quantize_em(b, e_b, m_b), e_b, m_b, tail_trunc_bits=guard)


def _rr_alu_block(a, b, fmt, op, substrate, *, exps=None, k_min=None, k_fixed=None):
    def pick():
        ae, be = exps if exps is not None else (block_max_exp(a), block_max_exp(b))
        return select_k_op(ae, be, fmt, op)

    k = _split(pick, k_min, k_fixed)
    e_b, m_b = fmt.eb + k, fmt.mb + fmt.fx - k
    return quantize_em(substrate(quantize_em(a, e_b, m_b), quantize_em(b, e_b, m_b)), e_b, m_b)


def rr_add_block(a, b, fmt, *, exps=None, k_min=None, k_fixed=None):
    """Shared-split flexible sum (alignment-shift envelope)."""
    return _rr_alu_block(a, b, fmt, "add", lambda x, y: x + y, exps=exps, k_min=k_min, k_fixed=k_fixed)


def rr_div_block(a, b, fmt, *, exps=None, k_min=None, k_fixed=None):
    """Shared-split flexible quotient (quotient-range envelope)."""
    return _rr_alu_block(a, b, fmt, "div", lambda x, y: x / y, exps=exps, k_min=k_min, k_fixed=k_fixed)


def rr_rsqrt_block(x, fmt, *, exps=None, k_min=None, k_fixed=None):
    """Shared-split flexible reciprocal square root; ``exps`` is the
    operand exponent doubled up, ``(ex, ex)``."""
    if exps is None:
        ex = block_max_exp(x)
        exps = (ex, ex)
    return _rr_alu_block(x, x, fmt, "rsqrt", lambda v, _w: torch.rsqrt(v), exps=exps, k_min=k_min, k_fixed=k_fixed)

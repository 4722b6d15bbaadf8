"""Tile-wise flexible ALU ops, ``r2f2_multiply``'s shape for add/div/rsqrt.

Quantize the operands to ``E(EB+k)M(MB+FX-k)``, run the op on the f32
substrate, quantize the result to the same format. No tail truncation: that
approximation models dropped partial products and has no analogue in an
adder or a divider. ``k=None`` picks, per tile, the minimal split covering
the op's exponent envelope. swe2d's ``swe.div`` site runs on this divider.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.flexformat import FlexFormat, quantize_em_with_flags
from repro_torch.core.r2f2 import R2F2Stats, _tile_max_exp, select_k_op

__all__ = ["flex_add", "flex_sub", "flex_div", "flex_rsqrt", "flex_op"]

_SUBSTRATE = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "div": lambda a, b: a / b,
    "rsqrt": lambda a, _b: torch.rsqrt(a),
}

#: substrate op -> the envelope law that governs it (sub shares add's)
_EVIDENCE_OP = {"add": "add", "sub": "add", "div": "div", "rsqrt": "rsqrt"}


def flex_op(a, b, fmt: FlexFormat, op: str, *, k=None, tile_shape: Optional[Tuple[int, ...]] = None):
    """Shared tile-wise driver; ``b`` is ignored for rsqrt. Returns
    ``(result, R2F2Stats)`` like :func:`repro_torch.core.r2f2.r2f2_multiply`."""
    if op not in _SUBSTRATE:
        raise ValueError(f"unknown flex op {op!r}; known: {tuple(_SUBSTRATE)}")
    a = a.to(torch.float32)
    unary = op == "rsqrt"
    b = a if unary else torch.broadcast_to(torch.as_tensor(b, device=a.device).to(torch.float32), a.shape)
    if k is None:
        ae, bcast = _tile_max_exp(a, tile_shape)
        be = ae if unary else _tile_max_exp(b, tile_shape)[0]
        k_tile = select_k_op(ae, be, fmt, _EVIDENCE_OP[op])
        k_full = bcast(k_tile)
    else:
        k_tile = torch.as_tensor(k, device=a.device).to(torch.int64)
        k_full = k_tile
    e_bits = fmt.eb + k_full
    m_bits = fmt.mb + fmt.fx - k_full

    qa, oa, ua = quantize_em_with_flags(a, e_bits, m_bits)
    if unary:
        qb, ob, ub = qa, torch.zeros_like(oa), torch.zeros_like(ua)
    else:
        qb, ob, ub = quantize_em_with_flags(b, e_bits, m_bits)
    qr, orr, ur = quantize_em_with_flags(_SUBSTRATE[op](qa, qb), e_bits, m_bits)
    stats = R2F2Stats(k=k_tile, overflow_count=(oa | ob | orr).sum(), underflow_count=(ua | ub | ur).sum())
    return qr, stats


def flex_add(a, b, fmt: FlexFormat, *, k=None, tile_shape=None):
    """Flexible-precision addition (alignment-shift envelope)."""
    return flex_op(a, b, fmt, "add", k=k, tile_shape=tile_shape)


def flex_sub(a, b, fmt: FlexFormat, *, k=None, tile_shape=None):
    """Flexible-precision subtraction (shares the add envelope)."""
    return flex_op(a, b, fmt, "sub", k=k, tile_shape=tile_shape)


def flex_div(a, b, fmt: FlexFormat, *, k=None, tile_shape=None):
    """Flexible-precision division (quotient-range envelope)."""
    return flex_op(a, b, fmt, "div", k=k, tile_shape=tile_shape)


def flex_rsqrt(x, fmt: FlexFormat, *, k=None, tile_shape=None):
    """Flexible-precision reciprocal square root (unary envelope)."""
    return flex_op(x, None, fmt, "rsqrt", k=k, tile_shape=tile_shape)

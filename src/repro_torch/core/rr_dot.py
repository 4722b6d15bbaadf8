"""Shims over the ``repro_torch.precision`` engine API, under their
historical names:

    rr_operand(x, cfg)            == repro_torch.precision.prepare_operand(x, cfg)
    rr_einsum(spec, a, b, cfg)    == repro_torch.precision.contract(spec, a, b, cfg)
    rr_dot(x, w, cfg)             == repro_torch.precision.dot(x, w, cfg)

``rr_einsum``/``rr_dot`` return ``out``, or ``(out, tracker)`` whenever a
tracker is passed. Imports are function-local: ``repro_torch.core`` stays
importable without the engine package, which imports back into core.
"""

from __future__ import annotations

__all__ = ["rr_operand", "rr_einsum", "rr_dot"]


def rr_operand(x, cfg, *, k=None):
    """Quantize one operand per the policy. Returns ``(x_q, k_tile)``."""
    from repro_torch.precision import prepare_operand

    return prepare_operand(x, cfg, k=k)


def rr_einsum(spec: str, a, b, cfg, *, tracker=None, site=None, shared_k: bool = False):
    """Einsum with policy operand treatment and f32 sums."""
    from repro_torch.precision import contract

    return contract(spec, a, b, cfg, tracker=tracker, site=site, shared_k=shared_k)


def rr_dot(x, w, cfg, **kw):
    """Dense-layer contraction: last dim of ``x`` against first of ``w``."""
    from repro_torch.precision import dot

    return dot(x, w, cfg, **kw)

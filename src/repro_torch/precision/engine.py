"""The PrecisionEngine protocol: what a policy does to arithmetic.

    multiply(a, b, cfg, *, tracker, site)   elementwise product
    multiply_add(a, b, c, cfg, *, ...)      a*b + c, the product on the policy
    add(a, b, cfg, *, tracker, site)        elementwise sum
    divide(a, b, cfg, *, tracker, site)     elementwise quotient
    rsqrt(x, cfg, *, tracker, site)         elementwise 1/sqrt
    store(x, cfg)                           state write-back rounding
    prepare_operand(x, cfg, *, k=None)      one operand, policy-rounded -> (x_q, k)
    contract(spec, a, b, cfg, *, ...)       einsum with policy operands, f32 sums

Every elementwise op and ``contract`` return ``(out, tracker)``; engines
that do not track pass the tracker through. The base class implements every
op on the f32 substrate and ``contract`` on top of ``prepare_operand``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.rsqrt import rsqrt

__all__ = ["PrecisionEngine", "native_bf16", "bf16_round", "bf16_pair", "tile_shape_for", "ste"]


def native_bf16() -> bool:
    """Whether a contraction keeps its bf16-rounded operands in bf16.

    False on every device the port runs on, the H100 included: the engines
    round each operand to bf16 and contract the rounded values as f32
    (:func:`bf16_pair`). A bf16 x bf16 product is exact in f32, so the
    products equal a bf16 tensor-core contraction's, and the sums stay f32
    in a fixed order; a bf16 matmul of cuBLAS would choose its own
    accumulation order and split-K and give other sums. The reference
    keeps bf16 operands only on the TPU's MXU.
    """
    return False


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 value (RNE), returned as f32."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def bf16_pair(a, b):
    """Both operands rounded to bf16 and cast back to f32, as the reference
    runs a bf16 contraction off the TPU and the port everywhere
    (:func:`native_bf16`): the products and sums stay f32."""
    return bf16_round(a), bf16_round(b)


def tile_shape_for(x, tile: int) -> Optional[Tuple[int, ...]]:
    """Tiles of ``tile`` on the last two dims (1 elsewhere) where ``tile``
    divides the dim, else the whole dim; None for a scalar."""
    if x.ndim == 0:
        return None
    shape = [1] * x.ndim
    for ax in range(max(0, x.ndim - 2), x.ndim):
        shape[ax] = tile if x.shape[ax] % tile == 0 else x.shape[ax]
    return tuple(shape)


class _STE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, xq):
        return x + (xq - x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def ste(x, xq):
    """Straight-through estimator: forward ``x + (xq - x)``, computed as
    written (not ``xq``: ``ste(inf, inf)`` is NaN and a negative value that
    quantizes to -0 gives +0, as in the reference), identity backward."""
    return _STE.apply(x, xq)


class PrecisionEngine:
    """Base engine: f32 substrate arithmetic.

    ``name`` is stamped by ``register_engine``; ``emulated`` marks bit-exact
    emulation engines; ``tracks`` tells a simulation driver to thread a
    SiteTracker through the engine's calls.
    """

    name: str = "?"
    emulated: bool = False
    tracks: bool = False

    def prepare_operand(self, x, cfg, *, k=None):
        """Quantize one operand per the policy: ``(x_q, k)``, where ``k`` is
        the chosen flexible split (None for non-flexible engines)."""
        return x.to(torch.float32), None

    def operand_dtype(self, cfg):
        """The dtype prepared operands travel in (the MoE dispatch payload)."""
        return torch.float32

    def contract(self, spec, a, b, cfg, *, tracker=None, site=None, shared_k=False):
        """Einsum of the policy-treated operands with f32 sums."""
        aq, _ = self.prepare_operand(a, cfg)
        bq, _ = self.prepare_operand(b, cfg)
        return torch.einsum(spec, aq, bq), tracker

    def multiply(self, a, b, cfg, *, tracker=None, site=None):
        return a.to(torch.float32) * b.to(torch.float32), tracker

    def multiply_add(self, a, b, c, cfg, *, tracker=None, site=None):
        """``a * b + c`` with the product on the policy's multiplier and the
        sum in f32. Families whose product is a plain f32 multiply override
        this with one fused rounding, as the compiled reference computes it."""
        out, tracker = self.multiply(a, b, cfg, tracker=tracker, site=site)
        return out + c, tracker

    def add(self, a, b, cfg, *, tracker=None, site=None):
        return a.to(torch.float32) + b.to(torch.float32), tracker

    def divide(self, a, b, cfg, *, tracker=None, site=None):
        return a.to(torch.float32) / b.to(torch.float32), tracker

    def rsqrt(self, x, cfg, *, tracker=None, site=None):
        return rsqrt(x.to(torch.float32)), tracker

    def store(self, x, cfg):
        return x.to(torch.float32)

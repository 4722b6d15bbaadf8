"""The PrecisionEngine protocol: what a policy does to arithmetic.

    multiply(a, b, cfg, *, tracker, site)   elementwise product
    multiply_add(a, b, c, cfg, *, ...)      a*b + c, the product on the policy
    add(a, b, cfg, *, tracker, site)        elementwise sum
    divide(a, b, cfg, *, tracker, site)     elementwise quotient
    rsqrt(x, cfg, *, tracker, site)         elementwise 1/sqrt
    store(x, cfg)                           state write-back rounding
    prepare_operand / contract              the LM contraction path

Every elementwise op returns ``(out, tracker)``; engines that do not track
pass the tracker through. The base class implements the elementwise ops on
the f32 substrate. ``prepare_operand`` and ``contract`` belong to the LM
stack, which this package does not carry yet.
"""

from __future__ import annotations

import torch

__all__ = ["PrecisionEngine", "LM_PATH_PENDING"]

#: the message every LM-path entry point raises with
LM_PATH_PENDING = (
    "the LM contraction path (prepare_operand/contract) is not ported to "
    "repro_torch yet: ROADMAP.md queue 1 item 13"
)


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
        raise NotImplementedError(LM_PATH_PENDING)

    def contract(self, spec, a, b, cfg, *, tracker=None, site=None, shared_k=False):
        raise NotImplementedError(LM_PATH_PENDING)

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
        return torch.rsqrt(x.to(torch.float32)), tracker

    def store(self, x, cfg):
        return x.to(torch.float32)

"""The six builtin precision engines, one per mode.

  f32         reference arithmetic (pass-through)
  bf16        plain mixed-precision baseline
  fixed       fixed E(e)M(m) emulation (the paper's failing E5M10 baseline)
  rr_tile     R2F2 emulation, per-tensor runtime k selection
  rr_tracked  R2F2 emulation, k carried by a SiteTracker
  deploy      bf16 arithmetic + tracker-driven k bookkeeping

The bf16 family is an f32 op on bf16-rounded operands with an f32 result.
The reference writes ``(a.astype(bf16) * b.astype(bf16)).astype(f32)``, but
compiled by XLA:CPU the bf16 op runs in f32 and the f32 -> bf16 -> f32
convert pair of its result is removed, so the result is not rounded to
bf16. The port follows the reference as it runs.

Where the compiled reference contracts a policy product into a following
add (the f32 and bf16 families, whose product is a plain f32 multiply),
``multiply_add`` rounds once (:func:`repro_torch.core.fma.fma`).
"""

from __future__ import annotations

import torch

from repro_torch.alu import flex_op
from repro_torch.core.fma import fma
from repro_torch.core.flexformat import quantize_em
from repro_torch.core.policy import tracker_k, tracker_update
from repro_torch.core.r2f2 import _tile_max_exp, r2f2_multiply, select_k, select_k_op, select_k_operand

from .engine import PrecisionEngine
from .registry import register_engine
from .sites import resolve_site, rewrap

__all__ = ["F32Engine", "BF16Engine", "FixedEngine", "RRTileEngine", "RRTrackedEngine", "DeployEngine", "bf16_round"]


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 value (RNE), returned as f32."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def _f32(x) -> torch.Tensor:
    return x.to(torch.float32)


@register_engine("f32")
class F32Engine(PrecisionEngine):
    """Reference arithmetic: everything stays f32."""

    def multiply_add(self, a, b, c, cfg, *, tracker=None, site=None):
        return fma(_f32(a), _f32(b), _f32(c)), tracker


@register_engine("bf16")
class BF16Engine(PrecisionEngine):
    """Plain mixed precision: bf16 operands and results."""

    def multiply(self, a, b, cfg, *, tracker=None, site=None):
        return bf16_round(a) * bf16_round(b), tracker

    def multiply_add(self, a, b, c, cfg, *, tracker=None, site=None):
        return fma(bf16_round(a), bf16_round(b), _f32(c)), tracker

    def add(self, a, b, cfg, *, tracker=None, site=None):
        return bf16_round(a) + bf16_round(b), tracker

    def divide(self, a, b, cfg, *, tracker=None, site=None):
        return bf16_round(a) / bf16_round(b), tracker

    def rsqrt(self, x, cfg, *, tracker=None, site=None):
        return torch.rsqrt(bf16_round(x)), tracker

    def store(self, x, cfg):
        return bf16_round(x)


@register_engine("fixed")
class FixedEngine(PrecisionEngine):
    """Fixed E(e)M(m) emulation, e.g. E5M10."""

    emulated = True

    def _q(self, x, cfg):
        e, m = cfg.fixed_em
        return quantize_em(_f32(x), e, m)

    def multiply(self, a, b, cfg, *, tracker=None, site=None):
        return self._q(self._q(a, cfg) * self._q(b, cfg), cfg), tracker

    def add(self, a, b, cfg, *, tracker=None, site=None):
        return self._q(self._q(a, cfg) + self._q(b, cfg), cfg), tracker

    def divide(self, a, b, cfg, *, tracker=None, site=None):
        return self._q(self._q(a, cfg) / self._q(b, cfg), cfg), tracker

    def rsqrt(self, x, cfg, *, tracker=None, site=None):
        return self._q(torch.rsqrt(self._q(x, cfg)), cfg), tracker

    def store(self, x, cfg):
        return self._q(x, cfg)


def _shared_k(a, b, cfg):
    """One split per op: both whole operands plus the product bound."""
    return select_k(_tile_max_exp(a, None)[0], _tile_max_exp(b, None)[0], cfg.fmt)


def _shared_k_op(a, b, cfg, op):
    """:func:`_shared_k` under one ALU op's envelope."""
    return select_k_op(_tile_max_exp(a, None)[0], _tile_max_exp(b, None)[0], cfg.fmt, op)


@register_engine("rr_tile")
class RRTileEngine(PrecisionEngine):
    """R2F2 emulation with a per-tensor runtime split (stateless)."""

    emulated = True

    def multiply(self, a, b, cfg, *, tracker=None, site=None):
        out, _ = r2f2_multiply(_f32(a), _f32(b), cfg.fmt, tile_shape=None, tail_approx=cfg.tail_approx)
        return out, tracker

    def add(self, a, b, cfg, *, tracker=None, site=None):
        return flex_op(_f32(a), b, cfg.fmt, "add")[0], tracker

    def divide(self, a, b, cfg, *, tracker=None, site=None):
        return flex_op(_f32(a), b, cfg.fmt, "div")[0], tracker

    def rsqrt(self, x, cfg, *, tracker=None, site=None):
        return flex_op(_f32(x), None, cfg.fmt, "rsqrt")[0], tracker

    def store(self, x, cfg):
        x = _f32(x)
        k = select_k_operand(_tile_max_exp(x, None)[0], cfg.fmt)
        return quantize_em(x, cfg.fmt.eb + k, cfg.fmt.mb + cfg.fmt.fx - k)


@register_engine("rr_tracked")
class RRTrackedEngine(RRTileEngine):
    """R2F2 emulation with k carried across steps by a SiteTracker: the live
    split is the carried one widened to the instantaneous safe minimum (the
    hardware's overflow retry); ``cfg.pinned`` uses the carried split as is."""

    emulated = True
    tracks = True

    def multiply(self, a, b, cfg, *, tracker=None, site=None):
        a, b = _f32(a), _f32(b)
        state, idx = resolve_site(tracker, site)
        if state is None or idx is None:
            return super().multiply(a, b, cfg, tracker=tracker, site=site)
        k = tracker_k(state, idx)
        if not cfg.pinned:
            k = torch.maximum(k, _shared_k(a, b, cfg))
            state = tracker_update(state, idx, a, b, cfg)
        out, _ = r2f2_multiply(a, b, cfg.fmt, k=k, tile_shape=None, tail_approx=cfg.tail_approx)
        return out, rewrap(tracker, state)

    def _tracked_alu(self, op, a, b, cfg, tracker, site):
        a = _f32(a)
        b = a if b is None else _f32(b)
        state, idx = resolve_site(tracker, site)
        if state is None or idx is None:
            return flex_op(a, b, cfg.fmt, op)[0], tracker
        ev_op = "add" if op == "sub" else op
        k = tracker_k(state, idx)
        if not cfg.pinned:
            k = torch.maximum(k, _shared_k_op(a, b, cfg, ev_op))
            state = tracker_update(state, idx, a, b, cfg, ev_op)
        out, _ = flex_op(a, b, cfg.fmt, op, k=k)
        return out, rewrap(tracker, state)

    def add(self, a, b, cfg, *, tracker=None, site=None):
        return self._tracked_alu("add", a, b, cfg, tracker, site)

    def divide(self, a, b, cfg, *, tracker=None, site=None):
        return self._tracked_alu("div", a, b, cfg, tracker, site)

    def rsqrt(self, x, cfg, *, tracker=None, site=None):
        return self._tracked_alu("rsqrt", x, None, cfg, tracker, site)


@register_engine("deploy")
class DeployEngine(BF16Engine):
    """bf16 arithmetic with tracker-driven k bookkeeping."""

    tracks = True

    def _track(self, tracker, site, a, b, cfg, op="mul"):
        if cfg.pinned:
            return tracker
        state, idx = resolve_site(tracker, site)
        if state is not None and idx is not None:
            tracker = rewrap(tracker, tracker_update(state, idx, _f32(a), _f32(b), cfg, op))
        return tracker

    def multiply(self, a, b, cfg, *, tracker=None, site=None):
        out, _ = super().multiply(a, b, cfg)
        return out, self._track(tracker, site, a, b, cfg)

    def multiply_add(self, a, b, c, cfg, *, tracker=None, site=None):
        out, _ = super().multiply_add(a, b, c, cfg)
        return out, self._track(tracker, site, a, b, cfg)

    def add(self, a, b, cfg, *, tracker=None, site=None):
        out, _ = super().add(a, b, cfg)
        return out, self._track(tracker, site, a, b, cfg, "add")

    def divide(self, a, b, cfg, *, tracker=None, site=None):
        out, _ = super().divide(a, b, cfg)
        return out, self._track(tracker, site, a, b, cfg, "div")

    def rsqrt(self, x, cfg, *, tracker=None, site=None):
        out, _ = super().rsqrt(x, cfg)
        return out, self._track(tracker, site, x, x, cfg, "rsqrt")

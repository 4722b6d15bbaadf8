"""The six builtin precision engines, one per mode.

  f32         reference arithmetic (pass-through)
  bf16        plain mixed-precision baseline
  fixed       fixed E(e)M(m) emulation (the paper's failing E5M10 baseline)
  rr_tile     R2F2 emulation, per-tile (contractions) or per-tensor
              (elementwise) runtime k selection, with the K7 fast path when
              ``cfg.use_kernels`` and the contraction is eligible
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

Kernel dispatch: a contraction reaches K7 (``kernels/r2f2_matmul.py``) iff
``cfg.use_kernels`` is set, both operands are 2-D and the spec is a plain
row-by-column matmul (``"ab,bc->ac"`` up to letter renaming). The kernel
picks its own split per block pair. A CUDA tensor launches the kernel; a
CPU tensor runs its plain version. The path applies no STE, as in the
reference.
"""

from __future__ import annotations

import re

import torch

from repro_torch.alu import flex_op
from repro_torch.core.fma import fma
from repro_torch.core.flexformat import quantize_em
from repro_torch.core.policy import tracker_k, tracker_update
from repro_torch.core.rsqrt import rsqrt
from repro_torch.core.r2f2 import _tile_max_exp, r2f2_multiply, select_k, select_k_op, select_k_operand

from .engine import PrecisionEngine, bf16_pair, bf16_round, ste, tile_shape_for
from .registry import register_engine
from .sites import resolve_site, rewrap

__all__ = [
    "F32Engine",
    "BF16Engine",
    "FixedEngine",
    "RRTileEngine",
    "RRTrackedEngine",
    "DeployEngine",
    "bf16_round",
    "kernel_eligible",
]

# "ab,bc->ac" with any distinct letters: the one contraction K7 implements
_MATMUL_SPEC = re.compile(r"^([a-zA-Z])([a-zA-Z]),([a-zA-Z])([a-zA-Z])->([a-zA-Z])([a-zA-Z])$")

#: operands above this many elements are quantized in slices of whole tile
#: rows (bit-identical: no tile crosses a slice), so that the int64 work of
#: ``quantize_em`` stays a few GB on llama4's (5120, 202048) head
_SLICE_ELEMS = 1 << 26


def _f32(x) -> torch.Tensor:
    return x.to(torch.float32)


def kernel_eligible(spec: str, a, b, cfg) -> bool:
    """Can this contraction run on K7 (``r2f2_matmul``)? Any 2-D matmul
    shape is: the kernel pads and crops non-divisible dims."""
    if not getattr(cfg, "use_kernels", False):
        return False
    if getattr(a, "ndim", 0) != 2 or getattr(b, "ndim", 0) != 2:
        return False
    m = _MATMUL_SPEC.match(spec.replace(" ", ""))
    if m is None:
        return False
    i, j, j2, l, oi, ol = m.groups()
    if len({i, j, l}) != 3 or j2 != j or (oi, ol) != (i, l):
        return False
    return a.shape[1] == b.shape[0]


def _kernel_contract(a, b, cfg):
    from repro_torch.kernels import ops as kernel_ops  # lazy: kernels.fused imports this module

    return kernel_ops.r2f2_matmul(_f32(a), _f32(b), cfg.fmt, blocks=cfg.kernel_blocks, tail_approx=cfg.tail_approx)


def _row_slices(x, tile_rows: int):
    """Slices of ``x`` along dim 0 at multiples of ``tile_rows``, each under
    :data:`_SLICE_ELEMS` elements where one tile row allows it."""
    if x.ndim < 2 or x.numel() <= _SLICE_ELEMS:
        return [x]
    row = x.numel() // x.shape[0] * tile_rows
    step = max(1, _SLICE_ELEMS // row) * tile_rows
    return list(torch.split(x, step, dim=0))


def _by_slices(x, tile_rows: int, quantize):
    """``quantize(slice) -> (xq, k)`` over :func:`_row_slices`, each slice's
    result written into one output as it comes (no list of quantized slices
    beside the whole: at jamba's expert weights, 3.8 GB an operand, that
    list was a second copy). Returns ``(xq, [k of each slice])``."""
    slices = _row_slices(x, tile_rows)
    if len(slices) == 1:
        xq, k = quantize(x)
        return xq, [k]
    xq, ks, row = torch.empty_like(x), [], 0
    for p in slices:
        q, k = quantize(p)
        xq[row : row + p.shape[0]] = q
        ks.append(k)
        row += p.shape[0]
        del q
    return xq, ks


@register_engine("f32")
class F32Engine(PrecisionEngine):
    """Reference arithmetic: everything stays f32."""

    def contract(self, spec, a, b, cfg, *, tracker=None, site=None, shared_k=False):
        return torch.einsum(spec, _f32(a), _f32(b)), tracker

    def multiply_add(self, a, b, c, cfg, *, tracker=None, site=None):
        return fma(_f32(a), _f32(b), _f32(c)), tracker


@register_engine("bf16")
class BF16Engine(PrecisionEngine):
    """Plain mixed precision: bf16 operands and results."""

    def prepare_operand(self, x, cfg, *, k=None):
        return bf16_round(x), None

    def operand_dtype(self, cfg):
        return torch.bfloat16

    def contract(self, spec, a, b, cfg, *, tracker=None, site=None, shared_k=False):
        aq, bq = bf16_pair(a, b)
        return torch.einsum(spec, aq, bq), tracker

    def multiply(self, a, b, cfg, *, tracker=None, site=None):
        return bf16_round(a) * bf16_round(b), tracker

    def multiply_add(self, a, b, c, cfg, *, tracker=None, site=None):
        return fma(bf16_round(a), bf16_round(b), _f32(c)), tracker

    def add(self, a, b, cfg, *, tracker=None, site=None):
        return bf16_round(a) + bf16_round(b), tracker

    def divide(self, a, b, cfg, *, tracker=None, site=None):
        return bf16_round(a) / bf16_round(b), tracker

    def rsqrt(self, x, cfg, *, tracker=None, site=None):
        return rsqrt(bf16_round(x)), tracker

    def store(self, x, cfg):
        return bf16_round(x)


@register_engine("fixed")
class FixedEngine(PrecisionEngine):
    """Fixed E(e)M(m) emulation, e.g. E5M10."""

    emulated = True

    def _q(self, x, cfg):
        e, m = cfg.fixed_em
        return quantize_em(_f32(x), e, m)

    def prepare_operand(self, x, cfg, *, k=None):
        x = _f32(x)
        e, m = cfg.fixed_em
        return _by_slices(x, 1, lambda p: (ste(p, quantize_em(p, e, m)), None))[0], None

    def multiply(self, a, b, cfg, *, tracker=None, site=None):
        return self._q(self._q(a, cfg) * self._q(b, cfg), cfg), tracker

    def add(self, a, b, cfg, *, tracker=None, site=None):
        return self._q(self._q(a, cfg) + self._q(b, cfg), cfg), tracker

    def divide(self, a, b, cfg, *, tracker=None, site=None):
        return self._q(self._q(a, cfg) / self._q(b, cfg), cfg), tracker

    def rsqrt(self, x, cfg, *, tracker=None, site=None):
        return self._q(rsqrt(self._q(x, cfg)), cfg), tracker

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
    """R2F2 emulation with a runtime split: per tile for operands of a
    contraction, per tensor for elementwise ops (stateless)."""

    emulated = True

    def _quantize(self, x, cfg, k):
        """``(x_q, k_tiles)``: the per-tile split picked from the data
        (``k`` None), or the given split (a scalar, or one per tile). A
        per-tile split broadcasts over a tiled view of ``x`` (one split per
        tile, never one per element: the same bits, a fraction of the work)."""
        fmt = cfg.fmt
        tile = tile_shape_for(x, cfg.tile)
        if k is None:
            k = select_k_operand(_tile_max_exp(x, tile)[0], fmt).to(torch.int32)
        if k.ndim == 0:
            kk = k.to(torch.int64)
            return ste(x, quantize_em(x, fmt.eb + kk, fmt.mb + fmt.fx - kk)), k
        split, grid = [], []
        for d, t in zip(x.shape, tile):
            split += [d // t, t]
            grid += [d // t, 1]
        kv = k.to(torch.int64).reshape(grid)
        xq = quantize_em(x.reshape(split), fmt.eb + kv, fmt.mb + fmt.fx - kv).reshape(x.shape)
        return ste(x, xq), k

    def prepare_operand(self, x, cfg, *, k=None):
        x = _f32(x)
        if k is not None:
            k = torch.as_tensor(k, device=x.device).to(torch.int32)
            if k.ndim:
                return self._quantize(x, cfg, k)
        tile = tile_shape_for(x, cfg.tile)
        xq, ks = _by_slices(x, 1 if tile is None else tile[0], lambda p: self._quantize(p, cfg, k))
        if len(ks) == 1:
            return xq, ks[0]
        return xq, (k if k is not None else torch.cat(ks))

    def contract(self, spec, a, b, cfg, *, tracker=None, site=None, shared_k=False):
        if kernel_eligible(spec, a, b, cfg):
            return _kernel_contract(a, b, cfg), tracker
        k = _shared_k(_f32(a), _f32(b), cfg) if shared_k else None
        aq, _ = self.prepare_operand(a, cfg, k=k)
        bq, _ = self.prepare_operand(b, cfg, k=k)
        return torch.einsum(spec, aq, bq), tracker

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

    def contract(self, spec, a, b, cfg, *, tracker=None, site=None, shared_k=False):
        state, idx = resolve_site(tracker, site)
        if state is None or idx is None:
            raise ValueError("rr_tracked needs tracker+site")
        a, b = _f32(a), _f32(b)
        k = tracker_k(state, idx)
        if not cfg.pinned:
            k = torch.maximum(k, _shared_k(a, b, cfg))
            state = tracker_update(state, idx, a, b, cfg)
        aq, _ = self.prepare_operand(a, cfg, k=k)
        bq, _ = self.prepare_operand(b, cfg, k=k)
        return torch.einsum(spec, aq, bq), rewrap(tracker, state)

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

    def contract(self, spec, a, b, cfg, *, tracker=None, site=None, shared_k=False):
        out, _ = super().contract(spec, a, b, cfg)
        return out, self._track(tracker, site, a, b, cfg)

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

"""Precision policy: the config, the presets, and the adjust unit's law.

* ``mode="rr_tile"``: every operand tile gets the minimal safe split ``k``
  from a max-|x| pre-pass, with no carried state;
* ``mode="rr_tracked"``: a :class:`RangeTracker` carries an EMA of each
  site's exponent envelope across steps, grows ``k`` on demand and shrinks
  it only on persistent redundancy (the paper's Fig. 5 unit);
* ``mode="deploy"``: bf16 arithmetic with the tracker still driven.

The tracker is a tuple of tensors that lives on the state's device; the
law (:func:`adjust_step`) is elementwise over tensors, so it runs on one
site's scalars or on a vector of sites alike.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch._device import f32_scalar

from .fma import fma
from .flexformat import FlexFormat
from .r2f2 import _finite_max_exp, _needed_e_bits, _needed_e_bits_lo, op_bounds

__all__ = [
    "PrecisionConfig",
    "KNOWN_MODES",
    "PRESETS",
    "RangeTracker",
    "tracker_init",
    "evidence_bounds",
    "evidence_k_need",
    "adjust_step",
    "adjust_sequence",
    "tracker_observe",
    "tracker_update",
    "tracker_k",
]

#: modes a PrecisionConfig may carry; ``register_engine`` extends it
KNOWN_MODES = {"f32", "bf16", "fixed", "rr_tile", "rr_tracked", "deploy"}


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Static precision policy (hashable). Fields match ``repro``'s config
    one for one, so a config converts field by field (``repro_torch.convert``).

    ``pinned`` freezes tracked engines at the tracker's carried split;
    ``k_bounds`` are per-site ``(k_lo, k_hi)`` clamps on re-picks;
    ``kernel_blocks[:2]`` tiles 2-D elementwise fused kernels (the SWE flux).
    """

    mode: str = "deploy"
    fmt: FlexFormat = FlexFormat(3, 9, 3)
    fixed_em: Tuple[int, int] = (5, 10)
    tile: int = 128
    tail_approx: bool = True
    ema: float = 0.95
    headroom: int = 1
    use_kernels: bool = False
    pinned: bool = False
    k_bounds: Optional[Tuple[Tuple[int, int], ...]] = None
    kernel_blocks: Tuple[int, int, int] = (128, 128, 128)

    def __post_init__(self):
        if self.mode not in KNOWN_MODES:
            raise ValueError(
                f"unknown precision mode {self.mode!r}; known: {sorted(KNOWN_MODES)} "
                "(register new modes via repro_torch.precision.register_engine)"
            )


PRESETS = {
    "f32": PrecisionConfig(mode="f32"),
    "bf16": PrecisionConfig(mode="bf16"),
    "e5m10": PrecisionConfig(mode="fixed", fixed_em=(5, 10)),
    "e5m9": PrecisionConfig(mode="fixed", fixed_em=(5, 9)),
    "e5m8": PrecisionConfig(mode="fixed", fixed_em=(5, 8)),
    "r2f2_16": PrecisionConfig(mode="rr_tile", fmt=FlexFormat(3, 9, 3)),
    "r2f2_16_384": PrecisionConfig(mode="rr_tile", fmt=FlexFormat(3, 8, 4)),
    "r2f2_15": PrecisionConfig(mode="rr_tile", fmt=FlexFormat(3, 8, 3)),
    "r2f2_14": PrecisionConfig(mode="rr_tile", fmt=FlexFormat(3, 7, 3)),
    "deploy": PrecisionConfig(mode="deploy"),
}


class RangeTracker(NamedTuple):
    """Per-site adjust-unit state, each field ``(n_sites,)``."""

    hi_ema: torch.Tensor  # f32: EMA of the per-step high exponent bound
    lo_ema: torch.Tensor  # f32: EMA of the per-step low exponent bound
    k: torch.Tensor  # int32: current flexible split per site
    overflow_steps: torch.Tensor  # int32: cumulative adjust-up events
    shrink_steps: torch.Tensor  # int32: cumulative adjust-down events

    def to(self, device) -> "RangeTracker":
        return RangeTracker(*(t.to(device) for t in self))


def tracker_init(n_sites: int, fmt: FlexFormat, k0=None, *, device) -> RangeTracker:
    """Fresh tracker; ``k0`` is a scalar or per-site starting split
    (default ``fmt.fx``: start wide, shrink on redundancy)."""
    k0 = fmt.fx if k0 is None else k0
    k = torch.as_tensor(k0, dtype=torch.int32).to(device).expand(n_sites).clone()
    return RangeTracker(
        hi_ema=torch.zeros(n_sites, dtype=torch.float32, device=device),
        lo_ema=torch.zeros(n_sites, dtype=torch.float32, device=device),
        k=k,
        overflow_steps=torch.zeros(n_sites, dtype=torch.int32, device=device),
        shrink_steps=torch.zeros(n_sites, dtype=torch.int32, device=device),
    )


def _site_max_exp(x: torch.Tensor) -> torch.Tensor:
    return _finite_max_exp(x).to(torch.float32)


def _k_for(hi, lo, fmt: FlexFormat) -> torch.Tensor:
    """Split covering the envelope ``[lo, hi]``; f32 bounds truncate toward
    zero first, as the reference's ``astype(int32)`` does."""
    e = torch.maximum(
        _needed_e_bits(hi.to(torch.int32), fmt.eb, fmt.fx),
        _needed_e_bits_lo(lo.to(torch.int32), fmt.eb, fmt.fx),
    )
    return (e - fmt.eb).to(torch.int32)


def evidence_bounds(ae, be, op: str = "mul"):
    """One observation's exponent envelope ``(step_hi, step_lo)``."""
    return op_bounds(ae, be, op)


def evidence_k_need(ae, be, cfg: PrecisionConfig, op: str = "mul") -> torch.Tensor:
    """Instantaneous split one observation demands, headroom included."""
    step_hi, step_lo = evidence_bounds(ae, be, op)
    return _k_for(step_hi + cfg.headroom, step_lo - cfg.headroom, cfg.fmt)


def _fma32(a: float, b: float, c: float) -> float:
    """``a * b + c`` for f32 values held in Python floats, rounded once to
    f32: the scalar twin of :func:`repro_torch.core.fma.fma` (exact
    product, two-sum, round to odd, then RNE to f32)."""
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    if err != 0.0 and math.isfinite(s) and not struct.unpack("<q", struct.pack("<d", s))[0] & 1:
        s = math.nextafter(s, math.inf if err > 0 else -math.inf)
    return struct.unpack("<f", struct.pack("<f", s))[0]


def _ema_sequence(start, addend, bound, ema: float, upper: bool) -> torch.Tensor:
    """Per site (columns), the sequence ``x = pick(fma(ema, x, addend[s]),
    bound[s])`` over substeps, with ``pick`` max (``upper``) or min taking
    its first argument on ties, as ``torch.maximum``/``minimum`` do."""
    cols = []
    for j, x in enumerate(start.tolist()):
        seq = []
        for a, b in zip(addend[:, j].tolist(), bound[:, j].tolist()):
            v = _fma32(ema, x, a)
            x = v if (v >= b if upper else v <= b) else b
            seq.append(x)
        cols.append(seq)
    return torch.tensor(cols, dtype=torch.float32).T


def adjust_sequence(state: RangeTracker, step_hi, step_lo, cfg: PrecisionConfig) -> RangeTracker:
    """The adjust law over a whole stream of envelopes ``(substeps, n_sites)``
    on the host: :func:`adjust_step` applied substep by substep to every
    site, with identical results. The EMAs never depend on k, so only the
    two scalar recursions (the EMAs and k) run as Python loops; everything
    else is vectorised."""
    st = state.to("cpu")
    ema = float(f32_scalar(cfg.ema, "cpu"))
    one_minus = f32_scalar(1.0 - cfg.ema, "cpu")
    hi = _ema_sequence(st.hi_ema, one_minus * step_hi, step_hi, ema, upper=True)
    lo = _ema_sequence(st.lo_ema, one_minus * step_lo, step_lo, ema, upper=False)
    need_now = _k_for(step_hi + cfg.headroom, step_lo - cfg.headroom, cfg.fmt).T.tolist()
    need_ema = _k_for(hi + cfg.headroom, lo - cfg.headroom, cfg.fmt).T.tolist()
    ks, ovs, shs = st.k.tolist(), st.overflow_steps.tolist(), st.shrink_steps.tolist()
    for j in range(len(ks)):
        k, ov, sh = ks[j], ovs[j], shs[j]
        for now, need in zip(need_now[j], need_ema[j]):
            k_new = max(now, min(k, need))
            if cfg.k_bounds is not None:
                k_new = min(max(k_new, cfg.k_bounds[j][0]), cfg.k_bounds[j][1])
            ov += k_new > k
            sh += k_new < k
            k = k_new
        ks[j], ovs[j], shs[j] = k, ov, sh
    n = len(ks)
    out = RangeTracker(
        hi_ema=hi[-1] if len(hi) else st.hi_ema,
        lo_ema=lo[-1] if len(lo) else st.lo_ema,
        k=torch.tensor(ks, dtype=torch.int32).reshape(n),
        overflow_steps=torch.tensor(ovs, dtype=torch.int32).reshape(n),
        shrink_steps=torch.tensor(shs, dtype=torch.int32).reshape(n),
    )
    return out.to(state.k.device)


def adjust_step(
    k, hi_ema, lo_ema, overflow_steps, shrink_steps, ae, be, cfg: PrecisionConfig,
    op: str = "mul", k_bounds: Optional[Tuple[int, int]] = None,
):
    """One tick of the paper's adjust unit: fold one operation's operand
    max-exponent evidence ``(ae, be)`` into one site's state, grow on
    demand, shrink only toward the EMA's persistent need, count both.
    Returns ``(k, hi_ema, lo_ema, overflow_steps, shrink_steps)``."""
    step_hi, step_lo = (b.to(hi_ema.device) for b in evidence_bounds(ae, be, op))
    # the compiled solver programs of the reference fuse the EMA's first
    # product into its add: fma(ema, old, (1-ema)*new). (XLA picks the fused
    # product per program; some other programs fuse the second, ulps apart.)
    ema = f32_scalar(cfg.ema, hi_ema.device)
    one_minus = f32_scalar(1.0 - cfg.ema, hi_ema.device)
    hi = torch.maximum(fma(ema, hi_ema, one_minus * step_hi), step_hi)
    lo = torch.minimum(fma(ema, lo_ema, one_minus * step_lo), step_lo)
    k_need_now = _k_for(step_hi + cfg.headroom, step_lo - cfg.headroom, cfg.fmt)
    k_need_ema = _k_for(hi + cfg.headroom, lo - cfg.headroom, cfg.fmt)
    k = torch.as_tensor(k).to(torch.int32)
    k_new = torch.maximum(k_need_now, torch.minimum(k, k_need_ema))
    if k_bounds is not None:
        k_new = k_new.clamp(k_bounds[0], k_bounds[1])
    grew = (k_new > k).to(torch.int32)
    shrank = (k_new < k).to(torch.int32)
    return k_new, hi, lo, overflow_steps + grew, shrink_steps + shrank


def tracker_observe(state: RangeTracker, site: int, ae, be, cfg: PrecisionConfig, op: str = "mul") -> RangeTracker:
    """Fold one observation into row ``site`` of the tracker."""
    kb = None if cfg.k_bounds is None else cfg.k_bounds[site]
    new = adjust_step(
        state.k[site], state.hi_ema[site], state.lo_ema[site],
        state.overflow_steps[site], state.shrink_steps[site], ae, be, cfg, op, k_bounds=kb,
    )
    fields = []
    for old, v in zip((state.k, state.hi_ema, state.lo_ema, state.overflow_steps, state.shrink_steps), new):
        t = old.clone()
        t[site] = v
        fields.append(t)
    k, hi, lo, ov, sh = fields
    return RangeTracker(hi_ema=hi, lo_ema=lo, k=k, overflow_steps=ov, shrink_steps=sh)


def tracker_update(state: RangeTracker, site: int, a, b, cfg: PrecisionConfig, op: str = "mul") -> RangeTracker:
    """Reduce the operands to max-exponent evidence, then observe it."""
    return tracker_observe(state, site, _site_max_exp(a), _site_max_exp(b), cfg, op)


def tracker_k(state: RangeTracker, site: int) -> torch.Tensor:
    return state.k[site]

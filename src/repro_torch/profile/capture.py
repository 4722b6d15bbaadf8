"""Range-distribution capture primitives (the port of
``repro/profile/capture.py``).

Every policy operation bins the unbiased exponents of both (broadcast)
operands into width-1 exponent bins, per named site, beside the site-level
max-exponent evidence. The same binning runs in ``pde.solver.StepOps``
(the reference plane) and in ``kernels.fused.FusedOps`` (the plain versions
of the fused and megakernel planes); the CUDA kernels bin with
``csrc/r2f2_device.cuh::Hist``, the same rule.

Counting is decided from the f32 bits: zero bits (either sign) and
non-finite values are skipped, the exponent is the biased field minus 127,
and it clamps into the edge bins. A subnormal (field 0, exponent -127) thus
counts in the low edge bin, as ``repro``'s compiled scans count it: a float
compare ``x != 0`` would drop it under a flush-to-zero mode, on the card
(``-ftz=true``) and on the CPU (``torch.set_flush_denormal``) alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.policy import _site_max_exp

__all__ = ["CaptureSpec", "CaptureResult", "exp_hist", "pair_exp_hist", "site_evidence"]


@dataclasses.dataclass(frozen=True)
class CaptureSpec:
    """The binning layout: one bin per unbiased exponent in ``[e_lo, e_hi]``
    inclusive; exponents outside clamp into the edge bins."""

    e_lo: int = -64
    e_hi: int = 63

    def __post_init__(self):
        if self.e_hi <= self.e_lo:
            raise ValueError(f"empty exponent range [{self.e_lo}, {self.e_hi}]")

    @property
    def n_bins(self) -> int:
        return self.e_hi - self.e_lo + 1

    def edges(self):
        """Bin exponents as a host-side range (analysis axis labels)."""
        return range(self.e_lo, self.e_hi + 1)


class CaptureResult(NamedTuple):
    """What a captured run hands to the offline layer.

    ``evidence``  (steps, n_sites, 2) f32: per-step site operand max exponents.
    ``exp_time``  (n_snapshots, n_sites, 2, n_bins) int32: per-interval counts.
    ``exp_total`` (n_sites, 2, n_bins) int32: whole-run counts, remainder included.
    """

    evidence: Any
    exp_time: Any
    exp_total: Any


def exp_hist(x, spec: CaptureSpec, mask=None) -> torch.Tensor:
    """Bin one (broadcast) operand's elementwise unbiased exponents into
    ``(n_bins,) int32``; ``mask`` (broadcastable, bool) keeps only True lanes."""
    x = torch.as_tensor(x).to(torch.float32)
    if mask is not None:
        x, mask = torch.broadcast_tensors(x, torch.as_tensor(mask, device=x.device))
        mask = mask.reshape(-1)
    u = x.reshape(-1).contiguous().view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    field = u >> 23
    keep = (u != 0) & (field != 255)
    if mask is not None:
        keep = keep & mask
    idx = (field - 127 - spec.e_lo).clamp(0, spec.n_bins - 1)
    return torch.bincount(idx[keep], minlength=spec.n_bins).to(torch.int32)


def pair_exp_hist(a, b, spec: CaptureSpec, mask=None) -> torch.Tensor:
    """Bin both operands of one operation (broadcast to a common shape by
    the caller): ``(2, n_bins) int32``."""
    return torch.stack([exp_hist(a, spec, mask), exp_hist(b, spec, mask)])


def site_evidence(a, b) -> torch.Tensor:
    """One operation's site-level evidence ``(a_max_exp, b_max_exp)`` as a
    ``(2,) f32``: what the tracker consumes."""
    return torch.stack([_site_max_exp(a), _site_max_exp(b)])

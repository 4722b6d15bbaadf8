"""Fused-plane policy: arithmetic families, eligibility, evidence fold-in.

* :data:`FUSED_FAMILIES` maps each builtin mode to the arithmetic family a
  fused kernel implements (``"rr"`` per-block runtime split, ``"bf16"``,
  ``"fixed"``, ``"f32"``). Engines registered later have no family and run
  on the reference plane only.
* :func:`fold_evidence` replays a fused chunk's per-substep site evidence
  (per-site operand max exponents, max-reduced across blocks) through the
  adjust law, so a carried tracker evolves exactly as the stepwise loop's
  per-multiply ``tracker_update`` calls move it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policy import PrecisionConfig, adjust_sequence, evidence_bounds

from .sites import SiteTracker, rewrap

__all__ = ["FUSED_FAMILIES", "fused_family", "fused_eligible", "fold_evidence"]

FUSED_FAMILIES = {
    "f32": "f32",
    "bf16": "bf16",
    "deploy": "bf16",
    "fixed": "fixed",
    "rr_tile": "rr",
    "rr_tracked": "rr",
}


def fused_family(mode: str) -> Optional[str]:
    """The fused kernels' arithmetic family for a mode (None: not fusable)."""
    return FUSED_FAMILIES.get(mode)


def fused_eligible(prec: PrecisionConfig, stepper, cfg=None) -> bool:
    """True iff the mode has a fused family, the stepper has a ``fused_step``
    hook, and its ``fused_supported`` shape gate accepts the config."""
    if fused_family(prec.mode) is None:
        return False
    if not callable(getattr(stepper, "fused_step", None)):
        return False
    supported = getattr(stepper, "fused_supported", None)
    return bool(supported(cfg, prec)) if callable(supported) else True


def fold_evidence(tracker, evidence, cfg: PrecisionConfig, ops=None):
    """Fold a chunk's evidence ``(substeps, n_sites, 2)`` into the tracker.

    Substeps replay in order through the adjust law
    (:func:`repro_torch.core.policy.adjust_sequence`). ``ops`` is the
    per-site op tuple selecting each site's envelope (None: all ``"mul"``).
    The evidence and the tracker are folded on the host, one copy per
    chunk, and the tracker goes back to its own device.
    """
    if tracker is None:
        return None
    if cfg.pinned:  # static profiled k: the adjust unit is out of the loop
        return tracker
    state = tracker.state if isinstance(tracker, SiteTracker) else tracker
    n_sites = evidence.shape[1]
    if len(state.k) != n_sites:
        raise ValueError(f"evidence covers {n_sites} sites but tracker has {len(state.k)} rows")
    if ops is not None and len(ops) != n_sites:
        raise ValueError(f"site_ops covers {len(ops)} sites but evidence has {n_sites}")
    ev = evidence.to("cpu", torch.float32)
    bounds = [evidence_bounds(ev[:, j, 0], ev[:, j, 1], "mul" if ops is None else ops[j]) for j in range(n_sites)]
    step_hi = torch.stack([b[0] for b in bounds], dim=1)
    step_lo = torch.stack([b[1] for b in bounds], dim=1)
    new = adjust_sequence(state, step_hi, step_lo, cfg)
    return rewrap(tracker, new)

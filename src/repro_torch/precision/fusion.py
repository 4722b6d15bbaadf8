"""Fused-plane policy: arithmetic families, eligibility, evidence fold-in.

* :data:`FUSED_FAMILIES` maps each builtin mode to the arithmetic family a
  fused kernel implements (``"rr"`` per-block runtime split, ``"bf16"``,
  ``"fixed"``, ``"f32"``). Engines registered later have no family and run
  on the reference plane only.
* :func:`mega_eligible` is the megakernel plane's gate, built the same way.
  Given a CUDA device, both also ask whether the stepper's CUDA kernels
  hold the config (``Stepper.kernels_hold``; True by default, since a body
  without a kernel of its own runs on the generic kernels K8 and K9): on
  the card ``auto`` then falls back where a stepper says its kernel cannot
  take the field, as ``repro`` runs every plane;
* :func:`fold_evidence` replays a fused chunk's per-substep site evidence
  (per-site operand max exponents, max-reduced across blocks) through the
  adjust law, so a carried tracker evolves exactly as the stepwise loop's
  per-multiply ``tracker_update`` calls move it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import on_card
from repro_torch.core.policy import PrecisionConfig, adjust_sequence, evidence_bounds, tracker_stack

from .sites import SiteTracker, rewrap

__all__ = ["FUSED_FAMILIES", "fused_family", "fused_eligible", "mega_eligible", "fold_evidence"]

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


def _eligible(prec: PrecisionConfig, stepper, cfg, hook: str, gate: str, device) -> bool:
    if fused_family(prec.mode) is None:
        return False
    if not callable(getattr(stepper, hook, None)):
        return False
    if on_card(device) and not stepper.kernels_hold(cfg):
        return False
    supported = getattr(stepper, gate, None)
    return bool(supported(cfg, prec)) if callable(supported) else True


def fused_eligible(prec: PrecisionConfig, stepper, cfg=None, device=None) -> bool:
    """True iff the mode has a fused family, the stepper has a ``fused_step``
    hook, and its ``fused_supported`` shape gate accepts the config; on a
    CUDA ``device`` its kernels must also hold the config."""
    return _eligible(prec, stepper, cfg, "fused_step", "fused_supported", device)


def mega_eligible(prec: PrecisionConfig, stepper, cfg=None, device=None) -> bool:
    """True iff the mode has a fused family, the stepper has a ``mega_step``
    hook, and its ``mega_supported`` shape gate accepts the config (on a
    CUDA ``device``, with kernels that hold it). The megakernel keeps one
    block per state leaf, so a stepper whose fused kernels tile the field
    refuses configs larger than one tile."""
    return _eligible(prec, stepper, cfg, "mega_step", "mega_supported", device)


def fold_evidence(tracker, evidence, cfg: PrecisionConfig, ops=None):
    """Fold a chunk's evidence ``(substeps, n_sites, 2)`` into the tracker.

    Substeps replay in order through the adjust law
    (:func:`repro_torch.core.policy.adjust_sequence`). ``ops`` is the
    per-site op tuple selecting each site's envelope (None: all ``"mul"``).
    The evidence and the tracker are folded on the host, one copy per
    chunk, and the tracker goes back to its own device. A stacked tracker
    (an ensemble's, rows ``(members, n_sites)``) takes ``(members,
    substeps, n_sites, 2)`` evidence and folds each member's as a tracker of
    its own, still with one copy per chunk for all members.
    """
    if tracker is None:
        return None
    if cfg.pinned:  # static profiled k: the adjust unit is out of the loop
        return tracker
    state = tracker.state if isinstance(tracker, SiteTracker) else tracker
    stacked = state.k.dim() == 2
    n_sites = evidence.shape[-2]
    if state.k.shape[-1] != n_sites:
        raise ValueError(f"evidence covers {n_sites} sites but tracker has {state.k.shape[-1]} rows")
    if ops is not None and len(ops) != n_sites:
        raise ValueError(f"site_ops covers {len(ops)} sites but evidence has {n_sites}")
    ev = evidence.to("cpu", torch.float32)
    if not stacked:
        return rewrap(tracker, _fold(state, ev, cfg, ops))
    if ev.dim() != 4 or ev.shape[0] != state.k.shape[0]:
        raise ValueError(f"a stacked tracker of {state.k.shape[0]} members takes (members, substeps, n_sites, 2) "
                         f"evidence; got {tuple(ev.shape)}")
    host = state.to("cpu")
    new = tracker_stack([_fold(host.member(m), ev[m], cfg, ops) for m in range(ev.shape[0])])
    return rewrap(tracker, new.to(state.k.device))


def _fold(state, ev, cfg, ops):
    """One tracker's fold of ``(substeps, n_sites, 2)`` host evidence."""
    n_sites = ev.shape[1]
    bounds = [evidence_bounds(ev[:, j, 0], ev[:, j, 1], "mul" if ops is None else ops[j]) for j in range(n_sites)]
    step_hi = torch.stack([b[0] for b in bounds], dim=1)
    step_lo = torch.stack([b[1] for b in bounds], dim=1)
    return adjust_sequence(state, step_hi, step_lo, cfg)

"""Policy synthesis and closed-loop validation (the port of
``repro/profile/autotune.py``).

The synthesizer replays the captured evidence through the adjust law the
runtime tracker applies (:func:`repro_torch.precision.fold_evidence`), so
the tuned per-site ``k`` is the split an ``rr_tracked`` run over the same
evidence converges to; the least and most instantaneous need
(:func:`repro_torch.core.policy.evidence_k_need`) become the floor and
ceiling hints. Validation re-runs the stepper under the policy against the
f32 oracle before stamping the artifact accepted.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.policy import PrecisionConfig, tracker_init
from repro_torch.precision import fold_evidence, site_tracker_init

from .analysis import RangeProfile, host, k_need
from .artifact import PrecisionPolicy

__all__ = ["synthesize_policy", "validate_policy", "tune_policy"]


def synthesize_policy(profile: RangeProfile, prec: Optional[PrecisionConfig] = None) -> PrecisionPolicy:
    """A (not yet validated) PrecisionPolicy from a range profile. ``prec``
    gives the target format and adjust constants (default: the profile's
    capture config). Per site, ``k`` is the split after replaying the whole
    evidence stream from the standard wide start, and ``k_lo``/``k_hi`` the
    least and most instantaneous need over the run."""
    prec = profile.prec if prec is None else prec
    base = dataclasses.replace(prec, k_bounds=None, pinned=False)
    n_sites = len(profile.sites)
    ev = torch.from_numpy(np.asarray(profile.evidence, np.float32))
    state = fold_evidence(tracker_init(n_sites, base.fmt, device="cpu"), ev, base, ops=profile.site_ops)
    k = state.k.numpy().astype(np.int64)
    need = k_need(profile.evidence, base, profile.site_ops)
    k_hi = np.maximum(need.max(axis=0), k)  # the converged k never exceeds the most need
    k_lo = np.minimum(need.min(axis=0), k)
    sites = {name: {"k": int(k[j]), "k_lo": int(k_lo[j]), "k_hi": int(k_hi[j])} for j, name in enumerate(profile.sites)}
    return PrecisionPolicy(
        stepper=profile.stepper,
        fmt=base.fmt,
        sites=sites,
        ema=base.ema,
        headroom=base.headroom,
        meta={
            "created_unix": time.time(),
            "profile": {
                "steps": profile.steps,
                "execution": profile.execution,
                "capture_mode": profile.prec.mode,
                "spec": {"e_lo": profile.spec.e_lo, "e_hi": profile.spec.e_hi},
            },
            "adjust_counters": {
                "overflow_steps": [int(x) for x in state.overflow_steps.tolist()],
                "shrink_steps": [int(x) for x in state.shrink_steps.tolist()],
            },
        },
    )


def _rel_l2(obs, ref, offset: float) -> float:
    obs = host(obs, np.float64) - offset
    ref = host(ref, np.float64) - offset
    return float(np.linalg.norm(obs - ref) / max(float(np.linalg.norm(ref)), 1e-30))


def validate_policy(
    policy: PrecisionPolicy,
    cfg=None,
    *,
    steps: int,
    tol: float = 0.1,
    execution: str = "reference",
    snapshot_every: Optional[int] = None,
    device=None,
) -> Dict[str, Any]:
    """Closed-loop validation replay on ``device`` (None: the card); stamps
    ``policy.validation`` in place and returns the stamp.

    Runs of ``policy.stepper`` over ``steps`` against the f32 oracle:
    ``rr_tracked`` seeded and clamped by the policy (the dynamic gate),
    ``rr_tracked`` pinned at each site's ``k_hi`` (the static gate: a build
    without the adjust unit), and pinned ``deploy`` under the policy, whose
    rel-L2 is recorded for the deploy-time reproducibility check."""
    from repro_torch.pde.solver import Simulation  # lazy: no pde import at module scope

    def run(prec, policy_arg, tracker=None):
        sim = Simulation(policy.stepper, cfg, prec, device=device)
        res = sim.run(steps, snapshot_every=snapshot_every, execution=execution, policy=policy_arg, tracker=tracker)
        return sim, res

    sim, ref = run(PrecisionConfig(mode="f32", fmt=policy.fmt), None)
    offset = sim.stepper.metric_offset(sim.cfg)
    ref_obs = sim.stepper.observables(ref.state, sim.cfg)

    base = PrecisionConfig(mode="rr_tracked", fmt=policy.fmt, ema=policy.ema, headroom=policy.headroom)
    _, tracked = run(base, policy)
    tracked_obs = sim.stepper.observables(tracked.state, sim.cfg)
    rel_tracked = _rel_l2(tracked_obs, ref_obs, offset)

    sites = sim.stepper.sites
    k_hi = np.asarray([policy.sites[n]["k_hi"] for n in sites], np.int32)
    static_tr = site_tracker_init(sites, policy.fmt, k0=torch.from_numpy(k_hi), device=sim.device)
    _, static = run(dataclasses.replace(base, pinned=True), None, tracker=static_tr)
    static_obs = sim.stepper.observables(static.state, sim.cfg)
    rel_static = _rel_l2(static_obs, ref_obs, offset)

    _, deploy = run(dataclasses.replace(base, mode="deploy", pinned=True), policy)
    deploy_obs = sim.stepper.observables(deploy.state, sim.cfg)
    rel_deploy = _rel_l2(deploy_obs, ref_obs, offset)

    finite = all(np.isfinite(host(o, np.float64)).all() for o in (tracked_obs, static_obs, deploy_obs))
    stamp = {
        "accepted": bool(finite and rel_tracked <= tol and rel_static <= tol),
        "tol": tol,
        "oracle": "f32",
        "steps": steps,
        "execution": execution,
        "snapshot_every": snapshot_every,
        "rel_l2_tracked": rel_tracked,
        "rel_l2_static": rel_static,
        "rel_l2_deploy": rel_deploy,
        "finite": finite,
        "validated_unix": time.time(),
    }
    policy.validation = stamp
    return stamp


def tune_policy(
    stepper,
    cfg=None,
    *,
    steps: int,
    prec: Optional[PrecisionConfig] = None,
    capture_prec: Optional[PrecisionConfig] = None,
    execution: str = "reference",
    snapshot_every: Optional[int] = None,
    tol: float = 0.1,
    validate: bool = True,
    device=None,
):
    """Capture, synthesize and validate in one call on ``device`` (None: the
    card). ``capture_prec`` is the profiling run's mode (default f32);
    ``prec`` the target format and adjust constants (default: the capture's).
    Returns ``(profile, report, policy)``, the policy stamped when ``validate``."""
    from .pipeline import capture_profile

    profile, _ = capture_profile(
        stepper, cfg, steps=steps, prec=capture_prec, execution=execution, snapshot_every=snapshot_every,
        device=device,
    )
    policy = synthesize_policy(profile, prec)
    if validate:
        validate_policy(policy, cfg, steps=steps, tol=tol, execution=execution, snapshot_every=snapshot_every,
                        device=device)
    return profile, profile.report(), policy

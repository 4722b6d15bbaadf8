"""Capture entry point (the port of ``repro/profile/pipeline.py``): from a
stepper name to a hosted RangeProfile. The capture itself lives in the
solver's loops and the kernels; this runs a simulation with capture on."""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.policy import PrecisionConfig

from .analysis import RangeProfile
from .capture import CaptureSpec

__all__ = ["capture_profile"]


def capture_profile(
    stepper,
    cfg=None,
    *,
    steps: int,
    prec: Optional[PrecisionConfig] = None,
    execution: str = "reference",
    snapshot_every: Optional[int] = None,
    spec: Optional[CaptureSpec] = None,
    state0=None,
    device=None,
) -> Tuple[RangeProfile, "SimResult"]:  # noqa: F821 (a lazy pde import)
    """Run ``steps`` of a registered stepper with range capture on, on
    ``device`` (None: the card). ``prec`` defaults to f32, the oracle
    trajectory. Returns ``(RangeProfile, SimResult)``."""
    from repro_torch.pde.solver import Simulation  # lazy: no pde import at module scope

    prec = PrecisionConfig(mode="f32") if prec is None else prec
    spec = CaptureSpec() if spec is None else spec
    sim = Simulation(stepper, cfg, prec, device=device)
    res = sim.run(steps, snapshot_every=snapshot_every, state0=state0, execution=execution, capture=spec)
    profile = RangeProfile(
        sim.stepper.name, sim.stepper.sites, spec, prec, steps, execution, res.profile,
        site_ops=getattr(sim.stepper, "site_ops", None) or None,
    )
    return profile, res

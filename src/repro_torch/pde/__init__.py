"""PDE workloads over the solver framework: the paper's heat1d and swe2d.

    from repro_torch.pde import Simulation
    res = Simulation("swe2d", None, PRESETS["r2f2_16"]).run(400, execution="fused")
"""

from .registry import get_stepper, known_steppers, register_stepper
from .solver import SimResult, Simulation, StepOps, Stepper
from .heat1d import HeatConfig
from .swe2d import SWEConfig

__all__ = [
    "Stepper",
    "StepOps",
    "Simulation",
    "SimResult",
    "register_stepper",
    "get_stepper",
    "known_steppers",
    "HeatConfig",
    "SWEConfig",
]

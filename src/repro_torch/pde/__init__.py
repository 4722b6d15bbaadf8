"""PDE workloads over the solver framework: the paper's heat1d and swe2d, and
heat2d, advection1d and burgers1d.

    from repro_torch.pde import Simulation
    res = Simulation("swe2d", None, PRESETS["r2f2_16"]).run(400, execution="fused")
"""

from .registry import get_stepper, known_steppers, register_stepper
from .solver import SimResult, Simulation, StepOps, Stepper
from .advection1d import AdvectionConfig
from .burgers1d import BurgersConfig
from .heat1d import HeatConfig
from .heat2d import Heat2DConfig
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
    "Heat2DConfig",
    "AdvectionConfig",
    "BurgersConfig",
]

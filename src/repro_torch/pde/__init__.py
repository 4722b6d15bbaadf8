"""PDE workloads over the solver framework: the paper's heat1d and swe2d, and
heat2d, advection1d and burgers1d.

    from repro_torch.pde import Simulation
    res = Simulation("swe2d", None, PRESETS["r2f2_16"]).run(400, execution="fused")

The per-workload entry points (``simulate_heat``/``simulate_swe``,
``heat_step``/``swe_step``) are shims over the framework, as in the
reference.
"""

from .registry import get_stepper, known_steppers, register_stepper
from .solver import SimResult, Simulation, StepOps, Stepper
from .advection1d import AdvectionConfig, initial_profile
from .burgers1d import BurgersConfig, initial_wave
from .heat1d import HeatConfig, heat_step
from .heat1d import simulate as simulate_heat
from .heat2d import Heat2DConfig, initial_condition_2d
from .precision_ops import padd, pdiv, pmul, pstore
from .swe2d import SWEConfig, swe_step
from .swe2d import simulate as simulate_swe

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
    "initial_condition_2d",
    "initial_profile",
    "initial_wave",
    "heat_step",
    "simulate_heat",
    "swe_step",
    "simulate_swe",
    "pmul",
    "pstore",
    "pdiv",
    "padd",
]

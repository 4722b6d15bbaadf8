"""1D linear advection, flux-form upwind: beyond-paper workload #2.

    du/dt + c * du/dx = 0,    u'[i] = u[i] - (dt/dx) * (f[i] - f[i-1])

with the flux ``f = c * u`` on the policy's multiplier (periodic domain,
``c > 0``). At ``cfl = c*dt/dx = 1`` each step translates the profile by
one cell, so the f32 run is an exact translation. The default pulse peaks
at 1e5, past E5M10's 65504 ceiling: the fixed-format flux quantizes to
inf and the run is destroyed within a step (overflow on the field itself),
while R2F2 widens its exponent and rides through.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import f32_scalar as _f32
from repro_torch._device import linspace_from_zero
from repro_torch.kernels.updates import advection1d_update

from .registry import register_stepper
from .solver import StepOps, Stepper

__all__ = ["AdvectionConfig", "Advection1DStepper", "initial_profile"]


@dataclasses.dataclass(frozen=True)
class AdvectionConfig:
    nx: int = 256
    length: float = 1.0
    speed: float = 1.0  # c > 0 (upwind bias is to the left neighbour)
    cfl: float = 1.0  # c*dt/dx; 1.0 -> exact translation per step
    amplitude: float = 1.0e5  # peaks past E5M10's 65504 ceiling
    width: float = 0.08  # gaussian pulse width (fraction of the domain)

    @property
    def dx(self) -> float:
        return self.length / self.nx

    @property
    def dt(self) -> float:
        return self.cfl * self.dx / self.speed

    @property
    def dtodx(self) -> float:
        return self.dt / self.dx


def initial_profile(cfg: AdvectionConfig, *, device) -> torch.Tensor:
    x = linspace_from_zero(cfg.length, cfg.nx, endpoint=False, device=device)
    z = (x - _f32(0.3 * cfg.length, device)) / _f32(cfg.width * cfg.length, device)
    return _f32(cfg.amplitude, device) * torch.exp(-(z * z))


@register_stepper("advection1d")
class Advection1DStepper(Stepper):
    """Flux-form first-order upwind on a periodic domain."""

    sites = ("adv.flux", "adv.update")
    site_ops = ("mul", "mul")
    failure_mode = "overflow"
    story = "flux operand is the 1e5-peak field itself; E5M10 infs the flux"
    snapshots_default = 8
    ensemble_hooks = True  # the hooks take members=True: one launch for every member
    fused_packed = True  # the fused kernel decodes and re-encodes a packed carry

    def kernels_hold(self, cfg: AdvectionConfig) -> bool:
        """Kernels K5b and K5e take a rod of any length (``kernels/rod.py::rod_plan``)."""
        return True

    def raw_cells(self, cfg: AdvectionConfig, device):
        """Every cell: the first step's capture bins the state itself (the
        flux's operand), each cell as its bits are."""
        return torch.ones(cfg.nx, dtype=torch.bool, device=device)

    def default_config(self) -> AdvectionConfig:
        return AdvectionConfig()

    def init_state(self, cfg: AdvectionConfig, *, device) -> torch.Tensor:
        return initial_profile(cfg, device=device)

    def step(self, u, cfg: AdvectionConfig, ops: StepOps):
        return advection1d_update(u, cfg.speed, cfg.dtodx, ops, self.sites)

    def fused_step(self, u, cfg: AdvectionConfig, prec, steps: int, *, k_floor=None, collect_evidence: bool = False,
                   storage: str = "f32", capture=None, members: bool = False):
        """``steps`` substeps in one launch of kernel K5b (the rod as one block)."""
        from repro_torch.kernels.pde_steps import advection1d_sweep

        return advection1d_sweep(
            u, speed=cfg.speed, dtodx=cfg.dtodx, prec=prec, steps=steps, sites=self.sites,
            k_floor=k_floor, collect_evidence=collect_evidence, storage=storage, capture=capture,
            members=members,
        )

    def mega_step(self, u, cfg: AdvectionConfig, prec, steps: int, every: int, *, tracker=None, storage: str = "f32",
                  capture=None, members: bool = False):
        """The whole horizon in one launch of kernel K5e (``advection1d_mega``)."""
        from repro_torch.kernels.mega import advection1d_mega

        return advection1d_mega(
            u, speed=cfg.speed, dtodx=cfg.dtodx, prec=prec, steps=steps, every=every, sites=self.sites,
            tracker=tracker, storage=storage, capture=capture, members=members,
        )

"""1D inviscid Burgers equation, Lax-Friedrichs: beyond-paper workload #3.

    du/dt + d(u^2/2)/dx = 0

The flux is the nonlinear product ``u * u`` on the policy's multiplier:
the operand range squares (a 350-amplitude wave gives u*u ~ 1.2e5, past
E5M10's 65504), then the shock forms and Lax-Friedrichs dissipation decays
the N-wave like ~1/t, dropping the product range by orders of magnitude.
The tracked modes' carried split must grow to FX and shrink back.

Periodic domain; fixed ``dt = cfl * dx / amplitude`` (max|u| only decays).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._device import f32_scalar as _f32
from repro_torch._device import linspace_from_zero
from repro_torch.kernels.updates import burgers1d_update

from .registry import register_stepper
from .solver import StepOps, Stepper

__all__ = ["BurgersConfig", "Burgers1DStepper", "initial_wave"]


@dataclasses.dataclass(frozen=True)
class BurgersConfig:
    nx: int = 256
    length: float = 1.0
    amplitude: float = 350.0  # u*u ~ 1.2e5 overflows E5M10's 65504
    cfl: float = 0.4  # dt = cfl*dx/amplitude (max|u| never grows)
    modes: int = 1  # sin harmonics

    @property
    def dx(self) -> float:
        return self.length / self.nx

    @property
    def dt(self) -> float:
        return self.cfl * self.dx / self.amplitude


def initial_wave(cfg: BurgersConfig, *, device) -> torch.Tensor:
    x = linspace_from_zero(cfg.length, cfg.nx, endpoint=False, device=device)
    arg = _f32(2.0 * cfg.modes * math.pi, device) * x / _f32(cfg.length, device)
    return _f32(cfg.amplitude, device) * torch.sin(arg.double()).float()  # sin rounded once from f64


@register_stepper("burgers1d")
class Burgers1DStepper(Stepper):
    """Conservative Lax-Friedrichs update on a periodic domain."""

    sites = ("burgers.uu", "burgers.flux")
    site_ops = ("mul", "mul")
    failure_mode = "nonlinear-drift"
    story = "u*u squares the range, overflows E5M10, then decays ~1/t post-shock"
    snapshots_default = 8
    ensemble_hooks = True  # the hooks take members=True: one launch for every member
    fused_packed = True  # the fused kernel decodes and re-encodes a packed carry

    def kernels_hold(self, cfg: BurgersConfig) -> bool:
        """Kernels K5c and K5f take a rod of any length (``kernels/rod.py::rod_plan``)."""
        return True

    def raw_cells(self, cfg: BurgersConfig, device):
        """Every cell: the first step's capture bins the state itself (both
        operands of u*u), each cell as its bits are."""
        return torch.ones(cfg.nx, dtype=torch.bool, device=device)

    def default_config(self) -> BurgersConfig:
        return BurgersConfig()

    def init_state(self, cfg: BurgersConfig, *, device) -> torch.Tensor:
        return initial_wave(cfg, device=device)

    def step(self, u, cfg: BurgersConfig, ops: StepOps):
        return burgers1d_update(u, cfg.dt, cfg.dx, ops, self.sites)

    def fused_step(self, u, cfg: BurgersConfig, prec, steps: int, *, k_floor=None, collect_evidence: bool = False,
                   storage: str = "f32", capture=None, members: bool = False):
        """``steps`` substeps in one launch of kernel K5c (the rod as one block)."""
        from repro_torch.kernels.pde_steps import burgers1d_sweep

        return burgers1d_sweep(
            u, dt=cfg.dt, dx=cfg.dx, prec=prec, steps=steps, sites=self.sites,
            k_floor=k_floor, collect_evidence=collect_evidence, storage=storage, capture=capture,
            members=members,
        )

    def mega_step(self, u, cfg: BurgersConfig, prec, steps: int, every: int, *, tracker=None, storage: str = "f32",
                  capture=None, members: bool = False):
        """The whole horizon in one launch of kernel K5f (``burgers1d_mega``)."""
        from repro_torch.kernels.mega import burgers1d_mega

        return burgers1d_mega(
            u, dt=cfg.dt, dx=cfg.dx, prec=prec, steps=steps, every=every, sites=self.sites,
            tracker=tracker, storage=storage, capture=capture, members=members,
        )

"""1D heat equation, explicit finite differences (paper §2, Figs. 1/2/7).

    du/dt = alpha * d2u/dx2,   u'[i] = u[i] + alpha*(dt/dx^2)*lap[i]

The update is two multiplications, ``flux = alpha * lap`` then
``upd = flux * dtodx2``: with a physical diffusivity the intermediate
``alpha * lap`` falls below E5M10's subnormal floor late in the run, while
R2F2 moves flexible bits to the exponent and tracks the true solution.
State stays f32; only the multiplies see the low bitwidth.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._device import f32_scalar as _f32

from .registry import register_stepper
from .solver import StepOps, Stepper

__all__ = ["HeatConfig", "Heat1DStepper", "initial_condition"]


@dataclasses.dataclass(frozen=True)
class HeatConfig:
    nx: int = 512
    length: float = 1.0
    alpha: float = 1e-5  # physical diffusivity (steel ~ 1.2e-5 m^2/s)
    cfl: float = 0.4  # r = alpha*dt/dx^2
    init: str = "sin"  # "sin" | "exp"
    amplitude: float = 500.0
    modes: int = 3

    @property
    def dx(self) -> float:
        return self.length / self.nx

    @property
    def dt(self) -> float:
        return self.cfl * self.dx * self.dx / self.alpha

    @property
    def dtodx2(self) -> float:
        return self.dt / (self.dx * self.dx)


def initial_condition(cfg: HeatConfig, *, device) -> torch.Tensor:
    x = torch.linspace(0.0, cfg.length, cfg.nx, dtype=torch.float32, device=device)
    if cfg.init == "sin":
        u0 = _f32(cfg.amplitude, device) * torch.sin(_f32(cfg.modes * math.pi, device) * x / _f32(cfg.length, device))
    elif cfg.init == "exp":
        z = (x - _f32(0.5 * cfg.length, device)) / _f32(0.05 * cfg.length, device)
        u0 = _f32(2000.0, device) * torch.exp(-(z * z))
    else:
        raise ValueError(f"unknown init {cfg.init!r}")
    u0[0] = 0.0
    u0[-1] = 0.0
    return u0


@register_stepper("heat1d")
class Heat1DStepper(Stepper):
    """One explicit-FD step under the precision policy."""

    sites = ("heat.flux", "heat.update")
    site_ops = ("mul", "mul")
    failure_mode = "underflow"
    story = "alpha*lap falls below E5M10's subnormal floor late in the run"
    snapshots_default = 8

    def default_config(self) -> HeatConfig:
        return HeatConfig(nx=128)

    def init_state(self, cfg: HeatConfig, *, device) -> torch.Tensor:
        return initial_condition(cfg, device=device)

    def step(self, u, cfg: HeatConfig, ops: StepOps):
        lap = u[:-2] - 2.0 * u[1:-1] + u[2:]
        flux = ops.mul(_f32(cfg.alpha, u.device), lap, "heat.flux")
        upd = ops.mul(flux, _f32(cfg.dtodx2, u.device), "heat.update")
        return torch.cat([u[:1], u[1:-1] + upd, u[-1:]])

    def fused_step(self, u, cfg: HeatConfig, prec, steps: int, *, k_floor=None, collect_evidence: bool = False):
        """``steps`` substeps in one launch of kernel K2 (one row, one block)."""
        from repro_torch.kernels.heat_stencil import heat1d_sweep

        out, ev = heat1d_sweep(
            u[None, :], alpha=cfg.alpha, dtodx2=cfg.dtodx2, prec=prec, steps=steps, block_rows=1,
            sites=self.sites, k_floor=k_floor, collect_evidence=collect_evidence,
        )
        return out[0], ev

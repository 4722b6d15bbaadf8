"""2D heat equation, explicit finite differences: beyond-paper workload #1.

    du/dt = alpha * (d2u/dx2 + d2u/dy2)

The paper's 1D two-multiplier split (``flux = alpha * lap`` then
``upd = flux * dtodx2``) on a 5-point stencil, with the same underflow
failure mode: the flux products sink below E5M10's subnormal floor as the
solution decays. Cells are square (``dy == dx == length / nx``; ``ny`` sets
the y extent) and the boundaries are pinned to zero.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._device import f32_scalar as _f32
from repro_torch._device import linspace_from_zero
from repro_torch.kernels.updates import heat2d_update

from .registry import register_stepper
from .solver import StepOps, Stepper

__all__ = ["Heat2DConfig", "Heat2DStepper", "initial_condition_2d"]


@dataclasses.dataclass(frozen=True)
class Heat2DConfig:
    nx: int = 64
    ny: int = 64
    length: float = 1.0  # x extent; cells are square, so the y extent is ny * dx
    alpha: float = 1e-5  # physical diffusivity (steel ~ 1.2e-5 m^2/s)
    cfl: float = 0.2  # r = alpha*dt/dx^2; 2D explicit stability needs r <= 1/4
    init: str = "sin"  # "sin" | "exp"
    amplitude: float = 500.0
    modes: tuple = (3, 2)  # (x, y) sin harmonics

    @property
    def dx(self) -> float:
        return self.length / self.nx

    @property
    def length_y(self) -> float:
        return self.ny * self.dx

    @property
    def dt(self) -> float:
        return self.cfl * self.dx * self.dx / self.alpha

    @property
    def dtodx2(self) -> float:
        return self.dt / (self.dx * self.dx)

    @property
    def decay_rate(self) -> float:
        """Analytic decay rate of the configured sin mode."""
        mx, my = self.modes
        return self.alpha * ((mx * math.pi / self.length) ** 2 + (my * math.pi / self.length_y) ** 2)


def _sin(x):
    """sin of f32 values, rounded once from f64 (the reference's f32 sin is
    closer to correctly rounded than PyTorch's)."""
    return torch.sin(x.double()).float()


def _exp(x):
    return torch.exp(x.double()).float()


def initial_condition_2d(cfg: Heat2DConfig, *, device) -> torch.Tensor:
    x = linspace_from_zero(cfg.length, cfg.nx, device=device)
    y = linspace_from_zero(cfg.length_y, cfg.ny, device=device)
    xx, yy = torch.meshgrid(x, y, indexing="ij")
    if cfg.init == "sin":
        mx, my = cfg.modes
        sx = _sin(_f32(mx * math.pi, device) * xx / _f32(cfg.length, device))
        sy = _sin(_f32(my * math.pi, device) * yy / _f32(cfg.length_y, device))
        u0 = _f32(cfg.amplitude, device) * (sx * sy)
    elif cfg.init == "exp":
        dx0, dy0 = xx - _f32(0.5 * cfg.length, device), yy - _f32(0.5 * cfg.length_y, device)
        r2 = (dx0 * dx0 + dy0 * dy0) / _f32((0.05 * cfg.length) ** 2, device)
        u0 = _f32(cfg.amplitude, device) * _exp(-r2)
    else:
        raise ValueError(f"unknown init {cfg.init!r}")
    u0[0, :] = 0.0
    u0[-1, :] = 0.0
    u0[:, 0] = 0.0
    u0[:, -1] = 0.0
    return u0


@register_stepper("heat2d")
class Heat2DStepper(Stepper):
    """Explicit 5-point stencil with the paper's two-multiplier split."""

    sites = ("heat2d.flux", "heat2d.update")
    site_ops = ("mul", "mul")
    failure_mode = "underflow"
    story = "2D decay drives alpha*lap below E5M10's floor; 2D locality tiles"
    snapshots_default = 8
    fused_packed = True  # the fused kernel decodes and re-encodes a packed carry
    ensemble_hooks = True  # the hooks take members=True: one launch for every member

    def kernels_hold(self, cfg: Heat2DConfig) -> bool:
        """Kernels K5a and K5d take a field of any size: heat2d's cluster,
        or beyond it a cooperative grid (``kernels/pde_steps.py::heat2d_plan``)."""
        return True

    def raw_cells(self, cfg: Heat2DConfig, device):
        """The field's boundary, which every step copies."""
        keep = torch.ones((cfg.nx, cfg.ny), dtype=torch.bool, device=device)
        keep[1:-1, 1:-1] = False
        return keep

    def default_config(self) -> Heat2DConfig:
        return Heat2DConfig()

    def init_state(self, cfg: Heat2DConfig, *, device) -> torch.Tensor:
        return initial_condition_2d(cfg, device=device)

    def step(self, u, cfg: Heat2DConfig, ops: StepOps):
        return heat2d_update(u, cfg.alpha, cfg.dtodx2, ops, self.sites)

    def fused_step(self, u, cfg: Heat2DConfig, prec, steps: int, *, k_floor=None, collect_evidence: bool = False,
                   storage: str = "f32", capture=None, members: bool = False):
        """``steps`` substeps in one launch of kernel K5a (the field as one block)."""
        from repro_torch.kernels.pde_steps import heat2d_sweep

        return heat2d_sweep(
            u, alpha=cfg.alpha, dtodx2=cfg.dtodx2, prec=prec, steps=steps, sites=self.sites,
            k_floor=k_floor, collect_evidence=collect_evidence, storage=storage, capture=capture,
            members=members,
        )

    def mega_step(self, u, cfg: Heat2DConfig, prec, steps: int, every: int, *, tracker=None, storage: str = "f32",
                  capture=None, members: bool = False):
        """The whole horizon in one launch of kernel K5d (``heat2d_mega``)."""
        from repro_torch.kernels.mega import heat2d_mega

        return heat2d_mega(
            u, alpha=cfg.alpha, dtodx2=cfg.dtodx2, prec=prec, steps=steps, every=every, sites=self.sites,
            tracker=tracker, storage=storage, capture=capture, members=members,
        )

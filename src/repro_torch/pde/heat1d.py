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
from typing import Optional, Tuple

import torch

from repro_torch._device import f32_scalar as _f32
from repro_torch.core.policy import PrecisionConfig
from repro_torch.kernels.updates import heat1d_update

from .registry import register_stepper
from .solver import Simulation, StepOps, Stepper

__all__ = ["HeatConfig", "Heat1DStepper", "initial_condition", "heat_step", "simulate"]


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
    fused_packed = True  # the fused kernel decodes and re-encodes a packed carry
    ensemble_hooks = True  # the hooks take members=True: one launch for every member

    def kernels_hold(self, cfg: HeatConfig) -> bool:
        """Kernels K2 and K4 take a rod of any length
        (``kernels/rod.py::rod_plan``)."""
        return True

    def raw_cells(self, cfg: HeatConfig, device):
        """The rod's two ends, which every step copies."""
        keep = torch.zeros(cfg.nx, dtype=torch.bool, device=device)
        keep[0] = keep[-1] = True
        return keep

    def default_config(self) -> HeatConfig:
        return HeatConfig(nx=128)

    def init_state(self, cfg: HeatConfig, *, device) -> torch.Tensor:
        return initial_condition(cfg, device=device)

    def step(self, u, cfg: HeatConfig, ops: StepOps):
        return heat1d_update(u[None, :], cfg.alpha, cfg.dtodx2, ops, self.sites)[0]

    def fused_step(self, u, cfg: HeatConfig, prec, steps: int, *, k_floor=None, collect_evidence: bool = False,
                   storage: str = "f32", capture=None, members: bool = False):
        """``steps`` substeps in one launch of kernel K2 (one row, one block;
        with ``members``, one a member)."""
        from repro_torch.kernels.heat_stencil import heat1d_sweep

        packed = storage == "packed"
        out, *rest = heat1d_sweep(
            u.with_view((1, cfg.nx)) if packed else u[..., None, :], alpha=cfg.alpha, dtodx2=cfg.dtodx2, prec=prec,
            steps=steps, block_rows=1, sites=self.sites, k_floor=k_floor, collect_evidence=collect_evidence,
            storage=storage, capture=capture, members=members,
        )
        return ((out.with_view((cfg.nx,)) if packed else out[..., 0, :]), *rest)

    def mega_step(self, u, cfg: HeatConfig, prec, steps: int, every: int, *, tracker=None, storage: str = "f32",
                  capture=None, members: bool = False):
        """The whole horizon in one launch of kernel K4 (``heat1d_mega``)."""
        from repro_torch.kernels.mega import heat1d_mega

        return heat1d_mega(
            u, alpha=cfg.alpha, dtodx2=cfg.dtodx2, prec=prec, steps=steps, every=every, sites=self.sites,
            tracker=tracker, storage=storage, capture=capture, members=members,
        )


_STEPPER = Heat1DStepper()


def heat_step(u, cfg: HeatConfig, prec: PrecisionConfig):
    """One explicit-FD step (untracked shim over the registered stepper)."""
    return _STEPPER.step(u, cfg, StepOps(prec))


def simulate(cfg: HeatConfig, prec: PrecisionConfig, steps: int, snapshot_every: Optional[int] = None, u0=None, *,
             device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``steps`` updates on ``device`` (None: the card). Returns
    ``(final_state, snapshots)``."""
    res = Simulation("heat1d", cfg, prec, device=device).run(steps, snapshot_every=snapshot_every, state0=u0)
    return res.state, res.snapshots

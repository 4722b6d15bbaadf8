"""2D shallow-water equations, Lax-Wendroff (Richtmyer two-step), paper §2
and Fig. 8.

State U = (h, hu, hv) on a square basin. As in the paper's experiment, only
the x-midpoint momentum-flux equation ``q1*q1/q3 + 0.5*g*q3*q3`` runs on the
policy: three multiplier sites and the tracked flexible divider
(``swe.div``); everything else stays f32. At a 500 m resting depth
``h*h = 2.5e5`` overflows E5M10's 65504, while R2F2 widens its exponent.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import f32_scalar as _f32
from repro_torch.core.fma import fma
from repro_torch.precision import PrecisionConfig

from .registry import register_stepper
from .solver import StepOps, Stepper

__all__ = ["SWEConfig", "SWE2DStepper", "initial_state"]

G = 9.81


@dataclasses.dataclass(frozen=True)
class SWEConfig:
    nx: int = 128
    ny: int = 128
    length: float = 1.0e6  # 1000 km basin
    depth: float = 500.0  # resting depth (m): h*h = 2.5e5 overflows E5M10
    bump: float = 100.0  # initial gaussian surface displacement (m)
    bump_sigma: float = 0.05  # as a fraction of the basin
    cfl: float = 0.4

    @property
    def dx(self) -> float:
        return self.length / self.nx

    @property
    def dy(self) -> float:
        return self.length / self.ny

    @property
    def dt(self) -> float:
        c = (G * (self.depth + self.bump)) ** 0.5
        return self.cfl * min(self.dx, self.dy) / (c * 2.0**0.5)


def initial_state(cfg: SWEConfig, *, device) -> torch.Tensor:
    x = torch.linspace(0.0, 1.0, cfg.nx, dtype=torch.float32, device=device)
    y = torch.linspace(0.0, 1.0, cfg.ny, dtype=torch.float32, device=device)
    xx, yy = torch.meshgrid(x, y, indexing="ij")
    dxx, dyy = xx - 0.5, yy - 0.5
    r2 = dxx * dxx + dyy * dyy
    h = _f32(cfg.depth, device) + _f32(cfg.bump, device) * torch.exp(-r2 / _f32(2 * cfg.bump_sigma**2, device))
    return torch.stack([h, torch.zeros_like(h), torch.zeros_like(h)])


def _momentum_flux(q1, q3, ops: StepOps):
    """The paper's substituted equation, q1*q1/q3 + 0.5*g*q3*q3, with its
    multiplications and its division on the policy's datapath."""
    t1 = ops.mul(q1, q1, "swe.q1q1")
    t2 = ops.div(t1, q3, "swe.div")
    t3 = ops.mul(q3, q3, "swe.q3q3")
    return ops.mul_add(_f32(0.5 * G, q3.device), t3, t2, "swe.gq3")  # t2 + (g/2)*t3


def _flux_F(U, mom):
    h, hu, hv = U[0], U[1], U[2]
    return torch.stack([hu, mom(hu, h), hu * hv / h])


def _flux_G(U, mom):
    h, hu, hv = U[0], U[1], U[2]
    return torch.stack([hv, hu * hv / h, mom(hv, h)])


def _reflect(U):
    """Reflective walls: zero normal momentum at the boundaries, mirror h."""
    h, hu, hv = U[0].clone(), U[1].clone(), U[2].clone()
    h[0, :], h[-1, :] = h[1, :], h[-2, :]
    h[:, 0], h[:, -1] = h[:, 1], h[:, -2]
    hu[0, :], hu[-1, :] = -hu[1, :], -hu[-2, :]
    hu[:, 0], hu[:, -1] = hu[:, 1], hu[:, -2]
    hv[:, 0], hv[:, -1] = -hv[:, 1], -hv[:, -2]
    hv[0, :], hv[-1, :] = hv[1, :], hv[-2, :]
    return torch.stack([h, hu, hv])


_F32 = PrecisionConfig(mode="f32")


def _lw_step(U, cfg: SWEConfig, mom):
    """One Richtmyer two-step update; ``mom(q1, q3)`` computes the
    substituted x-midpoint momentum flux, every other sub-equation is f32."""
    dev = U.device
    f32 = StepOps(_F32)

    def f32_mom(q1, q3):
        return _momentum_flux(q1, q3, f32)

    F = _flux_F(U, f32_mom)
    Gf = _flux_G(U, f32_mom)
    half = _f32(0.5, dev)
    Ux = half * (U[:, 1:, :] + U[:, :-1, :]) - _f32(cfg.dt / (2 * cfg.dx), dev) * (F[:, 1:, :] - F[:, :-1, :])
    Uy = half * (U[:, :, 1:] + U[:, :, :-1]) - _f32(cfg.dt / (2 * cfg.dy), dev) * (Gf[:, :, 1:] - Gf[:, :, :-1])

    Fx = _flux_F(Ux, mom)  # the paper's Ux_mx equation
    Gy = _flux_G(Uy, f32_mom)

    # U - cx*dFx - cy*dGy, each product fused into its subtraction as the
    # compiled reference computes it (the half steps' fused form rounds the
    # same as written, since 0.5*sum is exact)
    interior = fma(-_f32(cfg.dt / cfg.dx, dev), Fx[:, 1:, 1:-1] - Fx[:, :-1, 1:-1], U[:, 1:-1, 1:-1])
    interior = fma(-_f32(cfg.dt / cfg.dy, dev), Gy[:, 1:-1, 1:] - Gy[:, 1:-1, :-1], interior)
    U = U.clone()
    U[:, 1:-1, 1:-1] = interior
    return _reflect(U)


@register_stepper("swe2d")
class SWE2DStepper(Stepper):
    """One Lax-Wendroff update with the momentum-flux equation on the policy."""

    sites = ("swe.q1q1", "swe.q3q3", "swe.gq3", "swe.div")
    site_ops = ("mul", "mul", "mul", "div")
    failure_mode = "overflow"
    story = "h*h = 2.5e5 at a realistic basin depth overflows E5M10's 65504"
    snapshots_default = 4

    def default_config(self) -> SWEConfig:
        return SWEConfig()

    def init_state(self, cfg: SWEConfig, *, device):
        return initial_state(cfg, device=device)

    def step(self, U, cfg: SWEConfig, ops: StepOps):
        return _lw_step(U, cfg, lambda q1, q3: _momentum_flux(q1, q3, ops))

    def fused_step(self, U, cfg: SWEConfig, prec, steps: int, *, k_floor=None, collect_evidence: bool = False):
        """A fused chunk: each substep's momentum flux is one launch of
        kernel K3; the rest of the Lax-Wendroff step is f32 PyTorch, as the
        reference leaves it to XLA."""
        from repro_torch.kernels.swe_flux import swe_flux_fused

        evs = []

        def mom(q1, q3):
            flux, ev = swe_flux_fused(
                q1, q3, prec=prec, sites=self.sites, site_ops=self.site_ops,
                k_floor=k_floor, collect_evidence=collect_evidence,
            )
            evs.append(ev)
            return flux

        for _ in range(steps):
            U = _lw_step(U, cfg, mom)
        return U, (torch.cat(evs) if collect_evidence else None)

    def observables(self, U, cfg: SWEConfig):
        return U[0]  # snapshot h only

    def metric_offset(self, cfg: SWEConfig) -> float:
        return cfg.depth

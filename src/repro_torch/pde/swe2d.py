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
from typing import Optional, Tuple

import torch

from repro_torch._device import f32_scalar as _f32
from repro_torch.core.fma import fma
from repro_torch.core.ftz import card_flush
from repro_torch.precision import PrecisionConfig

from .registry import register_stepper
from .solver import Simulation, StepOps, Stepper

__all__ = ["SWEConfig", "SWE2DStepper", "initial_state", "swe_step", "simulate"]

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


def _f32_mom(q1, q3):
    return _momentum_flux(q1, q3, StepOps(_F32))


def _lw_predict(U, cfg: SWEConfig):
    """The f32 half of a Richtmyer two-step update before the policy's
    momentum flux: the x and y half steps ``Ux`` and the flux ``Gy`` of
    ``Uy``."""
    dev = U.device
    F = _flux_F(U, _f32_mom)
    Gf = _flux_G(U, _f32_mom)
    half = _f32(0.5, dev)
    Ux = half * (U[:, 1:, :] + U[:, :-1, :]) - _f32(cfg.dt / (2 * cfg.dx), dev) * (F[:, 1:, :] - F[:, :-1, :])
    Uy = half * (U[:, :, 1:] + U[:, :, :-1]) - _f32(cfg.dt / (2 * cfg.dy), dev) * (Gf[:, :, 1:] - Gf[:, :, :-1])
    return Ux, _flux_G(Uy, _f32_mom)


def _lw_step(U, cfg: SWEConfig, mom):
    """One Richtmyer two-step update; ``mom(q1, q3)`` computes the
    substituted x-midpoint momentum flux, every other sub-equation is f32."""
    Ux, Gy = _lw_predict(U, cfg)
    return _lw_correct(U, Ux, Gy, mom(Ux[1], Ux[0]), cfg)  # the paper's Ux_mx equation


def _lw_correct(U, Ux, Gy, flux, cfg: SWEConfig):
    """The rest of the update from the policy's momentum flux of ``Ux``."""
    dev = U.device
    Fx = torch.stack([Ux[1], flux, Ux[1] * Ux[2] / Ux[0]])

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
    ensemble_hooks = True  # the hooks take members=True: one launch for every member

    def kernels_hold(self, cfg: SWEConfig) -> bool:
        """K3 tiles any field; the megakernel's own limit is ``mega_supported``."""
        return True

    def default_config(self) -> SWEConfig:
        return SWEConfig()

    def init_state(self, cfg: SWEConfig, *, device):
        return initial_state(cfg, device=device)

    def step(self, U, cfg: SWEConfig, ops: StepOps):
        return _lw_step(U, cfg, lambda q1, q3: _momentum_flux(q1, q3, ops))

    def momentum_flux(self, q1, q3, prec, **kw):
        """One substep's momentum flux of the fused chunk, on kernel K3
        (``swe_flux_fused``'s result; ``kw`` its floor, evidence, capture and
        member arguments)."""
        from repro_torch.kernels.swe_flux import swe_flux_fused

        return swe_flux_fused(q1, q3, prec=prec, sites=self.sites, site_ops=self.site_ops, **kw)

    def fused_step(self, U, cfg: SWEConfig, prec, steps: int, *, k_floor=None, collect_evidence: bool = False,
                   capture=None, members: bool = False):
        """A fused chunk: each substep's momentum flux is one launch of
        kernel K3; the rest of the Lax-Wendroff step is f32 PyTorch, as the
        reference leaves it to XLA. With ``capture`` K3's counts are summed
        over the substeps and returned last. With ``members`` the state is
        ``(members, 3, nx, ny)``: the PyTorch part runs member by member, and
        each substep's K3 launch takes every member's flux at once."""
        evs, counts = [], []

        def mom(q1, q3):
            flux, ev, *cnt = self.momentum_flux(
                q1, q3, prec, k_floor=k_floor, collect_evidence=collect_evidence, capture=capture, members=members,
            )
            evs.append(ev)
            counts.extend(cnt)
            return flux

        with card_flush(U.device):  # the LW step's PyTorch arithmetic on the card
            for _ in range(steps):
                if members:
                    parts = [_lw_predict(u, cfg) for u in U]
                    flux = mom(torch.stack([ux[1] for ux, _ in parts]), torch.stack([ux[0] for ux, _ in parts]))
                    U = torch.stack([_lw_correct(u, ux, gy, f, cfg) for u, (ux, gy), f in zip(U, parts, flux)])
                else:
                    U = _lw_step(U, cfg, mom)
        lead = U.shape[:1] if members else ()
        ev = torch.cat(evs, dim=len(lead)) if (collect_evidence or capture is not None) and evs else None
        if ev is None and (collect_evidence or capture is not None):
            ev = torch.zeros(lead + (0, len(self.sites), 2), device=U.device)
        if capture is None:
            return U, ev
        if counts:
            total = torch.stack(counts).sum(dim=0, dtype=torch.int32)
        else:
            total = torch.zeros(lead + (len(self.sites), 2, capture.n_bins), dtype=torch.int32, device=U.device)
        return U, ev, total

    def mega_supported(self, cfg: SWEConfig, prec) -> bool:
        """The megakernel takes the momentum-flux fields ``(nx-1, ny)`` as one
        block, so it equals the fused plane only where K3's grid is one tile."""
        return (cfg.nx - 1) <= prec.kernel_blocks[0] and cfg.ny <= prec.kernel_blocks[1]

    def mega_step(self, U, cfg: SWEConfig, prec, steps: int, every: int, *, tracker=None, storage: str = "f32",
                  capture=None, members: bool = False):
        """The whole horizon, the entire Lax-Wendroff update included, in one
        launch of kernel K4 (``swe2d_mega``)."""
        from repro_torch.kernels.mega import swe2d_mega

        return swe2d_mega(
            U, cfg=cfg, prec=prec, steps=steps, every=every, sites=self.sites, site_ops=self.site_ops,
            tracker=tracker, storage=storage, capture=capture, members=members,
        )

    def observables(self, U, cfg: SWEConfig):
        return U[0]  # snapshot h only

    def metric_offset(self, cfg: SWEConfig) -> float:
        return cfg.depth


_STEPPER = SWE2DStepper()


def swe_step(U, cfg: SWEConfig, prec: PrecisionConfig):
    """One Lax-Wendroff update (untracked shim over the registered stepper)."""
    return _STEPPER.step(U, cfg, StepOps(prec))


def simulate(cfg: SWEConfig, prec: PrecisionConfig, steps: int, snapshot_every: Optional[int] = None, U0=None, *,
             device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``steps`` updates on ``device`` (None: the card). Returns
    ``(final_state, snapshots)`` (snapshots of h)."""
    res = Simulation("swe2d", cfg, prec, device=device).run(steps, snapshot_every=snapshot_every, state0=U0)
    return res.state, res.snapshots

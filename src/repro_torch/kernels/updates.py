"""The substep updates of the four stencil steppers, on a ``StepOps`` or a
fused body's ``FusedOps``: the steppers' ``step`` (``pde/``) and the plain
fused bodies (``heat_stencil.py``, ``pde_steps.py``) both call them, so the
fused plane equals the reference plane wherever one split block covers the
field. Each rounds where the compiled reference rounds (ROADMAP queue 3).
"""

from __future__ import annotations

import torch

from repro_torch._device import f32_scalar as _f32
from repro_torch.core.fma import fma

__all__ = ["heat1d_update", "heat2d_update", "advection1d_update", "burgers1d_update"]


def heat1d_update(u, alpha, dtodx2, ops, sites):
    """One explicit-FD substep of ``(rows, nx)`` rods on ``ops``, the ends
    pinned.

    In the f32 mode the compiled reference folds the two constant products,
    ``(lap * alpha) * dtodx2`` into ``lap * (alpha * dtodx2)`` with the
    constant rounded once to f32, and fuses the add: the interior becomes
    ``fma(lap, alpha * dtodx2, u)``. The other modes round their products on
    the policy, so nothing folds or fuses there."""
    flux_site, update_site = sites
    dev = u.device
    lap = u[:, :-2] - 2.0 * u[:, 1:-1] + u[:, 2:]
    flux = ops.mul(_f32(alpha, dev), lap, flux_site)
    upd = ops.mul(flux, _f32(dtodx2, dev), update_site)
    if ops.prec.mode == "f32":
        interior = fma(lap, _f32(alpha, dev) * _f32(dtodx2, dev), u[:, 1:-1])
    else:
        interior = u[:, 1:-1] + upd
    return torch.cat([u[:, :1], interior, u[:, -1:]], dim=1)


def heat2d_update(u, alpha, dtodx2, ops, sites):
    """One 5-point substep of an ``(nx, ny)`` field on ``ops``: the
    laplacian adds in f32, the two products run on the policy, the boundary
    stays pinned. The f32 mode folds and fuses as :func:`heat1d_update`
    does: the interior becomes ``fma(lap, alpha * dtodx2, u)``."""
    flux_site, update_site = sites
    dev = u.device
    lap = u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:] - 4.0 * u[1:-1, 1:-1]
    flux = ops.mul(_f32(alpha, dev), lap, flux_site)
    upd = ops.mul(flux, _f32(dtodx2, dev), update_site)
    out = u.clone()
    if ops.prec.mode == "f32":
        out[1:-1, 1:-1] = fma(lap, _f32(alpha, dev) * _f32(dtodx2, dev), u[1:-1, 1:-1])
    else:
        out[1:-1, 1:-1] = u[1:-1, 1:-1] + upd
    return out


def advection1d_update(u, speed, dtodx, ops, sites):
    """One periodic upwind substep on ``ops``, rounded where the compiled
    reference rounds: the update product is fused into its subtraction
    (``ops.mul_add``, one rounding for the f32 and bf16 families), and in
    the f32 mode the flux product is also fused into the upwind difference,
    ``fma(speed, u, -f[i-1])``. A bf16 product of two bf16-rounded operands
    is exact in f32, so neither fusion can change a bit there."""
    flux_site, update_site = sites
    speed = _f32(speed, u.device)
    f = ops.mul(speed, u, flux_site)
    f_prev = torch.roll(f, 1, dims=-1)
    df = fma(speed, u, -f_prev) if ops.prec.mode == "f32" else f - f_prev  # upwind difference in f32
    return ops.mul_add(-_f32(dtodx, u.device), df, u, update_site)  # u - dtodx*df


def burgers1d_update(u, dt, dx, ops, sites):
    """One periodic Lax-Friedrichs substep on ``ops``: ``u*u`` and ``0.5*uu``
    on the policy, the average and the difference in f32, and the update
    ``u_avg - (dt/(2dx))*df`` rounded twice, as the compiled reference
    computes it (its product is not fused into the subtraction)."""
    uu_site, flux_site = sites
    uu = ops.mul(u, u, uu_site)  # the nonlinear flux product
    f = ops.mul(_f32(0.5, u.device), uu, flux_site)  # f = u^2/2
    u_avg = 0.5 * (torch.roll(u, -1, dims=-1) + torch.roll(u, 1, dims=-1))
    df = torch.roll(f, -1, dims=-1) - torch.roll(f, 1, dims=-1)
    return u_avg - _f32(dt / (2.0 * dx), u.device) * df

"""Kernels K5a-c: the fused whole-step sweeps of heat2d, advection1d and
burgers1d (``heat2d_sweep``, ``advection1d_sweep``, ``burgers1d_sweep``).

Each sweep advances its workload ``steps`` substeps in one launch, every
policy product at one split for the whole field, and returns the per-site
evidence for the adjust unit. The bodies are the steppers' own updates
(``kernels/updates.py``), so the fused plane equals the reference plane
wherever one split block covers the field, which it always does here: the
2-D field rides as one ``(1, nx*ny)`` leaf, each periodic rod as one
``(1, nx)`` leaf.

Replaces the TPU kernel ``repro/kernels/fused.py::fused_sweep``
(``_sweep_kernel``) running ``repro/kernels/pde_steps.py::_heat2d_body``,
``_advection1d_body`` and ``_burgers1d_body``. The CUDA kernel is one
template, ``csrc/pde_steps.cu::fused_sweep_kernel``, instantiated for three
device bodies: one CTA holds the whole field in shared memory for the
chunk, with the stencil's neighbours (and the periodic wrap) read from
shared memory behind a barrier. At the main path's sizes (64x64 and 256
cells) a substep moves no bytes from device memory and does a few thousand
f32 operations: the kernels are bound by the latency of the serial substep
chain and its two or three block reductions, not by bytes or operations.
The field in shared memory for the whole chunk is what the design does
about it; a field larger than one CTA's shared memory is refused
(:data:`SMEM_LIMIT`), where ``repro`` on the TPU has no such limit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import SMEM_LIMIT
from repro_torch.kernels.fused import fused_sweep
from repro_torch.kernels.updates import advection1d_update, burgers1d_update, heat2d_update
from repro_torch.precision.fusion import fused_family

__all__ = [
    "HEAT2D_SITES",
    "ADVECTION1D_SITES",
    "BURGERS1D_SITES",
    "HEAT2D_SWEEP",
    "ADVECTION1D_SWEEP",
    "BURGERS1D_SWEEP",
    "HEAT2D_MEGA",
    "ADVECTION1D_MEGA",
    "BURGERS1D_MEGA",
    "BODIES",
    "SMEM_LIMIT",
    "check_field",
    "heat2d_sweep",
    "heat2d_sweep_plain",
    "advection1d_sweep",
    "advection1d_sweep_plain",
    "burgers1d_sweep",
    "burgers1d_sweep_plain",
]

HEAT2D_SITES = ("heat2d.flux", "heat2d.update")
ADVECTION1D_SITES = ("adv.flux", "adv.update")
BURGERS1D_SITES = ("burgers.uu", "burgers.flux")
#: launches of each CUDA kernel and runs of its plain version
HEAT2D_SWEEP = _cuda.KernelCounter("heat2d_sweep")
ADVECTION1D_SWEEP = _cuda.KernelCounter("advection1d_sweep")
BURGERS1D_SWEEP = _cuda.KernelCounter("burgers1d_sweep")
HEAT2D_MEGA = _cuda.KernelCounter("heat2d_mega")
ADVECTION1D_MEGA = _cuda.KernelCounter("advection1d_mega")
BURGERS1D_MEGA = _cuda.KernelCounter("burgers1d_mega")


class Body(NamedTuple):
    """What the launchers know of one device body of csrc/pde_steps.cu."""

    smem_rows: int  # f32 rows of the field in shared memory (Body::kRows)
    sweep: _cuda.KernelCounter  # its fused sweep, C entry r2f2_<body>_sweep
    mega: _cuda.KernelCounter  # its megakernel (kernels/mega.py), C entry r2f2_<body>_mega


#: per body: the state and a scratch row, and for Lax-Friedrichs a second
#: state row (its update reads both neighbours of the old state)
BODIES = {
    "heat2d": Body(2, HEAT2D_SWEEP, HEAT2D_MEGA),
    "advection1d": Body(2, ADVECTION1D_SWEEP, ADVECTION1D_MEGA),
    "burgers1d": Body(3, BURGERS1D_SWEEP, BURGERS1D_MEGA),
}


def check_field(body: str, nx: int, ny: int) -> None:
    """Refuse a field a K5 kernel does not take: a 2-D field needs an
    interior (nx, ny >= 3), and the field and its scratch rows must fit one
    CTA's shared memory, :data:`SMEM_LIMIT` (there is no multi-CTA path)."""
    if body == "heat2d" and min(nx, ny) < 3:
        raise ValueError(f"heat2d needs nx, ny >= 3; got ({nx}, {ny})")
    n = nx * ny
    smem = BODIES[body].smem_rows * n * 4
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{body} holds its {n}-cell field in one CTA's shared memory: {smem} B needed, "
            f"the kernel takes at most SMEM_LIMIT = {SMEM_LIMIT} B"
        )


def _heat2d_body(nx, ny, alpha, dtodx2, sites):
    """One 5-point substep of the field flattened to ``(1, nx*ny)``."""

    def body(state, ops):
        (uf,) = state
        return (heat2d_update(uf.reshape(nx, ny), alpha, dtodx2, ops, sites).reshape(1, nx * ny),)

    return body


def _advection1d_body(speed, dtodx, sites):
    """One periodic upwind substep of a ``(1, nx)`` rod."""

    def body(state, ops):
        (u,) = state
        return (advection1d_update(u, speed, dtodx, ops, sites),)

    return body


def _burgers1d_body(dt, dx, sites):
    """One periodic Lax-Friedrichs substep of a ``(1, nx)`` rod."""

    def body(state, ops):
        (u,) = state
        return (burgers1d_update(u, dt, dx, ops, sites),)

    return body


def _launch(leaves, *, br, bw, gi, gj, k_floor, collect, body, nx, ny, consts, prec, steps, n_sites):
    """Launch one K5 fused kernel on the ``(1, nx*ny)`` leaf, one CTA."""
    (u,) = leaves
    u = u.contiguous()
    if n_sites != 2 or (gi, gj) != (1, 1) or u.shape != (1, nx * ny):
        raise ValueError(f"{body}_sweep takes one (1, {nx * ny}) block and two sites; got {tuple(u.shape)}, {n_sites} sites")
    check_field(body, nx, ny)
    out = torch.empty_like(u)
    ev = torch.empty((1, 1, steps, n_sites, 2), dtype=torch.float32, device=u.device) if collect else None
    lib = _cuda.library()
    with torch.cuda.device(u.device):
        err = getattr(lib, f"r2f2_{body}_sweep")(
            _cuda.ptr(u), _cuda.ptr(out), _cuda.ptr(ev), _cuda.ptr(k_floor), nx, ny, steps, *consts,
            *_cuda.policy_args(prec, fused_family(prec.mode)), _cuda.stream_of(u),
        )
    _cuda.check(err, f"{body}_sweep")
    BODIES[body].sweep.launches += 1
    return [out], ev


def _sweep(body, fn, u0, nx, ny, consts, *, prec, steps, sites, k_floor, collect_evidence, capture, storage, plain):
    kernel = functools.partial(_launch, body=body, nx=nx, ny=ny, consts=consts, prec=prec, steps=steps, n_sites=len(sites))
    (out,), ev = fused_sweep(
        fn, (u0.reshape(1, nx * ny),), prec=prec, sites=sites, steps=steps, block=(1, nx * ny),
        k_floor=k_floor, collect_evidence=collect_evidence, kernel=kernel, counter=BODIES[body].sweep,
        plain=plain, capture=capture, storage=storage,
    )
    return out.reshape(u0.shape), ev


def _heat2d(u0, *, alpha, dtodx2, prec, steps, sites, k_floor, collect_evidence, capture, storage, plain):
    nx, ny = u0.shape
    alpha, dtodx2 = float(alpha), float(dtodx2)
    return _sweep(
        "heat2d", _heat2d_body(nx, ny, alpha, dtodx2, sites), u0, nx, ny, (alpha, dtodx2), prec=prec, steps=steps,
        sites=sites, k_floor=k_floor, collect_evidence=collect_evidence, capture=capture, storage=storage, plain=plain,
    )


def heat2d_sweep(
    u0, *, alpha, dtodx2, prec, steps=1, sites=HEAT2D_SITES, k_floor=None, collect_evidence=False,
    capture=None, storage="f32",
):
    """Advance an ``(nx, ny)`` field ``steps`` 5-point substeps in one
    launch. Returns ``(u, evidence)``; evidence is ``(steps, 2, 2)`` or None."""
    return _heat2d(
        u0, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, storage=storage, plain=False,
    )


def heat2d_sweep_plain(u0, *, alpha, dtodx2, prec, steps=1, sites=HEAT2D_SITES, k_floor=None, collect_evidence=False):
    """The plain PyTorch version of :func:`heat2d_sweep`, on any device."""
    return _heat2d(
        u0, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=None, storage="f32", plain=True,
    )


def _advection1d(u0, *, speed, dtodx, prec, steps, sites, k_floor, collect_evidence, capture, storage, plain):
    speed, dtodx = float(speed), float(dtodx)
    return _sweep(
        "advection1d", _advection1d_body(speed, dtodx, sites), u0, 1, u0.shape[-1], (speed, dtodx), prec=prec,
        steps=steps, sites=sites, k_floor=k_floor, collect_evidence=collect_evidence, capture=capture,
        storage=storage, plain=plain,
    )


def advection1d_sweep(
    u0, *, speed, dtodx, prec, steps=1, sites=ADVECTION1D_SITES, k_floor=None, collect_evidence=False,
    capture=None, storage="f32",
):
    """Advance an ``(nx,)`` periodic profile ``steps`` upwind substeps in one
    launch. Returns ``(u, evidence)``; evidence is ``(steps, 2, 2)`` or None."""
    return _advection1d(
        u0, speed=speed, dtodx=dtodx, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, storage=storage, plain=False,
    )


def advection1d_sweep_plain(
    u0, *, speed, dtodx, prec, steps=1, sites=ADVECTION1D_SITES, k_floor=None, collect_evidence=False,
):
    """The plain PyTorch version of :func:`advection1d_sweep`, on any device."""
    return _advection1d(
        u0, speed=speed, dtodx=dtodx, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=None, storage="f32", plain=True,
    )


def _burgers1d(u0, *, dt, dx, prec, steps, sites, k_floor, collect_evidence, capture, storage, plain):
    dt, dx = float(dt), float(dx)
    return _sweep(
        "burgers1d", _burgers1d_body(dt, dx, sites), u0, 1, u0.shape[-1], (dt / (2.0 * dx), 0.5), prec=prec,
        steps=steps, sites=sites, k_floor=k_floor, collect_evidence=collect_evidence, capture=capture,
        storage=storage, plain=plain,
    )


def burgers1d_sweep(
    u0, *, dt, dx, prec, steps=1, sites=BURGERS1D_SITES, k_floor=None, collect_evidence=False,
    capture=None, storage="f32",
):
    """Advance an ``(nx,)`` periodic wave ``steps`` Lax-Friedrichs substeps in
    one launch. Returns ``(u, evidence)``; evidence is ``(steps, 2, 2)`` or None."""
    return _burgers1d(
        u0, dt=dt, dx=dx, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, storage=storage, plain=False,
    )


def burgers1d_sweep_plain(u0, *, dt, dx, prec, steps=1, sites=BURGERS1D_SITES, k_floor=None, collect_evidence=False):
    """The plain PyTorch version of :func:`burgers1d_sweep`, on any device."""
    return _burgers1d(
        u0, dt=dt, dx=dx, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=None, storage="f32", plain=True,
    )

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
``_advection1d_body`` and ``_burgers1d_body``. At the main path's sizes
(64x64 and 256 cells) a substep moves no bytes from device memory and does
a few thousand f32 operations: the kernels are bound by the latency of the
serial substep chain and its field-wide maxima, not by bytes or operations.

Every field size runs on the card, as on ``repro``. :func:`heat2d_plan`
gives heat2d one thread-block cluster of up to 16 CTAs in row bands
(``csrc/pde_steps.cu::heat2d_sweep_kernel``, and the megakernel K5d;
:func:`heat2d_cluster_plan`) where its CTAs hold the field: each CTA holds
its band and two halo rows in shared memory and each thread its cells in
registers; the substep's two maxima and the halo exchange go through
distributed shared memory, three cluster barriers a substep. 16 CTAs of 512
threads hold up to 16 interior cells a thread: at most
:data:`HEAT2D_MAX_CTA_CELLS` interior cells a CTA, so 358x358 is the largest
square field there. A larger field runs on the grid shape of ``csrc/rod.cuh``
(``rod.rod_plan``), as the periodic rods do on its warp or grid shape: the
1-D bodies are rod bodies, each a substep of two barriers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.fused import fused_sweep
from repro_torch.kernels.rod import RodPlan, launch_rod, rod_plan, sweep_storage
from repro_torch.kernels.updates import advection1d_update, burgers1d_update, heat2d_update
from repro_torch.pack.packed import PackedArray
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
    "HEAT2D_CLUSTERS",
    "HEAT2D_CTA_CELLS",
    "HEAT2D_MAX_CTA_CELLS",
    "ClusterPlan",
    "heat2d_cluster_plan",
    "heat2d_plan",
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
    """The counters of one K5 body's two kernels."""

    sweep: _cuda.KernelCounter  # its fused sweep
    mega: _cuda.KernelCounter  # its megakernel (kernels/mega.py)


BODIES = {
    "heat2d": Body(HEAT2D_SWEEP, HEAT2D_MEGA),
    "advection1d": Body(ADVECTION1D_SWEEP, ADVECTION1D_MEGA),
    "burgers1d": Body(BURGERS1D_SWEEP, BURGERS1D_MEGA),
}

#: the cluster sizes heat2d's kernels are measured at (chip_smoke.py phase 5)
HEAT2D_CLUSTERS = (1, 2, 4, 8, 16)
#: interior cells one CTA of heat2d's cluster holds: 512 threads, 16 cells
#: each in registers (csrc/pde_steps.cu::kHeat2DMaxThreads, kHeat2DMaxPerThread)
HEAT2D_MAX_CTA_CELLS = 512 * 16
#: the plan's target of interior cells per CTA. At the main path's 64x64 it
#: picks C = 16 (248 cells a CTA, one a thread), the fastest of
#: HEAT2D_CLUSTERS there in chip_smoke.py phase 5 (PERF.md section 6, "Cluster size")
HEAT2D_CTA_CELLS = 256


class ClusterPlan(NamedTuple):
    """heat2d's thread-block cluster: ``ctas`` CTAs of ``band`` interior rows."""

    ctas: int
    band: int


def heat2d_cluster_plan(nx: int, ny: int, cluster: Optional[int] = None) -> ClusterPlan:
    """``(C, band)``: the thread-block cluster that runs an ``(nx, ny)``
    heat2d field, C CTAs each owning ``band`` of its ``nx - 2`` interior
    rows (the last CTA the rest, every CTA at least one). By default C is
    the smallest of :data:`HEAT2D_CLUSTERS` whose CTAs hold at most
    :data:`HEAT2D_CTA_CELLS` interior cells, else 16; ``cluster`` asks for
    a size instead (fewer CTAs where the rows run out). Raises ValueError
    where the CTAs cannot hold the field (:data:`HEAT2D_MAX_CTA_CELLS`
    interior cells a CTA; their shared memory, the band and two halo rows,
    stays under 100 KB then): :func:`heat2d_plan` gives such a field the
    grid."""
    if min(nx, ny) < 3:
        raise ValueError(f"heat2d needs nx, ny >= 3; got ({nx}, {ny})")
    ni, mi = nx - 2, ny - 2
    if cluster is None:
        cluster = next((c for c in HEAT2D_CLUSTERS if -(-ni // c) * mi <= HEAT2D_CTA_CELLS), HEAT2D_CLUSTERS[-1])
    if not 1 <= cluster <= HEAT2D_CLUSTERS[-1]:
        raise ValueError(f"a heat2d cluster has 1 to {HEAT2D_CLUSTERS[-1]} CTAs; got {cluster}")
    band = -(-ni // min(cluster, ni))
    if band * mi > HEAT2D_MAX_CTA_CELLS:
        raise ValueError(
            f"heat2d's cluster of {cluster} CTAs cannot hold a ({nx}, {ny}) field: {band} x {mi} interior cells a CTA, "
            f"the kernel takes at most {HEAT2D_MAX_CTA_CELLS}"
        )
    return ClusterPlan(-(-ni // band), band)


def heat2d_plan(nx: int, ny: int, n_sms: int = 132, *, cluster: Optional[int] = None) -> Union[ClusterPlan, RodPlan]:
    """How K5a and K5d run an ``(nx, ny)`` heat2d field: the thread-block
    cluster of :func:`heat2d_cluster_plan` where its CTAs hold the field (or
    the ``cluster`` size asked for), else the grid shape of ``csrc/rod.cuh``
    over the flattened field (``rod.rod_plan``; such a field is far beyond
    its warp shape). Any ``nx, ny >= 3``."""
    if cluster is not None or (nx - 2) * (ny - 2) <= HEAT2D_CLUSTERS[-1] * HEAT2D_MAX_CTA_CELLS:
        try:
            return heat2d_cluster_plan(nx, ny, cluster)
        except ValueError:
            if cluster is not None or min(nx, ny) < 3:
                raise
    return rod_plan(nx, ny, n_sms)  # a field the cluster cannot hold is far beyond the warp shape's cells


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


def k5_plan(body, nx, ny, device, cluster=None, plan=None):
    """The launch shape of a K5 kernel on its field: heat2d's cluster or grid
    (:func:`heat2d_plan`), a periodic rod's warp or grid shape
    (``rod.rod_plan``); ``cluster`` or ``plan`` forces one."""
    if plan is not None:
        return plan
    if body == "heat2d":
        return heat2d_plan(nx, ny, _cuda.sm_count(device), cluster=cluster)
    return rod_plan(1, nx * ny, _cuda.sm_count(device), periodic=True)


def launch_k5(body, u, out, plan, *, nx, ny, consts, prec, steps, storage=_cuda.StorageIO(), capture=_cuda.CaptureIO(),
              **kw):
    """Launch a K5 kernel on the ``(members, 1, nx*ny)`` leaves ``u`` into
    ``out``, one ensemble member each: heat2d's cluster (``csrc/pde_steps.cu``,
    its own entries; one cluster a member) or a rod shape (``csrc/rod.cuh``,
    :func:`rod.launch_rod` with its keywords). ``u`` or ``out`` is None
    where ``storage`` gives a packed input or output; ``capture`` is the
    histogram buffer. Returns the CUDA error code."""
    field = u if u is not None else storage.pay_in
    members = field.shape[0]
    if isinstance(plan, RodPlan):
        shape = (members, nx, ny) if body == "heat2d" else (members, 1, nx * ny)

        def view(t):
            return None if t is None else t.view(shape)

        storage = storage._replace(pay_in=view(storage.pay_in), pay_out=view(storage.pay_out))
        return launch_rod(body, view(u), view(out), plan, br=shape[1], steps=steps, consts=consts, prec=prec,
                          storage=storage, capture=capture, **kw)
    lib = _cuda.library()
    policy = _cuda.policy_args(prec, fused_family(prec.mode))
    ptrs = [_cuda.ptr(kw.get(name)) for name in ("snaps", "ev")]
    with torch.cuda.device(field.device):
        if kw.get("every", 0) == 0:  # the fused sweep
            return lib.r2f2_heat2d_sweep(
                _cuda.ptr(u), _cuda.ptr(out), ptrs[1], _cuda.ptr(kw.get("k")), members, nx, ny, steps, *consts, *plan,
                *policy, *storage.args(), *capture.args(), _cuda.stream_of(field),
            )
        hi, lo, ov, sh = kw["tracker_rows"]
        return lib.r2f2_heat2d_mega(
            _cuda.ptr(u), _cuda.ptr(out), *ptrs, _cuda.ptr(kw.get("k")), *map(_cuda.ptr, (hi, lo, ov, sh)),
            _cuda.ptr(kw.get("table")), int(kw["evolve"]), members, nx, ny, steps, kw["every"], *consts, *plan,
            *kw["law"], *policy, *storage.args(), *capture.args(), _cuda.stream_of(field),
        )


def _launch(leaves, *, br, bw, gi, gj, k_floor, collect, body, nx, ny, consts, prec, steps, n_sites, cluster, plan,
            k_in=None, capture=None, extent=None):
    """Launch one K5 fused kernel on the ``(members, 1, nx*ny)`` leaf
    (:func:`k5_plan`'s shape, a member each); with ``k_in`` the leaf and the
    output are payloads, with ``capture`` the counts come back last (the
    leaf is one block: no pad)."""
    (u,) = leaves
    u = u.contiguous()
    members = u.shape[0]
    if n_sites != 2 or (gi, gj) != (1, 1) or u.shape[1:] != (1, nx * ny):
        raise ValueError(f"{body}_sweep takes one (1, {nx * ny}) block and two sites; got {tuple(u.shape)}, {n_sites} sites")
    plan = k5_plan(body, nx, ny, u.device, cluster, plan)
    ev = torch.empty((members, 1, 1, steps, n_sites, 2), dtype=torch.float32, device=u.device) if collect else None
    u_in, u_out, out, storage = sweep_storage(u, k_in)
    cap = _cuda.capture_io(capture, 1, n_sites, u.device, members=members)
    err = launch_k5(body, u_in, u_out, plan, nx=nx, ny=ny, consts=consts, prec=prec, steps=steps, ev=ev, k=k_floor,
                    storage=storage, capture=cap)
    _cuda.check(err, f"{body}_sweep")
    BODIES[body].sweep.count("f32" if k_in is None else "packed", capture=capture is not None)
    res = [[out], ev] if k_in is None else [[out], ev, [storage.k_out]]
    return tuple(res) if capture is None else (*res, cap.out[:, 0])


def _sweep(body, fn, u0, nx, ny, consts, *, prec, steps, sites, k_floor, collect_evidence, capture, storage, plain,
           cluster=None, plan=None, members=False):
    kernel = functools.partial(
        _launch, body=body, nx=nx, ny=ny, consts=consts, prec=prec, steps=steps, n_sites=len(sites), cluster=cluster,
        plan=plan,
    )
    packed = isinstance(u0, PackedArray)
    lead = (u0.payload.shape[0],) if packed and members else (u0.shape[0],) if members else ()
    view = lead + (1, nx * ny)
    (out,), *rest = fused_sweep(
        fn, (u0.with_view((1, nx * ny)) if packed else u0.reshape(view),), prec=prec, sites=sites, steps=steps,
        block=(1, nx * ny), k_floor=k_floor, collect_evidence=collect_evidence, kernel=kernel,
        counter=BODIES[body].sweep, plain=plain, capture=capture, storage=storage, members=members,
    )
    return ((out.with_view(u0.shape) if packed else out.reshape(u0.shape)), *rest)


def _heat2d(u0, *, alpha, dtodx2, prec, steps, sites, k_floor, collect_evidence, capture, storage, plain, cluster=None,
            plan=None, members=False):
    nx, ny = u0.shape[-2:]
    alpha, dtodx2 = float(alpha), float(dtodx2)
    return _sweep(
        "heat2d", _heat2d_body(nx, ny, alpha, dtodx2, sites), u0, nx, ny, (alpha, dtodx2), prec=prec, steps=steps,
        sites=sites, k_floor=k_floor, collect_evidence=collect_evidence, capture=capture, storage=storage, plain=plain,
        cluster=cluster, plan=plan, members=members,
    )


def heat2d_sweep(
    u0, *, alpha, dtodx2, prec, steps=1, sites=HEAT2D_SITES, k_floor=None, collect_evidence=False,
    capture=None, storage="f32", members=False, _cluster=None, _plan=None,
):
    """Advance an ``(nx, ny)`` field ``steps`` 5-point substeps in one
    launch. Returns ``(u, evidence)``; evidence is ``(steps, 2, 2)`` or None,
    and with ``capture`` the ``(2, 2, n_bins)`` operand counts last.
    ``_cluster`` asks the kernel for a cluster size other than the plan's,
    ``_plan`` for a grid shape (``rod.RodPlan``): the chip checks and
    timings go through each. ``members=True`` takes ``(members, nx, ny)``
    ensemble members (one cluster each), with ``(members, 2)`` floors, in
    one launch; the evidence and counts then lead with the member."""
    return _heat2d(
        u0, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, storage=storage, plain=False, cluster=_cluster, plan=_plan,
        members=members,
    )


def heat2d_sweep_plain(u0, *, alpha, dtodx2, prec, steps=1, sites=HEAT2D_SITES, k_floor=None, collect_evidence=False, capture=None,
                       storage="f32", members=False):
    """The plain PyTorch version of :func:`heat2d_sweep`, on any device."""
    return _heat2d(
        u0, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, storage=storage, plain=True, members=members,
    )


def _advection1d(u0, *, speed, dtodx, prec, steps, sites, k_floor, collect_evidence, capture, storage, plain,
                 plan=None, members=False):
    speed, dtodx = float(speed), float(dtodx)
    return _sweep(
        "advection1d", _advection1d_body(speed, dtodx, sites), u0, 1, u0.shape[-1], (speed, dtodx), prec=prec,
        steps=steps, sites=sites, k_floor=k_floor, collect_evidence=collect_evidence, capture=capture,
        storage=storage, plain=plain, plan=plan, members=members,
    )


def advection1d_sweep(
    u0, *, speed, dtodx, prec, steps=1, sites=ADVECTION1D_SITES, k_floor=None, collect_evidence=False,
    capture=None, storage="f32", members=False, _plan=None,
):
    """Advance an ``(nx,)`` periodic profile ``steps`` upwind substeps in one
    launch. Returns ``(u, evidence)``; evidence is ``(steps, 2, 2)`` or None.
    ``_plan`` asks the kernel for another launch shape than ``rod.rod_plan``'s
    (the chip checks and timings)."""
    return _advection1d(
        u0, speed=speed, dtodx=dtodx, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, storage=storage, plain=False, plan=_plan,
        members=members,
    )


def advection1d_sweep_plain(
    u0, *, speed, dtodx, prec, steps=1, sites=ADVECTION1D_SITES, k_floor=None, collect_evidence=False, capture=None, storage="f32",
    members=False,
):
    """The plain PyTorch version of :func:`advection1d_sweep`, on any device."""
    return _advection1d(
        u0, speed=speed, dtodx=dtodx, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, storage=storage, plain=True, members=members,
    )


def _burgers1d(u0, *, dt, dx, prec, steps, sites, k_floor, collect_evidence, capture, storage, plain, plan=None,
               members=False):
    dt, dx = float(dt), float(dx)
    return _sweep(
        "burgers1d", _burgers1d_body(dt, dx, sites), u0, 1, u0.shape[-1], (dt / (2.0 * dx), 0.5), prec=prec,
        steps=steps, sites=sites, k_floor=k_floor, collect_evidence=collect_evidence, capture=capture,
        storage=storage, plain=plain, plan=plan, members=members,
    )


def burgers1d_sweep(
    u0, *, dt, dx, prec, steps=1, sites=BURGERS1D_SITES, k_floor=None, collect_evidence=False,
    capture=None, storage="f32", members=False, _plan=None,
):
    """Advance an ``(nx,)`` periodic wave ``steps`` Lax-Friedrichs substeps in
    one launch. Returns ``(u, evidence)``; evidence is ``(steps, 2, 2)`` or None.
    ``_plan`` asks the kernel for another launch shape than ``rod.rod_plan``'s
    (the chip checks and timings)."""
    return _burgers1d(
        u0, dt=dt, dx=dx, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, storage=storage, plain=False, plan=_plan,
        members=members,
    )


def burgers1d_sweep_plain(u0, *, dt, dx, prec, steps=1, sites=BURGERS1D_SITES, k_floor=None, collect_evidence=False, capture=None,
                          storage="f32", members=False):
    """The plain PyTorch version of :func:`burgers1d_sweep`, on any device."""
    return _burgers1d(
        u0, dt=dt, dx=dx, prec=prec, steps=steps, sites=sites, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, storage=storage, plain=True, members=members,
    )

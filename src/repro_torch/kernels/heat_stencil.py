"""Kernel K2: the fused 1D heat-equation sweep (``heat1d_sweep``).

One explicit-FD substep is ``u' = u + (alpha * lap) * dtodx2`` on the
interior with the ends pinned: the laplacian adds in f32 and the two
multiplies run on the policy's multiplier at one split per ``(br, nx)``
block (in the f32 mode ``fma(lap, alpha * dtodx2, u)``, as the compiled
reference folds it: ``kernels/updates.py::heat1d_update``). ``steps`` substeps
run in one launch.

Replaces the TPU kernel ``repro/kernels/fused.py::fused_sweep``
(``_sweep_kernel``) running ``repro/kernels/heat_stencil.py::_heat1d_body``
through ``heat1d_sweep``. The CUDA kernel is heat1d's body of
``csrc/rod.cuh`` (whose bodies kernel K4's heat1d megakernel and the 1-D K5
kernels run too), bound by the latency of the serial substep chain, not by
bytes (1 KB in, 1 KB out per chunk on the main path's ``(1, 128)`` row) or
operations: a substep is two block maxima, two split selections and the
rounding of every product. So ``kernels/rod.py::rod_plan`` gives a block of
at most 2048 cells the warp shape, up to eight warps of one CTA with the
cells in registers and each maximum a warp reduction and one over the warps
(three CTA barriers a substep); a larger block runs on a cooperative grid
over the block, which has no size limit. Under packed storage the kernel
decodes the payload into its cells before the first substep and encodes
them after the last at a split taken from their finite max (the warp shape:
one more reduction; the grid: one more grid barrier).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.policy import PrecisionConfig
from repro_torch.kernels import _cuda
from repro_torch.kernels.fused import fused_sweep
from repro_torch.kernels.rod import launch_rod, rod_plan, sweep_storage
from repro_torch.kernels.updates import heat1d_update

__all__ = ["HEAT1D_SITES", "HEAT1D_SWEEP", "heat1d_sweep", "heat1d_sweep_plain", "heat_stencil_pallas"]

HEAT1D_SITES = ("heat.flux", "heat.update")
#: launches of the CUDA kernel and runs of the plain version
HEAT1D_SWEEP = _cuda.KernelCounter("heat1d_sweep")


def _heat1d_body(alpha, dtodx2, sites):
    """One explicit-FD substep on a ``(br, nx)`` block (the plain version):
    the stepper's own update."""

    def body(state, ops):
        (u,) = state
        return (heat1d_update(u, alpha, dtodx2, ops, sites),)

    return body


def _launch(leaves, *, br, bw, gi, gj, k_floor, collect, alpha, dtodx2, prec, steps, n_sites, plan, k_in=None,
            capture=None, extent=None):
    (u,) = leaves
    u = u.contiguous()
    if n_sites != 2:
        raise ValueError(f"heat1d_sweep has two sites (flux, update); got {n_sites}")
    if capture is not None and extent is not None:
        raise ValueError("the rod kernel captures whole row blocks: pass rows divisible by block_rows")
    members = u.shape[0]
    plan = plan or rod_plan(br, u.shape[2], _cuda.sm_count(u.device))
    ev = torch.empty((members, gi, gj, steps, n_sites, 2), dtype=torch.float32, device=u.device) if collect else None
    u_in, u_out, out, storage = sweep_storage(u, k_in)
    cap = _cuda.capture_io(capture, 1, n_sites, u.device, members=members)
    err = launch_rod(
        "heat1d", u_in, u_out, plan, br=br, steps=steps, consts=(alpha, dtodx2), prec=prec, ev=ev, k=k_floor,
        storage=storage, capture=cap,
    )
    _cuda.check(err, "heat1d_sweep")
    HEAT1D_SWEEP.count("f32" if k_in is None else "packed", capture=capture is not None)
    res = [[out], ev] if k_in is None else [[out], ev, [storage.k_out]]
    return tuple(res) if capture is None else (*res, cap.out[:, 0])


def _sweep(u0, *, alpha, dtodx2, prec, steps, block_rows, sites, k_floor, collect_evidence, capture, storage, plain,
           plan=None, members=False):
    alpha, dtodx2 = float(alpha), float(dtodx2)
    kernel = functools.partial(_launch, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, n_sites=len(sites), plan=plan)
    (out,), *rest = fused_sweep(
        _heat1d_body(alpha, dtodx2, sites), (u0,), prec=prec, sites=sites, steps=steps,
        block=(block_rows, u0.shape[-1]), k_floor=k_floor, collect_evidence=collect_evidence,
        kernel=kernel, counter=HEAT1D_SWEEP, plain=plain, capture=capture, storage=storage, members=members,
    )
    return (out, *rest)


def heat1d_sweep(
    u0, *, alpha, dtodx2, prec, steps=1, block_rows=8, sites=HEAT1D_SITES, k_floor=None,
    collect_evidence=False, capture=None, storage="f32", members=False, _plan=None,
):
    """Advance ``(rows, nx)`` rods ``steps`` substeps in one launch.
    Returns ``(u, evidence)``; evidence is ``(steps, 2, 2)`` or None. With
    ``capture`` (a CaptureSpec) also the ``(2, 2, n_bins)`` operand counts.
    ``members=True`` takes ``(members, rows, nx)`` ensemble members, each
    with its own ``k_floor`` row, evidence and counts, in the same launch.
    ``_plan`` asks the kernel for another launch shape than
    ``rod.rod_plan``'s (the chip checks and timings)."""
    return _sweep(
        u0, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, block_rows=block_rows, sites=sites,
        k_floor=k_floor, collect_evidence=collect_evidence, capture=capture, storage=storage, plain=False, plan=_plan,
        members=members,
    )


def heat1d_sweep_plain(
    u0, *, alpha, dtodx2, prec, steps=1, block_rows=8, sites=HEAT1D_SITES, k_floor=None, collect_evidence=False,
    capture=None, storage="f32", members=False,
):
    """The plain PyTorch version of :func:`heat1d_sweep`, on any device."""
    return _sweep(
        u0, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, block_rows=block_rows, sites=sites,
        k_floor=k_floor, collect_evidence=collect_evidence, capture=capture, storage=storage, plain=True,
        members=members,
    )


def heat_stencil_pallas(u0, alpha, dtodx2, *, fmt, steps=1, block_rows=8, tail_approx=True):
    """The historical fmt-keyed surface: rr_tile semantics, no evidence."""
    prec = PrecisionConfig(mode="rr_tile", fmt=fmt, tail_approx=tail_approx)
    out, _ = heat1d_sweep(
        u0.to(torch.float32), alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, block_rows=block_rows
    )
    return out

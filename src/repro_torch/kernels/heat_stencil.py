"""Kernel K2: the fused 1D heat-equation sweep (``heat1d_sweep``).

One explicit-FD substep is ``u' = u + (alpha * lap) * dtodx2`` on the
interior with the ends pinned: the laplacian adds in f32 and the two
multiplies run on the policy's multiplier at one split per ``(br, nx)``
block (in the f32 mode ``fma(lap, alpha * dtodx2, u)``, as the compiled
reference folds it: ``kernels/updates.py::heat1d_update``). ``steps`` substeps
run in one launch.

Replaces the TPU kernel ``repro/kernels/fused.py::fused_sweep``
(``_sweep_kernel``) running ``repro/kernels/heat_stencil.py::_heat1d_body``
through ``heat1d_sweep``. The CUDA kernel (``csrc/heat1d_rod.cu``, whose
device body kernel K4's heat1d megakernel runs too) is bound by the latency
of the serial substep chain, not by bytes (1 KB in, 1 KB out per chunk on
the main path's ``(1, 128)`` row) or operations: a substep is two block
maxima, two split selections and the rounding of every product. So
:func:`heat1d_plan` gives a block of at most 2048 cells the warp shape, up
to eight warps of one CTA with the cells in registers and each maximum a
warp reduction and one over the warps (three CTA barriers a substep); a
larger block runs on a cooperative grid over the block, which has no
size limit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.policy import PrecisionConfig
from repro_torch.kernels import _cuda
from repro_torch.kernels.fused import fused_sweep
from repro_torch.kernels.updates import heat1d_update
from repro_torch.precision.fusion import fused_family

__all__ = [
    "CELLS", "GRID_CELLS", "GRID_THREADS", "HEAT1D_SITES", "HEAT1D_SWEEP", "Heat1DPlan", "WARP_LIMIT", "WARP_MAX",
    "grid_scratch", "heat1d_plan", "heat1d_sweep", "heat1d_sweep_plain", "heat_stencil_pallas", "launch_heat1d",
]

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


#: cells a lane (warp shape, up to 8) or a thread (grid shape) holds in
#: registers: the kernels' template sizes
CELLS = (1, 2, 4, 8, 16, 32)
#: the warp shape: at most WARP_MAX warps of one CTA on a block, so at most
#: WARP_LIMIT cells
WARP_MAX = 8
WARP_LIMIT = 32 * WARP_MAX * 8
#: threads of a grid-shape CTA, and the cells a thread should hold before the
#: plan adds a CTA to the block
GRID_THREADS, GRID_CELLS = 256, 8


class Heat1DPlan(NamedTuple):
    """The launch shape of one ``(br, nx)`` row block (``csrc/heat1d_rod.cu``)."""

    shape: str  # "warp": warps of one CTA; "grid": a cooperative grid over the block
    threads: int  # threads on the block: 32 * warps, or ctas * GRID_THREADS
    cells: int  # cells a lane or thread holds in registers (a grid block beyond threads * cells walks batches)
    ctas: int  # CTAs on the block


def heat1d_plan(br: int, nx: int, n_sms: int = 132) -> Heat1DPlan:
    """How K2 and K4 run one ``(br, nx)`` row block on a card of ``n_sms``
    SMs. Up to :data:`WARP_LIMIT` cells, the warp shape: one CTA of one
    warp for each 32 cells up to :data:`WARP_MAX` (one a scheduler at the
    main path's 128 cells), each lane holding ``cells`` consecutive cells of
    the flattened block (the smallest of :data:`CELLS` that covers it). Beyond that a
    cooperative grid of ``ctas`` CTAs of :data:`GRID_THREADS` threads (one
    per ``GRID_THREADS * GRID_CELLS`` cells, at most ``n_sms``), thread ``t``
    of CTA ``c`` holding cells ``c * GRID_THREADS + t + i * threads`` for
    ``i < cells`` (the smallest of :data:`CELLS` that covers its share, at
    most 32; a larger block walks them in batches). Any ``nx >= 3``."""
    if br < 1 or nx < 3:
        raise ValueError(f"heat1d needs br >= 1 and nx >= 3; got ({br}, {nx})")
    n = br * nx
    if n <= WARP_LIMIT:
        threads = 32 * min(WARP_MAX, -(-n // 32))
        return Heat1DPlan("warp", threads, next(g for g in CELLS if threads * g >= n), 1)
    ctas = min(-(-n // (GRID_THREADS * GRID_CELLS)), n_sms)
    share = -(-n // (ctas * GRID_THREADS))
    return Heat1DPlan("grid", ctas * GRID_THREADS, next((g for g in CELLS if g >= share), CELLS[-1]), ctas)


def grid_scratch(rows, nx, br, device):
    """The grid shape's scratch for a ``(rows, nx)`` field of ``(br, nx)``
    blocks, whatever the number of substeps: the other field buffer and the
    laplacian (f32), the lap and flux maxima of a ring of two substeps a
    block (int32, zeroed; the kernel zeroes each substep's slots for the one
    after next) and a 64-bit barrier counter a block (zeroed)."""
    blocks = rows // br
    work = torch.empty(2 * rows * nx, dtype=torch.float32, device=device)
    maxes = torch.zeros(blocks * 4, dtype=torch.int32, device=device)
    count = torch.zeros(blocks, dtype=torch.int64, device=device)
    return work, maxes, count


def launch_heat1d(u, out, plan, *, br, steps, alpha, dtodx2, prec, ev=None, k=None, tracker_rows=(None,) * 4,
                  table=None, evolve=False, every=0, snaps=None, law=(0.0, 0.0, 0)):
    """Launch ``csrc/heat1d_rod.cu`` on the ``(rows, nx)`` f32 field ``u``
    (contiguous, ``rows`` a multiple of ``br``) into ``out`` on the launch
    shape ``plan`` of one ``(br, nx)`` block: K2 with its carried floor
    ``k`` and per-block evidence ``ev`` ``(blocks, steps, 2, 2)``; K4 (one
    block) with its tracker's ``k`` and other rows, the adjust unit's
    ``table`` and ``law`` (ema, 1 - ema, headroom), and ``snaps`` at every
    ``every``-th substep."""
    rows, nx = u.shape
    blocks, n = rows // br, br * nx
    work, maxes, count = grid_scratch(rows, nx, br, u.device) if plan.shape == "grid" else (None, None, None)
    lib = _cuda.library()
    with torch.cuda.device(u.device):
        err = lib.r2f2_heat1d(
            _cuda.ptr(u), _cuda.ptr(out), _cuda.ptr(snaps), _cuda.ptr(ev), _cuda.ptr(work), _cuda.ptr(maxes),
            _cuda.ptr(count), _cuda.ptr(k), *map(_cuda.ptr, tracker_rows), _cuda.ptr(table), int(evolve), blocks, n, nx, steps, every,
            int(plan.shape == "grid"), plan.threads, plan.cells, plan.ctas, float(alpha), float(dtodx2), *law,
            *_cuda.policy_args(prec, fused_family(prec.mode)), _cuda.stream_of(u),
        )
    return err


def _launch(leaves, *, br, bw, gi, gj, k_floor, collect, alpha, dtodx2, prec, steps, n_sites, plan):
    (u,) = leaves
    u = u.contiguous()
    if n_sites != 2:
        raise ValueError(f"heat1d_sweep has two sites (flux, update); got {n_sites}")
    plan = plan or heat1d_plan(br, u.shape[1], _cuda.sm_count(u.device))
    out = torch.empty_like(u)
    ev = torch.empty((gi, gj, steps, n_sites, 2), dtype=torch.float32, device=u.device) if collect else None
    err = launch_heat1d(u, out, plan, br=br, steps=steps, alpha=alpha, dtodx2=dtodx2, prec=prec, ev=ev, k=k_floor)
    _cuda.check(err, "heat1d_sweep")
    HEAT1D_SWEEP.launches += 1
    return [out], ev


def _sweep(u0, *, alpha, dtodx2, prec, steps, block_rows, sites, k_floor, collect_evidence, capture, storage, plain,
           plan=None):
    alpha, dtodx2 = float(alpha), float(dtodx2)
    kernel = functools.partial(_launch, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, n_sites=len(sites), plan=plan)
    (out,), ev = fused_sweep(
        _heat1d_body(alpha, dtodx2, sites), (u0,), prec=prec, sites=sites, steps=steps,
        block=(block_rows, u0.shape[1]), k_floor=k_floor, collect_evidence=collect_evidence,
        kernel=kernel, counter=HEAT1D_SWEEP, plain=plain, capture=capture, storage=storage,
    )
    return out, ev


def heat1d_sweep(
    u0, *, alpha, dtodx2, prec, steps=1, block_rows=8, sites=HEAT1D_SITES, k_floor=None,
    collect_evidence=False, capture=None, storage="f32", _plan=None,
):
    """Advance ``(rows, nx)`` rods ``steps`` substeps in one launch.
    Returns ``(u, evidence)``; evidence is ``(steps, 2, 2)`` or None.
    ``_plan`` asks the kernel for another launch shape than
    :func:`heat1d_plan`'s (the chip checks and timings)."""
    return _sweep(
        u0, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, block_rows=block_rows, sites=sites,
        k_floor=k_floor, collect_evidence=collect_evidence, capture=capture, storage=storage, plain=False, plan=_plan,
    )


def heat1d_sweep_plain(
    u0, *, alpha, dtodx2, prec, steps=1, block_rows=8, sites=HEAT1D_SITES, k_floor=None, collect_evidence=False,
):
    """The plain PyTorch version of :func:`heat1d_sweep`, on any device."""
    return _sweep(
        u0, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, block_rows=block_rows, sites=sites,
        k_floor=k_floor, collect_evidence=collect_evidence, capture=None, storage="f32", plain=True,
    )


def heat_stencil_pallas(u0, alpha, dtodx2, *, fmt, steps=1, block_rows=8, tail_approx=True):
    """The historical fmt-keyed surface: rr_tile semantics, no evidence."""
    prec = PrecisionConfig(mode="rr_tile", fmt=fmt, tail_approx=tail_approx)
    out, _ = heat1d_sweep(
        u0.to(torch.float32), alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, block_rows=block_rows
    )
    return out

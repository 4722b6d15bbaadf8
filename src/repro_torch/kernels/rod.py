"""The launch shapes of ``csrc/rod.cuh`` (``rod_warp.cuh``, ``rod_grid.cuh``), the explicit stencil bodies on a
rod: K2 and K4 heat1d, the 1-D K5 bodies (advection1d, burgers1d) and
heat2d's fields beyond its thread-block cluster.

A field is flattened to a rod of ``n`` cells; :func:`rod_plan` gives a rod
its shape. Up to :data:`WARP_LIMIT` cells the warp shape: up to eight warps
of one CTA, the cells in registers, each field-wide maximum a warp reduction
and one over the warps. Beyond it a cooperative grid over the rod, the field
in global memory in two buffers, each maximum an atomic into a ring of two
substeps and each pass behind a grid barrier; it has no size limit.
:func:`launch_rod` launches one body on a plan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.precision.fusion import fused_family

__all__ = [
    "BODIES", "CELLS", "GRID_CELLS", "GRID_THREADS", "RodPlan", "WARP_LIMIT", "WARP_MAX", "grid_scratch",
    "launch_rod", "rod_plan", "sweep_storage", "mega_storage",
]

#: the bodies of csrc/rod.cuh (its enum Body)
BODIES = {"heat1d": 0, "advection1d": 1, "burgers1d": 2, "heat2d": 3}
#: cells a lane (warp shape, up to 8) or a thread (grid shape) holds in
#: registers: the kernels' template sizes
CELLS = (1, 2, 4, 8, 16, 32)
#: the warp shape: at most WARP_MAX warps of one CTA on a block, so at most
#: WARP_LIMIT cells
WARP_MAX = 8
WARP_LIMIT = 32 * WARP_MAX * 8
#: threads of a grid-shape CTA, and the cells a thread should hold before the
#: plan adds a CTA to the block (and the most a periodic rod's thread holds:
#: csrc/rod.cuh::kPeriodicGridCells)
GRID_THREADS, GRID_CELLS = 256, 8


class RodPlan(NamedTuple):
    """The launch shape of one block of a rod (``csrc/rod.cuh``)."""

    shape: str  # "warp": warps of one CTA; "grid": a cooperative grid over the block
    threads: int  # threads on the block: 32 * warps, or ctas * GRID_THREADS
    cells: int  # cells a lane or thread holds in registers (a grid block beyond threads * cells walks batches)
    ctas: int  # CTAs on the block


def rod_plan(br: int, nx: int, n_sms: int = 132, *, periodic: bool = False) -> RodPlan:
    """How the rod kernels run one ``(br, nx)`` block of ``br * nx`` cells on
    a card of ``n_sms`` SMs: heat1d's row blocks, a periodic rod (one row:
    advection1d, burgers1d) and heat2d's ``(nx, ny)`` field beyond its
    cluster. Up to :data:`WARP_LIMIT` cells, the warp shape: one CTA of one
    warp for each 32 cells up to :data:`WARP_MAX` (one a scheduler at the
    main path's 128 cells), each lane holding ``cells`` consecutive cells of
    the flattened block (the smallest of :data:`CELLS` that covers it).
    Beyond that a cooperative grid of ``ctas`` CTAs of :data:`GRID_THREADS`
    threads (one per ``GRID_THREADS * GRID_CELLS`` cells, at most ``n_sms``),
    thread ``t`` of CTA ``c`` holding cells ``c * GRID_THREADS + t + i *
    threads`` for ``i < cells`` (the smallest of :data:`CELLS` that covers
    its share, at most 32, a periodic rod's at most :data:`GRID_CELLS`; a
    larger block walks them in batches). Any ``nx >= 3`` (a periodic rod:
    any ``nx >= 1``)."""
    if br < 1 or nx < (1 if periodic else 3):
        raise ValueError(f"a rod block needs br >= 1 and nx >= {1 if periodic else 3}; got ({br}, {nx})")
    n = br * nx
    if n <= WARP_LIMIT:
        threads = 32 * min(WARP_MAX, -(-n // 32))
        return RodPlan("warp", threads, next(g for g in CELLS if threads * g >= n), 1)
    ctas = min(-(-n // (GRID_THREADS * GRID_CELLS)), n_sms)
    share = -(-n // (ctas * GRID_THREADS))
    most = GRID_CELLS if periodic else CELLS[-1]
    return RodPlan("grid", ctas * GRID_THREADS, next((g for g in CELLS if g >= min(share, most)), most), ctas)


def grid_scratch(rows, nx, br, device, *, staged=False, members=1):
    """The grid shape's scratch for ``members`` ``(rows, nx)`` fields of
    ``(br, nx)`` blocks, whatever the number of substeps, a member's after
    the member before: the other field buffer and the laplacian (f32; with
    ``staged``, a third buffer the kernel decodes a packed input into), a
    substep's two maxima in a ring of two substeps a block and two slots for
    the storage maxima (int32, zeroed; the kernel zeroes each slot again
    before its next use) and a 64-bit barrier counter a block (zeroed)."""
    blocks = rows // br
    work = torch.empty(members * (3 if staged else 2) * rows * nx, dtype=torch.float32, device=device)
    maxes = torch.zeros(members * (blocks * 4 + 2), dtype=torch.int32, device=device)
    count = torch.zeros(members * blocks, dtype=torch.int64, device=device)
    return work, maxes, count


def launch_rod(body, u, out, plan, *, br, steps, consts, prec, ev=None, k=None, tracker_rows=(None,) * 4, table=None,
               evolve=False, every=0, snaps=None, law=(0.0, 0.0, 0), storage=_cuda.StorageIO(),
               capture=_cuda.CaptureIO()):
    """Launch ``body`` of the rod kernels on the ``(members, rows, nx)`` f32
    fields ``u`` (contiguous, ``rows`` a multiple of ``br``; heat2d's field
    is one ``(nx, ny)`` block) into ``out`` on the launch shape ``plan`` of
    one ``(br, nx)`` block, with the body's two constants ``consts``: a fused
    sweep with its carried floor ``k`` ``(members, 2)`` and per-block
    evidence ``ev`` ``(members, blocks, steps, 2, 2)``; a megakernel (one
    block a member) with its tracker's ``k`` and other rows ``(members,
    2)``, the adjust unit's ``table`` and ``law`` (ema, 1 - ema, headroom),
    and ``snaps`` at every ``every``-th substep. ``storage`` (one block a
    member) gives a packed input in place of ``u`` (None), a packed output
    in place of ``out`` (None), the megakernels' boundary rounding and the
    output split; ``capture`` the histogram buffer (slot 0 a fused sweep's,
    slot i a megakernel's interval i, the last its remainder). Each member
    is an ensemble member of its own: nothing is shared between them.
    Returns the launch's CUDA error code."""
    field = u if u is not None else storage.pay_in
    members, rows, nx = field.shape
    blocks, n = rows // br, br * nx
    work = maxes = count = None
    if plan.shape == "grid":
        work, maxes, count = grid_scratch(rows, nx, br, field.device, staged=storage.pay_in is not None,
                                          members=members)
        if out is None:  # the last substep lands in f32 before the epilogue encodes it
            out = torch.empty((members, rows, nx), dtype=torch.float32, device=field.device)
    lib = _cuda.library()
    with torch.cuda.device(field.device):
        return lib.r2f2_rod(
            BODIES[body], _cuda.ptr(u), _cuda.ptr(out), _cuda.ptr(snaps), _cuda.ptr(ev), _cuda.ptr(work),
            _cuda.ptr(maxes), _cuda.ptr(count), _cuda.ptr(k), *map(_cuda.ptr, tracker_rows), _cuda.ptr(table),
            int(evolve), blocks, members, n, nx, steps, every, int(plan.shape == "grid"), plan.threads, plan.cells,
            plan.ctas, *map(float, consts), *law, *_cuda.policy_args(prec, fused_family(prec.mode)), *storage.args(),
            *capture.args(), _cuda.stream_of(field),
        )


def _splits(u):
    return torch.empty(u.shape[0], dtype=torch.int32, device=u.device)


def sweep_storage(u, k_in):
    """A fused sweep's arguments for its one leaf ``u`` (``(members, rows,
    width)``): ``(u_in, u_out, out, storage)``, the f32 input and output
    (None where packed), the tensor the launch returns, and its storage
    arguments: f32 in and out, or (``k_in``: the leaf's payload splits,
    ``(members,)``) the payload in and a payload out with its fresh split."""
    if k_in is None:
        out = torch.empty_like(u)
        return u, out, out, _cuda.StorageIO()
    out = torch.empty_like(u)
    return None, None, out, _cuda.StorageIO(pay_in=u, k_in=k_in[0].contiguous(), pay_out=out, k_out=_splits(u))


def mega_storage(u, storage, k_in):
    """A megakernel's arguments for its one leaf ``u``, as
    :func:`sweep_storage`'s: the boundary rounding and the carried split
    ``kst`` (one a member) under ``"quantized"``/``"packed"``, and with
    ``k_in`` (packed io) the payload in and the payload out at ``kst``."""
    rounding = storage != "f32"
    k_out = _splits(u) if rounding else None
    if k_in is None:
        out = torch.empty_like(u, dtype=torch.float32)
        return u, out, out, _cuda.StorageIO(k_out=k_out, round=rounding)
    out = torch.empty_like(u)
    return None, None, out, _cuda.StorageIO(pay_in=u, k_in=k_in[0].contiguous(), pay_out=out, k_out=k_out, round=True)

"""Kernel K4: the whole-horizon megakernel (``mega_sweep``).

A megakernel runs an ENTIRE simulation horizon in one launch: ``steps``
substeps of a stepper body, the state snapshots at every ``every``-th
substep, and the paper's adjust unit ticking once per site per substep on
the card. Where the fused plane re-enters its kernel per snapshot interval
and folds the chunk's evidence on the host, here the carried tracker rows
``(k, hi_ema, lo_ema, overflow_steps, shrink_steps)`` stay in the kernel
and evolve through :func:`repro_torch.core.policy.adjust_step`'s law.

The semantics are those of ``repro/kernels/mega.py``:

* the body runs at one block per state leaf (the whole field, no padding);
* a non-pinned policy with a tracker (``evolve``) ticks the tracker every
  substep, but the datapath floor ``ka`` latches to the tracker's split
  only at snapshot boundaries (``(s + 1) % every == 0``), the cadence at
  which the fused plane folds. The two planes are therefore bit-identical;
* a pinned policy with a tracker (``has_floor``) runs at the tracker's
  fixed splits and leaves the tracker as it is;
* the remainder substeps after the last boundary run in the same launch;
* per-substep evidence ``(steps, n_sites, 2)`` comes back on request;
* ``capture`` (a CaptureSpec) bins every policy operation's operands per
  site: ``exp_time`` holds each whole snapshot interval's counts ``(n_out,
  n_sites, 2, n_bins)``, ``exp_total`` the run's, the remainder substeps
  after the last boundary in it only; capture turns the evidence on;
* ``storage="quantized"|"packed"`` rounds the state at every snapshot
  boundary, after the update and before the snapshot and the next substep:
  one leaf-wide finite max, its storage split, the leaf quantized there
  (the carried split ``kst``), and once more after the remainder substeps.
  PackedArray leaves are decoded in the kernel's prologue and encoded at
  ``kst`` in its epilogue (the state is already quantized there, so the
  encode is the chunked plane's pack bit for bit); f32 leaves under
  ``"packed"`` come back f32 with ``kst``, and :func:`mega_sweep` packs
  them at it (swe2d's shape: kernel K1 on the card).

:func:`mega_sweep` launches a stepper's CUDA kernel for CUDA tensors and
runs :func:`mega_sweep_plain` (the same function in plain PyTorch) for CPU
tensors; a CUDA tensor takes the plain version only with ``plain=True``.
:data:`HEAT1D_MEGA`, :data:`SWE2D_MEGA`, :data:`HEAT2D_MEGA`,
:data:`ADVECTION1D_MEGA` and :data:`BURGERS1D_MEGA` count each kernel's
launches and its plain runs. Kernel K4 is ``csrc/rod.cuh`` for heat1d
(K2's device body on the launch shape of ``rod.rod_plan``: up to eight
warps of one CTA up to 2048 cells, else a cooperative grid) and
``csrc/mega_pde.cu`` for swe2d on the shape of :func:`swe2d_plan`: a
cooperative grid of CTAs that each own a band of rows and recompute the
halo row below it, two grid barriers a substep. Kernels
K5e-f are the 1-D bodies of ``csrc/rod.cuh`` on their rod's shape, K5d
heat2d's thread-block cluster (``csrc/pde_steps.cu::heat2d_mega_kernel``)
or, beyond it, the rod's grid (``pde_steps.heat2d_plan``), with the
adjust unit ticked on the card; ``pde_steps.BODIES`` holds the K5
counters.

Replaces the TPU kernel ``repro/kernels/mega.py::mega_sweep``
(``_mega_kernel``) running ``heat1d_mega`` and ``swe2d_mega`` (K4), and
``heat2d_mega``, ``advection1d_mega`` and ``burgers1d_mega`` (K5d-f).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

import repro_torch.obs as _obs
from repro_torch._device import f32_scalar
from repro_torch.core.flexformat import quantize_em
from repro_torch.core.policy import RangeTracker, adjust_step, tracker_stack
from repro_torch.kernels import _cuda
from repro_torch.kernels.fused import FusedOps, _packed_leaves, _single_block
from repro_torch.kernels.heat_stencil import _heat1d_body
from repro_torch.kernels.pde_steps import (
    ADVECTION1D_MEGA, BODIES, BURGERS1D_MEGA, HEAT2D_MEGA, _advection1d_body, _burgers1d_body, _heat2d_body,
    k5_plan, launch_k5,
)
from repro_torch.kernels.rod import launch_rod, mega_storage, rod_plan
from repro_torch.pack.packed import (
    PackedArray, block_storage_k, pack_block, pack_members, payload_dtype, unpack_array, unpack_block, unpack_members,
)
from repro_torch.precision.fusion import fused_family

__all__ = [
    "MegaResult",
    "HEAT1D_MEGA",
    "SWE2D_MEGA",
    "Swe2DPlan",
    "swe2d_plan",
    "swe2d_bands",
    "swe2d_band_floats",
    "swe2d_grid_scratch",
    "swe2d_capacity",
    "member_waves",
    "mega_sweep",
    "mega_sweep_plain",
    "heat1d_mega",
    "swe2d_mega",
    "HEAT2D_MEGA",
    "ADVECTION1D_MEGA",
    "BURGERS1D_MEGA",
    "heat2d_mega",
    "advection1d_mega",
    "burgers1d_mega",
]

#: per stepper: launches of its CUDA kernel and runs of its plain version
HEAT1D_MEGA = _cuda.KernelCounter("heat1d_mega")
SWE2D_MEGA = _cuda.KernelCounter("swe2d_mega")
#: the adjust unit's op codes in csrc/r2f2_device.cuh
OP_CODES = {"mul": 0, "div": 1}


class MegaResult(NamedTuple):
    """Everything one whole-horizon launch produces."""

    state: Tuple[torch.Tensor, ...]  # the advanced leaves
    snaps: Tuple[torch.Tensor, ...]  # per leaf, (n_out, *leaf.shape) boundary snapshots
    tracker: Optional[RangeTracker]  # the evolved tracker (the input one when pinned)
    evidence: Optional[torch.Tensor]  # (steps, n_sites, 2) f32, when requested
    kst: Optional[torch.Tensor] = None  # (n_state,) int32 carried storage splits, under storage rounding
    exp_time: Optional[torch.Tensor] = None  # (n_out, n_sites, 2, n_bins) int32 per-interval counts, capture
    exp_total: Optional[torch.Tensor] = None  # (n_sites, 2, n_bins) int32 whole-run counts, capture


def _site_ops(sites, site_ops):
    ops = ("mul",) * len(sites) if site_ops is None else tuple(site_ops)
    if len(ops) != len(sites):
        raise ValueError(f"site_ops covers {len(ops)} entries for {len(sites)} sites")
    return ops


def mega_sweep_plain(
    body: Callable,
    state: Sequence[torch.Tensor],
    *,
    prec,
    sites: Tuple[str, ...],
    site_ops: Optional[Tuple[str, ...]] = None,
    steps: int,
    every: int,
    tracker: Optional[RangeTracker] = None,
    collect_evidence: bool = False,
    storage: str = "f32",
    k_in=None,
    capture=None,
) -> MegaResult:
    """The plain PyTorch version of :func:`mega_sweep`, on any device:
    ``body(leaves, ops)`` once per substep over the whole leaves, with
    :class:`FusedOps` at the latched floor and :func:`adjust_step` per site.
    With ``k_in`` (the leaves' splits) the leaves are payloads, decoded
    first and encoded at ``kst`` last; with ``capture`` the operand counts
    come back per interval and in total."""
    sites = tuple(sites)
    ops_of = _site_ops(sites, site_ops)
    fmt = prec.fmt
    if k_in is not None:
        st = tuple(unpack_block(x.to(torch.int64), fmt, k.reshape(())) for x, k in zip(state, k_in))
    else:
        st = tuple(x.to(torch.float32) for x in state)
    rounding = storage != "f32"

    def round_all(leaves):
        """The boundary rounding: each leaf at its storage split."""
        ks = [block_storage_k(v, fmt) for v in leaves]
        qs = tuple(quantize_em(v, fmt.eb + k, fmt.mb + fmt.fx - k) for v, k in zip(leaves, ks))
        return qs, torch.stack(ks)

    kst = torch.zeros(len(st), dtype=torch.int32, device=st[0].device)
    evolve = tracker is not None and not prec.pinned
    has_floor = tracker is not None and prec.pinned
    collect_evidence = bool(collect_evidence) or capture is not None
    collect = evolve or collect_evidence
    n_out = steps // every
    snaps = tuple(x.new_empty((n_out,) + tuple(x.shape)) for x in st)
    if capture is not None:
        cnt = torch.zeros((len(sites), 2, capture.n_bins), dtype=torch.int32, device=st[0].device)
        cnt_last, exp_time = cnt, []
    trk = tuple(tracker) if evolve else None  # (hi_ema, lo_ema, k, overflow_steps, shrink_steps)
    floor = tracker.k if has_floor else (tracker.k.clone() if evolve else None)
    evs = []
    for s in range(steps):
        ops = FusedOps(prec, sites, k_floor=floor, collect=collect, site_ops=site_ops, capture=capture)
        new = tuple(body(st, ops))
        if len(new) != len(st):
            raise ValueError(f"mega body returned {len(new)} leaves for {len(st)} state leaves")
        if collect:
            missing = [n for n in sites if n not in ops.evidence]
            if missing:
                raise ValueError(f"mega body never reached sites {missing}")
            ev = torch.stack([torch.stack(ops.evidence[n]) for n in sites])
            if collect_evidence:
                evs.append(ev)
        if capture is not None:
            cnt = cnt + torch.stack([ops.counts[n] for n in sites])
        if evolve:
            hi, lo, k, ov, sh = trk
            rows = [
                adjust_step(
                    k[j], hi[j], lo[j], ov[j], sh[j], ev[j, 0], ev[j, 1], prec, ops_of[j],
                    k_bounds=None if prec.k_bounds is None else prec.k_bounds[j],
                )
                for j in range(len(sites))
            ]
            k, hi, lo, ov, sh = (torch.stack(col) for col in zip(*rows))
            trk = (hi, lo, k.to(torch.int32), ov.to(torch.int32), sh.to(torch.int32))
        if (s + 1) % every == 0:
            if rounding:
                new, kst = round_all(new)
            if evolve:
                floor = trk[2]
            for snap, v in zip(snaps, new):
                snap[(s + 1) // every - 1] = v
            if capture is not None:
                exp_time.append(cnt - cnt_last)
                cnt_last = cnt
        st = new
    if rounding and steps % every:  # the remainder epilogue: the same law
        st, kst = round_all(st)
    if k_in is not None:
        st = tuple(pack_block(v, fmt, k).to(payload_dtype(fmt)) for v, k in zip(st, kst))
    out_tracker = RangeTracker(*trk) if evolve else tracker
    evidence = None
    if collect_evidence:
        evidence = torch.stack(evs) if evs else snaps[0].new_empty((0, len(sites), 2))
    res = MegaResult(st, snaps, out_tracker, evidence, kst if rounding else None)
    if capture is not None:
        times = torch.stack(exp_time) if exp_time else cnt.new_zeros((0,) + tuple(cnt.shape))
        res = res._replace(exp_time=times, exp_total=cnt)
    return res


def mega_sweep(
    body: Callable,
    state: Sequence[torch.Tensor],
    *,
    prec,
    sites: Tuple[str, ...],
    site_ops: Optional[Tuple[str, ...]] = None,
    steps: int,
    every: int,
    tracker: Optional[RangeTracker] = None,
    collect_evidence: bool = False,
    kernel: Optional[Callable] = None,
    counter: Optional[_cuda.KernelCounter] = None,
    plain: bool = False,
    capture=None,
    storage: str = "f32",
    members: bool = False,
) -> MegaResult:
    """Run a whole horizon, ``steps`` substeps with a snapshot every
    ``every``, in one launch.

    ``storage`` is ``"f32"``, ``"quantized"`` or ``"packed"`` (the module
    docstring says what each does); PackedArray leaves take ``"packed"``.

    ``members=True`` runs an ensemble in the same launch: every leaf (a
    PackedArray's payload and splits) and every tracker row leads with a
    member dim, and so does every field of the result (``kst`` is then
    ``(members, n_state)``); each member runs as it would alone.

    ``kernel(leaves, steps=, every=, tracker=, evolve=, collect=, storage=,
    k_in=)`` launches the stepper's CUDA kernel on leaves that lead with the
    member (a run alone is one member; the tracker rows ``(members,
    n_sites)``, ``k_in`` the leaves' ``(members,)`` splits) and returns a
    :class:`MegaResult` whose fields lead with the member and whose state
    holds payloads where ``k_in`` is given; it runs for CUDA tensors unless
    ``plain`` and counts its own launch. Under ``capture`` (a CaptureSpec)
    it is also given ``capture=`` and fills ``exp_time`` and ``exp_total``;
    capture turns the evidence on. CPU tensors (or ``plain``) take
    :func:`mega_sweep_plain`, member by member, counted on ``counter``.
    """
    if storage not in ("f32", "quantized", "packed"):
        raise ValueError(f"unknown mega storage {storage!r}")
    if every < 1:
        raise ValueError(f"snapshot cadence must be positive; got every={every}")
    if fused_family(prec.mode) is None:
        raise ValueError(f"mode {prec.mode!r} has no fused arithmetic family; run it on the reference plane")
    _site_ops(sites, site_ops)
    if tracker is not None and tracker.k.shape[-1] != len(sites):
        raise ValueError(f"tracker has {tracker.k.shape[-1]} rows for {len(sites)} sites")
    if prec.k_bounds is not None and len(prec.k_bounds) != len(sites):
        raise ValueError(f"k_bounds covers {len(prec.k_bounds)} sites; the body has {len(sites)}")
    packed_io = any(isinstance(x, PackedArray) for x in state)
    pas = k_in = None
    if packed_io:
        if storage != "packed":
            raise ValueError("PackedArray leaves require storage='packed'")
        if not all(isinstance(x, PackedArray) for x in state):
            raise TypeError("mixed packed/f32 state leaves")
        pas = _packed_leaves(state, prec)
        _single_block(pas, "megakernel packed io")
        leaves = [pa.payload for pa in pas]
    else:
        leaves = [x.to(torch.float32) for x in state]
    if not members:  # a run alone: one member
        leaves = [x[None] for x in leaves]
        tracker = None if tracker is None else RangeTracker(*(t[None] for t in tracker))
    n_members = leaves[0].shape[0]
    if packed_io:
        k_in = [pa.k.reshape(n_members).to(torch.int32) for pa in pas]
    on_card = leaves[0].is_cuda and not plain
    if on_card:
        if kernel is None:
            raise RuntimeError("this mega body has no CUDA kernel; pass CPU tensors to run its plain version")
        with _obs.span("cuda.mega_sweep", steps=steps, every=every, members=n_members):
            _obs.inc("repro_cuda_dispatch_total", help="CUDA kernel launches entered", kernel="mega_sweep")
            res = kernel(
                leaves, steps=steps, every=every, tracker=tracker,
                evolve=tracker is not None and not prec.pinned, collect=bool(collect_evidence) or capture is not None,
                storage=storage, k_in=k_in, **({} if capture is None else {"capture": capture}),
            )
    else:
        if counter is not None:
            counter.plain_calls += 1
        res = _stack_results([
            mega_sweep_plain(
                body, [x[m] for x in leaves], prec=prec, sites=sites, site_ops=site_ops, steps=steps, every=every,
                tracker=None if tracker is None else tracker.member(m),
                collect_evidence=collect_evidence, storage=storage,
                k_in=None if k_in is None else [k[m] for k in k_in], capture=capture,
            )
            for m in range(n_members)
        ])
    if packed_io:
        res = res._replace(state=tuple(
            PackedArray(p, k.reshape((n_members, 1, 1)), pa.fmt, pa.shape, pa.block)
            for p, k, pa in zip(res.state, res.kst.T, pas)
        ))
    elif storage == "packed":  # f32 leaves: packed here at the kernel's carried split
        res = res._replace(state=tuple(
            pack_members(q, prec.fmt, k=k, plain=not on_card) for q, k in zip(res.state, res.kst.T)
        ))
    return res if members else _only_member(res)


def _stack_results(results) -> MegaResult:
    """Members' results as one result whose fields lead with the member."""
    def stack(values):
        return None if values[0] is None else torch.stack(list(values))

    first = results[0]
    return MegaResult(
        tuple(torch.stack(col) for col in zip(*(r.state for r in results))),
        tuple(torch.stack(col) for col in zip(*(r.snaps for r in results))),
        None if first.tracker is None else tracker_stack([r.tracker for r in results]),
        stack([r.evidence for r in results]), stack([r.kst for r in results]),
        stack([r.exp_time for r in results]), stack([r.exp_total for r in results]),
    )


def _only_member(res: MegaResult) -> MegaResult:
    """A one-member result as the result of a run alone."""
    def first(x):
        return None if x is None else x[0]

    def leaf(x):
        if isinstance(x, PackedArray):
            return PackedArray(x.payload[0], x.k[0], x.fmt, x.shape, x.block)
        return x[0]

    return MegaResult(
        tuple(leaf(x) for x in res.state), tuple(x[0] for x in res.snaps),
        None if res.tracker is None else res.tracker.member(0),
        first(res.evidence), first(res.kst), first(res.exp_time), first(res.exp_total),
    )


# ---------------------------------------------------------------------------
# the two CUDA kernels' launches
# ---------------------------------------------------------------------------


def _adjust_args(prec, sites, site_ops, device):
    """The adjust unit's per-site table ``(n_sites, 3)`` int32 (op code,
    k_lo, k_hi) on ``device`` (None: no table, which the kernels read only
    with an evolving tracker) and its scalars: ema and 1 - ema rounded once
    to f32, and the headroom."""
    ops = _site_ops(sites, site_ops)
    bounds = prec.k_bounds or ((-(2**30), 2**30),) * len(sites)
    table = None if device is None else torch.tensor(
        [[OP_CODES[op], lo, hi] for op, (lo, hi) in zip(ops, bounds)], dtype=torch.int32
    ).to(device)
    ema = float(f32_scalar(prec.ema, "cpu"))
    one_minus = float(f32_scalar(1.0 - prec.ema, "cpu"))
    return table, ema, one_minus, int(prec.headroom)


def _tracker_buffers(tracker, evolve, device):
    """Output copies of the tracker rows ``(members, n_sites)`` that the
    kernel updates in place (evolve), or the pinned split row (has_floor),
    or nothing."""
    if tracker is None:
        return None, (None,) * 5
    t = RangeTracker(
        hi_ema=tracker.hi_ema.to(device, torch.float32).contiguous().clone(),
        lo_ema=tracker.lo_ema.to(device, torch.float32).contiguous().clone(),
        k=tracker.k.to(device, torch.int32).contiguous().clone(),
        overflow_steps=tracker.overflow_steps.to(device, torch.int32).contiguous().clone(),
        shrink_steps=tracker.shrink_steps.to(device, torch.int32).contiguous().clone(),
    )
    if not evolve:
        return tracker, (t.k, None, None, None, None)
    return t, (t.k, t.hi_ema, t.lo_ema, t.overflow_steps, t.shrink_steps)


def _mega_capture(capture, steps, every, n_sites, device, members):
    """A megakernel's histogram buffer: a slot for each of the ``steps //
    every`` intervals and one for the remainder, a set a member."""
    return _cuda.capture_io(capture, steps // every + 1, n_sites, device, members=members)


def _with_counts(res: MegaResult, cap: _cuda.CaptureIO, n_out: int) -> MegaResult:
    """A launch's result with the counts of its histogram buffer: each
    member's interval slots, and their sum with the remainder's."""
    if cap.out is None:
        return res
    return res._replace(exp_time=cap.out[:, :n_out], exp_total=cap.out.sum(dim=1, dtype=torch.int32))


def _kst(sio):
    """The carried storage splits a launch gives back, ``(members, 1)``."""
    return None if sio.k_out is None else sio.k_out[:, None]


def _launch_heat1d(leaves, *, steps, every, tracker, evolve, collect, alpha, dtodx2, prec, sites, plan=None,
                   storage="f32", k_in=None, capture=None):
    (u,) = leaves
    u = u.contiguous()
    if u.dim() != 3 or u.shape[1] != 1:
        raise ValueError(f"heat1d_mega takes (members, 1, nx) rods; got {tuple(u.shape)}")
    members, nx = u.shape[0], u.shape[2]
    plan = plan or rod_plan(1, nx, _cuda.sm_count(u.device))
    if len(sites) != 2:
        raise ValueError(f"heat1d_mega has two sites (flux, update); got {len(sites)}")
    dev = u.device
    u_in, u_out, out, sio = mega_storage(u, storage, k_in)
    snaps = torch.empty((members, steps // every, 1, nx), dtype=torch.float32, device=dev)
    ev = torch.empty((members, steps, 2, 2), dtype=torch.float32, device=dev) if collect else None
    tracker_out, (k, hi, lo, ov, sh) = _tracker_buffers(tracker, evolve, dev)
    # untracked, no host-to-device copy: a CUDA graph captures the launch
    table, ema, one_minus, headroom = _adjust_args(prec, sites, None, dev if evolve else None)
    cap = _mega_capture(capture, steps, every, 2, dev, members)
    err = launch_rod(
        "heat1d", u_in, u_out, plan, br=1, steps=steps, consts=(alpha, dtodx2), prec=prec, ev=ev, k=k,
        tracker_rows=(hi, lo, ov, sh), table=table, evolve=evolve, every=every, snaps=snaps,
        law=(ema, one_minus, headroom), storage=sio, capture=cap,
    )
    _cuda.check(err, "heat1d_mega")
    HEAT1D_MEGA.count(storage, capture=capture is not None)
    return _with_counts(MegaResult((out,), (snaps,), tracker_out, ev, _kst(sio)), cap, steps // every)


#: threads of a CTA of swe2d's grid (csrc/mega_pde.cu): at least, and at most
_SWE2D_THREADS = 256
_SWE2D_MAX_THREADS = 512
#: a CTA keeps its band arrays in shared memory up to this size, else in a
#: slice of device memory
SWE2D_SMEM_LIMIT = _cuda.SMEM_LIMIT


class Swe2DPlan(NamedTuple):
    """The launch shape of swe2d's megakernel (``csrc/mega_pde.cu``)."""

    ctas: int  # the cooperative grid's CTAs a member, one band of rows each
    threads: int  # threads a CTA
    rows: int  # the tallest band's rows
    smem: int  # bytes of shared memory a CTA's band arrays take; 0: they live in device memory
    wave: int = 1  # ensemble members a cooperative grid runs at once (blockIdx.y); the rest in later waves


def swe2d_band_floats(rows: int, ny: int) -> int:
    """Floats of one CTA's band arrays for bands of up to ``rows`` rows:
    two U buffers of ``rows + 1`` rows (the halo row below the band), Ux
    then Fx and the two policy products on ``rows + 2`` rows (a halo row on
    each side), and Gy and two components of the flux G on ``rows + 1``,
    each ``ny`` wide."""
    return (16 * rows + 21) * ny


def swe2d_bands(nx: int, ctas: int):
    """Row ranges ``[r0, r1)`` of the bands, as the kernel cuts them: band b
    is ``[b*nx // ctas, (b+1)*nx // ctas)``; the last is the tallest."""
    return [(b * nx // ctas, (b + 1) * nx // ctas) for b in range(ctas)]


#: the fewest CTAs the plan gives a member of an ensemble before it runs the
#: members in waves instead (16 bands of 8 rows at 128x128)
SWE2D_MIN_MEMBER_CTAS = 16


def member_waves(members: int, wave: int):
    """The waves of an ensemble's members, ``[(first, count), ...]``, as a
    cooperative launch of ``wave`` members at a time runs them."""
    return [(m0, min(wave, members - m0)) for m0 in range(0, members, wave)]


def swe2d_plan(nx: int, ny: int, *, sms: int = 132, ctas: Optional[int] = None, members: int = 1,
               capacity: Optional[int] = None) -> Swe2DPlan:
    """How K4 runs an ``(nx, ny)`` swe2d state: a cooperative grid of one
    CTA per row (one-row bands were the fastest of one, two and four rows
    timed on the card at the main path's 128x128, PERF.md), at most one CTA
    per SM (``sms``) and at most ``nx - 1`` CTAs, so the last band holds
    both wall rows ``nx - 2`` and ``nx - 1`` (the main path's 128x128 runs
    127 CTAs, the last band two rows); fields with more rows take taller
    bands. A CTA has a thread per point of its tallest band's rows, rounded
    up to 128, from 256 to 512. ``ctas`` asks for another grid (the chip
    checks and timings). Any ``nx, ny >= 3``.

    ``members`` ensemble members each take a grid of their own, side by side
    in one cooperative launch of ``capacity`` resident CTAs (the occupancy
    query's, :func:`swe2d_capacity`; None: as many as asked): where
    ``members * ctas`` exceeds it, each member gets taller bands, down to
    :data:`SWE2D_MIN_MEMBER_CTAS` CTAs (at 128x128 and eight members on 264
    resident CTAs, 33 CTAs of up to four rows), and beyond that the members
    run in waves of ``wave``. A plan is a pure function of its arguments."""
    if min(nx, ny) < 3:
        raise ValueError(f"swe2d needs nx, ny >= 3; got ({nx}, {ny})")
    if members < 1:
        raise ValueError(f"an ensemble has at least one member; got {members}")
    if ctas is None:
        ctas = min(nx, sms)
        if capacity is not None and members * ctas > capacity:
            ctas = max(capacity // members, min(SWE2D_MIN_MEMBER_CTAS, ctas))
    ctas = max(1, min(ctas, nx - 1))
    rows = -(-nx // ctas)
    threads = min(max(-(-rows * ny // 128) * 128, _SWE2D_THREADS), _SWE2D_MAX_THREADS)
    nbytes = 4 * swe2d_band_floats(rows, ny)
    wave = members if capacity is None else max(1, min(members, capacity // ctas))
    return Swe2DPlan(ctas, threads, rows, nbytes if nbytes <= SWE2D_SMEM_LIMIT else 0, wave)


def swe2d_capacity(plan: Swe2DPlan, device, n_bins: int = 0) -> int:
    """The CTAs of ``plan``'s shape (its threads and shared memory, with a
    capture histogram of ``n_bins`` bins) one cooperative grid of K4 holds
    on ``device`` (the occupancy query of ``csrc/mega_pde.cu``)."""
    with torch.cuda.device(device):
        got = _cuda.library().r2f2_swe2d_capacity(plan.threads, plan.smem, n_bins)
    if got < 0:
        raise RuntimeError(f"the occupancy query of swe2d_mega failed: cudaError {-got}")
    return got


def _swe2d_member_plan(nx, ny, members, device, n_bins):
    """The default plan of ``members`` members on the card: planned against
    the resident CTAs of the one-member plan's shape, then of its own."""
    sms = _cuda.sm_count(device)
    plan = swe2d_plan(nx, ny, sms=sms)
    if members == 1:
        return plan
    capacity = swe2d_capacity(plan, device, n_bins)
    for _ in range(3):  # a taller band changes the CTA's shape, and so what fits
        plan = swe2d_plan(nx, ny, sms=sms, members=members, capacity=capacity)
        got = swe2d_capacity(plan, device, n_bins)
        if got == capacity:
            break
        capacity = got
    return swe2d_plan(nx, ny, sms=sms, ctas=plan.ctas, members=members, capacity=capacity)


def swe2d_grid_scratch(nx, ny, plan: Swe2DPlan, device, members=1):
    """The grid's scratch a member, whatever the number of substeps: Ux in a
    ring of two substeps (f32, ``(2, 3, nx-1, ny)``), the band arrays of
    every CTA when they do not fit shared memory (else None), each CTA's
    maxima at a substep's two grid barriers and at the storage rounding's
    (int32, ``(3, ctas)``, written before they are read) and the 64-bit
    barrier counter (zeroed)."""
    ux = torch.empty(members * 2 * 3 * (nx - 1) * ny, dtype=torch.float32, device=device)
    bands = None if plan.smem else torch.empty(members * plan.ctas * swe2d_band_floats(plan.rows, ny),
                                               dtype=torch.float32, device=device)
    words = torch.empty(members * 3 * plan.ctas, dtype=torch.int32, device=device)
    count = torch.zeros(members, dtype=torch.int64, device=device)
    return ux, bands, words, count


def _launch_swe2d(leaves, *, steps, every, tracker, evolve, collect, cfg, prec, sites, site_ops, plan=None,
                  storage="f32", k_in=None, capture=None):
    (U,) = leaves
    U = U.contiguous()
    if U.dim() != 4 or U.shape[1] != 3 or min(U.shape[2:]) < 3:
        raise ValueError(f"swe2d_mega takes (members, 3, nx, ny) states with nx, ny >= 3; got {tuple(U.shape)}")
    if len(sites) != 4 or _site_ops(sites, site_ops) != ("mul", "mul", "mul", "div"):
        raise ValueError(f"swe2d_mega's sites are (q1q1, q3q3, gq3, div) as mul, mul, mul, div; got {site_ops}")
    members, _, nx, ny = U.shape
    dev = U.device
    plan = plan or _swe2d_member_plan(nx, ny, members, dev, 0 if capture is None else capture.n_bins)
    n_out = steps // every
    if k_in is not None:
        raise ValueError("swe2d's megakernel takes f32 state: swe2d_mega decodes a packed carry first")
    _, _, out, sio = mega_storage(U, storage, None)
    snaps = torch.empty((members, n_out, 3, nx, ny), dtype=torch.float32, device=dev)
    ev = torch.empty((members, steps, 4, 2), dtype=torch.float32, device=dev) if collect else None
    if plan.threads % 32 or not 32 <= plan.threads <= _SWE2D_MAX_THREADS:
        raise ValueError(f"swe2d_mega's CTAs have a multiple of 32 threads up to {_SWE2D_MAX_THREADS}; got {plan}")
    ux, bands, words, count = swe2d_grid_scratch(nx, ny, plan, dev, members)
    tracker_out, (k, hi, lo, ov, sh) = _tracker_buffers(tracker, evolve, dev)
    # untracked, no host-to-device copy: a CUDA graph captures the launch
    table, ema, one_minus, headroom = _adjust_args(prec, sites, site_ops, dev if evolve else None)
    consts = [float(f32_scalar(v, "cpu")) for v in (
        cfg.dt / (2 * cfg.dx), cfg.dt / (2 * cfg.dy), cfg.dt / cfg.dx, cfg.dt / cfg.dy, 0.5 * 9.81,
    )]
    cap = _mega_capture(capture, steps, every, 4, dev, members)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        # k is the floor the run starts from; the kernel latches it per CTA
        # and writes the evolved rows back into k, hi, lo, ov, sh at the end
        err = lib.r2f2_swe2d_mega(
            _cuda.ptr(U), _cuda.ptr(out), _cuda.ptr(snaps), _cuda.ptr(ev), _cuda.ptr(ux), _cuda.ptr(bands),
            _cuda.ptr(words), _cuda.ptr(count), _cuda.ptr(k), _cuda.ptr(k), _cuda.ptr(hi), _cuda.ptr(lo), _cuda.ptr(ov),
            _cuda.ptr(sh), _cuda.ptr(table), int(evolve), members, min(plan.wave, members), nx, ny, steps, every,
            plan.ctas, plan.threads, plan.rows, plan.smem, *consts, ema, one_minus, headroom,
            *_cuda.policy_args(prec, fused_family(prec.mode)), *sio.args(), *cap.args(), _cuda.stream_of(U),
        )
    _cuda.check(err, "swe2d_mega")
    SWE2D_MEGA.count(storage, capture=capture is not None)
    return _with_counts(MegaResult((out,), (snaps,), tracker_out, ev, _kst(sio)), cap, n_out)


def _launch_k5(leaves, *, steps, every, tracker, evolve, collect, body, nx, ny, consts, prec, sites, cluster=None,
               plan=None, storage="f32", k_in=None, capture=None):
    """Launch one K5 megakernel on the ``(members, 1, nx*ny)`` leaves
    (``pde_steps.k5_plan``'s shape, a member each)."""
    (u,) = leaves
    u = u.contiguous()
    if u.shape[1:] != (1, nx * ny) or len(sites) != 2:
        raise ValueError(f"{body}_mega takes (members, 1, {nx * ny}) leaves and two sites; got {tuple(u.shape)}, "
                         f"{len(sites)} sites")
    members = u.shape[0]
    plan = k5_plan(body, nx, ny, u.device, cluster, plan)
    dev = u.device
    u_in, u_out, out, sio = mega_storage(u, storage, k_in)
    snaps = torch.empty((members, steps // every, 1, nx * ny), dtype=torch.float32, device=dev)
    ev = torch.empty((members, steps, 2, 2), dtype=torch.float32, device=dev) if collect else None
    tracker_out, (k, hi, lo, ov, sh) = _tracker_buffers(tracker, evolve, dev)
    # untracked, no host-to-device copy: a CUDA graph captures the launch
    table, ema, one_minus, headroom = _adjust_args(prec, sites, None, dev if evolve else None)
    cap = _mega_capture(capture, steps, every, 2, dev, members)
    err = launch_k5(
        body, u_in, u_out, plan, nx=nx, ny=ny, consts=consts, prec=prec, steps=steps, ev=ev, k=k,
        tracker_rows=(hi, lo, ov, sh), table=table, evolve=evolve, every=every, snaps=snaps,
        law=(ema, one_minus, headroom), storage=sio, capture=cap,
    )
    _cuda.check(err, f"{body}_mega")
    BODIES[body].mega.count(storage, capture=capture is not None)
    return _with_counts(MegaResult((out,), (snaps,), tracker_out, ev, _kst(sio)), cap, steps // every)


# ---------------------------------------------------------------------------
# per-stepper whole-horizon entries (the steppers' mega_step hooks)
# ---------------------------------------------------------------------------


def _lead(u0, view, members):
    """A stepper's leaf as the kernel's one 2-D leaf (after the member dim,
    with ``members``), a result back (a packed one too: f32 leaves under
    packed storage come back packed), and a member's shape."""
    packed = isinstance(u0, PackedArray)
    shape = u0.shape if packed else tuple(u0.shape[1:] if members else u0.shape)
    first = () if packed or not members else tuple(u0.shape[:1])

    def unwrap(o):
        if isinstance(o, PackedArray):
            return o.with_view(shape)
        return o.reshape(tuple(o.shape[:1] if members else ()) + shape)

    return (u0.with_view(view) if packed else u0.reshape(first + view)), unwrap, shape


def _snaps(snaps, shape, members):
    """The kernel's snapshots ``(n_out, *view)`` (a member dim first with
    ``members``) as ``(n_out, *shape)``."""
    lead = snaps.shape[:2] if members else snaps.shape[:1]
    return snaps.reshape(tuple(lead) + tuple(shape))


def heat1d_mega(
    u0, *, alpha, dtodx2, prec, steps, every, sites, tracker=None, collect_evidence=False,
    capture=None, storage="f32", plain=False, members=False, _plan=None,
) -> MegaResult:
    """Whole-horizon 1-D heat run of the ``(nx,)`` rod (a PackedArray under
    packed storage); snapshots come back as ``(n_out, nx)``. ``members=True``
    takes ``(members, nx)`` ensemble members (a PackedArray's payload and
    splits lead with the member) with ``(members, 2)`` tracker rows, one
    block each in one launch; every result field then leads with the
    member. ``_plan`` asks the kernel for another launch shape than
    ``rod.rod_plan``'s (the chip checks and timings)."""
    nx = u0.shape[-1]
    lead, unwrap, _ = _lead(u0, (1, nx), members)
    kernel = functools.partial(_launch_heat1d, alpha=alpha, dtodx2=dtodx2, prec=prec, sites=tuple(sites), plan=_plan)
    res = mega_sweep(
        _heat1d_body(float(alpha), float(dtodx2), sites), (lead,), prec=prec, sites=sites,
        steps=steps, every=every, tracker=tracker, collect_evidence=collect_evidence, kernel=kernel,
        counter=HEAT1D_MEGA, plain=plain, capture=capture, storage=storage, members=members,
    )
    (out,), (snaps,) = res.state, res.snaps
    return res._replace(state=unwrap(out), snaps=_snaps(snaps, (nx,), members))


def _swe2d_body(cfg, sites):
    """One whole Lax-Wendroff update: the substituted momentum flux on the
    megakernel's FusedOps, every other sub-equation in f32."""
    from repro_torch.pde.swe2d import _lw_step, _momentum_flux

    def body(state, ops):
        (U,) = state
        return (_lw_step(U, cfg, lambda q1, q3: _momentum_flux(q1, q3, ops)),)

    return body


def swe2d_mega(
    U0, *, cfg, prec, steps, every, sites, site_ops, tracker=None, collect_evidence=False,
    capture=None, storage="f32", plain=False, members=False, _plan=None,
) -> MegaResult:
    """Whole-horizon shallow-water run of the stacked ``(3, nx, ny)`` state.
    Packed storage takes the reference's host-pack shape: a packed carry is
    decoded here, the kernel rounds at boundaries and gives the carried
    split back, and :func:`mega_sweep` packs the final state at it.
    ``members=True`` takes ``(members, 3, nx, ny)`` ensemble members, each
    on its own bands of one cooperative launch (:func:`swe2d_plan`).
    ``_plan`` asks the kernel for another launch shape than
    :func:`swe2d_plan`'s (the chip checks and timings)."""
    if isinstance(U0, PackedArray):
        U0 = unpack_members(U0, plain=plain) if members else unpack_array(U0, plain=plain)
    kernel = functools.partial(
        _launch_swe2d, cfg=cfg, prec=prec, sites=tuple(sites), site_ops=tuple(site_ops), plan=_plan,
    )
    res = mega_sweep(
        _swe2d_body(cfg, sites), (U0,), prec=prec, sites=sites, site_ops=site_ops, steps=steps, every=every,
        tracker=tracker, collect_evidence=collect_evidence, kernel=kernel, counter=SWE2D_MEGA, plain=plain,
        capture=capture, storage=storage, members=members,
    )
    (out,), (snaps,) = res.state, res.snaps
    return res._replace(state=out, snaps=snaps)


def _k5_mega(body, fn, u0, nx, ny, consts, *, prec, steps, every, sites, tracker, collect_evidence, capture, storage, plain,
             cluster=None, plan=None, members=False):
    kernel = functools.partial(
        _launch_k5, body=body, nx=nx, ny=ny, consts=consts, prec=prec, sites=tuple(sites), cluster=cluster, plan=plan,
    )
    lead, unwrap, shape = _lead(u0, (1, nx * ny), members)
    res = mega_sweep(
        fn, (lead,), prec=prec, sites=sites, steps=steps, every=every, tracker=tracker,
        collect_evidence=collect_evidence, kernel=kernel, counter=BODIES[body].mega, plain=plain,
        capture=capture, storage=storage, members=members,
    )
    (out,), (snaps,) = res.state, res.snaps
    return res._replace(state=unwrap(out), snaps=_snaps(snaps, shape, members))


def heat2d_mega(
    u0, *, alpha, dtodx2, prec, steps, every, sites, tracker=None, collect_evidence=False,
    capture=None, storage="f32", plain=False, members=False, _cluster=None, _plan=None,
) -> MegaResult:
    """Whole-horizon 2-D heat run of the ``(nx, ny)`` field (``members=True``:
    ``(members, nx, ny)``, a cluster a member); snapshots come back as
    ``(n_out, nx, ny)``. ``_cluster`` asks the kernel for a cluster
    size other than the plan's, ``_plan`` for a grid shape (the chip checks
    and timings)."""
    nx, ny = u0.shape[-2:]
    alpha, dtodx2 = float(alpha), float(dtodx2)
    return _k5_mega(
        "heat2d", _heat2d_body(nx, ny, alpha, dtodx2, sites), u0, nx, ny, (alpha, dtodx2), prec=prec, steps=steps,
        every=every, sites=sites, tracker=tracker, collect_evidence=collect_evidence, capture=capture,
        storage=storage, plain=plain, cluster=_cluster, plan=_plan, members=members,
    )


def advection1d_mega(
    u0, *, speed, dtodx, prec, steps, every, sites, tracker=None, collect_evidence=False,
    capture=None, storage="f32", plain=False, members=False, _plan=None,
) -> MegaResult:
    """Whole-horizon upwind advection run of the ``(nx,)`` profile
    (``members=True``: ``(members, nx)``). ``_plan``
    asks the kernel for another launch shape than ``rod.rod_plan``'s."""
    speed, dtodx = float(speed), float(dtodx)
    return _k5_mega(
        "advection1d", _advection1d_body(speed, dtodx, sites), u0, 1, u0.shape[-1], (speed, dtodx), prec=prec,
        steps=steps, every=every, sites=sites, tracker=tracker, collect_evidence=collect_evidence,
        capture=capture, storage=storage, plain=plain, plan=_plan, members=members,
    )


def burgers1d_mega(
    u0, *, dt, dx, prec, steps, every, sites, tracker=None, collect_evidence=False,
    capture=None, storage="f32", plain=False, members=False, _plan=None,
) -> MegaResult:
    """Whole-horizon Lax-Friedrichs Burgers run of the ``(nx,)`` wave
    (``members=True``: ``(members, nx)``).
    ``_plan`` asks the kernel for another launch shape than ``rod.rod_plan``'s."""
    dt, dx = float(dt), float(dx)
    return _k5_mega(
        "burgers1d", _burgers1d_body(dt, dx, sites), u0, 1, u0.shape[-1], (dt / (2.0 * dx), 0.5), prec=prec,
        steps=steps, every=every, sites=sites, tracker=tracker, collect_evidence=collect_evidence,
        capture=capture, storage=storage, plain=plain, plan=_plan, members=members,
    )

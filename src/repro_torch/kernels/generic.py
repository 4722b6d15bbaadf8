"""Kernels K8 and K9: any fused body on the card.

``fused_sweep`` and ``mega_sweep`` launch a body's own CUDA kernel where its
hook passes one (``kernel=``: K2-K5 for the builtin steppers). A body
without one (a stepper added with ``register_stepper``) is traced into a
tape (``kernels/tape.py``) and run by one of two generic kernels of
``csrc/generic_body.cu``:

* K8 (:func:`sweep_kernel`): ``fused_sweep``'s contract, one CTA per split
  block and ensemble member, the block's state and every intermediate in
  device memory, a CTA barrier after each row of the tape; evidence per
  block, the floor or the pinned split, capture over the valid lanes of a
  padded grid, packed storage decoded in the prologue and encoded at a
  fresh split in the epilogue;
* K9 (:func:`mega_kernel`): ``mega_sweep``'s contract, one CTA per member
  for the whole horizon, with the adjust unit ticked per site per
  substep, the floor latched at snapshot boundaries, snapshots, the storage
  rounding there and packed I/O.

Both build with the other sources (``kernels/_cuda.py::SOURCES``), once: a
body needs no compile of its own. :data:`GENERIC_SWEEP` and
:data:`GENERIC_MEGA` count their launches. Their plain version is the
plain version of ``fused_sweep`` and ``mega_sweep``: the body under
``FusedOps``.

Replaces the TPU kernels ``repro/kernels/fused.py::_sweep_kernel`` and
``repro/kernels/mega.py::_mega_kernel`` for any other body than the five
builtins'.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.policy import PrecisionConfig
from repro_torch.kernels import _cuda
from repro_torch.kernels.tape import tape_for
from repro_torch.precision.fusion import fused_family

__all__ = ["GENERIC_SWEEP", "GENERIC_MEGA", "sweep_kernel", "mega_kernel", "family_op", "MAX_LEAVES", "MAX_SITES"]

#: launches of K8 and K9
GENERIC_SWEEP = _cuda.KernelCounter("generic_sweep")
GENERIC_MEGA = _cuda.KernelCounter("generic_mega")
#: the most state leaves and sites the kernels take (csrc/generic_body.cu)
MAX_LEAVES = 8
MAX_SITES = 64

_DEVICE_TAPES = {}


def _on_device(tape, device):
    """The tape's rows and constants on ``device`` (kept while the tape is)."""
    key = (id(tape), str(device))
    hit = _DEVICE_TAPES.get(key)
    if hit is None or hit[0] is not tape:
        if len(_DEVICE_TAPES) > 256:
            _DEVICE_TAPES.clear()
        hit = (tape, tape.code.to(device), tape.out_code.to(device), tape.consts.to(device))
        _DEVICE_TAPES[key] = hit
    return hit[1:]


def _threads(tape) -> int:
    """A thread per element of the tape's widest row, in warps, 64 to 1024."""
    return max(64, min(1024, -(-tape.max_n // 32) * 32))


def _ptrs(tensors):
    return (ctypes.c_void_p * max(len(tensors), 1))(*[t.data_ptr() for t in tensors])


def _limits(n_leaves, n_sites):
    if n_leaves > MAX_LEAVES or n_sites > MAX_SITES:
        raise ValueError(f"the generic kernels take up to {MAX_LEAVES} leaves and {MAX_SITES} sites; "
                         f"got {n_leaves} and {n_sites}")


def _check_capture_shapes(tape, br, bw, extent):
    """The plain version's rule for capture on a padded grid
    (``FusedOps._valid_mask``), checked on the tape's operand shapes."""
    rows, width = extent
    for ab, _ in tape.policy_shapes:
        if rows is not None and (len(ab) != 2 or ab[0] != br):
            raise ValueError(f"capture on a row-padded grid needs body operands to keep the block row extent {br}; "
                             f"got shape {tuple(ab)}")
        if width is not None and (len(ab) != 2 or ab[1] != bw):
            raise ValueError(f"capture on a width-padded grid needs body operands to keep the block width {bw}; "
                             f"got shape {tuple(ab)}")


def _launch_sweep(leaves, *, br, bw, gi, gj, k_floor, collect, body, prec, sites, site_ops, steps, n_out, k_in=None,
                  capture=None, extent=None):
    n_state, n_sites = len(leaves), len(sites)
    _limits(max(n_state, n_out), n_sites)
    dev = leaves[0].device
    tape = tape_for(body, [(br, bw)] * n_state, prec=prec, sites=sites, site_ops=site_ops,
                    out_shapes=[(br, bw)] * n_out, device=dev)
    tape.check_sites(sites, collect)
    if capture is not None and extent is not None:
        _check_capture_shapes(tape, br, bw, extent)
    leaves = [x.contiguous() for x in leaves]
    members, rows, width = leaves[0].shape
    packed = k_in is not None
    state = max(n_state, n_out) * br * bw
    stride = 2 * state + tape.scratch
    work = torch.empty(members * gi * gj * stride, dtype=torch.float32, device=dev)
    outs = [torch.empty_like(leaves[0]) for _ in range(n_out)]
    ev = torch.empty((members, gi, gj, steps, n_sites, 2), dtype=torch.float32, device=dev) if collect else None
    k_in_t = torch.stack([k.to(dev, torch.int32) for k in k_in]).contiguous() if packed else None
    k_out = torch.empty((n_out, members), dtype=torch.int32, device=dev) if packed else None
    valid_rows, valid_cols = (0, 0) if extent is None else (extent[0] or 0, extent[1] or 0)
    cap = _cuda.capture_io(capture, 1, n_sites, dev, valid_rows, valid_cols, members=members)
    floor = None if k_floor is None else k_floor.to(dev, torch.int32).contiguous()
    code, out_code, consts = _on_device(tape, dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.r2f2_generic_sweep(
            _cuda.ptr(code), code.shape[0], _cuda.ptr(out_code), out_code.shape[0], _cuda.ptr(consts),
            _cuda.ptr(work), stride, state, tape.scratch, _ptrs(leaves), _ptrs(outs), n_state, n_out,
            _cuda.ptr(k_in_t), _cuda.ptr(k_out), leaves[0].element_size(), int(packed), _cuda.ptr(ev),
            _cuda.ptr(floor), members, rows, width, br, bw, gi, gj, steps, n_sites, _threads(tape),
            *_cuda.policy_args(prec, fused_family(prec.mode)), *cap.args(), _cuda.stream_of(leaves[0]),
        )
    _cuda.check(err, "generic_sweep")
    GENERIC_SWEEP.count("packed" if packed else "f32", capture=capture is not None)
    res = [outs, ev] if not packed else [outs, ev, list(k_out)]
    return tuple(res) if capture is None else (*res, cap.out[:, 0])


def sweep_kernel(body, *, prec, sites, site_ops, steps, n_out):
    """K8 as the ``kernel=`` of :func:`repro_torch.kernels.fused.fused_sweep`
    for ``body``."""
    return functools.partial(_launch_sweep, body=body, prec=prec, sites=tuple(sites),
                             site_ops=None if site_ops is None else tuple(site_ops), steps=steps, n_out=n_out)


def _launch_mega(leaves, *, steps, every, tracker, evolve, collect, storage="f32", k_in=None, capture=None, body, prec,
                 sites, site_ops):
    from repro_torch.kernels.mega import MegaResult, _adjust_args, _mega_capture, _tracker_buffers, _with_counts

    n_state, n_sites = len(leaves), len(sites)
    _limits(n_state, n_sites)
    dev = leaves[0].device
    leaves = [x.contiguous() for x in leaves]
    members = leaves[0].shape[0]
    shapes = [tuple(x.shape[1:]) for x in leaves]
    tape = tape_for(body, shapes, prec=prec, sites=sites, site_ops=site_ops, out_shapes=shapes, device=dev)
    tape.check_sites(sites, collect or evolve)
    packed = k_in is not None
    rounding = storage != "f32"
    has_floor = tracker is not None and prec.pinned
    n_out = steps // every
    stride = 2 * tape.state_size + tape.scratch
    work = torch.empty(members * stride, dtype=torch.float32, device=dev)
    outs = [torch.empty_like(x) if packed else torch.empty_like(x, dtype=torch.float32) for x in leaves]
    snaps = [torch.empty((members, n_out) + s, dtype=torch.float32, device=dev) for s in shapes]
    ev = torch.empty((members, steps, n_sites, 2), dtype=torch.float32, device=dev) if collect else None
    kst = torch.empty((members, n_state), dtype=torch.int32, device=dev) if rounding else None
    k_in_t = torch.stack([k.to(dev, torch.int32) for k in k_in]).contiguous() if packed else None
    tracker_out, (k, hi, lo, ov, sh) = _tracker_buffers(tracker, evolve, dev)
    table, ema, one_minus, headroom = _adjust_args(prec, sites, site_ops, dev if evolve else None)
    cap = _mega_capture(capture, steps, every, n_sites, dev, members)
    code, out_code, consts = _on_device(tape, dev)
    offs = (ctypes.c_int * n_state)(*tape.leaf_offsets)
    sizes = (ctypes.c_int * n_state)(*[x[0].numel() for x in leaves])
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.r2f2_generic_mega(
            _cuda.ptr(code), code.shape[0], _cuda.ptr(out_code), out_code.shape[0], _cuda.ptr(consts),
            _cuda.ptr(work), stride, tape.state_size, tape.scratch, _ptrs(leaves), _ptrs(outs), _ptrs(snaps), offs,
            sizes, n_state, _cuda.ptr(k_in_t), _cuda.ptr(kst), leaves[0].element_size(), int(packed),
            int(rounding), _cuda.ptr(ev), *map(_cuda.ptr, (k, hi, lo, ov, sh)), _cuda.ptr(table), int(evolve),
            int(has_floor), members, steps, every, n_sites, _threads(tape), ema, one_minus, headroom,
            *_cuda.policy_args(prec, fused_family(prec.mode)), *cap.args(), _cuda.stream_of(leaves[0]),
        )
    _cuda.check(err, "generic_mega")
    GENERIC_MEGA.count(storage, capture=capture is not None)
    return _with_counts(MegaResult(tuple(outs), tuple(snaps), tracker_out, ev, kst), cap, n_out)


#: the ops of K1's harness (csrc/generic_body.cu::family_op_kernel)
FAMILY_OPS = {"rsqrt_rn": 0, "add": 1, "rsqrt": 2}


def family_op(op, a, b=None, *, prec=None, k=0):
    """K1's add and rsqrt on the card, elementwise over CUDA tensors:
    ``"rsqrt_rn"`` the bare ``__frsqrt_rn``, ``"add"`` and ``"rsqrt"`` the
    policy's ``family_add``/``family_rsqrt`` at split ``k`` (the chip checks
    hold them against ``core/rsqrt.py`` and ``FusedOps`` on the CPU)."""
    prec = PrecisionConfig(mode="f32") if prec is None else prec
    a = a.to(torch.float32).contiguous()
    b = None if b is None else b.to(torch.float32).contiguous()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = _cuda.library().r2f2_family_op(
            FAMILY_OPS[op], _cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(out), a.numel(), int(k),
            *_cuda.policy_args(prec, fused_family(prec.mode)), _cuda.stream_of(a),
        )
    _cuda.check(err, "family_op")
    return out


def mega_kernel(body, *, prec, sites, site_ops):
    """K9 as the ``kernel=`` of :func:`repro_torch.kernels.mega.mega_sweep`
    for ``body``."""
    return functools.partial(_launch_mega, body=body, prec=prec, sites=tuple(sites),
                             site_ops=None if site_ops is None else tuple(site_ops))

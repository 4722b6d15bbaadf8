"""Kernel K3: the fused SWE momentum flux (``swe_flux_fused``).

The paper's substituted sub-equation (§5.3), ``q1*q1/q3 + (0.5g)*(q3*q3)``:
three multiplier sites and the ``swe.div`` flexible-divider site, one split
per ``(br, bw)`` tile, the final add in f32 (fused into the ``g/2 * t3``
product for the f32 and bf16 families, as the compiled reference is). ``q3`` pads with 1.0 so a
padded divisor stays finite.

Replaces the TPU kernel ``repro/kernels/fused.py::fused_sweep``
(``_sweep_kernel``) running ``repro/kernels/swe_flux.py::_swe_flux_body``
through ``swe_flux_fused``. At the paper's size the split tile is the whole
``(127, 128)`` field: 130 KB read and 65 KB written, about 0.06 us of HBM
time, against ~16k elements of integer rounding work behind four tile-wide
maxima, so one CTA on one of 132 SMs is bound by operations and latency.
The CUDA kernel (``csrc/fused_pde.cu::swe_flux_kernel``) therefore runs each
split tile as one thread-block cluster of up to 16 CTAs
(:func:`cluster_plan`), each owning a band of the tile's rows: it loads its
band once into shared memory, the cluster takes each pair of tile maxima
through distributed shared memory after a cluster barrier, and each CTA
writes its band of the flux once. Its floor is the launch and three cluster
barriers.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.policy import PrecisionConfig
from repro_torch.kernels import _cuda
from repro_torch.kernels.fused import fused_sweep
from repro_torch.precision.fusion import fused_family

__all__ = [
    "G_GRAV", "SWE_SITES", "SWE_OPS", "SWE_FLUX", "cluster_plan", "swe_flux_fused", "swe_flux_fused_plain", "swe_flux_pallas",
]

G_GRAV = 9.81
DEFAULT_BLOCK = (64, 128)
SWE_SITES = ("swe.q1q1", "swe.q3q3", "swe.gq3", "swe.div")
SWE_OPS = ("mul", "mul", "mul", "div")
#: launches of the CUDA kernel and runs of the plain version
SWE_FLUX = _cuda.KernelCounter("swe_flux_fused")
#: the CUDA kernel's threads per CTA and its largest cluster (non-portable)
CTA_THREADS = 256
MAX_CLUSTER = 16


def cluster_plan(br, bw):
    """``(C, band)``: the CTAs of the thread-block cluster that runs one
    ``(br, bw)`` split tile, and the rows each owns (the last CTA the rest).
    Bands of at least one row and of at least one element per thread, at
    most MAX_CLUSTER CTAs; every CTA owns at least one row."""
    band = max(-(-br // MAX_CLUSTER), -(-CTA_THREADS // bw), 1)
    return -(-br // band), band


def _swe_flux_body(sites):
    """The momentum flux on one tile (the plain version)."""
    q1q1_site, q3q3_site, gq3_site, div_site = sites

    def body(state, ops):
        q1, q3 = state
        t1 = ops.mul(q1, q1, q1q1_site)
        t2 = ops.div(t1, q3, div_site)
        t3 = ops.mul(q3, q3, q3q3_site)
        return (ops.mul_add(torch.full_like(t3, 0.5 * G_GRAV), t3, t2, gq3_site),)  # t2 + t4

    return body


def _launch(leaves, *, br, bw, gi, gj, k_floor, collect, prec, n_sites, capture=None, extent=None):
    q1, q3 = (x.contiguous() for x in leaves)
    members, rows, width = q1.shape
    if n_sites != 4:
        raise ValueError(f"swe_flux_fused has four sites (q1q1, q3q3, gq3, div); got {n_sites}")
    cluster, band = cluster_plan(br, bw)
    if 3 * band * bw * 4 > _cuda.SMEM_LIMIT:
        raise ValueError(f"a ({br}, {bw}) tile needs {3 * band * bw * 4} B of shared memory per CTA; "
                         f"the kernel takes at most {_cuda.SMEM_LIMIT} B")
    valid_rows, valid_cols = (rows, width) if extent is None else (extent[0] or rows, extent[1] or width)
    cap = _cuda.capture_io(capture, 1, n_sites, q1.device, valid_rows, valid_cols, members=members)
    out = torch.empty_like(q1)
    ev = torch.empty((members, gi, gj, 1, n_sites, 2), dtype=torch.float32, device=q1.device) if collect else None
    lib = _cuda.library()
    with torch.cuda.device(q1.device):
        err = lib.r2f2_swe_flux(
            _cuda.ptr(q1), _cuda.ptr(q3), _cuda.ptr(out), _cuda.ptr(ev), _cuda.ptr(k_floor),
            members, rows, width, br, bw, cluster, band, 0.5 * G_GRAV,
            *_cuda.policy_args(prec, fused_family(prec.mode)), *cap.args(), _cuda.stream_of(q1),
        )
    _cuda.check(err, "swe_flux_fused")
    SWE_FLUX.count(capture=capture is not None)
    return ([out], ev) if capture is None else ([out], ev, cap.out[:, 0])


def _flux(q1, q3, *, prec, block, sites, site_ops, k_floor, collect_evidence, capture, plain, members=False):
    if tuple(site_ops) != SWE_OPS:
        raise ValueError(f"swe_flux_fused's sites are {SWE_OPS} ops; got {tuple(site_ops)}")
    block = tuple(prec.kernel_blocks[:2]) if block is None else tuple(block)
    kernel = functools.partial(_launch, prec=prec, n_sites=len(sites))
    (out,), *rest = fused_sweep(
        _swe_flux_body(sites), (q1, q3), prec=prec, sites=sites, site_ops=site_ops, steps=1,
        block=block, n_out=1, pad_values=(0.0, 1.0), k_floor=k_floor,
        collect_evidence=collect_evidence, kernel=kernel, counter=SWE_FLUX, plain=plain, capture=capture,
        members=members,
    )
    return (out, *rest)


def swe_flux_fused(
    q1, q3, *, prec, block=None, sites=SWE_SITES, site_ops=SWE_OPS, k_floor=None,
    collect_evidence=False, capture=None, members=False,
):
    """Momentum flux over 2-D fields ``q1 = hu``, ``q3 = h``; ``block``
    defaults to ``prec.kernel_blocks[:2]``. Returns ``(flux, evidence)``
    with evidence ``(1, 4, 2)`` or None, and with ``capture`` the ``(4, 2,
    n_bins)`` counts of the valid midpoints (pad lanes never count) last.
    ``members=True`` takes ``(members, rows, width)`` ensemble members with
    ``(members, 4)`` floors in one launch, each member's tiles its own (a
    tile never takes another member's rows); the evidence and counts then
    lead with the member."""
    return _flux(
        q1, q3, prec=prec, block=block, sites=sites, site_ops=site_ops, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, plain=False, members=members,
    )


def swe_flux_fused_plain(
    q1, q3, *, prec, block=None, sites=SWE_SITES, site_ops=SWE_OPS, k_floor=None, collect_evidence=False, capture=None,
    members=False,
):
    """The plain PyTorch version of :func:`swe_flux_fused`, on any device."""
    return _flux(
        q1, q3, prec=prec, block=block, sites=sites, site_ops=site_ops, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, plain=True, members=members,
    )


def swe_flux_pallas(q1, q3, *, fmt, block=DEFAULT_BLOCK, tail_approx=True):
    """The historical fmt-keyed surface: rr_tile semantics, no evidence."""
    prec = PrecisionConfig(mode="rr_tile", fmt=fmt, tail_approx=tail_approx)
    out, _ = swe_flux_fused(q1, q3, prec=prec, block=block)
    return out

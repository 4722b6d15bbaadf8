"""Kernel K3: the fused SWE momentum flux (``swe_flux_fused``).

The paper's substituted sub-equation (§5.3), ``q1*q1/q3 + (0.5g)*(q3*q3)``:
three multiplier sites and the ``swe.div`` flexible-divider site, one split
per ``(br, bw)`` tile, the final add in f32 (fused into the ``g/2 * t3``
product for the f32 and bf16 families, as the compiled reference is). ``q3`` pads with 1.0 so a
padded divisor stays finite.

Replaces the TPU kernel ``repro/kernels/fused.py::fused_sweep``
(``_sweep_kernel``) running ``repro/kernels/swe_flux.py::_swe_flux_body``
through ``swe_flux_fused``. The CUDA kernel
(``csrc/fused_pde.cu::swe_flux_kernel``) gives each split tile one CTA that
loops over the tile's elements in three phases: the block maxes of q1 and
q3, the products and their block maxes, then the quotient, the scaled
square and the sum, recomputing the products rather than staging them. At
the paper's size the tile is the whole ``(127, 128)`` field: 130 KB read
and 65 KB written, about 0.06 us of HBM time, while one CTA on one of 132
SMs does ~16k elements of integer rounding work serially behind four
block-wide reductions. It is bound by operations and latency on one SM;
spreading a tile over several CTAs (a cross-CTA max before each phase) is
the change that would address it.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.policy import PrecisionConfig
from repro_torch.kernels import _cuda
from repro_torch.kernels.fused import fused_sweep
from repro_torch.precision.fusion import fused_family

__all__ = ["G_GRAV", "SWE_SITES", "SWE_OPS", "SWE_FLUX", "swe_flux_fused", "swe_flux_fused_plain", "swe_flux_pallas"]

G_GRAV = 9.81
DEFAULT_BLOCK = (64, 128)
SWE_SITES = ("swe.q1q1", "swe.q3q3", "swe.gq3", "swe.div")
SWE_OPS = ("mul", "mul", "mul", "div")
#: launches of the CUDA kernel and runs of the plain version
SWE_FLUX = _cuda.KernelCounter("swe_flux_fused")


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


def _launch(leaves, *, br, bw, gi, gj, k_floor, collect, prec, n_sites):
    q1, q3 = (x.contiguous() for x in leaves)
    rows, width = q1.shape
    if n_sites != 4:
        raise ValueError(f"swe_flux_fused has four sites (q1q1, q3q3, gq3, div); got {n_sites}")
    out = torch.empty_like(q1)
    ev = torch.empty((gi, gj, 1, n_sites, 2), dtype=torch.float32, device=q1.device) if collect else None
    lib = _cuda.library()
    with torch.cuda.device(q1.device):
        err = lib.r2f2_swe_flux(
            _cuda.ptr(q1), _cuda.ptr(q3), _cuda.ptr(out), _cuda.ptr(ev), _cuda.ptr(k_floor),
            rows, width, br, bw, 0.5 * G_GRAV,
            *_cuda.policy_args(prec, fused_family(prec.mode)), _cuda.stream_of(q1),
        )
    _cuda.check(err, "swe_flux_fused")
    SWE_FLUX.launches += 1
    return [out], ev


def _flux(q1, q3, *, prec, block, sites, site_ops, k_floor, collect_evidence, capture, plain):
    if tuple(site_ops) != SWE_OPS:
        raise ValueError(f"swe_flux_fused's sites are {SWE_OPS} ops; got {tuple(site_ops)}")
    block = tuple(prec.kernel_blocks[:2]) if block is None else tuple(block)
    kernel = functools.partial(_launch, prec=prec, n_sites=len(sites))
    (out,), ev = fused_sweep(
        _swe_flux_body(sites), (q1, q3), prec=prec, sites=sites, site_ops=site_ops, steps=1,
        block=block, n_out=1, pad_values=(0.0, 1.0), k_floor=k_floor,
        collect_evidence=collect_evidence, kernel=kernel, counter=SWE_FLUX, plain=plain, capture=capture,
    )
    return out, ev


def swe_flux_fused(
    q1, q3, *, prec, block=None, sites=SWE_SITES, site_ops=SWE_OPS, k_floor=None,
    collect_evidence=False, capture=None,
):
    """Momentum flux over 2-D fields ``q1 = hu``, ``q3 = h``; ``block``
    defaults to ``prec.kernel_blocks[:2]``. Returns ``(flux, evidence)``
    with evidence ``(1, 4, 2)`` or None."""
    return _flux(
        q1, q3, prec=prec, block=block, sites=sites, site_ops=site_ops, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=capture, plain=False,
    )


def swe_flux_fused_plain(
    q1, q3, *, prec, block=None, sites=SWE_SITES, site_ops=SWE_OPS, k_floor=None, collect_evidence=False,
):
    """The plain PyTorch version of :func:`swe_flux_fused`, on any device."""
    return _flux(
        q1, q3, prec=prec, block=block, sites=sites, site_ops=site_ops, k_floor=k_floor,
        collect_evidence=collect_evidence, capture=None, plain=True,
    )


def swe_flux_pallas(q1, q3, *, fmt, block=DEFAULT_BLOCK, tail_approx=True):
    """The historical fmt-keyed surface: rr_tile semantics, no evidence."""
    prec = PrecisionConfig(mode="rr_tile", fmt=fmt, tail_approx=tail_approx)
    out, _ = swe_flux_fused(q1, q3, prec=prec, block=block)
    return out

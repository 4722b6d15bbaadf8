"""Kernel K2: the fused 1D heat-equation sweep (``heat1d_sweep``).

One explicit-FD substep is ``u' = u + (alpha * lap) * dtodx2`` on the
interior with the ends pinned: the laplacian adds in f32 and the two
multiplies run on the policy's multiplier at one split per ``(br, nx)``
block. ``steps`` substeps run in one launch.

Replaces the TPU kernel ``repro/kernels/fused.py::fused_sweep``
(``_sweep_kernel``) running ``repro/kernels/heat_stencil.py::_heat1d_body``
through ``heat1d_sweep``. The CUDA kernel
(``csrc/fused_pde.cu::heat1d_sweep_kernel``) gives each row block one CTA
that holds the block in shared memory for the whole chunk. On the main path
the field is one ``(1, 128)`` row, so the work per substep is a few hundred
integer and float operations behind four block-wide reductions: the kernel
is bound by latency (barriers and the serial substep chain), not by bytes
(1 KB in, 1 KB out per chunk) or operations. Keeping the row in shared
memory for all substeps of a chunk is what this design does about it; a
batch of rows spreads over SMs, one CTA per row block.
"""

from __future__ import annotations

import functools

import torch

from repro_torch._device import f32_scalar
from repro_torch.core.policy import PrecisionConfig
from repro_torch.kernels import _cuda
from repro_torch.kernels.fused import fused_sweep
from repro_torch.precision.fusion import fused_family

__all__ = ["HEAT1D_SITES", "HEAT1D_SWEEP", "heat1d_sweep", "heat1d_sweep_plain", "heat_stencil_pallas"]

HEAT1D_SITES = ("heat.flux", "heat.update")
#: launches of the CUDA kernel and runs of the plain version
HEAT1D_SWEEP = _cuda.KernelCounter("heat1d_sweep")
#: shared memory the kernel may take per row block (u and a scratch row)
SMEM_LIMIT = 200 * 1024


def _heat1d_body(alpha, dtodx2, sites):
    """One explicit-FD substep on a ``(br, nx)`` block (the plain version)."""
    flux_site, update_site = sites

    def body(state, ops):
        (u,) = state
        lap = u[:, :-2] - 2.0 * u[:, 1:-1] + u[:, 2:]
        flux = ops.mul(f32_scalar(alpha, u.device), lap, flux_site)
        upd = ops.mul(flux, f32_scalar(dtodx2, u.device), update_site)
        interior = u[:, 1:-1] + upd
        return (torch.cat([u[:, :1], interior, u[:, -1:]], dim=1),)

    return body


def _launch(leaves, *, br, bw, gi, gj, k_floor, collect, alpha, dtodx2, prec, steps, n_sites):
    (u,) = leaves
    u = u.contiguous()
    rows, nx = u.shape
    if n_sites != 2:
        raise ValueError(f"heat1d_sweep has two sites (flux, update); got {n_sites}")
    if nx < 3:
        raise ValueError(f"heat1d_sweep needs nx >= 3; got {nx}")
    smem = 2 * br * nx * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"a ({br}, {nx}) row block needs {smem} B of shared memory; the kernel takes at most {SMEM_LIMIT} B")
    out = torch.empty_like(u)
    ev = torch.empty((gi, gj, steps, n_sites, 2), dtype=torch.float32, device=u.device) if collect else None
    lib = _cuda.library()
    with torch.cuda.device(u.device):
        err = lib.r2f2_heat1d_sweep(
            _cuda.ptr(u), _cuda.ptr(out), _cuda.ptr(ev), _cuda.ptr(k_floor),
            rows, nx, br, steps, float(alpha), float(dtodx2),
            *_cuda.policy_args(prec, fused_family(prec.mode)), _cuda.stream_of(u),
        )
    _cuda.check(err, "heat1d_sweep")
    HEAT1D_SWEEP.launches += 1
    return [out], ev


def _sweep(u0, *, alpha, dtodx2, prec, steps, block_rows, sites, k_floor, collect_evidence, capture, storage, plain):
    alpha, dtodx2 = float(alpha), float(dtodx2)
    kernel = functools.partial(_launch, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, n_sites=len(sites))
    (out,), ev = fused_sweep(
        _heat1d_body(alpha, dtodx2, sites), (u0,), prec=prec, sites=sites, steps=steps,
        block=(block_rows, u0.shape[1]), k_floor=k_floor, collect_evidence=collect_evidence,
        kernel=kernel, counter=HEAT1D_SWEEP, plain=plain, capture=capture, storage=storage,
    )
    return out, ev


def heat1d_sweep(
    u0, *, alpha, dtodx2, prec, steps=1, block_rows=8, sites=HEAT1D_SITES, k_floor=None,
    collect_evidence=False, capture=None, storage="f32",
):
    """Advance ``(rows, nx)`` rods ``steps`` substeps in one launch.
    Returns ``(u, evidence)``; evidence is ``(steps, 2, 2)`` or None."""
    return _sweep(
        u0, alpha=alpha, dtodx2=dtodx2, prec=prec, steps=steps, block_rows=block_rows, sites=sites,
        k_floor=k_floor, collect_evidence=collect_evidence, capture=capture, storage=storage, plain=False,
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

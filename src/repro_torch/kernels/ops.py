"""Public entry points of the kernels, by their historical names.

Each runs its CUDA kernel on CUDA tensors and its plain PyTorch version on
CPU tensors:

    r2f2_quantize   K6 (kernels/r2f2_quantize.py)
    r2f2_matmul     K7 (kernels/r2f2_matmul.py)
    heat_stencil    K2 (kernels/heat_stencil.py), rr_tile semantics
    swe_flux        K3 (kernels/swe_flux.py), rr_tile semantics

``plain_matmul()`` is the one place that sends ``r2f2_matmul`` to K7's plain
version on CUDA tensors too: a comparison of K7 with its plain version on a
whole model runs the model once inside it and once outside.
"""

from __future__ import annotations

import contextlib

from repro_torch.core.flexformat import FlexFormat

from .heat_stencil import heat_stencil_pallas
from .r2f2_matmul import R2F2_MATMUL, r2f2_matmul_plain
from .r2f2_matmul import r2f2_matmul as _r2f2_matmul
from .r2f2_quantize import r2f2_quantize as _r2f2_quantize
from .swe_flux import DEFAULT_BLOCK as _SWE_BLOCK
from .swe_flux import swe_flux_pallas

__all__ = ["r2f2_quantize", "r2f2_matmul", "plain_matmul", "heat_stencil", "swe_flux"]

_plain_matmul = False


@contextlib.contextmanager
def plain_matmul():
    """For the length of the block, :func:`r2f2_matmul` runs K7's plain
    version on any device; each call counts in ``R2F2_MATMUL.plain_calls``."""
    global _plain_matmul
    prev, _plain_matmul = _plain_matmul, True
    try:
        yield
    finally:
        _plain_matmul = prev


def r2f2_quantize(x, fmt: FlexFormat, *, block=(256, 256)):
    """Tile-quantize x to the runtime-selected flexible format. -> (y, k_tiles)"""
    return _r2f2_quantize(x, fmt=fmt, block=block)


def r2f2_matmul(a, b, fmt: FlexFormat, *, blocks=(128, 128, 128), round_products=False, tail_approx=True):
    """A @ B through block-granular R2F2 multipliers (f32 sums)."""
    if _plain_matmul:
        R2F2_MATMUL.plain_calls += 1
        return r2f2_matmul_plain(a, b, fmt=fmt, blocks=blocks, round_products=round_products, tail_approx=tail_approx)
    return _r2f2_matmul(a, b, fmt=fmt, blocks=blocks, round_products=round_products, tail_approx=tail_approx)


def heat_stencil(u0, alpha, dtodx2, fmt: FlexFormat, *, steps=1, block_rows=8, tail_approx=True):
    """Fused heat-equation step(s) with R2F2 multiplies."""
    return heat_stencil_pallas(u0, alpha, dtodx2, fmt=fmt, steps=steps, block_rows=block_rows, tail_approx=tail_approx)


def swe_flux(q1, q3, fmt: FlexFormat, *, block=_SWE_BLOCK, tail_approx=True):
    """Fused SWE momentum flux (the paper's substituted equation) per block."""
    return swe_flux_pallas(q1, q3, fmt=fmt, block=block, tail_approx=tail_approx)

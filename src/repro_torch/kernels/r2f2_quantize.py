"""Kernel K6: per-tile R2F2 quantization (``r2f2_quantize``).

For each ``(bm, bn)`` tile (default ``(256, 256)``): the max finite |x|, the
minimal operand split ``select_k_operand`` of its exponent, and RNE
quantization of the tile to ``E(EB+k) M(MB+FX-k)``. Returns the quantized
matrix and one int32 k per tile; a block that does not divide the shape
raises ``ValueError``.

Replaces the TPU kernel ``repro/kernels/r2f2_quantize.py::r2f2_quantize_pallas``
(``_quantize_kernel``). The CUDA kernel (``csrc/r2f2_quantize.cu``) gives
each tile one CTA that reads the tile twice, a block max and then
quantize-and-write (a 256 KB tile does not fit in shared memory; the second
read comes from L2). It is bound by bytes: 8 B per element, read once and
written once.
"""

from __future__ import annotations

import torch

from repro_torch.core.flexformat import FlexFormat, quantize_em
from repro_torch.core.r2f2 import _finite_max_exp, select_k_operand
from repro_torch.kernels import _cuda

__all__ = ["DEFAULT_BLOCK", "R2F2_QUANTIZE", "r2f2_quantize", "r2f2_quantize_plain"]

DEFAULT_BLOCK = (256, 256)
#: launches of the CUDA kernel and runs of the plain version
R2F2_QUANTIZE = _cuda.KernelCounter("r2f2_quantize")


def _tiles(x, block):
    if x.ndim != 2:
        raise ValueError(f"r2f2_quantize takes a 2-D matrix; got shape {tuple(x.shape)}")
    m, n = x.shape
    bm, bn = min(block[0], m), min(block[1], n)
    if m % bm or n % bn:
        raise ValueError(f"shape {tuple(x.shape)} not divisible by block ({bm},{bn})")
    return m, n, bm, bn


def r2f2_quantize_plain(x, *, fmt: FlexFormat, block=DEFAULT_BLOCK):
    """The plain PyTorch version of :func:`r2f2_quantize`, on any device."""
    x = x.to(torch.float32)
    m, n, bm, bn = _tiles(x, block)
    xt = x.reshape(m // bm, bm, n // bn, bn)
    k = select_k_operand(_finite_max_exp(xt, dim=(1, 3)), fmt)
    kb = k[:, None, :, None]
    y = quantize_em(xt, fmt.eb + kb, fmt.mb + fmt.fx - kb)
    return y.reshape(m, n), k.to(torch.int32)


def r2f2_quantize(x, *, fmt: FlexFormat, block=DEFAULT_BLOCK):
    """Quantize a 2-D f32 matrix tile by tile. Returns ``(y, k_tiles)``.
    A CUDA tensor launches K6; a CPU tensor runs the plain version."""
    m, n, bm, bn = _tiles(x, block)
    if not x.is_cuda:
        R2F2_QUANTIZE.plain_calls += 1
        return r2f2_quantize_plain(x, fmt=fmt, block=block)
    x = x.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    k = torch.empty((m // bm, n // bn), dtype=torch.int32, device=x.device)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.r2f2_quantize(
            _cuda.ptr(x), _cuda.ptr(y), _cuda.ptr(k), m, n, bm, bn, fmt.eb, fmt.mb, fmt.fx, _cuda.stream_of(x)
        )
    _cuda.check(err, "r2f2_quantize")
    R2F2_QUANTIZE.launches += 1
    return y, k

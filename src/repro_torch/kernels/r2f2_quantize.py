"""Kernel K6: per-tile R2F2 quantization (``r2f2_quantize``).

For each ``(bm, bn)`` tile (default ``(256, 256)``): the max finite |x|, the
minimal operand split ``select_k_operand`` of its exponent, and RNE
quantization of the tile to ``E(EB+k) M(MB+FX-k)``. Returns the quantized
matrix and one int32 k per tile; a block that does not divide the shape
raises ``ValueError``.

Replaces the TPU kernel ``repro/kernels/r2f2_quantize.py::r2f2_quantize_pallas``
(``_quantize_kernel``). The CUDA kernel (``csrc/r2f2_quantize.cu``) is
bound by bytes, 8 B per element, and runs in one of two launch shapes that
:func:`quantize_plan` picks from the shapes alone. The cluster shape reads
each element from device memory once: a tile is split over a thread-block
cluster of CTAs (4 of 64 KB at ``(256, 256)``), each loading its rows into
shared memory with 16-byte copies, the tile's max taken across the cluster
through distributed shared memory, then quantized from shared memory and
stored in 16-byte vectors. The two-pass shape (one CTA per tile, a block
max, then quantize-and-write over the same elements read again) takes the
tiles the cluster cannot hold (``(512, 512)`` is 1 MB), tiles under 16 KB,
and rows without 16-byte vectors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

import repro_torch.obs as _obs
from repro_torch.core.flexformat import FlexFormat, quantize_em
from repro_torch.core.r2f2 import _finite_max_exp, select_k_operand
from repro_torch.kernels import _cuda

__all__ = ["DEFAULT_BLOCK", "QuantizePlan", "R2F2_QUANTIZE", "quantize_plan", "r2f2_quantize", "r2f2_quantize_plain"]

DEFAULT_BLOCK = (256, 256)
#: launches of the CUDA kernel and runs of the plain version
R2F2_QUANTIZE = _cuda.KernelCounter("r2f2_quantize")


#: the most shared memory one CTA of the cluster shape fills with its rows
CTA_TILE_BYTES = 64 * 1024
#: the most CTAs a tile's cluster takes (the portable cluster size)
MAX_CLUSTER = 8
#: smaller tiles take the two-pass shape, whose second read finds them in L1
MIN_CLUSTER_TILE_BYTES = 16 * 1024


class QuantizePlan(NamedTuple):
    """The launch shape of K6 (``csrc/r2f2_quantize.cu``)."""

    shape: str  # "cluster" (each element read once) or "two_pass"
    cluster: int  # CTAs per tile in the cluster shape; 0 in the two-pass shape
    rows: int  # tile rows one CTA holds (the cluster shape), or bm
    smem: int  # bytes of shared memory a CTA fills with its rows (the cluster shape)
    ctas: int  # CTAs of the launch


def quantize_plan(m: int, n: int, bm: int, bn: int, *, aligned: bool = True) -> QuantizePlan:
    """How K6 runs an ``(m, n)`` matrix in ``(bm, bn)`` tiles (a block that
    divides the shape): the cluster shape splits a tile over the fewest CTAs
    (a power of two, at most :data:`MAX_CLUSTER`) whose rows fit
    :data:`CTA_TILE_BYTES` each, where ``bn`` allows 16-byte vectors, the matrix is
    16-byte ``aligned``, the cluster divides ``bm`` and the tile is at
    least :data:`MIN_CLUSTER_TILE_BYTES`; every other tile takes the
    two-pass shape, one CTA each."""
    tiles = (m // bm) * (n // bn)
    tile_bytes = 4 * bm * bn
    cluster = 1
    while cluster * CTA_TILE_BYTES < tile_bytes:
        cluster *= 2
    if (not aligned or bn % 4 or tile_bytes < MIN_CLUSTER_TILE_BYTES or cluster > MAX_CLUSTER
            or bm % cluster):
        return QuantizePlan("two_pass", 0, bm, 0, tiles)
    rows = bm // cluster
    return QuantizePlan("cluster", cluster, rows, 4 * rows * bn, tiles * cluster)


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


def r2f2_quantize(x, *, fmt: FlexFormat, block=DEFAULT_BLOCK, _plan: Optional[QuantizePlan] = None):
    """Quantize a 2-D f32 matrix tile by tile. Returns ``(y, k_tiles)``.
    A CUDA tensor launches K6 on the shape of :func:`quantize_plan` (or
    ``_plan``, for the chip checks and timings); a CPU tensor runs the plain
    version."""
    m, n, bm, bn = _tiles(x, block)
    if not x.is_cuda:
        R2F2_QUANTIZE.plain_calls += 1
        return r2f2_quantize_plain(x, fmt=fmt, block=block)
    x = x.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    k = torch.empty((m // bm, n // bn), dtype=torch.int32, device=x.device)
    plan = _plan or quantize_plan(m, n, bm, bn, aligned=x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    lib = _cuda.library()
    with _obs.span("cuda.r2f2_quantize", m=m, n=n), torch.cuda.device(x.device):
        _obs.inc("repro_cuda_dispatch_total", help="CUDA kernel launches entered", kernel="r2f2_quantize")
        err = lib.r2f2_quantize(
            _cuda.ptr(x), _cuda.ptr(y), _cuda.ptr(k), m, n, bm, bn, fmt.eb, fmt.mb, fmt.fx, plan.cluster, plan.rows,
            _cuda.stream_of(x),
        )
    _cuda.check(err, "r2f2_quantize")
    R2F2_QUANTIZE.launches += 1
    return y, k

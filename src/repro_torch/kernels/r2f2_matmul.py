"""Kernel K7: blocked matmul through R2F2 multipliers (``r2f2_matmul``).

``C = A @ B`` for a ``(M, K)`` and a ``(K, N)`` f32 matrix, in ``(bm, bn,
bk)`` blocks (default ``(128, 128, 128)``, each cut to its dim):

* each ``(bm, bk) x (bk, bn)`` block pair shares one split ``k``, the
  minimal one covering both tiles' max exponents and their product bound
  (``select_k``);
* both tiles are quantized to ``E(EB+k) M(MB+FX-k)`` by RNE;
* each output block sums its block pairs in K order in f32: per pair the
  ``bk``-term products (``round_products=True``: each product first rounded
  to the runtime format with the FX-tail truncation), then ``acc += partial``.

Non-divisible shapes are zero-padded to block multiples and the output is
cropped: padded zeros add nothing and never raise a tile max.

Replaces the TPU kernel ``repro/kernels/r2f2_matmul.py::r2f2_matmul_pallas``
(``_matmul_kernel``). The CUDA kernel (``csrc/r2f2_matmul.cu``) runs the same
f32 operations in the same order (no tensor cores: TF32 would round the
operands) and chooses only where and when they run. :func:`split_plan` gives
each K block its own CTA where the output grid leaves SMs idle (the router,
and the shared expert at decode, where the work is bound by the bytes of B):
each CTA writes its block pair's partial into a ``(gk, M, N)`` scratch
buffer and a second small kernel folds the partials in K order, so a split
launch gives the bits of an unsplit one. :func:`ring_plan` sizes the ring of
shared-memory slots through which every CTA streams its tiles with
``cp.async``. At the shared expert's prefill shape (256 x 5120 @ 5120 x 8192)
the kernel is bound by f32 operations, at decode (4 rows) by the bytes of B.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.flexformat import FlexFormat, quantize_em
from repro_torch.core.r2f2 import _finite_max_exp, product_guard_bits, select_k
from repro_torch.kernels import _cuda

__all__ = [
    "DEFAULT_BLOCKS", "MAX_BLOCK", "R2F2_MATMUL", "Plan", "k_ranges", "launch_plan", "r2f2_matmul", "r2f2_matmul_plain",
    "ring_plan", "split_plan",
]

DEFAULT_BLOCKS = (128, 128, 128)
#: the CUDA kernel's largest output block edge (16 threads x 8 outputs)
MAX_BLOCK = 128
#: K rows per ring slot of the CUDA kernel (csrc/r2f2_matmul.cu kChunk)
RING_CHUNK = 32
#: the largest (gk, M, N) f32 scratch a split launch may take
SCRATCH_CAP = 64 * 2**20
#: launches of the CUDA kernel and runs of the plain version
R2F2_MATMUL = _cuda.KernelCounter("r2f2_matmul")


def _shapes(a, b, blocks):
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"r2f2_matmul takes 2-D matrices; got {tuple(a.shape)} @ {tuple(b.shape)}")
    (m, kdim), (k2, n) = a.shape, b.shape
    if kdim != k2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    return m, n, kdim, min(blocks[0], m), min(blocks[1], n), min(blocks[2], kdim)


def split_plan(m, n, kdim, blocks=DEFAULT_BLOCKS, n_sms=132, scratch_cap=SCRATCH_CAP) -> int:
    """CTAs along K of one launch: every K block its own CTA (``S = gk``)
    where the output grid has fewer blocks than the card has SMs and the
    ``(gk, m, n)`` f32 scratch of the partials fits ``scratch_cap`` bytes;
    else 1 (one CTA walks all K blocks of its output block)."""
    bm, bn, bk = min(blocks[0], m), min(blocks[1], n), min(blocks[2], kdim)
    gm, gn, gk = -(-m // bm), -(-n // bn), -(-kdim // bk)
    if gk > 1 and gm * gn < n_sms and gk * m * n * 4 <= scratch_cap:
        return gk
    return 1


def k_ranges(gk, splits):
    """The contiguous K-block range ``[j0, j1)`` of each CTA along K, as the
    kernel computes it from ``blockIdx.z``."""
    return [(z * gk // splits, (z + 1) * gk // splits) for z in range(splits)]


def ring_plan(bm, bn, bk, tiles_per_cta, smem_limit=_cuda.SMEM_LIMIT):
    """``(slots, bytes)`` of a CTA's ring: slots of ``RING_CHUNK`` K rows
    (an A chunk ``(bm, 32)`` and a B chunk ``(32, bn)``, bn rounded up to
    4), enough for one K block, or two where the CTA walks several and
    shared memory holds them. Raises if one K block does not fit."""
    chunks = -(-bk // RING_CHUNK)
    slot_bytes = 4 * RING_CHUNK * (bm + -(-bn // 4) * 4)
    slots = min(chunks * (2 if tiles_per_cta > 1 else 1), smem_limit // slot_bytes)
    if slots < chunks:
        raise ValueError(f"blocks ({bm}, {bn}, {bk}) need {chunks * slot_bytes} B of shared memory for one K block; "
                         f"the kernel takes at most {smem_limit} B")
    return slots, slots * slot_bytes


class Plan(NamedTuple):
    """One launch of the CUDA kernel: the cut blocks, the grid (gn, gm, S),
    the ring and the CTA count."""

    bm: int
    bn: int
    bk: int
    gm: int
    gn: int
    gk: int
    splits: int
    slots: int
    smem: int
    ctas: int


def launch_plan(m, n, kdim, blocks=DEFAULT_BLOCKS, n_sms=132, split=True) -> Plan:
    """The launch :func:`r2f2_matmul` makes for these shapes on a card of
    ``n_sms`` SMs (``split=False``: one CTA per output block)."""
    bm, bn, bk = min(blocks[0], m), min(blocks[1], n), min(blocks[2], kdim)
    if bm > MAX_BLOCK or bn > MAX_BLOCK:
        raise ValueError(f"the CUDA r2f2_matmul takes output blocks up to {MAX_BLOCK}; got ({bm}, {bn})")
    gm, gn, gk = -(-m // bm), -(-n // bn), -(-kdim // bk)
    splits = split_plan(m, n, kdim, blocks, n_sms) if split else 1
    slots, smem = ring_plan(bm, bn, bk, -(-gk // splits))
    return Plan(bm, bn, bk, gm, gn, gk, splits, slots, smem, gm * gn * splits)


def r2f2_matmul_plain(a, b, *, fmt: FlexFormat, blocks=DEFAULT_BLOCKS, round_products=False, tail_approx=True):
    """The plain PyTorch version of :func:`r2f2_matmul`, on any device.

    Every block pair's products are formed at once for each split value the
    pairs use, and the pairs are summed in K order. With ``round_products``
    the ``(bm, bk, bn)`` products of every block pair are materialized: keep
    that to small shapes."""
    m, n, kdim, bm, bn, bk = _shapes(a, b, blocks)
    a = F.pad(a.to(torch.float32), (0, -kdim % bk, 0, -m % bm))
    b = F.pad(b.to(torch.float32), (0, -n % bn, 0, -kdim % bk))
    gm, gn, gk = a.shape[0] // bm, b.shape[1] // bn, a.shape[1] // bk
    at = a.reshape(gm, bm, gk, bk).permute(2, 0, 1, 3).contiguous()  # (gk, gm, bm, bk)
    bt = b.reshape(gk, bk, gn, bn).permute(0, 2, 1, 3).contiguous()  # (gk, gn, bk, bn)
    k = select_k(_finite_max_exp(at, dim=(2, 3))[:, :, None], _finite_max_exp(bt, dim=(2, 3))[:, None, :], fmt)
    partial = torch.zeros((gk, gm, gn, bm, bn), dtype=torch.float32, device=a.device)
    for v in torch.unique(k).tolist():
        e_bits, m_bits = fmt.eb + v, fmt.mb + fmt.fx - v
        aq, bq = quantize_em(at, e_bits, m_bits), quantize_em(bt, e_bits, m_bits)
        if round_products:
            prods = aq[:, :, None, :, :, None] * bq[:, None, :, None, :, :]  # (gk, gm, gn, bm, bk, bn)
            guard = product_guard_bits(fmt, v) if tail_approx else None
            p = quantize_em(prods, e_bits, m_bits, tail_trunc_bits=guard).sum(dim=4)
        else:
            p = torch.einsum("kibx,kjxc->kijbc", aq, bq)
        partial = torch.where((k == v)[..., None, None], p, partial)
    acc = torch.zeros((gm, gn, bm, bn), dtype=torch.float32, device=a.device)
    for kk in range(gk):
        acc = acc + partial[kk]
    return acc.permute(0, 2, 1, 3).reshape(gm * bm, gn * bn)[:m, :n]


def r2f2_matmul(a, b, *, fmt: FlexFormat, blocks=DEFAULT_BLOCKS, round_products=False, tail_approx=True, _split=True):
    """``A @ B`` through block-granular R2F2 multipliers, f32 sums. CUDA
    tensors launch K7; CPU tensors run the plain version. ``_split=False``
    keeps one CTA per output block (a check that the split gives the same
    bits), not a user option."""
    m, n, kdim, bm, bn, bk = _shapes(a, b, blocks)
    if not a.is_cuda:
        R2F2_MATMUL.plain_calls += 1
        return r2f2_matmul_plain(a, b, fmt=fmt, blocks=blocks, round_products=round_products, tail_approx=tail_approx)
    if b.device != a.device:
        raise ValueError(f"r2f2_matmul operands on {a.device} and {b.device}")
    plan = launch_plan(m, n, kdim, blocks, _cuda.sm_count(a.device), split=_split)
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    scratch = torch.empty((plan.gk, m, n), dtype=torch.float32, device=a.device) if plan.splits > 1 else None
    lib = _cuda.library()
    with torch.cuda.device(a.device):
        err = lib.r2f2_matmul(
            _cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(out), _cuda.ptr(scratch), m, n, kdim, bm, bn, bk, plan.splits,
            plan.slots, fmt.eb, fmt.mb, fmt.fx, int(round_products), int(tail_approx), _cuda.stream_of(a),
        )
    _cuda.check(err, "r2f2_matmul")
    R2F2_MATMUL.launches += 1
    return out

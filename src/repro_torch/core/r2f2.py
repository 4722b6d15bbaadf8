"""R2F2, the paper's runtime-reconfigurable multiplier (§4), in two forms.

``r2f2_multiply`` is the tile-wise form. A vector machine scans operand tiles before multiplying, so the hardware's
"overflow -> grow exponent -> retry" loop collapses into one pre-pass that
picks, per tile, the minimal exponent width ``k in [0, FX]`` covering the
operands and their product. Products are rounded with the paper's
flexible-region approximation: ``MB + 1 + k`` guard bits survive below the
result mantissa before the final round-to-nearest-even.

``r2f2_mul_sequential`` is the hardware-faithful state machine of Fig. 5:
a stream of scalar products carrying the current split ``k``, growing the
exponent and retrying on overflow or underflow, shrinking it when operands
and result all show exponent redundancy, and counting both events (§5.3).

Split widths are computed in integer logic (``_ceil_log2``), never with a
floating ``log2``: a ``log2`` that is one ulp off at a power of two moves
``k``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .flexformat import FlexFormat, _bits, exponent_redundant, quantize_em_with_flags, unbiased_exponent

__all__ = [
    "R2F2Stats",
    "OPS",
    "product_guard_bits",
    "op_bounds",
    "select_k",
    "select_k_op",
    "select_k_operand",
    "r2f2_multiply",
    "SequentialState",
    "sequential_init",
    "r2f2_mul_sequential",
]

#: operations the adjust unit knows an exponent envelope for
OPS = ("mul", "add", "div", "rsqrt")

#: inputs to ``_ceil_log2`` are clamped here; every caller clips the result
#: far below, and integers up to 2**24 convert to f32 exactly
_CLAMP = 1 << 24


class R2F2Stats(NamedTuple):
    """Diagnostics returned by the tile-wise multiplier."""

    k: torch.Tensor  # per-tile chosen flexible split
    overflow_count: torch.Tensor
    underflow_count: torch.Tensor


def product_guard_bits(fmt: FlexFormat, k):
    """Guard bits kept below the result-mantissa LSB: ``MB + 1 + k``."""
    return fmt.mb + 1 + k


def _ceil_log2(n: torch.Tensor) -> torch.Tensor:
    """ceil(log2(n)) for integer n >= 1, exactly: the exponent field of the
    exactly-representable f32 ``n - 1`` is floor(log2(n - 1))."""
    n = n.to(torch.int64).clamp(1, _CLAMP)
    return torch.where(n <= 1, 0, unbiased_exponent((n - 1).to(torch.float32)) + 1)


def _needed_e_bits(max_exp, eb: int, fx: int) -> torch.Tensor:
    """Smallest e_bits in [eb, eb+fx] with emax(e) = 2**(e-1) - 1 >= max_exp."""
    need = torch.as_tensor(max_exp).to(torch.int64).clamp_min(0)
    return (_ceil_log2(need + 1) + 1).clamp(eb, eb + fx)


def _needed_e_bits_lo(min_exp, eb: int, fx: int) -> torch.Tensor:
    """Smallest e_bits in [eb, eb+fx] with emin(e) = 2 - 2**(e-1) <= min_exp."""
    t = (2 - torch.as_tensor(min_exp).to(torch.int64)).clamp_min(1)
    return (_ceil_log2(t) + 1).clamp(eb, eb + fx)


def _k_cover(hi, lo, fmt: FlexFormat) -> torch.Tensor:
    """Split whose format covers the integer exponent envelope ``[lo, hi]``."""
    e = torch.maximum(_needed_e_bits(hi, fmt.eb, fmt.fx), _needed_e_bits_lo(lo, fmt.eb, fmt.fx))
    return e - fmt.eb


def select_k(a_max_exp, b_max_exp, fmt: FlexFormat) -> torch.Tensor:
    """Minimal split such that both operand cluster tops and their product
    neither overflow nor flush in ``E(EB+k)``."""
    ae = torch.as_tensor(a_max_exp).to(torch.int64)
    be = torch.as_tensor(b_max_exp).to(torch.int64)
    hi = torch.maximum(torch.maximum(ae, be), ae + be + 1)
    lo = torch.minimum(torch.minimum(ae, be), ae + be)
    return _k_cover(hi, lo, fmt)


def op_bounds(ae, be, op: str = "mul"):
    """Exponent envelope ``(hi, lo)`` of one operation on clusters topped at
    ``(ae, be)``, computed in f32 as the reference does."""
    if op not in OPS:
        raise ValueError(f"unknown alu op {op!r}; known: {OPS}")
    ae = torch.as_tensor(ae).to(torch.float32)
    be = torch.as_tensor(be).to(torch.float32)
    if op == "mul":
        hi = torch.maximum(torch.maximum(ae, be), ae + be + 1)
        lo = torch.minimum(torch.minimum(ae, be), ae + be)
    elif op == "add":
        hi = torch.maximum(ae, be) + 1
        lo = torch.minimum(ae, be)
    elif op == "div":
        hi = torch.maximum(torch.maximum(ae, be), ae - be + 1)
        lo = torch.minimum(torch.minimum(ae, be), ae - be - 1)
    else:  # rsqrt
        r_hi = torch.ceil(-ae / 2.0)
        r_lo = torch.floor(-(ae + 1.0) / 2.0)
        hi = torch.maximum(ae, r_hi)
        lo = torch.minimum(ae, r_lo)
    return hi, lo


def select_k_op(a_max_exp, b_max_exp, fmt: FlexFormat, op: str = "mul") -> torch.Tensor:
    """Minimal split covering one operation's envelope; ``"mul"`` equals
    :func:`select_k`. The envelope is integer-valued for integer inputs."""
    hi, lo = op_bounds(a_max_exp, b_max_exp, op)
    return _k_cover(hi, lo, fmt)


def select_k_operand(max_exp, fmt: FlexFormat) -> torch.Tensor:
    """Minimal split keeping a single operand tile's top a normal."""
    return _k_cover(max_exp, max_exp, fmt)


def _finite_max_exp(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Max unbiased exponent over finite entries (-127 for none or all
    zero). The max of non-negative floats is the max of their bit patterns,
    and any |x| below 2**-126 has exponent field 0, so this equals the
    reference's ``unbiased_exponent(max(max|x|, tiny))``."""
    u = _bits(x) & 0x7FFFFFFF
    u = torch.where(u >= 0x7F800000, 0, u)
    m = u.amax() if dim is None else u.amax(dim=dim)
    return (m >> 23) - 127


def _tile_max_exp(x: torch.Tensor, tile_shape: Optional[Tuple[int, ...]]):
    """Per-tile max unbiased exponent; returns (max_exp_tiles, broadcast_fn).
    ``tile_shape`` None means one value for the whole tensor."""
    if tile_shape is None:
        return _finite_max_exp(x), (lambda t: t)
    if len(tile_shape) != x.ndim:
        raise ValueError(f"tile_shape rank {len(tile_shape)} != operand rank {x.ndim}")
    for d, t in zip(x.shape, tile_shape):
        if d % t != 0:
            raise ValueError(f"tile {tile_shape} does not divide shape {x.shape}")
    split = []
    for d, t in zip(x.shape, tile_shape):
        split += [d // t, t]
    me = _finite_max_exp(x.reshape(split), dim=tuple(range(1, 2 * x.ndim, 2)))

    def broadcast(t):
        t = torch.as_tensor(t)
        expand = t.reshape(tuple(s for pair in zip(t.shape, (1,) * x.ndim) for s in pair))
        full = tuple(s for pair in zip(t.shape, tile_shape) for s in pair)
        return expand.expand(full).reshape(x.shape)

    return me, broadcast


def r2f2_multiply(a, b, fmt: FlexFormat, *, k=None, tile_shape=None, tail_approx: bool = True):
    """Tile-wise R2F2 elementwise product. ``k``: fixed split, or None to
    pick the minimal split per tile. Returns ``(product, R2F2Stats)``."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if k is None:
        ae, bcast = _tile_max_exp(a, tile_shape)
        be, _ = _tile_max_exp(b, tile_shape)
        k_tile = select_k(ae, be, fmt)
        k_full = bcast(k_tile)
    else:
        k_tile = torch.as_tensor(k, device=a.device).to(torch.int64)
        k_full = k_tile
    e_bits = fmt.eb + k_full
    m_bits = fmt.mb + fmt.fx - k_full
    qa, oa, ua = quantize_em_with_flags(a, e_bits, m_bits)
    qb, ob, ub = quantize_em_with_flags(b, e_bits, m_bits)
    guard = product_guard_bits(fmt, k_full) if tail_approx else None
    qp, op_, up = quantize_em_with_flags(qa * qb, e_bits, m_bits, tail_trunc_bits=guard)
    stats = R2F2Stats(
        k=k_tile,
        overflow_count=(oa | ob | op_).sum(),
        underflow_count=(ua | ub | up).sum(),
    )
    return qp, stats


# ---------------------------------------------------------------------------
# Hardware-faithful sequential mode (paper Fig. 5 state machine).
# ---------------------------------------------------------------------------


class SequentialState(NamedTuple):
    k: torch.Tensor  # current flexible split (int32 scalar)
    overflow_adjusts: torch.Tensor  # times precision was increased (paper §5.3)
    redundancy_adjusts: torch.Tensor  # times precision was decreased


def sequential_init(fmt: FlexFormat, k0: int = 0, *, device="cpu") -> SequentialState:
    del fmt
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return SequentialState(k=torch.tensor(int(k0), dtype=torch.int32, device=device), overflow_adjusts=zero,
                           redundancy_adjusts=zero.clone())


def _mul_at_k(a, b, fmt: FlexFormat, k, tail_approx: bool):
    e_bits, m_bits = fmt.eb + k, fmt.mb + fmt.fx - k
    qa, oa, ua = quantize_em_with_flags(a, e_bits, m_bits)
    qb, ob, ub = quantize_em_with_flags(b, e_bits, m_bits)
    guard = product_guard_bits(fmt, k) if tail_approx else None
    qp, op_, up = quantize_em_with_flags(qa * qb, e_bits, m_bits, tail_trunc_bits=guard)
    return qp, oa | ob | op_ | ua | ub | up


def r2f2_mul_sequential(a_stream, b_stream, fmt: FlexFormat, *, k0: int = 0, tail_approx: bool = True):
    """Run a stream of scalar multiplications through the paper's adjustment
    unit (Fig. 5), element by element:

      1. multiply at the current split ``k``;
      2. on overflow or underflow grow the exponent (``k += 1``) and retry,
         up to the FX budget;
      3. else, when both operands and the result show exponent redundancy
         (the two-bits-after-MSB rule), shrink it (``k -= 1``) for the
         products that follow.

    The stream starts at split ``k0``. Returns ``(products,
    SequentialState)`` with the adjustment counters the paper reports.

    The splits are the whole stream's carried state, so the elements run one
    after another; every retry is evaluated on the whole stream at once and
    the state machine reads the flags per element.
    """
    a = torch.as_tensor(a_stream).to(torch.float32).reshape(-1)
    b = torch.as_tensor(b_stream).to(torch.float32).reshape(-1)
    dev = a.device
    # faults and products at every split, for every element: k walks [0, fx]
    faults, prods = [], []
    for kk in range(fmt.fx + 1):
        p, f = _mul_at_k(a, b, fmt, kk, tail_approx)
        prods.append(p)
        faults.append(f)
    fault = torch.stack(faults).cpu().tolist()
    red = [
        (exponent_redundant(a, fmt.eb + kk) & exponent_redundant(b, fmt.eb + kk)
         & exponent_redundant(prods[kk], fmt.eb + kk)).cpu().tolist()
        for kk in range(fmt.fx + 1)
    ]
    k, n_up_total, n_red_total = int(k0), 0, 0
    ks = []
    for i in range(a.numel()):
        n_up = 0
        for _ in range(fmt.fx + 1):
            if not fault[k][i]:
                break
            if k >= fmt.fx:
                break
            k += 1
            n_up += 1
        ks.append(k)
        shrink = red[k][i] and k > 0 and n_up == 0
        n_up_total += n_up
        n_red_total += int(shrink)
        k -= int(shrink)
    idx = torch.tensor(ks, dtype=torch.int64, device=dev)
    products = torch.stack(prods).gather(0, idx[None]).reshape(-1) if ks else a.new_empty((0,))
    state = SequentialState(
        k=torch.tensor(k, dtype=torch.int32, device=dev),
        overflow_adjusts=torch.tensor(n_up_total, dtype=torch.int32, device=dev),
        redundancy_adjusts=torch.tensor(n_red_total, dtype=torch.int32, device=dev),
    )
    return products, state

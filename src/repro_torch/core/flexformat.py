"""Flexible floating-point formats (paper §4.1, Fig. 4a), in PyTorch.

A FlexFormat ``<EB, MB, FX>`` is a fixed-total-bitwidth floating point layout:

    [ 1 sign | EB fixed exponent | MB fixed mantissa | FX flexible bits ]

At runtime ``k`` of the FX flexible bits go to the exponent and ``FX - k``
to the mantissa, giving an IEEE-style format ``E(EB+k) M(MB+FX-k)`` with
``bias = emax = 2**(e-1) - 1``, ``emin = 2 - 2**(e-1)``, subnormals, signed
zero and overflow to +-inf.

Every function here is bit-exact: rounding is done with integer arithmetic
on the f32 encoding. PyTorch has no shifts on uint32 tensors, so the bit
work runs on int64 tensors that hold the unsigned 32-bit pattern; every
value stays below 2**32, so arithmetic right shifts equal logical ones.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "FlexFormat",
    "quantize_em",
    "quantize_em_with_flags",
    "quantize_product",
    "max_normal",
    "min_normal",
    "min_subnormal",
    "exponent_bias",
    "unbiased_exponent",
    "exponent_redundant",
    "pack_r2f2",
    "unpack_r2f2",
    "E5M10",
    "E5M9",
    "E5M8",
    "E8M23",
]

_F32_MANT_BITS = 23
_F32_EXP_BITS = 8
_F32_BIAS = 127
_U32_MASK = 0xFFFFFFFF
_ABS_MASK = 0x7FFFFFFF
_SIGN_MASK = 0x80000000
_INF_BITS = 0x7F800000


@dataclasses.dataclass(frozen=True)
class FlexFormat:
    """The paper's ``<EB, MB, FX>`` flexible format descriptor."""

    eb: int  # fixed exponent bits
    mb: int  # fixed mantissa bits
    fx: int  # flexible bits (runtime-assignable to exponent or mantissa)

    def __post_init__(self):
        if self.eb < 2:
            raise ValueError("need >=2 fixed exponent bits")
        if self.mb < 1:
            raise ValueError("need >=1 fixed mantissa bits")
        if self.fx < 0:
            raise ValueError("FX must be >= 0")
        if self.eb + self.fx > _F32_EXP_BITS:
            raise ValueError("exponent cannot exceed f32's 8 bits (emulation substrate)")
        if self.mb + self.fx > _F32_MANT_BITS:
            raise ValueError("mantissa cannot exceed f32's 23 bits (emulation substrate)")

    @property
    def total_bits(self) -> int:
        return 1 + self.eb + self.mb + self.fx

    def em(self, k):
        """Effective (exponent_bits, mantissa_bits) when ``k`` flex bits go to exponent."""
        return self.eb + k, self.mb + self.fx - k

    def k_range(self):
        return 0, self.fx

    def __str__(self) -> str:  # paper notation
        return f"<{self.eb},{self.mb},{self.fx}>"


# Fixed IEEE-style formats used as baselines in the paper (FX = 0).
E5M10 = FlexFormat(5, 10, 0)  # standard half
E5M9 = FlexFormat(5, 9, 0)
E5M8 = FlexFormat(5, 8, 0)
E8M23 = FlexFormat(8, 23, 0)  # f32 itself (identity quantization)


def _i64(v, device) -> torch.Tensor:
    """An int or int tensor as an int64 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.tensor(v, dtype=torch.int64, device=device)


def _shl(a, s):
    """``a << s`` for int64 tensors (or a Python int ``a``)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(s, a)
    return torch.bitwise_left_shift(a, s)


def _device_of(*vs):
    for v in vs:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def exponent_bias(e_bits) -> torch.Tensor:
    e = _i64(e_bits, _device_of(e_bits))
    return _shl(1, e - 1) - 1


def _emin(e):
    return 2 - _shl(1, e - 1)


def max_normal(e_bits, m_bits) -> torch.Tensor:
    """Largest finite value of E(e)M(m), as f32."""
    dev = _device_of(e_bits, m_bits)
    e, m = _i64(e_bits, dev), _i64(m_bits, dev)
    return _scale_pow2(2.0 - _pow2(-m), _shl(1, e - 1) - 1)


def min_normal(e_bits) -> torch.Tensor:
    return _pow2(_emin(_i64(e_bits, _device_of(e_bits))))


def min_subnormal(e_bits, m_bits) -> torch.Tensor:
    dev = _device_of(e_bits, m_bits)
    return _pow2(_emin(_i64(e_bits, dev)) - _i64(m_bits, dev))


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The unsigned f32 bit pattern of ``x`` as int64."""
    return x.to(torch.float32).view(torch.int32).to(torch.int64) & _U32_MASK


def _from_bits(u: torch.Tensor) -> torch.Tensor:
    """An unsigned 32-bit pattern held in int64 back to f32."""
    signed = ((u & _U32_MASK) ^ _SIGN_MASK) - _SIGN_MASK
    return signed.to(torch.int32).view(torch.float32)


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """Exact 2**n as f32 for integer n in [-149, 127], built from bits."""
    normal = _from_bits((n.clamp(-126, 127) + 127) << _F32_MANT_BITS)
    sub = _from_bits(_shl(1, (n + 149).clamp(0, _F32_MANT_BITS)))
    return torch.where(n >= -126, normal, sub)


def _scale_pow2(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Exact x * 2**n in two power-of-two multiplies, for |n| <= 254."""
    h1 = n.clamp(-126, 127)
    return x * _pow2(h1) * _pow2(n - h1)


def unbiased_exponent(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(|x|)) for normal f32 inputs, via bit extraction (int64)."""
    return ((_bits(x) & _ABS_MASK) >> _F32_MANT_BITS) - _F32_BIAS


def _round_mantissa_rne(u_abs: torch.Tensor, m_bits: torch.Tensor) -> torch.Tensor:
    """RNE-round the sign-stripped f32 encoding ``u_abs`` to ``m_bits`` of
    mantissa; a carry out of the mantissa moves into the exponent field."""
    shift = _F32_MANT_BITS - m_bits
    half = _shl(1, shift) >> 1
    lsb = torch.bitwise_right_shift(u_abs, shift) & 1
    rounded = u_abs + torch.where(shift > 0, half - 1 + lsb, 0)
    return rounded & ~(_shl(1, shift) - 1)


def quantize_em_with_flags(x, e_bits, m_bits, tail_trunc_bits=None):
    """Bit-exact RNE quantization of f32 ``x`` to E(e)M(m).

    ``e_bits``/``m_bits`` may be ints or integer tensors broadcastable
    against ``x``. Returns ``(y, overflow, underflow)``. ``tail_trunc_bits``
    ``t`` first truncates the mantissa toward zero to ``m_bits + t`` bits
    (the paper's flexible-region product approximation). Inputs below
    2**-126 are treated as signed zero, matching the reference's explicit
    flush of f32 subnormals.
    """
    x = x.to(torch.float32)
    dev = x.device
    e_bits = _i64(e_bits, dev)
    m_bits = _i64(m_bits, dev)

    u = _bits(x)
    sign = u & _SIGN_MASK
    u_abs = u & _ABS_MASK
    u_abs = torch.where((u_abs >> _F32_MANT_BITS) == 0, 0, u_abs)

    is_nan = torch.isnan(x)
    is_inf = torch.isinf(x)

    if tail_trunc_bits is not None:
        keep = (m_bits + _i64(tail_trunc_bits, dev)).clamp(1, _F32_MANT_BITS)
        u_abs = u_abs & ~(_shl(1, _F32_MANT_BITS - keep) - 1)

    r = _round_mantissa_rne(u_abs, m_bits)
    r_exp = (r >> _F32_MANT_BITS) - _F32_BIAS
    half_range = _shl(1, e_bits - 1)
    emax = half_range - 1
    emin = 2 - half_range

    overflow = (r_exp > emax) & ~is_nan
    y_norm = _from_bits(sign | r)

    # subnormal path: one rounding of the (possibly truncated) magnitude
    x_mag = _from_bits(u_abs)
    sub_ulp_exp = emin - m_bits
    scaled = _scale_pow2(x_mag, -sub_ulp_exp)
    y_sub_mag = _scale_pow2(torch.round(scaled), sub_ulp_exp)
    y_sub = torch.where(sign != 0, -y_sub_mag, y_sub_mag)

    x_exp = (u_abs >> _F32_MANT_BITS) - _F32_BIAS
    in_sub_range = (x_exp < emin) & (u_abs != 0)
    rounded_to_normal = y_sub.abs() >= _pow2(emin)

    y = torch.where(in_sub_range, y_sub, y_norm)
    y = torch.where(overflow | is_inf, _from_bits(sign | _INF_BITS), y)
    y = torch.where(is_nan, x, y)
    y = torch.where(u_abs == 0, _from_bits(sign), y)

    underflow = in_sub_range & ~rounded_to_normal & ~is_nan
    overflow = overflow | (is_inf & ~is_nan)
    return y, overflow, underflow


def quantize_em(x, e_bits, m_bits, tail_trunc_bits=None):
    """Value-only variant of :func:`quantize_em_with_flags`."""
    return quantize_em_with_flags(x, e_bits, m_bits, tail_trunc_bits)[0]


def quantize_product(p, e_bits, m_bits, fx_guard_bits):
    """Round an exact f32 product to E(e)M(m) with the paper's FX-tail
    truncation approximation (§4.1, Fig. 4b)."""
    return quantize_em_with_flags(p, e_bits, m_bits, tail_trunc_bits=fx_guard_bits)


def exponent_redundant(x, e_bits) -> torch.Tensor:
    """The paper's redundancy detector (§4.2): in the biased exponent of
    ``x`` under an ``e_bits``-wide exponent, the two bits after the MSB both
    being the complement of the MSB mean one flexible bit can go back to the
    mantissa."""
    x = torch.as_tensor(x).to(torch.float32)
    e = _i64(e_bits, x.device)
    biased = unbiased_exponent(x) + exponent_bias(e)
    msb = torch.bitwise_right_shift(biased, e - 1) & 1
    b1 = torch.bitwise_right_shift(biased, e - 2) & 1
    b2 = torch.where(e >= 3, torch.bitwise_right_shift(biased, (e - 3).clamp_min(0)) & 1, 1 - msb)
    return (x.abs() > 0) & (b1 == 1 - msb) & (b2 == 1 - msb)


# ---------------------------------------------------------------------------
# The storage layout (Fig. 4a): sign | exp | mantissa in 1 + EB + MB + FX
# bits, with the split k kept out of band. The payloads are unsigned bit
# patterns held in int64 tensors (PyTorch has no uint32 shifts on the CPU).
# ---------------------------------------------------------------------------


def pack_r2f2(x, fmt: FlexFormat, k) -> torch.Tensor:
    """Encode quantized f32 values (``quantize_em`` output at the same
    split) into the ``total_bits``-wide payload, as int64. A NaN keeps its
    sign and takes the canonical mantissa ``1 << (m - 1)``."""
    x = torch.as_tensor(x).to(torch.float32)
    k = _i64(k, x.device)
    e_bits = fmt.eb + k
    m_bits = fmt.mb + fmt.fx - k
    u = _bits(x)
    sign = u >> 31
    f32_exp = (u & _ABS_MASK) >> _F32_MANT_BITS
    mant32 = u & ((1 << _F32_MANT_BITS) - 1)
    bias = _shl(1, e_bits - 1) - 1
    emin = _emin(e_bits)
    unb = f32_exp - _F32_BIAS

    is_zero = (u & _ABS_MASK) == 0
    is_inf = torch.isinf(x)
    is_nan = torch.isnan(x)
    is_sub = (~is_zero) & (unb < emin)

    mant_norm = torch.bitwise_right_shift(mant32, _F32_MANT_BITS - m_bits)
    # subnormal: the mantissa field is round(|x| / 2**(emin - m)), half to even
    mant_sub = torch.round(_scale_pow2(x.abs(), -(emin - m_bits))).to(torch.int64)

    exp_field = torch.where(is_sub | is_zero, 0, unb + bias)
    exp_field = torch.where(is_inf | is_nan, _shl(1, e_bits) - 1, exp_field)
    mant_field = torch.where(is_sub, mant_sub, torch.where(is_zero | is_inf, 0, mant_norm))
    mant_field = torch.where(is_nan, _shl(1, m_bits - 1), mant_field)
    return _shl(sign, e_bits + m_bits) | _shl(exp_field, m_bits) | mant_field


def unpack_r2f2(payload, fmt: FlexFormat, k) -> torch.Tensor:
    """Decode :func:`pack_r2f2` payloads (any integer dtype) back to f32."""
    payload = torch.as_tensor(payload).to(torch.int64) & _U32_MASK
    k = _i64(k, payload.device)
    e_bits = fmt.eb + k
    m_bits = fmt.mb + fmt.fx - k
    mant = (payload & (_shl(1, m_bits) - 1)).to(torch.float32)
    expf = torch.bitwise_right_shift(payload, m_bits) & (_shl(1, e_bits) - 1)
    sign = torch.bitwise_right_shift(payload, e_bits + m_bits) & 1
    bias = _shl(1, e_bits - 1) - 1
    emin = _emin(e_bits)

    is_sub = expf == 0
    is_special = expf == _shl(1, e_bits) - 1
    mag_norm = _scale_pow2(1.0 + mant * _pow2(-m_bits), expf - bias)
    mag_sub = _scale_pow2(mant, emin - m_bits)
    mag = torch.where(is_sub, mag_sub, mag_norm)
    special = torch.where(mant == 0, torch.full_like(mag, math.inf), torch.full_like(mag, math.nan))
    mag = torch.where(is_special, special, mag)
    return torch.where(sign == 1, -mag, mag).to(torch.float32)

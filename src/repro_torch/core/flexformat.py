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

import torch

__all__ = [
    "FlexFormat",
    "quantize_em",
    "quantize_em_with_flags",
    "unbiased_exponent",
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

    def __str__(self) -> str:  # paper notation
        return f"<{self.eb},{self.mb},{self.fx}>"


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

// R2F2 device math (kernel K1): the per-element and per-block arithmetic every
// fused kernel of repro_torch runs. Each function is the bit-exact device form
// of a plain PyTorch function in repro_torch/core and repro_torch/kernels/blockops.py:
//
//   quantize_em        core/flexformat.py::quantize_em_with_flags (value only)
//   select_k, ...      core/r2f2.py (split widths in integer logic)
//   block_max_u32      kernels/blockops.py::block_max_exp (as a CTA reduction)
//   family_mul/div     kernels/fused.py::FusedOps.mul / .div (ConstMul, PairMul:
//                      a pass's formats built once, branch-free by kind)
//   family_add/rsqrt   FusedOps.add / .rsqrt (select_k_add, select_k_rsqrt)
//   grid_barrier, cluster_publish/collect: barriers over a cooperative grid
//                      and maxima over a thread-block cluster
//   adjust_tick        core/policy.py::adjust_step (one site's tick)
//   storage_k, Codec   pack/packed.py::block_storage_k, pack_block and
//                      unpack_block (core/flexformat.py::pack_r2f2 and
//                      unpack_r2f2): the packed storage format
//   Capture, Hist      profile/capture.py::pair_exp_hist as FusedOps bins a
//                      policy operation's operands: a CTA's exponent
//                      histogram in shared memory
//
// Build with --fmad=false -prec-div=true, so that nvcc contracts nothing on
// its own, and -ftz=true (every kernel, K2-K7): f32 subnormal inputs and
// results flush to a zero of their sign, as XLA runs the reference on the
// CPU and the TPU. The one fused multiply-add is
// explicit (family_mul_add): the compiled reference (XLA:CPU) fuses a plain f32
// product into the add that follows it, and rounds that sum once.
//
// The bf16 family is an f32 op on bf16-rounded operands with an f32 result:
// compiled by XLA:CPU, the reference's bf16 op runs in f32 and the rounding of
// its result to bf16 is removed.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace r2f2 {

enum Family : int { kF32 = 0, kBF16 = 1, kFixed = 2, kRR = 3 };

// The policy as the kernels see it (the eight ints of kernels/_cuda.py::policy_args).
struct Policy {
  int family;
  int eb, mb, fx;   // flexible format <EB, MB, FX>
  int fe, fm;       // fixed format E(fe)M(fm)
  int tail_approx;  // rr products keep MB + 1 + k guard bits before rounding
  int pinned;       // rr splits are exactly the carried k_floor
};

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ float from_bits(uint32_t u) { return __uint_as_float(u); }

// 2**n built from bits, as core/flexformat.py::_pow2 does: the normal branch
// clamps n to 127, the subnormal branch shifts by clamp(n + 149, 0, 23).
__device__ __forceinline__ float pow2(int n) {
  if (n >= -126) return from_bits(static_cast<uint32_t>(min(n, 127) + 127) << 23);
  return from_bits(1u << max(n + 149, 0));
}

// x * 2**n in two exact power-of-two multiplies (_scale_pow2).
__device__ __forceinline__ float scale_pow2(float x, int n) {
  const int h1 = min(max(n, -126), 127);
  return __fmul_rn(__fmul_rn(x, pow2(h1)), pow2(n - h1));
}

// |x| as a bit pattern, 0 for inf and NaN. Over non-negative floats the max of
// the patterns is the pattern of the max.
__device__ __forceinline__ uint32_t finite_mag_bits(float x) {
  const uint32_t u = bits(x) & 0x7FFFFFFFu;
  return u >= 0x7F800000u ? 0u : u;
}

// Unbiased exponent of a magnitude pattern. The reference takes
// unbiased_exponent(max(max|x|, 1e-38)); 1e-38 and every |x| < 2**-126 have
// exponent field 0, so a block of zeros gives -127 either way.
__device__ __forceinline__ int mag_exponent(uint32_t u) { return static_cast<int>(u >> 23) - 127; }

__device__ __forceinline__ uint32_t round_mantissa_rne(uint32_t u_abs, int m) {
  const int shift = 23 - m;
  if (shift <= 0) return u_abs;
  const uint32_t lsb = (u_abs >> shift) & 1u;
  const uint32_t half = 1u << (shift - 1);
  return (u_abs + (half - 1u + lsb)) & ~((1u << shift) - 1u);
}

// RNE quantization of x to E(e)M(m); tail >= 0 first truncates the mantissa to
// m + tail bits (the flexible-region product approximation).
__device__ __forceinline__ float quantize_em(float x, int e, int m, int tail) {
  const uint32_t u = bits(x);
  const uint32_t sign = u & 0x80000000u;
  uint32_t u_abs = u & 0x7FFFFFFFu;
  if ((u_abs >> 23) == 0u) return from_bits(sign);  // zero and f32 subnormals
  if (u_abs > 0x7F800000u) return x;                 // NaN passes through
  if (u_abs == 0x7F800000u) return from_bits(sign | 0x7F800000u);
  if (tail >= 0) {
    const int keep = min(max(m + tail, 1), 23);
    u_abs &= ~((1u << (23 - keep)) - 1u);
  }
  const int half_range = 1 << (e - 1);
  const int emin = 2 - half_range;
  if (static_cast<int>(u_abs >> 23) - 127 < emin) {  // subnormal in E(e)M(m)
    const int sub = emin - m;
    const float y = scale_pow2(rintf(scale_pow2(from_bits(u_abs), -sub)), sub);
    return sign ? -y : y;
  }
  const uint32_t r = round_mantissa_rne(u_abs, m);
  if (static_cast<int>(r >> 23) - 127 > half_range - 1) return from_bits(sign | 0x7F800000u);
  return from_bits(sign | r);
}

// quantize_em at one format for a whole tile, with the format's constants
// derived once. Its result is quantize_em's, bit for bit. Both roundings are
// computed and one is selected, so a warp whose entries mix them does not
// diverge: a normal result is an integer RNE on the bit pattern; a result
// subnormal in E(e)M(m) (most of a weight matrix near 2**-7 at E4) is
// rint(|x| * 2**s) * 2**-s with s = m - emin, both multiplies exact, as
// quantize_em's scale_pow2 computes it when 2**s and 2**-s are normal
// floats (an f32 subnormal input then rounds to zero there, as quantize_em
// gives it). A format outside that range (or with m >= 23) takes quantize_em.
struct TileQuant {
  int e, m, tail;
  bool fast;           // 0 < 23 - m and 0 <= s <= 125
  uint32_t min_field;  // smallest f32 exponent field of a normal result
  uint32_t ovf;        // rounded magnitudes at or above this overflow to inf
  uint32_t trunc;      // the tail truncation's mask (all ones without one)
  int shift;           // 23 - m: the mantissa bits RNE drops
  uint32_t half_m1, keep;
  float up, down;      // 2**s, 2**-s
};

__device__ __forceinline__ TileQuant tile_quant(int e, int m, int tail) {
  TileQuant q;
  q.e = e, q.m = m, q.tail = tail;
  const int half_range = 1 << (e - 1);
  const int emin = 2 - half_range;
  const int s = m - emin;
  q.fast = m < 23 && s >= 0 && s <= 125;
  q.min_field = static_cast<uint32_t>(max(emin + 127, 1));
  q.ovf = half_range + 127 <= 255 ? static_cast<uint32_t>(half_range + 127) << 23 : 0xFFFFFFFFu;
  q.trunc = tail >= 0 ? ~((1u << (23 - min(max(m + tail, 1), 23))) - 1u) : 0xFFFFFFFFu;
  q.shift = min(max(23 - m, 1), 23);
  q.half_m1 = (1u << (q.shift - 1)) - 1u;
  q.keep = ~((1u << q.shift) - 1u);
  q.up = q.fast ? pow2(s) : 1.0f;
  q.down = q.fast ? pow2(-s) : 1.0f;
  return q;
}

// quantize_tile for a format with q.fast set.
__device__ __forceinline__ float quantize_tile_fast(float x, const TileQuant& q) {
  const uint32_t u = bits(x);
  const uint32_t sign = u & 0x80000000u;
  const uint32_t field = (u >> 23) & 0xFFu;
  const uint32_t ua = u & 0x7FFFFFFFu & q.trunc;
  const uint32_t r = (ua + q.half_m1 + ((ua >> q.shift) & 1u)) & q.keep;
  const uint32_t normal = r >= q.ovf ? 0x7F800000u : r;
  const uint32_t sub = bits(__fmul_rn(rintf(__fmul_rn(from_bits(ua), q.up)), q.down));
  const uint32_t mag = field >= q.min_field ? normal : sub;
  return field == 255u ? x : from_bits(sign | mag);  // inf and NaN pass through
}

__device__ __forceinline__ float quantize_tile(float x, const TileQuant& q) {
  return q.fast ? quantize_tile_fast(x, q) : quantize_em(x, q.e, q.m, q.tail);
}

// The rr family's product and quotient (family_mul / family_div at split k)
// with the split's formats precomputed: `op` quantizes operands, `prod`
// products (with the tail truncation when the policy asks for it).
struct SplitQuant {
  TileQuant op, prod;
};

// ceil(log2(n)) for n >= 1, in integers.
__device__ __forceinline__ int ceil_log2(int n) { return n <= 1 ? 0 : 32 - __clz(n - 1); }

__device__ __forceinline__ int needed_e_bits(int max_exp, int eb, int fx) {
  const int e = ceil_log2(max(max_exp, 0) + 1) + 1;
  return min(max(e, eb), eb + fx);
}

__device__ __forceinline__ int needed_e_bits_lo(int min_exp, int eb, int fx) {
  const int e = ceil_log2(max(2 - min_exp, 1)) + 1;
  return min(max(e, eb), eb + fx);
}

__device__ __forceinline__ int k_cover(int hi, int lo, const Policy& p) {
  return max(needed_e_bits(hi, p.eb, p.fx), needed_e_bits_lo(lo, p.eb, p.fx)) - p.eb;
}

// Minimal split for a product of clusters topped at (ae, be).
__device__ __forceinline__ int select_k_mul(int ae, int be, const Policy& p) {
  return k_cover(max(max(ae, be), ae + be + 1), min(min(ae, be), ae + be), p);
}

// Minimal split for a quotient (the quotient-range envelope).
__device__ __forceinline__ int select_k_div(int ae, int be, const Policy& p) {
  return k_cover(max(max(ae, be), ae - be + 1), min(min(ae, be), ae - be - 1), p);
}

// Minimal split for a sum (the alignment-shift envelope).
__device__ __forceinline__ int select_k_add(int ae, int be, const Policy& p) {
  return k_cover(max(ae, be) + 1, min(ae, be), p);
}

// Minimal split for a reciprocal square root of a cluster topped at ae: the
// result's exponents ceil(-ae/2) and floor(-(ae+1)/2) as arithmetic shifts
// (a shift floors), never through a float ceil of a log2.
__device__ __forceinline__ int select_k_rsqrt(int ae, const Policy& p) {
  const int r_hi = -(ae >> 1), r_lo = (-(ae + 1)) >> 1;
  return k_cover(max(ae, r_hi), min(ae, r_lo), p);
}

// The split one site runs at: the block's selection, floored at the carried
// split or, when pinned, the carried split itself.
__device__ __forceinline__ int site_k(int k_select, const int* k_floor, int site, const Policy& p) {
  if (k_floor == nullptr) return k_select;
  const int f = k_floor[site];
  return p.pinned ? f : max(k_select, f);
}

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// One policy product (FusedOps.mul) at split k.
__device__ __forceinline__ float family_mul(float a, float b, int k, const Policy& p) {
  switch (p.family) {
    case kF32:
      return __fmul_rn(a, b);
    case kBF16:
      return __fmul_rn(bf16_round(a), bf16_round(b));
    case kFixed:
      return quantize_em(__fmul_rn(quantize_em(a, p.fe, p.fm, -1), quantize_em(b, p.fe, p.fm, -1)), p.fe, p.fm, -1);
    default: {
      const int e = p.eb + k, m = p.mb + p.fx - k;
      const float q = __fmul_rn(quantize_em(a, e, m, -1), quantize_em(b, e, m, -1));
      return quantize_em(q, e, m, p.tail_approx ? p.mb + 1 + k : -1);
    }
  }
}

// a*b + c with the product on the policy (FusedOps.mul_add): one rounding for
// the f32 and bf16 families, whose product is a plain f32 multiply.
__device__ __forceinline__ float family_mul_add(float a, float b, float c, int k, const Policy& p) {
  switch (p.family) {
    case kF32:
      return __fmaf_rn(a, b, c);
    case kBF16:
      return __fmaf_rn(bf16_round(a), bf16_round(b), c);
    default:
      return __fadd_rn(family_mul(a, b, k, p), c);
  }
}

__device__ __forceinline__ SplitQuant split_quant(int k, const Policy& p) {
  const int e = p.eb + k, m = p.mb + p.fx - k;
  return SplitQuant{tile_quant(e, m, -1), tile_quant(e, m, p.tail_approx ? p.mb + 1 + k : -1)};
}

__device__ __forceinline__ float rr_mul(float a, float b, const SplitQuant& f) {
  return quantize_tile(__fmul_rn(quantize_tile(a, f.op), quantize_tile(b, f.op)), f.prod);
}

__device__ __forceinline__ float rr_div(float a, float b, const SplitQuant& f) {
  return quantize_tile(__fdiv_rn(quantize_tile(a, f.op), quantize_tile(b, f.op)), f.op);
}

// One policy quotient (FusedOps.div) at split k: no tail truncation.
__device__ __forceinline__ float family_div(float a, float b, int k, const Policy& p) {
  switch (p.family) {
    case kF32:
      return __fdiv_rn(a, b);
    case kBF16:
      return __fdiv_rn(bf16_round(a), bf16_round(b));
    case kFixed:
      return quantize_em(__fdiv_rn(quantize_em(a, p.fe, p.fm, -1), quantize_em(b, p.fe, p.fm, -1)), p.fe, p.fm, -1);
    default: {
      const int e = p.eb + k, m = p.mb + p.fx - k;
      return quantize_em(__fdiv_rn(quantize_em(a, e, m, -1), quantize_em(b, e, m, -1)), e, m, -1);
    }
  }
}

// One policy sum (FusedOps.add) at split k: operands and result rounded to
// the split's format, no tail truncation.
__device__ __forceinline__ float family_add(float a, float b, int k, const Policy& p) {
  switch (p.family) {
    case kF32:
      return __fadd_rn(a, b);
    case kBF16:
      return __fadd_rn(bf16_round(a), bf16_round(b));
    case kFixed:
      return quantize_em(__fadd_rn(quantize_em(a, p.fe, p.fm, -1), quantize_em(b, p.fe, p.fm, -1)), p.fe, p.fm, -1);
    default: {
      const int e = p.eb + k, m = p.mb + p.fx - k;
      return quantize_em(__fadd_rn(quantize_em(a, e, m, -1), quantize_em(b, e, m, -1)), e, m, -1);
    }
  }
}

// One policy reciprocal square root (FusedOps.rsqrt) at split k, on the
// correctly rounded f32 rsqrt (core/rsqrt.py::rsqrt is its CPU route).
__device__ __forceinline__ float family_rsqrt(float x, int k, const Policy& p) {
  switch (p.family) {
    case kF32:
      return __frsqrt_rn(x);
    case kBF16:
      return __frsqrt_rn(bf16_round(x));
    case kFixed:
      return quantize_em(__frsqrt_rn(quantize_em(x, p.fe, p.fm, -1)), p.fe, p.fm, -1);
    default: {
      const int e = p.eb + k, m = p.mb + p.fx - k;
      return quantize_em(__frsqrt_rn(quantize_em(x, e, m, -1)), e, m, -1);
    }
  }
}

// One policy product by a pass-wide constant c at the pass's split k:
// family_mul(c, x, k, p) bit for bit (and family_mul(x, c, k, p): an IEEE
// product does not see the order), with the constant's rounding and the
// format's constants derived once per pass, or once per launch in a table
// (the trivial default constructor lets one live in shared memory).
struct ConstMul {
  int family;
  float c;  // f32: as given; bf16: bf16-rounded; fixed and rr: quantized
  SplitQuant q;

  ConstMul() = default;

  __device__ ConstMul(float c0, int k, const Policy& p, const TileQuant& fixed) : family(p.family), c(c0) {
    if (family == kBF16) {
      c = bf16_round(c0);
    } else if (family != kF32) {
      q = family == kFixed ? SplitQuant{fixed, fixed} : split_quant(k, p);
      c = quantize_tile(c0, q.op);
    }
  }

  __device__ float operator()(float x) const {
    switch (family) {
      case kF32:
        return __fmul_rn(c, x);
      case kBF16:
        return __fmul_rn(c, bf16_round(x));
      default:
        return quantize_tile(__fmul_rn(c, quantize_tile(x, q.op)), q.prod);
    }
  }

  // The product's variant, uniform over a pass: 0 f32, 1 bf16, 2 both
  // formats on quantize_tile_fast, 3 any other. A pass that selects it once
  // (with_kind) runs its cells through straight-line code, so the cells'
  // chains interleave instead of each product branching on the family and
  // the format.
  __device__ int kind() const { return family == kF32 ? 0 : family == kBF16 ? 1 : q.op.fast && q.prod.fast ? 2 : 3; }

  // operator() for a product of kind K: the same bits.
  template <int K>
  __device__ float apply(float x) const {
    if constexpr (K == 0) {
      return __fmul_rn(c, x);
    } else if constexpr (K == 1) {
      return __fmul_rn(c, bf16_round(x));
    } else if constexpr (K == 2) {
      return quantize_tile_fast(__fmul_rn(c, quantize_tile_fast(x, q.op)), q.prod);
    } else {
      return (*this)(x);
    }
  }

  // family_mul_add(c, x, y, k, p) for a product of kind K: one rounding in
  // the f32 and bf16 families, whose product is a plain f32 multiply.
  template <int K>
  __device__ float mul_add(float x, float y) const {
    if constexpr (K == 0) {
      return __fmaf_rn(c, x, y);
    } else if constexpr (K == 1) {
      return __fmaf_rn(c, bf16_round(x), y);
    } else if constexpr (K == 2) {
      return __fadd_rn(apply<2>(x), y);
    } else {
      if (family == kF32) return __fmaf_rn(c, x, y);
      if (family == kBF16) return __fmaf_rn(c, bf16_round(x), y);
      return __fadd_rn((*this)(x), y);
    }
  }
};

// One policy product or quotient of two variable operands at a pass's split
// k: family_mul(a, b, k, p) and family_div(a, b, k, p) bit for bit, with the
// split's formats built once (ConstMul's counterpart where neither operand is
// a constant). Its kind is ConstMul's; the quotient rounds to the operand
// format, with no tail truncation.
struct PairMul {
  int family;
  SplitQuant q;

  PairMul() = default;

  __device__ PairMul(int k, const Policy& p, const TileQuant& fixed) : family(p.family) {
    if (family != kF32 && family != kBF16) q = family == kFixed ? SplitQuant{fixed, fixed} : split_quant(k, p);
  }

  __device__ int kind() const { return family == kF32 ? 0 : family == kBF16 ? 1 : q.op.fast && q.prod.fast ? 2 : 3; }

  template <int K>
  __device__ float mul(float a, float b) const {
    if constexpr (K == 0) {
      return __fmul_rn(a, b);
    } else if constexpr (K == 1) {
      return __fmul_rn(bf16_round(a), bf16_round(b));
    } else if constexpr (K == 2) {
      return quantize_tile_fast(__fmul_rn(quantize_tile_fast(a, q.op), quantize_tile_fast(b, q.op)), q.prod);
    } else {
      if (family == kF32) return __fmul_rn(a, b);
      if (family == kBF16) return __fmul_rn(bf16_round(a), bf16_round(b));
      return rr_mul(a, b, q);
    }
  }

  template <int K>
  __device__ float div(float a, float b) const {
    if constexpr (K == 0) {
      return __fdiv_rn(a, b);
    } else if constexpr (K == 1) {
      return __fdiv_rn(bf16_round(a), bf16_round(b));
    } else if constexpr (K == 2) {
      return quantize_tile_fast(__fdiv_rn(quantize_tile_fast(a, q.op), quantize_tile_fast(b, q.op)), q.op);
    } else {
      if (family == kF32) return __fdiv_rn(a, b);
      if (family == kBF16) return __fdiv_rn(bf16_round(a), bf16_round(b));
      return rr_div(a, b, q);
    }
  }
};

// Host side: the kind (ConstMul::kind) a launch's products run at where its
// formats are fast, a template parameter of its kernel: 0 f32, 1 bf16, 2 the
// fixed family's and the rr splits' formats on quantize_tile_fast (a split
// whose formats are not takes the generic product, kind 3, in that pass).
inline int table_kind(const Policy& p) { return p.family == kF32 || p.family == kBF16 ? p.family : 2; }

template <int K>
struct MulKind {
  static constexpr int value = K;
};

// fn(MulKind<m.kind()>{}) for a ConstMul or a PairMul: a pass's cell loop
// compiled once per kind.
template <typename Mul, typename Fn>
__device__ __forceinline__ void with_kind(const Mul& m, Fn&& fn) {
  switch (m.kind()) {
    case 0: fn(MulKind<0>{}); break;
    case 1: fn(MulKind<1>{}); break;
    case 2: fn(MulKind<2>{}); break;
    default: fn(MulKind<3>{}); break;
  }
}

// fn(MulKind<K>{}) for two products of one pass (of one family): K their
// common kind, or 3 (the generic product, right for every kind) where a
// split puts one on the fast path and not the other; four variants of the
// pass where a nested with_kind would compile sixteen.
template <typename MulA, typename MulB, typename Fn>
__device__ __forceinline__ void with_kinds(const MulA& a, const MulB& b, Fn&& fn) {
  const int k = a.kind();
  switch (k == b.kind() ? k : 3) {
    case 0: fn(MulKind<0>{}); break;
    case 1: fn(MulKind<1>{}); break;
    case 2: fn(MulKind<2>{}); break;
    default: fn(MulKind<3>{}); break;
  }
}

// ---------------------------------------------------------------------------
// Packed storage (pack/packed.py): a block's storage split, and the payload
// encode and decode at a split. A payload is 1, 2 or 4 bytes an element
// (pack/packed.py::payload_dtype by the format's total bits); the kernels
// take the width as a launch argument, one uniform branch per load or
// store, rather than as a template parameter that would triple the rod
// kernels' instances and their build time.

// The storage split of a block whose largest finite magnitude has the bit
// pattern `max_mag` (block_storage_k: select_k_operand of its exponent,
// clipped to [k_min, fx]; a block of zeros gives exponent -127).
__device__ __forceinline__ int storage_k(uint32_t max_mag, int eb, int fx, int k_min = 0) {
  const int me = mag_exponent(max_mag);
  const int e = max(needed_e_bits(me, eb, fx), needed_e_bits_lo(me, eb, fx));
  return min(max(e - eb, k_min), fx);
}

__device__ __forceinline__ uint32_t load_payload(const void* p, size_t i, int bytes) {
  if (bytes == 1) return static_cast<const uint8_t*>(p)[i];
  if (bytes == 2) return static_cast<const uint16_t*>(p)[i];
  return static_cast<const uint32_t*>(p)[i];
}

__device__ __forceinline__ void store_payload(void* p, size_t i, int bytes, uint32_t v) {
  if (bytes == 1) {
    static_cast<uint8_t*>(p)[i] = static_cast<uint8_t>(v);
  } else if (bytes == 2) {
    static_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(v);
  } else {
    static_cast<uint32_t*>(p)[i] = v;
  }
}

// The storage format E(eb + k) M(mb + fx - k) at one split: its rounding
// (quantize_em without tail truncation) and its payload fields.
struct Codec {
  int e, m;
  TileQuant q;

  Codec() = default;
  __device__ Codec(int k, const Policy& p) : e(p.eb + k), m(p.mb + p.fx - k), q(tile_quant(p.eb + k, p.mb + p.fx - k, -1)) {}

  __device__ float round(float x) const { return quantize_tile(x, q); }

  // pack_r2f2 of a value already rounded to this format: sign | exponent
  // field | mantissa field; a NaN keeps its sign and takes the mantissa
  // 1 << (m - 1).
  __device__ uint32_t encode(float v) const {
    const uint32_t u = bits(v), ua = u & 0x7FFFFFFFu;
    const int half = 1 << (e - 1), emin = 2 - half, unb = static_cast<int>(ua >> 23) - 127;
    const uint32_t all = (1u << e) - 1u;
    uint32_t ef = 0u, mf = 0u;
    if (ua > 0x7F800000u) {
      ef = all, mf = 1u << (m - 1);
    } else if (ua == 0x7F800000u) {
      ef = all;
    } else if (ua != 0u && unb < emin) {  // below normal: round(|v| / 2**(emin - m)), half to even
      mf = static_cast<uint32_t>(rintf(scale_pow2(from_bits(ua), m - emin)));
    } else if (ua != 0u) {
      ef = static_cast<uint32_t>(unb + half - 1), mf = (ua & 0x7FFFFFu) >> (23 - m);
    }
    return (u >> 31) << (e + m) | ef << m | mf;
  }

  __device__ uint32_t pack(float x) const { return encode(round(x)); }

  // unpack_r2f2: the magnitude from the fields in f32 multiplies, as the
  // reference builds it (a value below 2**-126 flushes to a zero of its
  // sign under -ftz=true, as XLA flushes it).
  __device__ float decode(uint32_t pay) const {
    const uint32_t mbits = pay & ((1u << m) - 1u);
    const uint32_t ef = (pay >> m) & ((1u << e) - 1u);
    const float mant = static_cast<float>(mbits);
    const int half = 1 << (e - 1);
    float mag;
    if (ef == (1u << e) - 1u) {
      mag = mbits == 0u ? from_bits(0x7F800000u) : from_bits(0x7FC00000u);
    } else if (ef == 0u) {
      mag = scale_pow2(mant, 2 - half - m);
    } else {
      mag = scale_pow2(__fadd_rn(1.0f, __fmul_rn(mant, pow2(-m))), static_cast<int>(ef) - (half - 1));
    }
    return ((pay >> (e + m)) & 1u) ? -mag : mag;
  }
};

// A kernel's storage I/O: a packed input (payload and its split, one per
// block) instead of f32, a packed output, the megakernels' storage rounding
// at snapshot boundaries, and the output split (a packed output's, or a
// megakernel's carried split kst where its state stays f32).
struct Storage {
  const void* pay_in;  // null: f32 input
  const int* k_in;
  void* pay_out;       // null: f32 output
  int* k_out;          // null: no split out
  int bytes;           // payload bytes an element
  int round;           // quantize the state at every snapshot boundary and after the remainder
};

// ---------------------------------------------------------------------------
// Range capture (profile/capture.py, kernels/fused.py::FusedOps): every policy
// operation bins the unbiased exponents of its two operands, per site, into
// width-1 bins. A kernel's capture arguments (null `out`: capture off, which
// the kernels test as a uniform branch; no template instance depends on it):
struct Capture {
  int* out;         // (slots, n_sites, 2, n_bins) int32, zeroed by the host; null: capture off
  int e_lo, n_bins;  // bin b counts exponent e_lo + b; exponents outside clamp into the edge bins
  int rows, cols;    // the valid extent of a padded field (K3): lanes beyond it never count
};

// Most bins a kernel takes (kernels/_cuda.py::MAX_BINS): every f32 exponent
// field fits 256.
constexpr int kMaxBins = 512;

// A CTA's histogram of n_sites x 2 operand rows (row = 2 * site + operand) in
// shared memory, n_bins int32 words a row. The bin of x is decided from its
// bits, as profile/capture.py::exp_hist decides it: zero bits (either sign)
// and a non-finite field (255) do not count, and the exponent is the biased
// field minus 127, so a subnormal counts in the low edge bin (a float compare
// would drop it under -ftz=true). add() is warp-aggregated: the calling lanes
// that share a word make one shared-memory atomic between them. At the end of
// a chunk or snapshot interval, flush() adds each nonzero word to the slot of
// `out` with one global atomic and zeroes it. Counts are integers, so every
// order of addition gives the same result. It is a view over the kernel's
// capture arguments: the rod, K3 and heat2d's cluster keep one for the launch,
// K4 swe2d builds it where capture is on (of the designs timed with capture
// off, the fastest for each, PERF.md section 6).
struct Hist {
  int* h;
  int* out;
  int e_lo, n_bins, words;

  __device__ Hist(const Capture& c, int* smem, int n_sites)
      : h(smem), out(c.out), e_lo(c.e_lo), n_bins(c.n_bins), words(n_sites * 2 * c.n_bins) {}

  __device__ bool on() const { return out != nullptr; }

  // Every thread of the CTA, once before the first add; the caller's next CTA
  // barrier orders the zeroing before any add.
  __device__ void zero() const {
    for (int w = threadIdx.x; w < words; w += blockDim.x) h[w] = 0;
  }

  // The word of x's bin in row `row`, or -1 where x does not count.
  __device__ int word(int row, float x) const {
    const uint32_t u = __float_as_uint(x) & 0x7fffffffu;
    const int field = static_cast<int>(u >> 23);
    if (u == 0u || field == 255) return -1;
    return row * n_bins + min(max(field - 127 - e_lo, 0), n_bins - 1);
  }

  // One element x of row `row` from every calling lane (`valid`: a lane of
  // the field; the others take part in the vote and count nothing).
  __device__ void add(int row, float x, bool valid) const {
    const int w = valid ? word(row, x) : -1;
    const unsigned peers = __match_any_sync(__activemask(), w);
    if (w >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(h + w, __popc(peers));
  }

  // `count` copies of x: a broadcast constant operand over `count` valid lanes.
  __device__ void add_n(int row, float x, int count) const {
    const int w = word(row, x);
    if (w >= 0 && count > 0) atomicAdd(h + w, count);
  }

  // The CTA's words into slot `slot` of out, then zeroed; every thread of the
  // CTA calls it (CTA barriers before and after).
  __device__ void flush(int slot) const {
    __syncthreads();
    int* dst = out + static_cast<size_t>(slot) * words;
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      const int v = h[w];
      if (v != 0) {
        atomicAdd(dst + w, v);
        h[w] = 0;
      }
    }
    __syncthreads();
  }
};

// The count of i = first, first + stride, ... below n: the loop
// `for (i = first; i < n; i += stride)` runs that many times.
__device__ __forceinline__ int strided_count(int first, int n, int stride) {
  return first < n ? (n - 1 - first) / stride + 1 : 0;
}

// Host side: the shared-memory bytes of a histogram of n_sites sites (0: capture off).
inline size_t hist_bytes(const Capture& c, int n_sites) {
  return c.out != nullptr ? static_cast<size_t>(n_sites) * 2 * c.n_bins * sizeof(int) : 0;
}

// Host side: capture arguments a kernel can run.
inline bool capture_ok(const Capture& c) { return c.out == nullptr || (c.n_bins >= 1 && c.n_bins <= kMaxBins); }

// ---------------------------------------------------------------------------
// Ensemble members (pde/solver.py::Simulation.run_ensemble): one launch runs
// the same run for `members` states, each member's arrays at the member's
// index times a per-member stride. A kernel takes its member from its grid
// (blockIdx.y, or .z where y is taken, plus the wave's first member where the
// members of a cooperative grid run in waves) and moves every pointer to it
// first, so the body runs as for one member: no maximum, split, tracker row,
// histogram, evidence, snapshot, storage split or barrier is shared.
template <typename T>
__host__ __device__ __forceinline__ T* at_member(T* p, size_t m, size_t stride) {
  return p != nullptr ? p + m * stride : p;
}

// Member m's storage arguments: payloads of `n` elements and `splits` splits a member.
__host__ __device__ inline Storage member_storage(Storage s, size_t m, size_t n, size_t splits) {
  if (s.pay_in != nullptr) s.pay_in = static_cast<const char*>(s.pay_in) + m * n * s.bytes;
  if (s.pay_out != nullptr) s.pay_out = static_cast<char*>(s.pay_out) + m * n * s.bytes;
  s.k_in = at_member(s.k_in, m, splits);
  s.k_out = at_member(s.k_out, m, splits);
  return s;
}

// Member m's histograms: `slots` slots of n_sites sites a member.
__host__ __device__ inline Capture member_capture(Capture c, size_t m, int slots, int n_sites) {
  c.out = at_member(c.out, m, static_cast<size_t>(slots) * n_sites * 2 * c.n_bins);
  return c;
}

// Host side: members a wave of a cooperative grid holds, `ctas` CTAs a member
// and `capacity` CTAs resident at once (0: one member does not fit).
inline int member_wave(int members, int ctas, int capacity) {
  return ctas < 1 || ctas > capacity ? 0 : (capacity / ctas < members ? capacity / ctas : members);
}

// ---------------------------------------------------------------------------
// The adjust unit (core/policy.py::adjust_step), one site's tick in f32 and
// integer logic, as the megakernels run it once per site per substep.

enum AdjustOp : int { kOpMul = 0, kOpDiv = 1, kOpAdd = 2, kOpRsqrt = 3 };

// One site's carried tracker row.
struct SiteState {
  int k;
  float hi, lo;  // the EMAs of the exponent envelope
  int ov, sh;    // grow and shrink events
};

// The tick's constants: ema and 1 - ema rounded once to f32 on the host.
struct AdjustLaw {
  float ema, one_minus;
  int headroom;
  int eb, fx;
};

// max/min that take the first argument on ties, as the reference's
// maximum/minimum do (fmaxf/fminf promise nothing for +0 and -0).
__device__ __forceinline__ float pick_max(float a, float b) { return a >= b ? a : b; }
__device__ __forceinline__ float pick_min(float a, float b) { return a <= b ? a : b; }

// core/r2f2.py::op_bounds in f32: the exponent envelope of one op on clusters
// topped at (ae, be).
__device__ __forceinline__ void op_bounds(int op, float ae, float be, float& hi, float& lo) {
  if (op == kOpDiv) {
    const float q = __fsub_rn(ae, be);
    hi = pick_max(pick_max(ae, be), __fadd_rn(q, 1.0f));
    lo = pick_min(pick_min(ae, be), __fsub_rn(q, 1.0f));
  } else if (op == kOpAdd) {
    hi = __fadd_rn(pick_max(ae, be), 1.0f);
    lo = pick_min(ae, be);
  } else if (op == kOpRsqrt) {  // exact: ae holds an integer
    hi = pick_max(ae, ceilf(__fdiv_rn(-ae, 2.0f)));
    lo = pick_min(ae, floorf(__fdiv_rn(-__fadd_rn(ae, 1.0f), 2.0f)));
  } else {
    const float p = __fadd_rn(ae, be);
    hi = pick_max(pick_max(ae, be), __fadd_rn(p, 1.0f));
    lo = pick_min(pick_min(ae, be), p);
  }
}

// core/policy.py::_k_for: the split covering [lo, hi] after the f32 bounds
// are truncated toward zero, as .to(int32) does.
__device__ __forceinline__ int k_for(float hi, float lo, const AdjustLaw& law) {
  const int e_hi = needed_e_bits(__float2int_rz(hi), law.eb, law.fx);
  const int e_lo = needed_e_bits_lo(__float2int_rz(lo), law.eb, law.fx);
  return max(e_hi, e_lo) - law.eb;
}

// One tick: fold the evidence (ae, be) into the row, grow on demand, shrink
// only toward the EMA's need, clamp to [k_lo, k_hi], count both events.
__device__ __forceinline__ void adjust_tick(SiteState& st, float ae, float be, int op, int k_lo, int k_hi,
                                            const AdjustLaw& law) {
  float step_hi, step_lo;
  op_bounds(op, ae, be, step_hi, step_lo);
  // the compiled reference fuses the EMA's first product: fma(ema, old, (1-ema)*new)
  st.hi = pick_max(__fmaf_rn(law.ema, st.hi, __fmul_rn(law.one_minus, step_hi)), step_hi);
  st.lo = pick_min(__fmaf_rn(law.ema, st.lo, __fmul_rn(law.one_minus, step_lo)), step_lo);
  const float h = static_cast<float>(law.headroom);
  const int need_now = k_for(__fadd_rn(step_hi, h), __fsub_rn(step_lo, h), law);
  const int need_ema = k_for(__fadd_rn(st.hi, h), __fsub_rn(st.lo, h), law);
  int k_new = max(need_now, min(st.k, need_ema));
  k_new = min(max(k_new, k_lo), k_hi);
  st.ov += k_new > st.k;
  st.sh += k_new < st.k;
  st.k = k_new;
}

// Max of v over the CTA, returned to every thread. blockDim.x must be a
// multiple of 32; scratch holds 32 words of shared memory.
__device__ __forceinline__ uint32_t block_max_u32(uint32_t v, uint32_t* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's readers are done with scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? scratch[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

// Exponent of a block max: block_max_exp over the CTA's elements.
__device__ __forceinline__ int block_max_exp(uint32_t local_mag_bits, uint32_t* scratch) {
  return mag_exponent(block_max_u32(local_mag_bits, scratch));
}

// ---------------------------------------------------------------------------
// Barriers beyond one CTA

// A barrier over a cooperative grid: once the CTA's threads are past their
// writes (the CTA barrier), its thread 0 adds one to the launch's counter
// with release semantics and spins on acquire loads until the counter
// reaches `target`; the CTA barrier after it lets the CTA go on. The counter
// only grows, so the n-th barrier of a launch waits for n times its CTAs; it
// is 64-bit, so it does not wrap (three barriers a substep on 132 CTAs would
// wrap 32 bits in 11 million substeps). (The same pattern as CUTLASS's
// generic barrier; cooperative_groups' grid.sync() adds a full fence on each
// side.) Data a barrier publishes is read with __ldcg (L2), never through L1.
__device__ __forceinline__ void grid_barrier(unsigned long long* counter, unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(counter) : "memory");
    unsigned long long seen = 0ull;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// The two halves of a thread-block cluster's barrier: arrive once this
// thread's writes (shared memory, its own and the neighbours' through
// distributed shared memory) are out, wait before reading what the others
// wrote. Work between the two overlaps the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// Field-wide maxima of N magnitude-bit words over a thread-block cluster of
// n_ctas CTAs, in two halves around its barrier. cluster_publish folds each
// thread's words into this CTA's `words` (a warp reduction, then one
// shared-memory atomicMax a warp) and arrives; cluster_collect waits, then
// lane r of every warp reads CTA r's words through distributed shared memory,
// and every thread gets the maxima. A CTA zeroes its words again only after
// the next cluster barrier, when every CTA has read them. An integer max of
// bit patterns, so the order of arrival does not matter.
template <int N>
__device__ __forceinline__ void cluster_publish(uint32_t (&v)[N], uint32_t* words) {
  for (int i = 0; i < N; ++i) {
    v[i] = __reduce_max_sync(0xffffffffu, v[i]);
    if ((threadIdx.x & 31) == 0) atomicMax(words + i, v[i]);
  }
  cluster_arrive();
}

template <int N, typename Cluster>
__device__ __forceinline__ void cluster_collect(uint32_t (&v)[N], uint32_t* words, int n_ctas, const Cluster& cluster) {
  cluster_wait();
  const int lane = threadIdx.x & 31;
  const uint32_t* remote = lane < n_ctas ? cluster.map_shared_rank(words, lane) : nullptr;
  for (int i = 0; i < N; ++i) v[i] = __reduce_max_sync(0xffffffffu, remote != nullptr ? remote[i] : 0u);
}

// Host side: launch `kernel` on a cooperative grid (every CTA resident at
// once, which a grid barrier needs) through cudaLaunchKernelEx.
template <typename... Params, typename... Args>
inline cudaError_t launch_cooperative(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                                      cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The CTAs of `threads` threads and `smem` bytes of dynamic shared memory
// that a cooperative grid of `kernel` holds on the current device.
template <typename Kernel>
inline cudaError_t cooperative_capacity(Kernel kernel, int threads, size_t smem, int& ctas) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  ctas = coop ? per_sm * sms : 0;
  return err;
}

// Host side: the launch attributes a kernel needs beyond the defaults, set
// once per kernel and device (at its first launch, so never inside a CUDA
// graph's capture). `allowed` is the kernel's own record, one entry per device.
constexpr int kMaxDevices = 64;

template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || bytes <= 48 * 1024 || (dev < kMaxDevices && bytes <= allowed[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

template <typename Kernel>
inline cudaError_t allow_large_clusters(Kernel kernel, bool* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && allowed[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

// Host side: `members` thread-block clusters of `cluster` CTAs, one a member
// (blockIdx.y; cudaLaunchKernelEx with a cluster dimension); `smem_allowed`
// and `clusters_allowed` are the kernel's own records of the attributes set.
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), size_t* smem_allowed, bool* clusters_allowed,
                                  int cluster, int members, int threads, size_t smem, void* stream, Args... args) {
  cudaError_t err = allow_dynamic_smem(kernel, smem, smem_allowed);
  if (err == cudaSuccess && cluster > 8) err = allow_large_clusters(kernel, clusters_allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, members);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace r2f2

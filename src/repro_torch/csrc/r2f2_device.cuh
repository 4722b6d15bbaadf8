// R2F2 device math (kernel K1): the per-element and per-block arithmetic every
// fused kernel of repro_torch runs. Each function is the bit-exact device form
// of a plain PyTorch function in repro_torch/core and repro_torch/kernels/blockops.py:
//
//   quantize_em        core/flexformat.py::quantize_em_with_flags (value only)
//   select_k, ...      core/r2f2.py (split widths in integer logic)
//   block_max_u32      kernels/blockops.py::block_max_exp (as a CTA reduction)
//   family_mul/div     kernels/fused.py::FusedOps.mul / .div
//
// Build with --fmad=false -prec-div=true -ftz=false, so that nvcc contracts
// nothing on its own and keeps subnormals. The one fused multiply-add is
// explicit (family_mul_add): the compiled reference (XLA:CPU) fuses a plain f32
// product into the add that follows it, and rounds that sum once.
//
// The bf16 family is an f32 op on bf16-rounded operands with an f32 result:
// compiled by XLA:CPU, the reference's bf16 op runs in f32 and the rounding of
// its result to bf16 is removed.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

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

}  // namespace r2f2

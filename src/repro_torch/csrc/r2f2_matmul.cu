// Kernel K7 of repro_torch, for sm_90a:
//
//   r2f2_matmul_kernel  replaces repro/kernels/r2f2_matmul.py::r2f2_matmul_pallas
//                       (_matmul_kernel)
//
// C = A @ B through block-granular R2F2 multipliers. A is (m, kdim), B is
// (kdim, n), C is (m, n), all row-major f32. One CTA owns one (bm, bn) output
// block and walks the K blocks in order, as the reference's grid walks its
// innermost ("arbitrary") axis. For each (bm, bk) x (bk, bn) block pair:
//
//   1. load both tiles into shared memory (entries past the matrix edge are
//      zero, which never raises a tile max: the reference's zero padding);
//   2. reduce each tile's max finite magnitude to its exponent;
//   3. pick the pair's one split k with select_k (both tiles and their
//      product bound) and quantize both tiles in place, RNE, to
//      E(EB+k) M(MB+FX-k);
//   4. partial = the bk-term dot products in f32 (one FMA per product, in k
//      order; with round_products each product is rounded to the runtime
//      format with the FX-tail truncation and then added), then acc += partial.
//
// No tensor cores: TF32 would round the quantized significands. The sums are
// taken in another order than XLA's dot, so they agree with the reference to
// a rounding bound, and bit for bit where every partial sum is exact.
//
// Bound: at the prefill shapes of the shared expert (256 x 5120 @ 5120 x 8192)
// by f32 operations (2 m n kdim); at decode (m = 4) by the bytes of B. This
// simple kernel keeps a 16 x 16 thread grid with an 8 x 8 register tile per
// thread (so bm, bn <= 128), stages each tile through shared memory once, and
// reads shared memory twice per eight FMAs.
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::Policy;

namespace {

constexpr int kThreadsX = 16, kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kTile = 8;  // outputs per thread along each axis
constexpr int kMaxBlock = kThreadsX * kTile;

template <bool kRoundProducts>
__global__ void __launch_bounds__(kThreads)
r2f2_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c, int m, int n,
                   int kdim, int bm, int bn, int bk, Policy p) {
  extern __shared__ float smem[];
  __shared__ uint32_t scratch[32];
  const int lda = bk + 1;  // a padded row: the two rows a warp reads fall in different banks
  float* as = smem;            // bm x lda
  float* bs = smem + bm * lda;  // bk x bn
  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;
  const int tx = threadIdx.x % kThreadsX, ty = threadIdx.x / kThreadsX;

  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < kdim; k0 += bk) {
    __syncthreads();  // the previous block pair's readers are done with as and bs
    uint32_t amx = 0u, bmx = 0u;
    for (int i = threadIdx.x; i < bm * bk; i += kThreads) {
      const int r = i / bk, col = i % bk;
      const int gr = row0 + r, gc = k0 + col;
      const float v = (gr < m && gc < kdim) ? a[static_cast<size_t>(gr) * kdim + gc] : 0.0f;
      as[r * lda + col] = v;
      amx = max(amx, r2f2::finite_mag_bits(v));
    }
    for (int i = threadIdx.x; i < bk * bn; i += kThreads) {
      const int r = i / bn, col = i % bn;
      const int gr = k0 + r, gc = col0 + col;
      const float v = (gr < kdim && gc < n) ? b[static_cast<size_t>(gr) * n + gc] : 0.0f;
      bs[i] = v;
      bmx = max(bmx, r2f2::finite_mag_bits(v));
    }
    const int ae = r2f2::block_max_exp(amx, scratch);
    const int be = r2f2::block_max_exp(bmx, scratch);
    const int k = r2f2::select_k_mul(ae, be, p);
    const int e = p.eb + k, mbits = p.mb + p.fx - k;
    const int tail = p.tail_approx ? p.mb + 1 + k : -1;
    // each thread quantizes the entries it loaded
    for (int i = threadIdx.x; i < bm * bk; i += kThreads) {
      float& v = as[(i / bk) * lda + i % bk];
      v = r2f2::quantize_em(v, e, mbits, -1);
    }
    for (int i = threadIdx.x; i < bk * bn; i += kThreads) bs[i] = r2f2::quantize_em(bs[i], e, mbits, -1);
    __syncthreads();

    float part[kTile][kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int j = 0; j < kTile; ++j) part[i][j] = 0.0f;
    for (int kk = 0; kk < bk; ++kk) {
      float av[kTile], bv[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const int r = ty + kThreadsY * i;
        av[i] = r < bm ? as[r * lda + kk] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int col = tx + kThreadsX * j;
        bv[j] = col < bn ? bs[kk * bn + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          if (kRoundProducts) {
            const float q = r2f2::quantize_em(__fmul_rn(av[i], bv[j]), e, mbits, tail);
            part[i][j] = __fadd_rn(part[i][j], q);
          } else {
            part[i][j] = __fmaf_rn(av[i], bv[j], part[i][j]);
          }
        }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
  }

#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int r = ty + kThreadsY * i, gr = row0 + r;
    if (r >= bm || gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int col = tx + kThreadsX * j, gc = col0 + col;
      if (col < bn && gc < n) c[static_cast<size_t>(gr) * n + gc] = acc[i][j];
    }
  }
}

template <bool kRoundProducts>
int launch(const float* a, const float* b, float* c, int m, int n, int kdim, int bm, int bn, int bk, const Policy& p,
           cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(bm) * (bk + 1) + static_cast<size_t>(bk) * bn) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(r2f2_matmul_kernel<kRoundProducts>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  r2f2_matmul_kernel<kRoundProducts><<<grid, kThreads, smem, stream>>>(a, b, c, m, n, kdim, bm, bn, bk, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int r2f2_matmul(const float* a, const float* b, float* c, int m, int n, int kdim, int bm, int bn, int bk,
                           int eb, int mb, int fx, int round_products, int tail_approx, void* stream) {
  if (bm > kMaxBlock || bn > kMaxBlock) return static_cast<int>(cudaErrorInvalidValue);
  const Policy p{r2f2::kRR, eb, mb, fx, 0, 0, tail_approx, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_products ? launch<true>(a, b, c, m, n, kdim, bm, bn, bk, p, s)
                        : launch<false>(a, b, c, m, n, kdim, bm, bn, bk, p, s);
}

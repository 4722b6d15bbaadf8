// Kernel K6 of repro_torch, for sm_90a:
//
//   r2f2_quantize_kernel  replaces repro/kernels/r2f2_quantize.py::r2f2_quantize_pallas
//                         (_quantize_kernel)
//
// Per (bm, bn) tile of a row-major (m, n) f32 matrix: the max finite |x|, its
// exponent (-127 for a tile of zeros, subnormals or non-finite values only),
// the operand-only split select_k_operand, then RNE quantization of every
// element to E(EB+k) M(MB+FX-k). Writes the quantized matrix and one int32 k
// per tile. The wrapper (kernels/r2f2_quantize.py) checks that the block
// divides the shape.
//
// Bound by bytes: each element is read and written once (8 B), a few dozen
// integer operations each. One CTA per tile, two passes over the tile: a
// block max, then quantize-and-write. A (256, 256) f32 tile is 256 KB, more
// than a CTA's shared memory, so the second pass reads the tile again; with
// one tile per SM in flight that read comes from the 50 MB L2.
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::Policy;

namespace {

constexpr int kQuantizeThreads = 512;

__global__ void __launch_bounds__(kQuantizeThreads)
r2f2_quantize_kernel(const float* __restrict__ x, float* __restrict__ y, int* __restrict__ k_tiles, int n, int bm,
                     int bn, Policy p) {
  __shared__ uint32_t scratch[32];
  const size_t row0 = static_cast<size_t>(blockIdx.y) * bm;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * bn;
  const int count = bm * bn;
  uint32_t mx = 0u;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    mx = max(mx, r2f2::finite_mag_bits(x[(row0 + i / bn) * n + col0 + i % bn]));
  }
  // operand-only need: a product's bound is its consumer's shared split
  const int me = r2f2::block_max_exp(mx, scratch);
  const int k = r2f2::k_cover(me, me, p);
  const int e = p.eb + k, m = p.mb + p.fx - k;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const size_t g = (row0 + i / bn) * n + col0 + i % bn;
    y[g] = r2f2::quantize_em(x[g], e, m, -1);
  }
  if (threadIdx.x == 0) k_tiles[blockIdx.y * gridDim.x + blockIdx.x] = k;
}

}  // namespace

extern "C" int r2f2_quantize(const float* x, float* y, int* k_tiles, int m, int n, int bm, int bn, int eb, int mb,
                             int fx, void* stream) {
  const dim3 grid(n / bn, m / bm);
  r2f2_quantize_kernel<<<grid, kQuantizeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, k_tiles, n, bm, bn, Policy{r2f2::kRR, eb, mb, fx, 0, 0, 0, 0});
  return static_cast<int>(cudaGetLastError());
}

// Kernel K6 of repro_torch, for sm_90a:
//
//   r2f2_quantize_tile_kernel, r2f2_quantize_kernel
//       replace repro/kernels/r2f2_quantize.py::r2f2_quantize_pallas (_quantize_kernel)
//
// Per (bm, bn) tile of a row-major (m, n) f32 matrix: the max finite |x|, its
// exponent (-127 for a tile of zeros, subnormals or non-finite values only),
// the operand-only split select_k_operand, then RNE quantization of every
// element to E(EB+k) M(MB+FX-k). Writes the quantized matrix and one int32 k
// per tile. The wrapper (kernels/r2f2_quantize.py) checks that the block
// divides the shape, and its quantize_plan picks one of two launch shapes.
//
// Bound by bytes: each element is read and written once (8 B), a few dozen
// integer operations each.
//
// The cluster shape (r2f2_quantize_tile_kernel) reads each element from
// device memory once. A tile is split over a thread-block cluster of C CTAs
// (4 of 64 KB at (256, 256)), CTA `rank` holding `rows` rows of it in shared
// memory, filled by 16-byte cp.async copies; three such CTAs fit an SM, so
// one CTA's loads overlap another's quantize. The CTA's max goes into its
// shared memory and every CTA reads the cluster's through distributed
// shared memory (r2f2::cluster_publish / cluster_collect); k is uniform
// over the tile, so the elements quantize from shared memory on
// r2f2::TileQuant's branch-free path and leave as 16-byte streaming stores.
// Each thread walks its 16-byte items by row and column, with no division
// per element. A small matrix still fills the card: (1024, 1024) at (256,
// 256) is 64 CTAs, not 16.
//
// The two-pass shape (r2f2_quantize_kernel) takes the tiles the cluster
// cannot hold (more than 8 CTAs of 64 KB), tiles under 16 KB, and rows that
// do not allow 16-byte vectors: one CTA per tile, a block max, then
// quantize-and-write over the same elements, read again (from L1 or L2).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::Policy;

namespace {

constexpr int kQuantizeThreads = 512;  // the two-pass shape
constexpr int kTileThreads = 256;      // the cluster shape

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ uint32_t mag4(const float4& v) {
  return max(max(r2f2::finite_mag_bits(v.x), r2f2::finite_mag_bits(v.y)),
             max(r2f2::finite_mag_bits(v.z), r2f2::finite_mag_bits(v.w)));
}

__device__ __forceinline__ float4 quantize4(const float4& v, const r2f2::TileQuant& q) {
  return make_float4(r2f2::quantize_tile(v.x, q), r2f2::quantize_tile(v.y, q), r2f2::quantize_tile(v.z, q),
                     r2f2::quantize_tile(v.w, q));
}

// The cluster shape: CTA `rank` of the tile's cluster holds tile rows
// [rank * rows, (rank + 1) * rows), bn wide (bn a multiple of 4, the matrix
// 16-byte aligned).
__global__ void __launch_bounds__(kTileThreads)
r2f2_quantize_tile_kernel(const float* __restrict__ x, float* __restrict__ y, int* __restrict__ k_tiles, int n, int bm,
                          int bn, int rows, Policy p) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float tile[];
  __shared__ uint32_t words[1];  // the CTA's max, read by the cluster
  const int n_ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile_j = blockIdx.x / n_ctas;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * bm + static_cast<size_t>(rank) * rows;
  const size_t col0 = static_cast<size_t>(tile_j) * bn;
  if (threadIdx.x == 0) words[0] = 0u;

  // this thread's 16-byte items: (r, c4) walked without division
  const int per_row = bn / 4, items = rows * per_row;
  const int dr = kTileThreads / per_row, dc = kTileThreads % per_row;
  auto for_items = [&](auto fn) {
    int r = threadIdx.x / per_row, c = threadIdx.x % per_row;
    for (int i = threadIdx.x; i < items; i += kTileThreads) {
      fn(r * bn + c * 4, (row0 + r) * n + col0 + c * 4);
      r += dr;
      c += dc;
      if (c >= per_row) {
        c -= per_row;
        ++r;
      }
    }
  };
  for_items([&](int at, size_t g) { cp_async16(tile + at, x + g); });
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // each thread reads back only its own copies
  uint32_t v[1] = {0u};
  for_items([&](int at, size_t) { v[0] = max(v[0], mag4(*reinterpret_cast<const float4*>(tile + at))); });
  __syncthreads();  // words is zeroed
  r2f2::cluster_publish<1>(v, words);
  r2f2::cluster_collect<1>(v, words, n_ctas, cluster);
  r2f2::cluster_arrive();  // done reading the other CTAs' words
  // operand-only need: a product's bound is its consumer's shared split
  const int me = r2f2::mag_exponent(v[0]);
  const int k = r2f2::k_cover(me, me, p);
  const r2f2::TileQuant q = r2f2::tile_quant(p.eb + k, p.mb + p.fx - k, -1);
  for_items([&](int at, size_t g) {
    __stcs(reinterpret_cast<float4*>(y + g), quantize4(*reinterpret_cast<const float4*>(tile + at), q));
  });
  if (rank == 0 && threadIdx.x == 0) k_tiles[blockIdx.y * (gridDim.x / n_ctas) + tile_j] = k;
  r2f2::cluster_wait();  // no CTA leaves while its words may still be read
}

size_t smem_allowed[r2f2::kMaxDevices] = {};

}  // namespace

// cluster 0: the two-pass shape, one CTA per tile; else the cluster shape,
// `cluster` CTAs per tile of `rows` rows each.
extern "C" int r2f2_quantize(const float* x, float* y, int* k_tiles, int m, int n, int bm, int bn, int eb, int mb,
                             int fx, int cluster, int rows, void* stream) {
  const Policy p{r2f2::kRR, eb, mb, fx, 0, 0, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 0) {
    r2f2_quantize_kernel<<<dim3(n / bn, m / bm), kQuantizeThreads, 0, s>>>(x, y, k_tiles, n, bm, bn, p);
    return static_cast<int>(cudaGetLastError());
  }
  if (cluster < 1 || cluster > 8 || bn % 4 != 0 || rows * cluster != bm)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(rows) * bn * sizeof(float);
  cudaError_t err = r2f2::allow_dynamic_smem(r2f2_quantize_tile_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n / bn) * cluster, m / bm);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, r2f2_quantize_tile_kernel, x, y, k_tiles, n, bm, bn, rows, p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

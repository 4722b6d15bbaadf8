// Kernel K1's harness for the packed storage format, for sm_90a: the device
// functions of r2f2_device.cuh (storage_k, Codec) over the blocks of a 2-D
// array, one CTA a storage block.
//
//   storage_kernel   replaces repro/pack/packed.py::pack_array and unpack_array
//                    (block_storage_k, pack_block, unpack_block), which the
//                    reference runs in XLA around its kernels
//
// Mode 0 packs an f32 array (rows, width) of (br, bw) blocks into payloads,
// each block at its split (the minimal split holding its largest finite
// magnitude, clipped to [k_min, fx]; or k_in's); mode 1 unpacks payloads at
// k_in. The host pads the array to whole blocks with zeros, which carry no exponent.
// The kernels' own storage parts (the rod, heat2d's cluster, K4 swe2d) call
// the same device functions; this kernel packs and unpacks where a chunk's
// state crosses the host: a run's first pack, swe2d's boundaries on the
// fused plane and its megakernel's final pack. It is bound by bytes (4 + 2
// bytes an element at uint16 payloads), one read of the block for its max
// and one for its payloads.
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::Codec;
using r2f2::Policy;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
storage_kernel(int mode, const float* __restrict__ x, void* payload, const int* __restrict__ k_in, int* k_out,
               float* __restrict__ y, int width, int br, int bw, int k_min, int bytes, Policy p) {
  __shared__ uint32_t scratch[32];
  const int gj = width / bw, bi = blockIdx.x / gj, bj = blockIdx.x % gj;
  const int n = br * bw;
  const size_t r0 = static_cast<size_t>(bi) * br, c0 = static_cast<size_t>(bj) * bw;
  auto at = [&](int i) { return (r0 + i / bw) * width + c0 + i % bw; };
  int k;
  if (mode == 1 || k_in != nullptr) {
    k = k_in[blockIdx.x];
  } else {
    uint32_t mx = 0u;
    for (int i = threadIdx.x; i < n; i += blockDim.x) mx = max(mx, r2f2::finite_mag_bits(x[at(i)]));
    k = r2f2::storage_k(r2f2::block_max_u32(mx, scratch), p.eb, p.fx, k_min);
  }
  const Codec codec(k, p);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t j = at(i);
    if (mode == 1) {
      y[j] = codec.decode(r2f2::load_payload(payload, j, bytes));
    } else {
      r2f2::store_payload(payload, j, bytes, codec.pack(x[j]));
    }
  }
  if (mode == 0 && k_out != nullptr && threadIdx.x == 0) k_out[blockIdx.x] = k;
}

}  // namespace

// A (rows, width) array of (br, bw) blocks, both dividing; payload holds
// `bytes` bytes an element (1, 2 or 4), k_in and k_out one split a block
// (row-major over the blocks).
extern "C" int r2f2_storage(int mode, const float* x, void* payload, const int* k_in, int* k_out, float* y, int rows,
                            int width, int br, int bw, int k_min, int bytes, int eb, int mb, int fx, void* stream) {
  const bool ok = (mode == 0 || mode == 1) && rows >= 1 && width >= 1 && br >= 1 && bw >= 1 && rows % br == 0 &&
                  width % bw == 0 && (bytes == 1 || bytes == 2 || bytes == 4) && 1 + eb + mb + fx <= 8 * bytes &&
                  payload != nullptr && (mode == 1 ? k_in != nullptr && y != nullptr : x != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Policy p{r2f2::kRR, eb, mb, fx, 0, 0, 0, 0};
  const int blocks = (rows / br) * (width / bw);
  storage_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(mode, x, payload, k_in, k_out, y, width,
                                                                             br, bw, k_min, bytes, p);
  return static_cast<int>(cudaGetLastError());
}

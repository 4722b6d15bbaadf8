// Kernel K7 of repro_torch, for sm_90a:
//
//   r2f2_matmul_kernel  replaces repro/kernels/r2f2_matmul.py::r2f2_matmul_pallas
//                       (_matmul_kernel)
//   split_sum_kernel    sums the K blocks' partials of a split launch
//
// C = A @ B through block-granular R2F2 multipliers. A is (m, kdim), B is
// (kdim, n), C is (m, n), all row-major f32. Each (bm, bn) output block has
// K blocks j = 0 .. gk-1; for each (bm, bk) x (bk, bn) block pair:
//
//   1. k_j = select_k_mul(max exponent of the A tile, of the B tile); entries
//      past the matrix edge are zero, which never raises a tile max (the
//      reference's zero padding);
//   2. both tiles are quantized, RNE, to E(EB+k_j) M(MB+FX-k_j);
//   3. partial_j = the bk-term dot products in kk order from 0.0f, one FMA per
//      product (with round_products: each product rounded to the runtime
//      format with the FX-tail truncation, then added);
//   4. acc = (((0 + partial_0) + partial_1) + ...) in j order.
//
// Every step runs the same f32 operations in the same order as the reference's
// grid walk (`o_ref[...] += partial` over its innermost axis), so a split and
// an unsplit launch give the same bits. No tensor cores: TF32 would round the
// quantized significands, and an MMA aligns and truncates inside each
// instruction.
//
// What bounds each shape class on an H100, and what the design does about it:
//
// * Few output blocks (the router; the shared expert at decode, 4 rows): the
//   bytes of B bound the work, but every entry of B also takes the tile max
//   and an RNE quantize, ~30 integer instructions, while it feeds only 4 FMAs;
//   one CTA per output block would leave most of the 132 SMs idle.
//   kernels/r2f2_matmul.py::split_plan then gives every K block its own CTA
//   (grid (gn, gm, S)): each CTA writes its partial_j into a (gk, m, n)
//   scratch buffer, and split_sum_kernel folds the partials in j order. A
//   CTA holds one K block's ring, so three share an SM. Small-bm blocks use
//   the column layout: each thread owns TM rows of one column, so no thread
//   computes padding rows while the whole CTA streams and quantizes B.
// * Many output blocks with many rows (the shared expert at prefill): bound by
//   f32 operations. One CTA per output block walks its K blocks with an 8 x 8
//   register tile per thread and float4 shared-memory reads.
// * Every CTA streams its tiles through a ring of shared-memory slots of
//   kChunk K rows each, filled by 16-byte cp.async.cg copies (4-byte
//   cp.async.ca where a row is not 16-byte aligned; zero fill past the edges),
//   addressed by row and column loops. As the products of a chunk finish, its
//   slot is refilled with a chunk of the next K block, and slots beyond one K
//   block keep more of it in flight, while the current block is reduced,
//   quantized and multiplied. Each thread takes the maximum of the entries it
//   copied and quantizes them in place (r2f2::TileQuant: the format's
//   constants once per tile, no divergence between normal and subnormal
//   results); both tiles' maxima meet in one barrier.
#include <cstdint>

#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::Policy;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // K rows per ring slot
constexpr int kMaxBlock = 128;
constexpr int kMaxSmem = 227 * 1024;

// The ring's geometry and the problem, as every CTA sees them.
struct Shape {
  int m, n, kdim;
  int bm, bn, bk;
  int bnp;     // a B chunk row in shared memory: bn rounded up to 4
  int gk;      // K blocks
  int splits;  // CTAs along K (grid z); 1 = one CTA walks all K blocks
  int slots;   // ring slots
  int chunks;  // ring slots per K block: ceil(bk / kChunk)
  int vec_a, vec_b;  // 16-byte copies for A, B rows
};

__device__ __forceinline__ void cp_async(float* dst, const float* src, int g, int valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (g == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid * 4) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid * 4) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n of this thread's copy groups are pending. Waiting for
// fewer is always correct, so a count past the table waits for all.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// The entries one thread copies from a (rows x cols) chunk: items of g floats
// at row r0, r0 + rstep, ... and column c0. Computed once per kernel; the
// same thread copies, reduces and quantizes the same positions of every chunk.
struct CopyMap {
  int r0, c0, rstep, g;
  bool active;
};

__device__ __forceinline__ CopyMap copy_map(int cols, int g) {
  const int per_row = (cols + g - 1) / g;
  CopyMap mp;
  mp.g = g;
  mp.rstep = kThreads / per_row;
  mp.r0 = threadIdx.x / per_row;
  mp.c0 = (threadIdx.x % per_row) * g;
  mp.active = threadIdx.x < mp.rstep * per_row;
  return mp;
}

__device__ __forceinline__ int clamp_items(int v, int g) { return min(max(v, 0), g); }

__device__ __forceinline__ float lane(const float4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

template <bool kRoundProducts>
__device__ __forceinline__ float product_add(float a, float b, float part, const r2f2::TileQuant& qp) {
  if (kRoundProducts) return __fadd_rn(part, r2f2::quantize_tile(__fmul_rn(a, b), qp));
  return __fmaf_rn(a, b, part);
}

// The block's ring: slot s holds an A chunk (bm x kChunk) then a B chunk
// (kChunk x bnp).
struct Ring {
  float* base;
  int slot_floats, a_floats;
  __device__ __forceinline__ float* a(int slot) const { return base + slot * slot_floats; }
  __device__ __forceinline__ float* b(int slot) const { return base + slot * slot_floats + a_floats; }
};

// Issue chunk q of this CTA's K range (one copy group, empty past the range).
__device__ __forceinline__ void issue_chunk(const Shape& s, const Ring& ring, const CopyMap& ma, const CopyMap& mb,
                                            const float* __restrict__ a, const float* __restrict__ b, int row0,
                                            int col0, int j0, int n_chunks, int q) {
  if (q < n_chunks) {
    const int j = j0 + q / s.chunks, c = q % s.chunks;
    const int kc = c * kChunk, k0 = j * s.bk + kc;
    const int clen = min(kChunk, s.bk - kc);
    const int slot = q % s.slots;
    float* as = ring.a(slot);
    float* bs = ring.b(slot);
    for (int r = ma.r0; r < s.bm; r += ma.rstep) {
      const int gr = row0 + r, gc = k0 + ma.c0;
      const int valid = gr < s.m ? clamp_items(min(clen - ma.c0, s.kdim - gc), ma.g) : 0;
      const float* src = valid > 0 ? a + static_cast<size_t>(gr) * s.kdim + gc : a;
      cp_async(as + r * kChunk + ma.c0, src, ma.g, valid);
    }
    if (mb.active) {
      for (int r = mb.r0; r < kChunk; r += mb.rstep) {
        const int gr = k0 + r, gc = col0 + mb.c0;
        const int valid = (r < clen && gr < s.kdim) ? clamp_items(min(s.bn - mb.c0, s.n - gc), mb.g) : 0;
        const float* src = valid > 0 ? b + static_cast<size_t>(gr) * s.n + gc : b;
        cp_async(bs + r * s.bnp + mb.c0, src, mb.g, valid);
      }
    }
  }
  cp_async_commit();
}

// The items this thread copied into one chunk: up to N at rows r0, r0 +
// rstep, ... below `rows`, of G floats at column c0 (a B chunk row holds at
// most 32 items of 4 floats or 128 of 1, and 256 threads cover 8 or 2 rows at
// a time, so N = 4 for G = 4 and 16 for G = 1). All loads are issued before
// any item is used.
template <int G, int N, bool kStore, typename Fn>
__device__ __forceinline__ void chunk_items(float* base, int ld, const CopyMap& mp, int rows, Fn& fn) {
  float v[N][G];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = mp.r0 + i * mp.rstep;
    if (r < rows) {
      if constexpr (G == 4) {
        const float4 x = *reinterpret_cast<const float4*>(base + r * ld + mp.c0);
        v[i][0] = x.x, v[i][1] = x.y, v[i][2] = x.z, v[i][3] = x.w;
      } else {
        v[i][0] = base[r * ld + mp.c0];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = mp.r0 + i * mp.rstep;
    if (r < rows) {
#pragma unroll
      for (int k = 0; k < G; ++k) fn(v[i][k]);
      if constexpr (kStore) {
        if constexpr (G == 4) {
          *reinterpret_cast<float4*>(base + r * ld + mp.c0) = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
        } else {
          base[r * ld + mp.c0] = v[i][0];
        }
      }
    }
  }
}

template <bool kStore, typename Fn>
__device__ __forceinline__ void map_items(float* base, int ld, const CopyMap& mp, int rows, Fn& fn) {
  if (!mp.active) return;
  if (mp.g == 4) chunk_items<4, 4, kStore>(base, ld, mp, rows, fn);
  else chunk_items<1, 16, kStore>(base, ld, mp, rows, fn);
}

// Apply fa to every float this thread copied into the A chunks of local K
// block t, fb to those of its B chunks (kStore: they may change them, and the
// result is written back).
template <bool kStore, typename FnA, typename FnB>
__device__ __forceinline__ void for_own(const Shape& s, const Ring& ring, const CopyMap& ma, const CopyMap& mb, int t,
                                        FnA fa, FnB fb) {
  for (int c = 0; c < s.chunks; ++c) {
    const int slot = (t * s.chunks + c) % s.slots;
    map_items<kStore>(ring.a(slot), kChunk, ma, s.bm, fa);
    map_items<kStore>(ring.b(slot), s.bnp, mb, kChunk, fb);
  }
}

// The output layouts. Tiled: 16 x 16 threads, 8 x 8 outputs each (rows
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, the same for columns), for blocks up
// to 128 x 128. Column<TM>: thread t owns column t % bn and rows
// (t / bn) * TM + {0..TM-1}, for blocks with bn * ceil(bm / TM) <= 256.
struct Tiled {
  static constexpr int kRows = 8, kCols = 8;
  static constexpr int kMinBlocks = 1;  // 64 + 64 accumulators and operands: ~240 registers
  int ty, tx;
  __device__ Tiled(const Shape&) : ty(threadIdx.x / 16), tx(threadIdx.x % 16) {}
  __device__ __forceinline__ bool active() const { return true; }
  __device__ __forceinline__ int row(int i) const { return ty * 4 + (i & 3) + (i >> 2) * 64; }
  __device__ __forceinline__ int col(int j) const { return tx * 4 + (j & 3) + (j >> 2) * 64; }

  template <bool kRP>
  __device__ __forceinline__ void fma_chunk(const Shape& s, const float* as, const float* bs, int clen,
                                            float (&part)[kRows][kCols], const r2f2::TileQuant& qp) const {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int kk = 0;
#pragma unroll 1
    for (; kk + 4 <= clen; kk += 4) {
      float4 av[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        av[i] = row(i) < s.bm ? *reinterpret_cast<const float4*>(as + row(i) * kChunk + kk) : zero;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* brow = bs + (kk + q) * s.bnp;
        const float4 b0 = col(0) < s.bnp ? *reinterpret_cast<const float4*>(brow + col(0)) : zero;
        const float4 b1 = col(4) < s.bnp ? *reinterpret_cast<const float4*>(brow + col(4)) : zero;
        const float bv[kCols] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float a = lane(av[i], q);
#pragma unroll
          for (int j = 0; j < kCols; ++j) part[i][j] = product_add<kRP>(a, bv[j], part[i][j], qp);
        }
      }
    }
    for (; kk < clen; ++kk) {
      const float* brow = bs + kk * s.bnp;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float a = row(i) < s.bm ? as[row(i) * kChunk + kk] : 0.0f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float b = col(j) < s.bnp ? brow[col(j)] : 0.0f;
          part[i][j] = product_add<kRP>(a, b, part[i][j], qp);
        }
      }
    }
  }
};

template <int TM>
struct Column {
  static constexpr int kRows = TM, kCols = 1;
  static constexpr int kMinBlocks = TM <= 2 ? 3 : 2;  // decode: three CTAs of one K block's ring per SM
  int c, r0;
  bool on;
  __device__ Column(const Shape& s) : c(threadIdx.x % s.bn), r0((threadIdx.x / s.bn) * TM) {
    on = r0 < s.bm && threadIdx.x < s.bn * ((s.bm + TM - 1) / TM);
  }
  __device__ __forceinline__ bool active() const { return on; }
  __device__ __forceinline__ int row(int i) const { return r0 + i; }
  __device__ __forceinline__ int col(int) const { return c; }

  template <bool kRP>
  __device__ __forceinline__ void fma_chunk(const Shape& s, const float* as, const float* bs, int clen,
                                            float (&part)[kRows][kCols], const r2f2::TileQuant& qp) const {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int kk = 0;
    for (; kk + 4 <= clen; kk += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = row(i) < s.bm ? *reinterpret_cast<const float4*>(as + row(i) * kChunk + kk) : zero;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float b = bs[(kk + q) * s.bnp + c];
#pragma unroll
        for (int i = 0; i < TM; ++i) part[i][0] = product_add<kRP>(lane(av[i], q), b, part[i][0], qp);
      }
    }
    for (; kk < clen; ++kk) {
      const float b = bs[kk * s.bnp + c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = row(i) < s.bm ? as[row(i) * kChunk + kk] : 0.0f;
        part[i][0] = product_add<kRP>(a, b, part[i][0], qp);
      }
    }
  }
};

// This thread's outputs of an (m, n) matrix.
template <typename Layout, int R, int Cn>
__device__ __forceinline__ void store(const Shape& s, const Layout& lay, float* dst, int row0, int col0,
                                      const float (&v)[R][Cn]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int gr = row0 + lay.row(i);
    if (lay.row(i) >= s.bm || gr >= s.m) continue;
#pragma unroll
    for (int j = 0; j < Cn; ++j) {
      const int gc = col0 + lay.col(j);
      if (lay.col(j) < s.bn && gc < s.n) dst[static_cast<size_t>(gr) * s.n + gc] = v[i][j];
    }
  }
}

// One CTA: output block (blockIdx.y, blockIdx.x), K blocks [j0, j1) of
// blockIdx.z's share. S == 1 writes C; S > 1 writes each partial_j into
// out = scratch (gk, m, n).
template <typename Layout, bool kRoundProducts>
__global__ void __launch_bounds__(kThreads, Layout::kMinBlocks)
r2f2_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out, Shape s,
                   Policy p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t red[kWarps][2];
  constexpr int R = Layout::kRows, Cn = Layout::kCols;
  const Ring ring{smem, s.bm * kChunk + kChunk * s.bnp, s.bm * kChunk};
  const int row0 = blockIdx.y * s.bm, col0 = blockIdx.x * s.bn;
  const int j0 = static_cast<int>(static_cast<long long>(blockIdx.z) * s.gk / s.splits);
  const int j1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * s.gk / s.splits);
  const int n_chunks = (j1 - j0) * s.chunks;
  const CopyMap ma = copy_map(kChunk, s.vec_a ? 4 : 1);
  const CopyMap mb = copy_map(s.bn, s.vec_b ? 4 : 1);
  const Layout lay(s);
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;

  for (int q = 0; q < s.slots; ++q) issue_chunk(s, ring, ma, mb, a, b, row0, col0, j0, n_chunks, q);

  float acc[R][Cn];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < Cn; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < j1 - j0; ++t) {
    // this thread's copies of K block t have landed (slots - chunks groups,
    // the next blocks' chunks, may still be in flight)
    cp_async_wait_dyn(s.slots - s.chunks);
    uint32_t amx = 0u, bmx = 0u;
    for_own<false>(
        s, ring, ma, mb, t, [&](float& v) { amx = max(amx, r2f2::finite_mag_bits(v)); },
        [&](float& v) { bmx = max(bmx, r2f2::finite_mag_bits(v)); });
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      amx = max(amx, __shfl_xor_sync(0xffffffffu, amx, o));
      bmx = max(bmx, __shfl_xor_sync(0xffffffffu, bmx, o));
    }
    if (lane_id == 0) {
      red[warp][0] = amx;
      red[warp][1] = bmx;
    }
    __syncthreads();  // the one barrier of the two tile maxima
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      amx = max(amx, red[w][0]);
      bmx = max(bmx, red[w][1]);
    }
    const int k = r2f2::select_k_mul(r2f2::mag_exponent(amx), r2f2::mag_exponent(bmx), p);
    const r2f2::SplitQuant fq = r2f2::split_quant(k, p);  // operands; products with the tail
    if (fq.op.fast) {
      const auto quantize = [&](float& v) { v = r2f2::quantize_tile_fast(v, fq.op); };
      for_own<true>(s, ring, ma, mb, t, quantize, quantize);
    } else {
      const auto quantize = [&](float& v) { v = r2f2::quantize_tile(v, fq.op); };
      for_own<true>(s, ring, ma, mb, t, quantize, quantize);
    }
    __syncthreads();  // every thread's quantized entries are in place (and red is read)

    float part[R][Cn];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < Cn; ++j) part[i][j] = 0.0f;
    for (int c = 0; c < s.chunks; ++c) {
      const int q = t * s.chunks + c, slot = q % s.slots;
      if (lay.active())
        lay.template fma_chunk<kRoundProducts>(s, ring.a(slot), ring.b(slot), min(kChunk, s.bk - c * kChunk), part,
                                               fq.prod);
      // refill the slot once every reader is done with it; past the range the
      // group is empty (the waits count one group per chunk) and needs no barrier
      if (q + s.slots < n_chunks) __syncthreads();
      issue_chunk(s, ring, ma, mb, a, b, row0, col0, j0, n_chunks, q + s.slots);
    }

    if (s.splits > 1) {
      if (lay.active()) store(s, lay, out + static_cast<size_t>(j0 + t) * s.m * s.n, row0, col0, part);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < Cn; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    }
  }
  cp_async_wait<0>();
  if (s.splits == 1 && lay.active()) store(s, lay, out, row0, col0, acc);
}

// acc = (((0 + partial_0) + partial_1) + ...) in j order, one thread per output.
__global__ void split_sum_kernel(const float* __restrict__ scratch, float* __restrict__ c, int gk, size_t mn) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float acc = 0.0f;
  for (int j = 0; j < gk; ++j) acc = __fadd_rn(acc, scratch[static_cast<size_t>(j) * mn + idx]);
  c[idx] = acc;
}

template <typename Layout, bool kRoundProducts>
int launch(const float* a, const float* b, float* out, const Shape& s, const Policy& p, size_t smem,
           cudaStream_t stream) {
  const auto kernel = r2f2_matmul_kernel<Layout, kRoundProducts>;
  static size_t allowed[r2f2::kMaxDevices] = {};  // this kernel's shared-memory attribute
  const cudaError_t err = r2f2::allow_dynamic_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.n + s.bn - 1) / s.bn, (s.m + s.bm - 1) / s.bm, s.splits);
  kernel<<<grid, kThreads, smem, stream>>>(a, b, out, s, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRoundProducts>
int launch_layout(const float* a, const float* b, float* out, const Shape& s, const Policy& p, size_t smem,
                  cudaStream_t stream) {
  const auto fits = [&](int tm) { return s.bn * ((s.bm + tm - 1) / tm) <= kThreads; };
  if (fits(2)) return launch<Column<2>, kRoundProducts>(a, b, out, s, p, smem, stream);
  if (fits(8)) return launch<Column<8>, kRoundProducts>(a, b, out, s, p, smem, stream);
  return launch<Tiled, kRoundProducts>(a, b, out, s, p, smem, stream);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// splits > 1 needs scratch of gk * m * n floats; slots >= ceil(bk / 32).
extern "C" int r2f2_matmul(const float* a, const float* b, float* c, float* scratch, int m, int n, int kdim, int bm,
                           int bn, int bk, int splits, int slots, int eb, int mb, int fx, int round_products,
                           int tail_approx, void* stream) {
  Shape s{};
  s.m = m, s.n = n, s.kdim = kdim, s.bm = bm, s.bn = bn, s.bk = bk;
  s.bnp = (bn + 3) / 4 * 4;
  s.gk = (kdim + bk - 1) / bk;
  s.splits = splits, s.slots = slots;
  s.chunks = (bk + kChunk - 1) / kChunk;
  s.vec_a = kdim % 4 == 0 && bk % 4 == 0 && aligned16(a);
  s.vec_b = n % 4 == 0 && bn % 4 == 0 && aligned16(b);
  const size_t smem = static_cast<size_t>(slots) * (bm * kChunk + kChunk * s.bnp) * sizeof(float);
  if (bm < 1 || bn < 1 || bk < 1 || bm > kMaxBlock || bn > kMaxBlock || splits < 1 || splits > s.gk ||
      slots < s.chunks || smem > kMaxSmem || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Policy p{r2f2::kRR, eb, mb, fx, 0, 0, tail_approx, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? scratch : c;
  const int err = round_products ? launch_layout<true>(a, b, out, s, p, smem, st)
                                 : launch_layout<false>(a, b, out, s, p, smem, st);
  if (err != 0 || splits == 1) return err;
  const size_t mn = static_cast<size_t>(m) * n;
  split_sum_kernel<<<static_cast<unsigned>((mn + kThreads - 1) / kThreads), kThreads, 0, st>>>(scratch, c, s.gk, mn);
  return static_cast<int>(cudaGetLastError());
}

// The fused-plane SWE kernel of repro_torch, for sm_90a:
//
//   K3 swe_flux_kernel  replaces repro/kernels/fused.py::fused_sweep with
//                       repro/kernels/swe_flux.py::_swe_flux_body
//
// (K2, the heat1d sweep, is the rod, rod.cuh.) The host side
// (kernels/fused.py::fused_sweep) pads the field and fixes the split blocks;
// K3 gives one split tile to one thread-block cluster, so every block max
// spans exactly the reference's block, pad lanes included. Evidence is
// written per block as (gi, gj, steps, n_sites, 2) floats and max-reduced
// across blocks on the host. With capture (r2f2::Capture) each CTA bins its
// band's operands, the lanes inside the field's valid extent only (a padded
// q3 lane holds 1.0, which must never count), into a shared-memory histogram
// after its band arrays, and adds it to the launch's one slot. The C entry
// point returns cudaGetLastError().
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::Policy;

namespace {

constexpr int kSweThreads = 256;
constexpr int kSweWarps = kSweThreads / 32;
constexpr int kMaxCluster = 16;  // the non-portable cluster size limit

// G consecutive floats, one 16-byte access for G = 4.
template <int G>
__device__ __forceinline__ void load(const float* src, float (&v)[G]) {
  if constexpr (G == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) v[i] = src[i];
  }
}

template <int G>
__device__ __forceinline__ void store(float* dst, const float (&v)[G]) {
  if constexpr (G == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) dst[i] = v[i];
  }
}

// K3: the momentum flux q1*q1/q3 + c*(q3*q3) over one (br, bw) split tile,
// run by one thread-block cluster of C CTAs (kernels/swe_flux.py::cluster_plan).
// An ensemble's member is blockIdx.z: its own field, tiles, floor, evidence
// and histograms, so a member's tile never takes another member's rows.
// Sites: 0 q1*q1, 1 q3*q3, 2 c*t3, 3 t1/q3. CTA `rank` owns rows
// [rank * band, (rank + 1) * band) of the tile. It loads its q1 and q3 once
// (float4 where the rows are 16-byte aligned) into shared memory; each split
// needs a tile-wide max, which the cluster takes in two rounds: every CTA
// publishes its maxima in its shared memory, and after cluster.sync() every
// warp reads all C of them through distributed shared memory, so all CTAs
// derive the same splits. The products t1 and t3 stay in shared
// memory between the rounds; each CTA writes its out band once, and rank 0
// writes the tile's evidence. Elements are walked by row and column, with no
// per-element division. Capture bins, per site, q1 (q1*q1: both operands), q3
// (q3*q3 both, and the quotient's divisor), t3 and t1, and the constant c over
// the valid lanes.
template <int G>
__global__ void __launch_bounds__(kSweThreads)
swe_flux_kernel(const float* __restrict__ q1, const float* __restrict__ q3, float* __restrict__ out,
                float* __restrict__ ev, const int* __restrict__ k_floor, int width, int br, int bw, int band, float c,
                Policy p, r2f2::Capture cap) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  {  // the member's arrays (blockIdx.z): its field of gridDim.y row tiles, its tiles' evidence
    const size_t m = blockIdx.z, field = static_cast<size_t>(gridDim.y) * br * width;
    q1 = r2f2::at_member(q1, m, field);
    q3 = r2f2::at_member(q3, m, field);
    out = r2f2::at_member(out, m, field);
    ev = r2f2::at_member(ev, m, static_cast<size_t>(gridDim.y) * (gridDim.x / cluster.num_blocks()) * 8);
    k_floor = r2f2::at_member(k_floor, m, 4);
    cap = r2f2::member_capture(cap, m, 1, 4);
  }
  extern __shared__ __align__(16) float band_smem[];
  __shared__ uint32_t red[kSweWarps][2];  // per-warp maxima
  __shared__ uint32_t pub[2][2];          // the CTA's maxima of the two rounds, read by the cluster
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ctas = static_cast<int>(cluster.num_blocks());
  const int tile_j = blockIdx.x / n_ctas;
  const int r_lo = rank * band;
  const int rows = max(min(br, r_lo + band) - r_lo, 0);
  const size_t row0 = static_cast<size_t>(blockIdx.y) * br + r_lo;
  const int col0 = tile_j * bw;
  float* hs = band_smem;          // q3
  float* t1s = hs + band * bw;    // q1, then t1
  float* t3s = t1s + band * bw;   // t3
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const r2f2::Hist hist(cap, reinterpret_cast<int*>(t3s + band * bw), 4);  // after the band arrays
  if (hist.on()) {
    hist.zero();
    __syncthreads();  // the words zeroed before any lane adds
  }

  // this thread's items: G floats at (r, col) for r, col walked without division;
  // fn(shared offset, global offset, the items' lanes inside the valid extent as bits)
  const int per_row = bw / G, items = rows * per_row;
  const int dr = kSweThreads / per_row, dc = kSweThreads % per_row;
  auto for_items = [&](auto fn) {
    int r = threadIdx.x / per_row, col = threadIdx.x % per_row;
    for (int i = threadIdx.x; i < items; i += kSweThreads) {
      uint32_t valid = 0u;
      if (hist.on() && static_cast<int>(row0) + r < cap.rows) {
#pragma unroll
        for (int g = 0; g < G; ++g) valid |= static_cast<uint32_t>(col0 + col * G + g < cap.cols) << g;
      }
      fn(r * bw + col * G, (row0 + r) * width + col0 + col * G, valid);
      r += dr;
      col += dc;
      if (col >= per_row) {
        col -= per_row;
        ++r;
      }
    }
  };
  // the tile-wide max of (x, y) over the cluster, in round `round`: the CTA's
  // max is published in its shared memory, and after the cluster barrier lane
  // r of every warp reads CTA r's
  auto cluster_max = [&](uint32_t x, uint32_t y, int round) {
    for (int o = 16; o > 0; o >>= 1) {
      x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
      y = max(y, __shfl_xor_sync(0xffffffffu, y, o));
    }
    if (lane == 0) {
      red[warp][0] = x;
      red[warp][1] = y;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 0; w < kSweWarps; ++w) {
        x = max(x, red[w][0]);
        y = max(y, red[w][1]);
      }
      pub[round][0] = x;
      pub[round][1] = y;
    }
    cluster.sync();
    x = y = 0u;
    if (lane < n_ctas) {
      const uint32_t* remote = cluster.map_shared_rank(&pub[round][0], lane);
      x = remote[0];
      y = remote[1];
    }
    for (int o = 16; o > 0; o >>= 1) {
      x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
      y = max(y, __shfl_xor_sync(0xffffffffu, y, o));
    }
    return make_int2(r2f2::mag_exponent(x), r2f2::mag_exponent(y));
  };

  uint32_t m1 = 0u, m3 = 0u;
  for_items([&](int at, size_t gi, uint32_t) {
    float a[G], h[G];
    load<G>(q1 + gi, a);
    load<G>(q3 + gi, h);
    store<G>(t1s + at, a);
    store<G>(hs + at, h);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      m1 = max(m1, r2f2::finite_mag_bits(a[i]));
      m3 = max(m3, r2f2::finite_mag_bits(h[i]));
    }
  });
  if (hist.on()) {  // q1q1 (q1, q1), q3q3 (q3, q3), div's divisor q3, from the band in shared memory
    const r2f2::Hist& h = hist;
    for_items([&](int at, size_t, uint32_t valid) {
      float a[G], q[G];
      load<G>(t1s + at, a);
      load<G>(hs + at, q);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const bool in = (valid >> i) & 1u;
        h.add(0, a[i], in);
        h.add(1, a[i], in);
        h.add(2, q[i], in);
        h.add(3, q[i], in);
        h.add(7, q[i], in);
      }
    });
  }
  const int2 e13 = cluster_max(m1, m3, 0);
  const int e1 = e13.x, e3 = e13.y;
  const int k11 = r2f2::site_k(r2f2::select_k_mul(e1, e1, p), k_floor, 0, p);
  const int k33 = r2f2::site_k(r2f2::select_k_mul(e3, e3, p), k_floor, 1, p);
  // the rr family's splits as precomputed formats (the same bits as family_mul)
  const bool rr = p.family == r2f2::kRR;
  const r2f2::SplitQuant f11 = r2f2::split_quant(k11, p), f33 = r2f2::split_quant(k33, p);

  uint32_t mt1 = 0u, mt3 = 0u;
  for_items([&](int at, size_t, uint32_t) {
    float a[G], h[G], t1[G], t3[G];
    load<G>(t1s + at, a);
    load<G>(hs + at, h);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      t1[i] = rr ? r2f2::rr_mul(a[i], a[i], f11) : r2f2::family_mul(a[i], a[i], k11, p);
      t3[i] = rr ? r2f2::rr_mul(h[i], h[i], f33) : r2f2::family_mul(h[i], h[i], k33, p);
      mt1 = max(mt1, r2f2::finite_mag_bits(t1[i]));
      mt3 = max(mt3, r2f2::finite_mag_bits(t3[i]));
    }
    store<G>(t1s + at, t1);
    store<G>(t3s + at, t3);
  });
  if (hist.on()) {  // gq3's t3 and div's dividend t1, each thread its own items
    const r2f2::Hist& h = hist;
    for_items([&](int at, size_t, uint32_t valid) {
      float t1[G], t3[G];
      load<G>(t1s + at, t1);
      load<G>(t3s + at, t3);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        h.add(5, t3[i], (valid >> i) & 1u);
        h.add(6, t1[i], (valid >> i) & 1u);
      }
    });
  }
  const int2 et13 = cluster_max(mt1, mt3, 1);
  // this CTA has read the cluster's maxima: arrive at the exit barrier now,
  // wait for the others only before leaving
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  const int et1 = et13.x, et3 = et13.y;
  const int ec = r2f2::mag_exponent(r2f2::finite_mag_bits(c));
  const int k_gq3 = r2f2::site_k(r2f2::select_k_mul(ec, et3, p), k_floor, 2, p);
  const int k_div = r2f2::site_k(r2f2::select_k_div(et1, e3, p), k_floor, 3, p);
  const r2f2::SplitQuant fgq3 = r2f2::split_quant(k_gq3, p), fdiv = r2f2::split_quant(k_div, p);

  for_items([&](int at, size_t gi, uint32_t) {
    float t1[G], t3[G], h[G], f[G];
    load<G>(t1s + at, t1);
    load<G>(t3s + at, t3);
    load<G>(hs + at, h);
#pragma unroll
    for (int i = 0; i < G; ++i)
      f[i] = rr ? __fadd_rn(r2f2::rr_mul(c, t3[i], fgq3), r2f2::rr_div(t1[i], h[i], fdiv))
                : r2f2::family_mul_add(c, t3[i], r2f2::family_div(t1[i], h[i], k_div, p), k_gq3, p);
    store<G>(out + gi, f);
  });
  if (ev != nullptr && rank == 0 && threadIdx.x == 0) {
    float* e = ev + (static_cast<size_t>(blockIdx.y) * (gridDim.x / n_ctas) + tile_j) * 8;
    e[0] = static_cast<float>(e1);
    e[1] = static_cast<float>(e1);
    e[2] = static_cast<float>(e3);
    e[3] = static_cast<float>(e3);
    e[4] = static_cast<float>(ec);
    e[5] = static_cast<float>(et3);
    e[6] = static_cast<float>(et1);
    e[7] = static_cast<float>(e3);
  }
  if (hist.on()) {  // gq3's constant c over this thread's valid lanes, then the CTA's words
    int n_valid = 0;
    for_items([&](int, size_t, uint32_t valid) { n_valid += __popc(valid); });
    const r2f2::Hist& h = hist;
    h.add_n(4, c, n_valid);
    h.flush(0);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");  // no CTA leaves while another may read it
}

Policy make_policy(int family, int eb, int mb, int fx, int fe, int fm, int tail_approx, int pinned) {
  return Policy{family, eb, mb, fx, fe, fm, tail_approx, pinned};
}

}  // namespace

// One cluster of `cluster` CTAs per (br, bw) tile, each owning `band` rows
// (cluster * band >= br > (cluster - 1) * band). cap_out (null: capture off)
// takes the four sites' operand histograms, (4, 2, cap_bins) int32 zeroed,
// over the lanes of the unpadded (cap_rows, cap_cols) field. `members`
// ensemble members (blockIdx.z) each have their own (rows, width) field, tiles,
// floor, evidence and histograms: every array leads with the member.
extern "C" int r2f2_swe_flux(const float* q1, const float* q3, float* out, float* ev, const int* k_floor, int members,
                             int rows, int width, int br, int bw, int cluster, int band, float c, int family, int eb,
                             int mb, int fx, int fe, int fm, int tail_approx, int pinned, int* cap_out, int cap_e_lo,
                             int cap_bins, int cap_rows, int cap_cols, void* stream) {
  const r2f2::Capture cap{cap_out, cap_e_lo, cap_bins, cap_rows, cap_cols};
  if (members < 1 || members > 65535 || cluster < 1 || cluster > kMaxCluster || band < 1 || cluster * band < br ||
      (cluster - 1) * band >= br || !r2f2::capture_ok(cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const bool vec = bw % 4 == 0 && width % 4 == 0 && aligned(q1) && aligned(q3) && aligned(out);
  const auto kernel = vec ? &swe_flux_kernel<4> : &swe_flux_kernel<1>;
  const size_t smem = 3 * static_cast<size_t>(band) * bw * sizeof(float) + r2f2::hist_bytes(cap, 4);
  static size_t smem_allowed[2][r2f2::kMaxDevices] = {};  // per kernel: scalar, vector
  static bool clusters_allowed[2][r2f2::kMaxDevices] = {};
  cudaError_t err = r2f2::allow_dynamic_smem(kernel, smem, smem_allowed[vec]);
  if (err == cudaSuccess && cluster > 8) err = r2f2::allow_large_clusters(kernel, clusters_allowed[vec]);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((width / bw) * cluster, rows / br, members);
  cfg.blockDim = dim3(kSweThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q1, q3, out, ev, k_floor, width, br, bw, band, c,
                           make_policy(family, eb, mb, fx, fe, fm, tail_approx, pinned), cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

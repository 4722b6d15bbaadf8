// Kernel K5 of repro_torch, for sm_90a: the fused sweeps and the megakernels
// of the three beyond-paper workloads.
//
//   heat2d_sweep_kernel<P>           K5a  replaces repro/kernels/fused.py::fused_sweep
//   fused_sweep_kernel<Advection1D>  K5b    with repro/kernels/pde_steps.py::_heat2d_body,
//   fused_sweep_kernel<Burgers1D>    K5c    _advection1d_body, _burgers1d_body
//   heat2d_mega_kernel<P>            K5d  replace repro/kernels/mega.py::mega_sweep
//   mega_sweep_kernel<Advection1D>   K5e    with heat2d_mega, advection1d_mega,
//   mega_sweep_kernel<Burgers1D>     K5f    burgers1d_mega
//
// heat2d (K5a, K5d) runs as one thread-block cluster of C CTAs in row bands
// (kernels/pde_steps.py::heat2d_cluster_plan): each CTA keeps its band of the
// field and a halo row above and below in shared memory, and each thread keeps
// the up to P interior cells it owns (their offsets, values, and lap then
// flux) in registers across a substep's three passes. The two field-wide
// maxima of a substep (lap, then flux) each take one cluster barrier: every
// warp folds its max into its CTA's word with a shared-memory atomic, and
// after cluster.sync() lane r of every warp reads CTA r's word through
// distributed shared memory, so every CTA derives the same splits. The update
// writes each band's edge rows into the neighbours' halos through distributed
// shared memory, behind the substep's third cluster barrier. A pass builds its
// split's formats once (r2f2::split_quant; the fixed family one TileQuant):
// no per-element format constants and no divergent subnormal branch. Fused
// and megakernel templates share this body (Heat2DBand).
//
// The 1-D bodies keep one CTA for the whole rod, in two templates over their
// device bodies: the periodic rod as one row (256 f32 is 1 KB) in shared
// memory, a substep a few passes over it, each ending in a block-wide max of
// magnitude bits where a policy product needs its split; neighbours (the
// periodic wrap at (i - 1 + n) % n and (i + 1) % n) are read from shared
// memory behind a barrier. advection1d updates in place (every thread reads
// only its own cell in the last pass); burgers1d into a second state row
// (its average reads both neighbours).
//
// The megakernels add kernel K4's contract (mega_pde.cu): with an evolving
// tracker each site's row ticks every substep (r2f2::adjust_tick) while the
// datapath floor `ka` latches to the row's split only at snapshot boundaries;
// a pinned tracker's row is the fixed split; snapshots at every boundary; the
// remainder substeps after the last boundary in the same launch. In the
// heat2d cluster the evidence is cluster-wide, so every CTA's thread 0 ticks
// its own copy of the rows and latches its own `ka`; rank 0 writes the rows.
//
// Rounding follows the compiled reference (the plain versions in
// pde/heat2d.py, advection1d.py and burgers1d.py say where): in the f32 family
// heat2d's update is fma(lap, alpha*dtodx2, u) and advection1d's difference is
// fma(speed, u, -f[i-1]); advection1d's update is a family_mul_add; burgers1d
// rounds its update twice. At the main path's sizes a substep moves no bytes
// from device memory and does a few thousand f32 operations: the kernels are
// bound by the latency of the serial substep chain and its reductions, which
// heat2d's cluster spreads over up to 16 SMs. Each C entry point returns the
// launch's cudaError_t.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::AdjustLaw;
using r2f2::Policy;
using r2f2::SiteState;

namespace {

// The field's shape and the body's two f32 constants, each rounded once from
// its f64 value on the host: heat2d (alpha, dtodx2), advection1d (speed,
// dtodx), burgers1d (dt/(2dx), 0.5). A 1-D rod has nx = 1.
struct Consts {
  int nx, ny;
  float c0, c1;
};

// The substep's evidence: the operand max exponents of site 0 and site 1.
struct Evidence {
  int e[4];
};

__device__ __forceinline__ int scalar_exp(float x) { return r2f2::mag_exponent(r2f2::finite_mag_bits(x)); }

// ---------------------------------------------------------------------------
// heat2d as a thread-block cluster (K5a, K5d)

namespace cg = cooperative_groups;

constexpr int kHeat2DMaxThreads = 512;
constexpr int kHeat2DMaxPerThread = 16;  // interior cells a thread holds in registers
constexpr int kMaxCluster = 16;          // the non-portable cluster size limit

// One CTA's part of an (nx, ny) heat2d field, whose interior is
// (nx - 2, ny - 2). CTA `rank` owns interior rows [1 + rank * band,
// 1 + rank * band + rows) (every CTA `band`, the last the rest); its shared
// memory `s` holds field rows [rank * band, rank * band + rows + 2), the
// halo row above and below included. Thread t owns the band's interior cells
// t, t + T, ..., at most P of them (row-major, walked by row and column
// without division): their offsets in `s`, their values and their lap (then
// flux) live in registers for the whole launch.
template <int P>
struct Heat2DBand {
  int ny, rows, band, rank, n_ctas, n_own;
  float* s;
  size_t base;  // the field offset of s[0]
  int at[P];
  float u[P], v[P];

  __device__ Heat2DBand(const float* u_in, float* smem, const Consts& c, int band_, const cg::cluster_group& cluster)
      : ny(c.ny), band(band_), s(smem) {
    rank = static_cast<int>(cluster.block_rank());
    n_ctas = static_cast<int>(cluster.num_blocks());
    rows = min(band, c.nx - 2 - rank * band);
    base = static_cast<size_t>(rank) * band * ny;
    const int n = (rows + 2) * ny;
    for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = u_in[base + i];
    const int mi = ny - 2, cells = rows * mi, T = blockDim.x;
    const int dr = T / mi, dc = T % mi;
    int r = threadIdx.x / mi, col = threadIdx.x % mi;
    n_own = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      at[k] = (r + 1) * ny + col + 1;
      if (static_cast<int>(threadIdx.x) + k * T < cells) n_own = k + 1;
      r += dr;
      col += dc;
      if (col >= mi) {
        col -= mi;
        ++r;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < n_own) u[k] = s[at[k]];
  }

  // The field-wide max of the magnitude bits v: every warp folds its max into
  // this CTA's `word`, and after the cluster barrier lane r of every warp
  // reads CTA r's word. The word is zeroed again only after the next cluster
  // barrier, when every CTA has read it.
  __device__ uint32_t cluster_max(uint32_t v, uint32_t* word, const cg::cluster_group& cluster) const {
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int lane = threadIdx.x & 31;
    if (lane == 0) atomicMax(word, v);
    cluster.sync();
    uint32_t x = lane < n_ctas ? *cluster.map_shared_rank(word, lane) : 0u;
    for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
  }

  // One substep: lap in pde/heat2d.py's add order, ((N + S) + W) + E - 4u;
  // flux = alpha*lap at the lap max's split (site 0); u += flux*dtodx2 at
  // the flux max's split (site 1), in the f32 family u = fma(lap,
  // alpha*dtodx2, u); the band's edge rows into the neighbours' halos. The
  // caller's cluster barrier makes them visible before the next substep.
  __device__ Evidence substep(float alpha, float dtodx2, const int* floor, const Policy& p,
                              const r2f2::TileQuant& fixed, uint32_t* pub, const cg::cluster_group& cluster) {
    uint32_t mx = 0u;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k < n_own) {
        const int a = at[k];
        const float sum = __fadd_rn(__fadd_rn(__fadd_rn(s[a - ny], s[a + ny]), s[a - 1]), s[a + 1]);
        v[k] = __fsub_rn(sum, __fmul_rn(4.0f, u[k]));
        mx = max(mx, r2f2::finite_mag_bits(v[k]));
      }
    }
    const int e_alpha = scalar_exp(alpha), e_lap = r2f2::mag_exponent(cluster_max(mx, &pub[0], cluster));
    const int k_flux = r2f2::site_k(r2f2::select_k_mul(e_alpha, e_lap, p), floor, 0, p);
    const bool fold = p.family == r2f2::kF32;  // v keeps lap for the fused update
    const r2f2::ConstMul flux_of(alpha, k_flux, p, fixed);
    mx = 0u;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k < n_own) {
        const float flux = flux_of(v[k]);
        if (!fold) v[k] = flux;
        mx = max(mx, r2f2::finite_mag_bits(flux));
      }
    }
    const uint32_t m_flux = cluster_max(mx, &pub[1], cluster);
    if (threadIdx.x == 0) pub[0] = 0u;  // every CTA read it before the barrier above
    const int e_dtodx2 = scalar_exp(dtodx2), e_flux = r2f2::mag_exponent(m_flux);
    const int k_upd = r2f2::site_k(r2f2::select_k_mul(e_flux, e_dtodx2, p), floor, 1, p);
    const r2f2::ConstMul upd_of(dtodx2, k_upd, p, fixed);
    const float folded = __fmul_rn(alpha, dtodx2);
    float* up = rank > 0 ? cluster.map_shared_rank(s, rank - 1) : nullptr;  // its halo below: row band + 1
    float* down = rank + 1 < n_ctas ? cluster.map_shared_rank(s, rank + 1) : nullptr;  // its halo above: row 0
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k < n_own) {
        const int a = at[k];
        u[k] = fold ? __fmaf_rn(v[k], folded, u[k]) : __fadd_rn(u[k], upd_of(v[k]));
        s[a] = u[k];
        if (up != nullptr && a < 2 * ny) up[a + band * ny] = u[k];
        if (down != nullptr && a >= rows * ny) down[a - rows * ny] = u[k];
      }
    }
    return Evidence{{e_alpha, e_lap, e_flux, e_dtodx2}};
  }

  // This CTA's rows of the field into dst: its cells from registers, the
  // pinned boundary (columns 0 and ny - 1, the first CTA's row 0, the last
  // CTA's row nx - 1) from shared memory, where nothing writes it after the
  // load. So no barrier is needed before a store.
  __device__ void store(float* dst) const {
    dst += base;
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < n_own) dst[at[k]] = u[k];
    for (int j = 1 + threadIdx.x; j <= rows; j += blockDim.x) {
      dst[j * ny] = s[j * ny];
      dst[j * ny + ny - 1] = s[j * ny + ny - 1];
    }
    if (rank == 0)
      for (int i = threadIdx.x; i < ny; i += blockDim.x) dst[i] = s[i];
    if (rank == n_ctas - 1)
      for (int i = threadIdx.x; i < ny; i += blockDim.x) dst[(rows + 1) * ny + i] = s[(rows + 1) * ny + i];
  }
};

__device__ __forceinline__ void write_evidence(float* ev, int s, const Evidence& e) {
  float* d = ev + static_cast<size_t>(s) * 4;
  for (int j = 0; j < 4; ++j) d[j] = static_cast<float>(e.e[j]);
}

// Three cluster barriers a substep: the lap max, the flux max, and (at the
// top of the next substep) the halos. The last substep's halo barrier is
// split: arrive once this CTA's remote writes are out, wait before leaving.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// K5a: `steps` substeps of the (nx, ny) field; per-substep evidence as
// (steps, 2, 2) floats when ev is not null (written by rank 0).
template <int P>
__global__ void __launch_bounds__(kHeat2DMaxThreads)
heat2d_sweep_kernel(const float* __restrict__ u_in, float* __restrict__ u_out, float* __restrict__ ev,
                    const int* __restrict__ k_floor, Consts c, int band, int steps, Policy p) {
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  __shared__ uint32_t pub[2];  // the CTA's lap and flux maxima, read by the cluster
  if (threadIdx.x == 0) pub[0] = pub[1] = 0u;
  Heat2DBand<P> b(u_in, smem, c, band, cluster);
  const r2f2::TileQuant fixed = r2f2::tile_quant(p.fe, p.fm, -1);
  for (int s = 0; s < steps; ++s) {
    if (s > 0) {
      cluster.sync();  // the neighbours' halo writes of the last substep are in
      if (threadIdx.x == 0) pub[1] = 0u;
    }
    const Evidence e = b.substep(c.c0, c.c1, k_floor, p, fixed, pub, cluster);
    if (ev != nullptr && b.rank == 0 && threadIdx.x == 0) write_evidence(ev, s, e);
  }
  cluster_arrive();
  b.store(u_out);
  cluster_wait();  // a neighbour may still write this CTA's halo
}

// K5d: the whole horizon of the field with the adjust unit. trk_k is the
// tracker's k row (the floor's start, or the fixed splits when pinned), null
// when untracked; site_cfg rows are (op, k_lo, k_hi).
template <int P>
__global__ void __launch_bounds__(kHeat2DMaxThreads)
heat2d_mega_kernel(const float* __restrict__ u_in, float* __restrict__ u_out, float* __restrict__ snaps,
                   float* __restrict__ ev, int* trk_k, float* trk_hi, float* trk_lo, int* trk_ov, int* trk_sh,
                   const int* __restrict__ site_cfg, int evolve, Consts c, int band, int steps, int every,
                   AdjustLaw law, Policy p) {
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  __shared__ uint32_t pub[2];
  __shared__ int ka[2];  // the datapath floor, latched at snapshot boundaries
  if (threadIdx.x == 0) pub[0] = pub[1] = 0u;
  if (trk_k != nullptr && threadIdx.x < 2) ka[threadIdx.x] = trk_k[threadIdx.x];
  const int* floor = trk_k != nullptr ? ka : nullptr;
  SiteState st[2];  // this CTA's copy of the rows, ticked by its thread 0
  if (evolve && threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) st[j] = SiteState{trk_k[j], trk_hi[j], trk_lo[j], trk_ov[j], trk_sh[j]};
  }
  Heat2DBand<P> b(u_in, smem, c, band, cluster);
  const r2f2::TileQuant fixed = r2f2::tile_quant(p.fe, p.fm, -1);
  const size_t n = static_cast<size_t>(c.nx) * c.ny;
  bool latch = false;
  for (int s = 0, until = every; s < steps; ++s) {
    if (s > 0) {
      cluster.sync();  // halos in; every thread has read ka for the last substep
      if (threadIdx.x == 0) {
        pub[1] = 0u;
        if (latch) {
          ka[0] = st[0].k;
          ka[1] = st[1].k;
        }
      }
    }
    const Evidence e = b.substep(c.c0, c.c1, floor, p, fixed, pub, cluster);
    const bool boundary = --until == 0;
    if (threadIdx.x == 0) {
      if (ev != nullptr && b.rank == 0) write_evidence(ev, s, e);
      if (evolve) {
        for (int j = 0; j < 2; ++j) {
          const int* cfg = site_cfg + 3 * j;
          r2f2::adjust_tick(st[j], static_cast<float>(e.e[2 * j]), static_cast<float>(e.e[2 * j + 1]), cfg[0], cfg[1],
                            cfg[2], law);
        }
        latch = boundary;
      }
    }
    if (boundary) {
      b.store(snaps + static_cast<size_t>((s + 1) / every - 1) * n);
      until = every;
    }
  }
  cluster_arrive();
  b.store(u_out);
  if (evolve && b.rank == 0 && threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) {
      trk_k[j] = st[j].k;
      trk_hi[j] = st[j].hi;
      trk_lo[j] = st[j].lo;
      trk_ov[j] = st[j].ov;
      trk_sh[j] = st[j].sh;
    }
  }
  cluster_wait();
}

// advection1d: f = speed*u (site 0) into t, df = f[i] - f[i-1] periodic,
// u = u - dtodx*df (site 1, a family_mul_add of -dtodx), in place.
struct Advection1D {
  static constexpr int kThreads = 256;
  static constexpr int kRows = 2;  // u, t

  __device__ static float df_at(const float* u, const float* t, int i, int n, float speed, bool f32) {
    const float prev = t[i == 0 ? n - 1 : i - 1];
    return f32 ? __fmaf_rn(speed, u[i], -prev) : __fsub_rn(t[i], prev);
  }

  __device__ static float* substep(const Consts& c, float* u, float*, float* t, const int* floor, const Policy& p,
                                   uint32_t* scratch, Evidence& ev) {
    const int n = c.ny;
    const float speed = c.c0, dtodx = c.c1;
    const bool f32 = p.family == r2f2::kF32;
    uint32_t mx = 0u;
    for (int i = threadIdx.x; i < n; i += blockDim.x) mx = max(mx, r2f2::finite_mag_bits(u[i]));
    const int e_speed = scalar_exp(speed), e_u = r2f2::block_max_exp(mx, scratch);
    const int k_flux = r2f2::site_k(r2f2::select_k_mul(e_speed, e_u, p), floor, 0, p);
    for (int i = threadIdx.x; i < n; i += blockDim.x) t[i] = r2f2::family_mul(speed, u[i], k_flux, p);
    __syncthreads();  // the difference reads the left neighbour's flux
    mx = 0u;
    for (int i = threadIdx.x; i < n; i += blockDim.x) mx = max(mx, r2f2::finite_mag_bits(df_at(u, t, i, n, speed, f32)));
    const int e_dtodx = scalar_exp(dtodx), e_df = r2f2::block_max_exp(mx, scratch);
    const int k_upd = r2f2::site_k(r2f2::select_k_mul(e_dtodx, e_df, p), floor, 1, p);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      u[i] = r2f2::family_mul_add(-dtodx, df_at(u, t, i, n, speed, f32), u[i], k_upd, p);
    }
    ev = Evidence{{e_speed, e_u, e_dtodx, e_df}};
    return u;
  }
};

// burgers1d: uu = u*u (site 0) into t, f = 0.5*uu (site 1) in place, then
// w = 0.5*(u[i+1] + u[i-1]) - (dt/(2dx))*(f[i+1] - f[i-1]), periodic, rounded
// twice; w is the new state.
struct Burgers1D {
  static constexpr int kThreads = 256;
  static constexpr int kRows = 3;  // u, t, w

  __device__ static float* substep(const Consts& c, float* u, float* w, float* t, const int* floor, const Policy& p,
                                   uint32_t* scratch, Evidence& ev) {
    const int n = c.ny;
    const float cdt = c.c0, half = c.c1;
    uint32_t mx = 0u;
    for (int i = threadIdx.x; i < n; i += blockDim.x) mx = max(mx, r2f2::finite_mag_bits(u[i]));
    const int e_u = r2f2::block_max_exp(mx, scratch);
    const int k_uu = r2f2::site_k(r2f2::select_k_mul(e_u, e_u, p), floor, 0, p);
    mx = 0u;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float uu = r2f2::family_mul(u[i], u[i], k_uu, p);
      t[i] = uu;
      mx = max(mx, r2f2::finite_mag_bits(uu));
    }
    const int e_half = scalar_exp(half), e_uu = r2f2::block_max_exp(mx, scratch);
    const int k_flux = r2f2::site_k(r2f2::select_k_mul(e_half, e_uu, p), floor, 1, p);
    for (int i = threadIdx.x; i < n; i += blockDim.x) t[i] = r2f2::family_mul(half, t[i], k_flux, p);
    __syncthreads();  // the update reads both neighbours' flux
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int ip = i + 1 == n ? 0 : i + 1, im = i == 0 ? n - 1 : i - 1;
      const float u_avg = __fmul_rn(0.5f, __fadd_rn(u[ip], u[im]));
      w[i] = __fsub_rn(u_avg, __fmul_rn(cdt, __fsub_rn(t[ip], t[im])));
    }
    ev = Evidence{{e_u, e_u, e_half, e_uu}};
    return w;
  }
};

template <class Body>
__device__ __forceinline__ void carve(float* smem, int n, float*& u, float*& t, float*& w) {
  u = smem;
  t = smem + n;
  w = Body::kRows > 2 ? smem + 2 * n : nullptr;
}

// K5b-c: `steps` substeps of one body on the (1, nx) rod in one CTA;
// per-substep evidence as (steps, 2, 2) floats when ev is not null.
template <class Body>
__global__ void __launch_bounds__(Body::kThreads)
fused_sweep_kernel(const float* __restrict__ u_in, float* __restrict__ u_out, float* __restrict__ ev,
                   const int* __restrict__ k_floor, Consts c, int steps, Policy p) {
  extern __shared__ float smem[];
  __shared__ uint32_t scratch[32];
  const int n = c.nx * c.ny;
  float *u, *t, *w;
  carve<Body>(smem, n, u, t, w);
  for (int i = threadIdx.x; i < n; i += blockDim.x) u[i] = u_in[i];
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    Evidence e;
    float* next = Body::substep(c, u, w, t, k_floor, p, scratch, e);
    if (next != u) {
      w = u;
      u = next;
    }
    if (ev != nullptr && threadIdx.x == 0) write_evidence(ev, s, e);
    __syncthreads();  // the next substep reads neighbours written above
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) u_out[i] = u[i];
}

// K5e-f: the whole horizon of one body in one CTA, with the adjust unit.
// trk_k is the tracker's k row (the floor's start, or the fixed splits when
// pinned), null when untracked; site_cfg rows are (op, k_lo, k_hi).
template <class Body>
__global__ void __launch_bounds__(Body::kThreads)
mega_sweep_kernel(const float* __restrict__ u_in, float* __restrict__ u_out, float* __restrict__ snaps,
                  float* __restrict__ ev, int* trk_k, float* trk_hi, float* trk_lo, int* trk_ov, int* trk_sh,
                  const int* __restrict__ site_cfg, int evolve, Consts c, int steps, int every, AdjustLaw law,
                  Policy p) {
  extern __shared__ float smem[];
  __shared__ uint32_t scratch[32];
  __shared__ int ka[2];
  const int n = c.nx * c.ny;
  float *u, *t, *w;
  carve<Body>(smem, n, u, t, w);
  for (int i = threadIdx.x; i < n; i += blockDim.x) u[i] = u_in[i];
  const int* floor = nullptr;
  if (trk_k != nullptr) {
    if (threadIdx.x < 2) ka[threadIdx.x] = trk_k[threadIdx.x];
    floor = ka;
  }
  SiteState st[2];
  if (evolve && threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) st[j] = SiteState{trk_k[j], trk_hi[j], trk_lo[j], trk_ov[j], trk_sh[j]};
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    Evidence e;
    float* next = Body::substep(c, u, w, t, floor, p, scratch, e);
    if (next != u) {
      w = u;
      u = next;
    }
    __syncthreads();  // u is this substep's result; every thread has read ka
    const bool boundary = (s + 1) % every == 0;
    if (threadIdx.x == 0) {
      if (ev != nullptr) write_evidence(ev, s, e);
      if (evolve) {
        for (int j = 0; j < 2; ++j) {
          const int* cfg = site_cfg + 3 * j;
          r2f2::adjust_tick(st[j], static_cast<float>(e.e[2 * j]), static_cast<float>(e.e[2 * j + 1]), cfg[0], cfg[1],
                            cfg[2], law);
        }
        if (boundary) {  // read again only after the next substep's first barrier
          ka[0] = st[0].k;
          ka[1] = st[1].k;
        }
      }
    }
    if (boundary) {
      float* snap = snaps + static_cast<size_t>((s + 1) / every - 1) * n;
      for (int i = threadIdx.x; i < n; i += blockDim.x) snap[i] = u[i];
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) u_out[i] = u[i];
  if (evolve && threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) {
      trk_k[j] = st[j].k;
      trk_hi[j] = st[j].hi;
      trk_lo[j] = st[j].lo;
      trk_ov[j] = st[j].ov;
      trk_sh[j] = st[j].sh;
    }
  }
}

// Opt in to the field's dynamic shared memory (above 48 KB a kernel must).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

template <class Body>
int launch_fused(const float* u_in, float* u_out, float* ev, const int* k_floor, int nx, int ny, int steps, float c0,
                 float c1, Policy p, void* stream) {
  const size_t smem = Body::kRows * static_cast<size_t>(nx) * ny * sizeof(float);
  const cudaError_t err = allow_smem(fused_sweep_kernel<Body>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_sweep_kernel<Body><<<1, Body::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u_in, u_out, ev, k_floor, Consts{nx, ny, c0, c1}, steps, p);
  return static_cast<int>(cudaGetLastError());
}

template <class Body>
int launch_mega(const float* u_in, float* u_out, float* snaps, float* ev, int* trk_k, float* trk_hi, float* trk_lo,
                int* trk_ov, int* trk_sh, const int* site_cfg, int evolve, int nx, int ny, int steps, int every,
                float c0, float c1, float ema, float one_minus, int headroom, Policy p, void* stream) {
  const size_t smem = Body::kRows * static_cast<size_t>(nx) * ny * sizeof(float);
  const cudaError_t err = allow_smem(mega_sweep_kernel<Body>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const AdjustLaw law{ema, one_minus, headroom, p.eb, p.fx};
  mega_sweep_kernel<Body><<<1, Body::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u_in, u_out, snaps, ev, trk_k, trk_hi, trk_lo, trk_ov, trk_sh, site_cfg, evolve, Consts{nx, ny, c0, c1}, steps,
      every, law, p);
  return static_cast<int>(cudaGetLastError());
}

// heat2d's launch shape for bands of `cells` interior cells: the fewest cells
// per thread (a power of two up to kHeat2DMaxPerThread) that
// kHeat2DMaxThreads threads cover, and the fewest whole warps for them.
void heat2d_shape(int cells, int& per_thread, int& threads) {
  per_thread = 1;
  while (per_thread * kHeat2DMaxThreads < cells) per_thread *= 2;
  threads = ((cells + per_thread - 1) / per_thread + 31) / 32 * 32;
}

// One cluster of `cluster` CTAs; `smem_allowed` and `clusters_allowed` are the
// kernel's own records of the attributes set.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), size_t* smem_allowed, bool* clusters_allowed, int cluster,
                           int threads, size_t smem, void* stream, Args... args) {
  cudaError_t err = r2f2::allow_dynamic_smem(kernel, smem, smem_allowed);
  if (err == cudaSuccess && cluster > 8) err = r2f2::allow_large_clusters(kernel, clusters_allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
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

template <int P>
cudaError_t heat2d_sweep(int cluster, int threads, size_t smem, void* stream, const float* u_in, float* u_out,
                         float* ev, const int* k_floor, Consts c, int band, int steps, Policy p) {
  static size_t smem_allowed[r2f2::kMaxDevices] = {};
  static bool clusters_allowed[r2f2::kMaxDevices] = {};
  return launch_cluster(heat2d_sweep_kernel<P>, smem_allowed, clusters_allowed, cluster, threads, smem, stream, u_in,
                        u_out, ev, k_floor, c, band, steps, p);
}

template <int P>
cudaError_t heat2d_mega(int cluster, int threads, size_t smem, void* stream, const float* u_in, float* u_out,
                        float* snaps, float* ev, int* trk_k, float* trk_hi, float* trk_lo, int* trk_ov, int* trk_sh,
                        const int* site_cfg, int evolve, Consts c, int band, int steps, int every, AdjustLaw law,
                        Policy p) {
  static size_t smem_allowed[r2f2::kMaxDevices] = {};
  static bool clusters_allowed[r2f2::kMaxDevices] = {};
  return launch_cluster(heat2d_mega_kernel<P>, smem_allowed, clusters_allowed, cluster, threads, smem, stream, u_in,
                        u_out, snaps, ev, trk_k, trk_hi, trk_lo, trk_ov, trk_sh, site_cfg, evolve, c, band, steps,
                        every, law, p);
}

// Validate a heat2d plan and give its launch shape: `cluster` CTAs of `band`
// interior rows cover the nx - 2 interior rows, each CTA with at least one.
bool heat2d_plan(int nx, int ny, int cluster, int band, int& per_thread, int& threads, size_t& smem) {
  const int ni = nx - 2;
  if (nx < 3 || ny < 3 || cluster < 1 || cluster > kMaxCluster || band < 1 || cluster * band < ni ||
      (cluster - 1) * band >= ni || band * (ny - 2) > kHeat2DMaxThreads * kHeat2DMaxPerThread)
    return false;
  heat2d_shape(band * (ny - 2), per_thread, threads);
  smem = static_cast<size_t>(band + 2) * ny * sizeof(float);
  return true;
}

// Dispatch on the cells per thread, the template's register arrays.
#define R2F2_HEAT2D_DISPATCH(FN, ...)                     \
  switch (per_thread) {                                   \
    case 1: return static_cast<int>(FN<1>(__VA_ARGS__));  \
    case 2: return static_cast<int>(FN<2>(__VA_ARGS__));  \
    case 4: return static_cast<int>(FN<4>(__VA_ARGS__));  \
    case 8: return static_cast<int>(FN<8>(__VA_ARGS__));  \
    default: return static_cast<int>(FN<16>(__VA_ARGS__)); \
  }

}  // namespace

#define R2F2_POLICY_ARGS int family, int eb, int mb, int fx, int fe, int fm, int tail_approx, int pinned
#define R2F2_POLICY Policy{family, eb, mb, fx, fe, fm, tail_approx, pinned}

#define R2F2_K5_ENTRIES(NAME, BODY)                                                                                 \
  extern "C" int r2f2_##NAME##_sweep(const float* u_in, float* u_out, float* ev, const int* k_floor, int nx, int ny, \
                                     int steps, float c0, float c1, R2F2_POLICY_ARGS, void* stream) {               \
    return launch_fused<BODY>(u_in, u_out, ev, k_floor, nx, ny, steps, c0, c1, R2F2_POLICY, stream);                \
  }                                                                                                                 \
  extern "C" int r2f2_##NAME##_mega(const float* u_in, float* u_out, float* snaps, float* ev, int* trk_k,           \
                                    float* trk_hi, float* trk_lo, int* trk_ov, int* trk_sh, const int* site_cfg,    \
                                    int evolve, int nx, int ny, int steps, int every, float c0, float c1, float ema, \
                                    float one_minus, int headroom, R2F2_POLICY_ARGS, void* stream) {                \
    return launch_mega<BODY>(u_in, u_out, snaps, ev, trk_k, trk_hi, trk_lo, trk_ov, trk_sh, site_cfg, evolve, nx,   \
                             ny, steps, every, c0, c1, ema, one_minus, headroom, R2F2_POLICY, stream);              \
  }

R2F2_K5_ENTRIES(advection1d, Advection1D)
R2F2_K5_ENTRIES(burgers1d, Burgers1D)

// heat2d (K5a, K5d): one cluster of `cluster` CTAs of `band` interior rows
// (kernels/pde_steps.py::heat2d_cluster_plan).
extern "C" int r2f2_heat2d_sweep(const float* u_in, float* u_out, float* ev, const int* k_floor, int nx, int ny,
                                 int steps, float c0, float c1, int cluster, int band, R2F2_POLICY_ARGS,
                                 void* stream) {
  int per_thread, threads;
  size_t smem;
  if (!heat2d_plan(nx, ny, cluster, band, per_thread, threads, smem)) return static_cast<int>(cudaErrorInvalidValue);
  R2F2_HEAT2D_DISPATCH(heat2d_sweep, cluster, threads, smem, stream, u_in, u_out, ev, k_floor, Consts{nx, ny, c0, c1},
                       band, steps, R2F2_POLICY)
}

extern "C" int r2f2_heat2d_mega(const float* u_in, float* u_out, float* snaps, float* ev, int* trk_k, float* trk_hi,
                                float* trk_lo, int* trk_ov, int* trk_sh, const int* site_cfg, int evolve, int nx,
                                int ny, int steps, int every, float c0, float c1, int cluster, int band, float ema,
                                float one_minus, int headroom, R2F2_POLICY_ARGS, void* stream) {
  int per_thread, threads;
  size_t smem;
  if (!heat2d_plan(nx, ny, cluster, band, per_thread, threads, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const Policy p = R2F2_POLICY;
  const AdjustLaw law{ema, one_minus, headroom, p.eb, p.fx};
  R2F2_HEAT2D_DISPATCH(heat2d_mega, cluster, threads, smem, stream, u_in, u_out, snaps, ev, trk_k, trk_hi, trk_lo,
                       trk_ov, trk_sh, site_cfg, evolve, Consts{nx, ny, c0, c1}, band, steps, every, law, p)
}

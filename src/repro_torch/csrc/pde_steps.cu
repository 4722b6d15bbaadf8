// Kernels K5a and K5d of repro_torch, for sm_90a: heat2d's fused sweep and
// megakernel as one thread-block cluster.
//
//   heat2d_sweep_kernel<P>   K5a  replaces repro/kernels/fused.py::fused_sweep
//                                   with repro/kernels/pde_steps.py::_heat2d_body
//   heat2d_mega_kernel<P>    K5d  replaces repro/kernels/mega.py::mega_sweep with heat2d_mega
//
// (The 1-D K5 bodies, advection1d and burgers1d, and heat2d's fields beyond
// the cluster run on the rod's warp and grid shapes, rod.cuh; kernels/pde_steps.py::
// heat2d_plan picks the cluster or the grid.)
//
// heat2d runs as one thread-block cluster of C CTAs in row bands
// (kernels/pde_steps.py::heat2d_cluster_plan): each CTA keeps its band of the
// field and a halo row above and below in shared memory, and each thread keeps
// the up to P interior cells it owns (their offsets, values, and lap then
// flux) in registers across a substep's three passes. The two field-wide
// maxima of a substep (lap, then flux) each take one cluster barrier
// (r2f2::cluster_publish/collect): every warp folds its max into its CTA's
// word with a shared-memory atomic, and after the barrier lane r of every
// warp reads CTA r's word through distributed shared memory, so every CTA
// derives the same splits. The update writes each band's edge rows into the
// neighbours' halos through distributed shared memory, behind the substep's
// third cluster barrier. A pass builds its split's formats once
// (r2f2::split_quant; the fixed family one TileQuant): no per-element format
// constants and no divergent subnormal branch. Fused and megakernel templates
// share this body (Heat2DBand).
//
// The megakernel adds kernel K4's contract (mega_pde.cu): with an evolving
// tracker each site's row ticks every substep (r2f2::adjust_tick) while the
// datapath floor `ka` latches to the row's split only at snapshot boundaries;
// a pinned tracker's row is the fixed split; snapshots at every boundary; the
// remainder substeps after the last boundary in the same launch. The evidence
// is cluster-wide, so every CTA's thread 0 ticks its own copy of the rows and
// latches its own `ka`; rank 0 writes the rows.
//
// Ensembles (Simulation.run_ensemble): one cluster a member (blockIdx.y),
// each with its own field, floor or tracker rows, evidence, storage split
// and histograms; clusters need not be resident together.
//
// Packed storage (r2f2::Storage): a packed input is decoded into the bands
// at its split as they load; a packed output is encoded from the cells after
// the last substep, at a split from the field's finite max (K5a: one more
// cluster-wide max) or at the carried split kst (K5d). K5d's storage rounding
// takes, at each snapshot boundary after the update, the field's finite max
// over every cell (the pinned boundary too) through a third word of the
// cluster, its split kst, and rounds each CTA's cells (its interior in
// registers, shared memory and the neighbours' halos; its boundary cells in
// shared memory) before the snapshot and the next substep; and once more
// after a remainder.
//
// Capture (r2f2::Capture): each CTA bins every substep's lap (site 0's second
// operand) and flux (site 1's first) over its own interior cells, and the
// constants alpha and dtodx2 once a cell, into a shared-memory histogram
// after its band rows (a halo cell is its owner's, so no cell counts twice);
// K5a adds it to the launch's one slot after the last substep, K5d to slot i
// at the end of interval i and to the last slot after a remainder. The f32
// family's fused update never forms flux, so the flux pass computes it
// (it does anyway, for the flux max).
//
// Rounding follows the compiled reference (pde/heat2d.py says where): in the
// f32 family the update is fma(lap, alpha*dtodx2, u). At the main path's 64x64
// a substep moves no bytes from device memory and does a few thousand f32
// operations: the kernels are bound by the latency of the serial substep
// chain and its reductions, which the cluster spreads over up to 16 SMs. Each
// C entry point returns the launch's cudaError_t.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::AdjustLaw;
using r2f2::Policy;
using r2f2::SiteState;

namespace {

// The field's shape and the body's two f32 constants (alpha, dtodx2), each
// rounded once from its f64 value on the host.
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

  __device__ Heat2DBand(const float* u_in, const r2f2::Storage& st, const Policy& p, float* smem, const Consts& c,
                        int band_, const cg::cluster_group& cluster)
      : ny(c.ny), band(band_), s(smem) {
    rank = static_cast<int>(cluster.block_rank());
    n_ctas = static_cast<int>(cluster.num_blocks());
    rows = min(band, c.nx - 2 - rank * band);
    base = static_cast<size_t>(rank) * band * ny;
    const int n = (rows + 2) * ny;
    if (st.pay_in != nullptr) {
      const r2f2::Codec in(st.k_in[0], p);
      for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = in.decode(r2f2::load_payload(st.pay_in, base + i, st.bytes));
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = u_in[base + i];
    }
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

  // The field-wide max of the magnitude bits v over the cluster, in every
  // thread (r2f2::cluster_publish/collect; `word` is this CTA's).
  __device__ uint32_t cluster_max(uint32_t v, uint32_t* word, const cg::cluster_group& cluster) const {
    uint32_t x[1] = {v};
    r2f2::cluster_publish(x, word);
    r2f2::cluster_collect(x, word, n_ctas, cluster);
    return x[0];
  }

  // One substep: lap in pde/heat2d.py's add order, ((N + S) + W) + E - 4u;
  // flux = alpha*lap at the lap max's split (site 0); u += flux*dtodx2 at
  // the flux max's split (site 1), in the f32 family u = fma(lap,
  // alpha*dtodx2, u); the band's edge rows into the neighbours' halos. The
  // caller's cluster barrier makes them visible before the next substep.
  __device__ Evidence substep(float alpha, float dtodx2, const int* floor, const Policy& p,
                              const r2f2::TileQuant& fixed, uint32_t* pub, const cg::cluster_group& cluster,
                              const r2f2::Hist& hist) {
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
    if (hist.on()) {  // site 0's lap
#pragma unroll
      for (int k = 0; k < P; ++k) hist.add(1, k < n_own ? v[k] : 0.0f, k < n_own);
    }
    const int e_alpha = scalar_exp(alpha), e_lap = r2f2::mag_exponent(cluster_max(mx, &pub[0], cluster));
    const int k_flux = r2f2::site_k(r2f2::select_k_mul(e_alpha, e_lap, p), floor, 0, p);
    const bool fold = p.family == r2f2::kF32;  // v keeps lap for the fused update
    const r2f2::ConstMul flux_of(alpha, k_flux, p, fixed);
    mx = 0u;
    float fl[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      fl[k] = 0.0f;
      if (k < n_own) {
        const float flux = flux_of(v[k]);
        if (!fold) v[k] = flux;
        fl[k] = flux;
        mx = max(mx, r2f2::finite_mag_bits(flux));
      }
    }
    if (hist.on()) {  // site 1's flux
#pragma unroll
      for (int k = 0; k < P; ++k) hist.add(2, fl[k], k < n_own);
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

  // fn(offset) over this CTA's pinned boundary cells (columns 0 and ny - 1
  // of its rows, the first CTA's row 0, the last CTA's row nx - 1), offsets
  // in `s`; each thread always visits the same cells.
  template <typename Fn>
  __device__ void each_boundary(Fn&& fn) const {
    for (int j = 1 + threadIdx.x; j <= rows; j += blockDim.x) {
      fn(j * ny);
      fn(j * ny + ny - 1);
    }
    if (rank == 0)
      for (int i = threadIdx.x; i < ny; i += blockDim.x) fn(i);
    if (rank == n_ctas - 1)
      for (int i = threadIdx.x; i < ny; i += blockDim.x) fn((rows + 1) * ny + i);
  }

  // This CTA's rows of the field into dst: its cells from registers, the
  // pinned boundary from shared memory, where only this thread writes it
  // after the load (the storage rounding). So no barrier is needed before a
  // store.
  __device__ void store(float* dst) const {
    dst += base;
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < n_own) dst[at[k]] = u[k];
    each_boundary([&](int i) { dst[i] = s[i]; });
  }

  // The same cells encoded at one split into the payload.
  __device__ void store_packed(const r2f2::Storage& st, const r2f2::Codec& out) const {
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < n_own) r2f2::store_payload(st.pay_out, base + at[k], st.bytes, out.pack(u[k]));
    each_boundary([&](int i) { r2f2::store_payload(st.pay_out, base + i, st.bytes, out.pack(s[i])); });
  }

  // The field's storage split: the finite max over this CTA's cells, then
  // over the cluster (`word` is this CTA's third word).
  __device__ int storage_split(const Policy& p, uint32_t* word, const cg::cluster_group& cluster) const {
    uint32_t mx = 0u;
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < n_own) mx = max(mx, r2f2::finite_mag_bits(u[k]));
    each_boundary([&](int i) { mx = max(mx, r2f2::finite_mag_bits(s[i])); });
    return r2f2::storage_k(cluster_max(mx, word, cluster), p.eb, p.fx);
  }

  // The storage rounding at the field's split (returned): the interior cells
  // in registers, shared memory and the neighbours' halos, the boundary
  // cells in shared memory. The next cluster barrier publishes the halos.
  __device__ int round_all(const Policy& p, uint32_t* word, const cg::cluster_group& cluster) {
    const int k = storage_split(p, word, cluster);
    const r2f2::Codec at_k(k, p);
    float* up = rank > 0 ? cluster.map_shared_rank(s, rank - 1) : nullptr;
    float* down = rank + 1 < n_ctas ? cluster.map_shared_rank(s, rank + 1) : nullptr;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (j < n_own) {
        const int a = at[j];
        u[j] = at_k.round(u[j]);
        s[a] = u[j];
        if (up != nullptr && a < 2 * ny) up[a + band * ny] = u[j];
        if (down != nullptr && a >= rows * ny) down[a - rows * ny] = u[j];
      }
    }
    each_boundary([&](int i) { s[i] = at_k.round(s[i]); });
    return k;
  }
};

// Capture: the constants alpha (site 0's first operand) and dtodx2 (site 1's
// second) over `cells` lanes, then the CTA's words into slot `slot`.
__device__ __forceinline__ void flush_hist(const r2f2::Hist& hist, const Consts& c, int cells, int slot) {
  hist.add_n(0, c.c0, cells);
  hist.add_n(3, c.c1, cells);
  hist.flush(slot);
}

__device__ __forceinline__ void write_evidence(float* ev, int s, const Evidence& e) {
  float* d = ev + static_cast<size_t>(s) * 4;
  for (int j = 0; j < 4; ++j) d[j] = static_cast<float>(e.e[j]);
}

// Three cluster barriers a substep: the lap max, the flux max, and (at the
// top of the next substep) the halos. The last substep's halo barrier is
// split: arrive once this CTA's remote writes are out, wait before leaving.
using r2f2::cluster_arrive;
using r2f2::cluster_wait;

// K5a: `steps` substeps of the (nx, ny) field; per-substep evidence as
// (steps, 2, 2) floats when ev is not null (written by rank 0).
template <int P>
__global__ void __launch_bounds__(kHeat2DMaxThreads)
heat2d_sweep_kernel(const float* __restrict__ u_in, float* __restrict__ u_out, float* __restrict__ ev,
                    const int* __restrict__ k_floor, Consts c, int band, int steps, Policy p, r2f2::Storage io,
                    r2f2::Capture cap) {
  {  // the member's arrays (blockIdx.y: one cluster a member)
    const size_t m = blockIdx.y, n = static_cast<size_t>(c.nx) * c.ny;
    u_in = r2f2::at_member(u_in, m, n);
    u_out = r2f2::at_member(u_out, m, n);
    ev = r2f2::at_member(ev, m, static_cast<size_t>(steps) * 4);
    k_floor = r2f2::at_member(k_floor, m, 2);
    io = r2f2::member_storage(io, m, n, 1);
    cap = r2f2::member_capture(cap, m, 1, 2);
  }
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  __shared__ uint32_t pub[3];  // the CTA's lap, flux and storage maxima, read by the cluster
  if (threadIdx.x == 0) pub[0] = pub[1] = pub[2] = 0u;
  // after the band rows, zeroed before the band's CTA barrier
  const r2f2::Hist hist(cap, reinterpret_cast<int*>(smem + static_cast<size_t>(band + 2) * c.ny), 2);
  if (hist.on()) hist.zero();
  Heat2DBand<P> b(u_in, io, p, smem, c, band, cluster);
  const r2f2::TileQuant fixed = r2f2::tile_quant(p.fe, p.fm, -1);
  for (int s = 0; s < steps; ++s) {
    if (s > 0) {
      cluster.sync();  // the neighbours' halo writes of the last substep are in
      if (threadIdx.x == 0) pub[1] = 0u;
    }
    const Evidence e = b.substep(c.c0, c.c1, k_floor, p, fixed, pub, cluster, hist);
    if (ev != nullptr && b.rank == 0 && threadIdx.x == 0) write_evidence(ev, s, e);
  }
  if (hist.on()) flush_hist(hist, c, steps * b.n_own, 0);
  if (io.pay_out != nullptr) {  // a split picked afresh from the advanced field, then its payload
    const int k = b.storage_split(p, &pub[2], cluster);
    cluster_arrive();
    b.store_packed(io, r2f2::Codec(k, p));
    if (io.k_out != nullptr && b.rank == 0 && threadIdx.x == 0) io.k_out[0] = k;
  } else {
    cluster_arrive();
    b.store(u_out);
  }
  cluster_wait();  // a neighbour may still write this CTA's halo or read its words
}

// K5d: the whole horizon of the field with the adjust unit. trk_k is the
// tracker's k row (the floor's start, or the fixed splits when pinned), null
// when untracked; site_cfg rows are (op, k_lo, k_hi).
template <int P>
__global__ void __launch_bounds__(kHeat2DMaxThreads)
heat2d_mega_kernel(const float* __restrict__ u_in, float* __restrict__ u_out, float* __restrict__ snaps,
                   float* __restrict__ ev, int* trk_k, float* trk_hi, float* trk_lo, int* trk_ov, int* trk_sh,
                   const int* __restrict__ site_cfg, int evolve, Consts c, int band, int steps, int every,
                   AdjustLaw law, Policy p, r2f2::Storage io, r2f2::Capture cap) {
  {  // the member's arrays (blockIdx.y: one cluster a member)
    const size_t m = blockIdx.y, n = static_cast<size_t>(c.nx) * c.ny;
    u_in = r2f2::at_member(u_in, m, n);
    u_out = r2f2::at_member(u_out, m, n);
    snaps = r2f2::at_member(snaps, m, static_cast<size_t>(steps / every) * n);
    ev = r2f2::at_member(ev, m, static_cast<size_t>(steps) * 4);
    trk_k = r2f2::at_member(trk_k, m, 2);
    trk_hi = r2f2::at_member(trk_hi, m, 2);
    trk_lo = r2f2::at_member(trk_lo, m, 2);
    trk_ov = r2f2::at_member(trk_ov, m, 2);
    trk_sh = r2f2::at_member(trk_sh, m, 2);
    io = r2f2::member_storage(io, m, n, 1);
    cap = r2f2::member_capture(cap, m, steps / every + 1, 2);
  }
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  __shared__ uint32_t pub[3];
  __shared__ int ka[2];  // the datapath floor, latched at snapshot boundaries
  const r2f2::Hist hist(cap, reinterpret_cast<int*>(smem + static_cast<size_t>(band + 2) * c.ny), 2);
  if (hist.on()) hist.zero();
  if (threadIdx.x == 0) pub[0] = pub[1] = pub[2] = 0u;
  if (trk_k != nullptr && threadIdx.x < 2) ka[threadIdx.x] = trk_k[threadIdx.x];
  const int* floor = trk_k != nullptr ? ka : nullptr;
  SiteState st[2];  // this CTA's copy of the rows, ticked by its thread 0
  if (evolve && threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) st[j] = SiteState{trk_k[j], trk_hi[j], trk_lo[j], trk_ov[j], trk_sh[j]};
  }
  Heat2DBand<P> b(u_in, io, p, smem, c, band, cluster);
  const r2f2::TileQuant fixed = r2f2::tile_quant(p.fe, p.fm, -1);
  const size_t n = static_cast<size_t>(c.nx) * c.ny;
  bool latch = false;
  int kst = 0;  // the carried storage split
  for (int s = 0, until = every; s < steps; ++s) {
    if (s > 0) {
      cluster.sync();  // halos in; every thread has read ka for the last substep
      if (threadIdx.x == 0) {
        pub[1] = pub[2] = 0u;
        if (latch) {
          ka[0] = st[0].k;
          ka[1] = st[1].k;
        }
      }
    }
    const Evidence e = b.substep(c.c0, c.c1, floor, p, fixed, pub, cluster, hist);
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
      if (io.round) kst = b.round_all(p, &pub[2], cluster);
      b.store(snaps + static_cast<size_t>((s + 1) / every - 1) * n);
      if (hist.on()) flush_hist(hist, c, every * b.n_own, (s + 1) / every - 1);
      until = every;
    }
  }
  if (hist.on() && steps % every != 0) flush_hist(hist, c, (steps % every) * b.n_own, steps / every);
  // the remainder's rounding (its word zeroed at the top of the substep after
  // the last boundary; its halo writes reach CTAs that only store now)
  if (io.round && steps % every != 0) kst = b.round_all(p, &pub[2], cluster);
  cluster_arrive();
  if (io.pay_out != nullptr) {
    b.store_packed(io, r2f2::Codec(kst, p));
  } else {
    b.store(u_out);
  }
  if (io.k_out != nullptr && b.rank == 0 && threadIdx.x == 0) io.k_out[0] = kst;
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

// heat2d's launch shape for bands of `cells` interior cells: the fewest cells
// per thread (a power of two up to kHeat2DMaxPerThread) that
// kHeat2DMaxThreads threads cover, and the fewest whole warps for them.
void heat2d_shape(int cells, int& per_thread, int& threads) {
  per_thread = 1;
  while (per_thread * kHeat2DMaxThreads < cells) per_thread *= 2;
  threads = ((cells + per_thread - 1) / per_thread + 31) / 32 * 32;
}

template <int P>
cudaError_t heat2d_sweep(int cluster, int members, int threads, size_t smem, void* stream, const float* u_in,
                         float* u_out, float* ev, const int* k_floor, Consts c, int band, int steps, Policy p,
                         r2f2::Storage st, r2f2::Capture cap) {
  static size_t smem_allowed[r2f2::kMaxDevices] = {};
  static bool clusters_allowed[r2f2::kMaxDevices] = {};
  return r2f2::launch_cluster(heat2d_sweep_kernel<P>, smem_allowed, clusters_allowed, cluster, members, threads, smem,
                              stream, u_in, u_out, ev, k_floor, c, band, steps, p, st, cap);
}

template <int P>
cudaError_t heat2d_mega(int cluster, int members, int threads, size_t smem, void* stream, const float* u_in,
                        float* u_out, float* snaps, float* ev, int* trk_k, float* trk_hi, float* trk_lo, int* trk_ov,
                        int* trk_sh, const int* site_cfg, int evolve, Consts c, int band, int steps, int every,
                        AdjustLaw law, Policy p, r2f2::Storage st, r2f2::Capture cap) {
  static size_t smem_allowed[r2f2::kMaxDevices] = {};
  static bool clusters_allowed[r2f2::kMaxDevices] = {};
  return r2f2::launch_cluster(heat2d_mega_kernel<P>, smem_allowed, clusters_allowed, cluster, members, threads, smem,
                              stream, u_in, u_out, snaps, ev, trk_k, trk_hi, trk_lo, trk_ov, trk_sh, site_cfg, evolve,
                              c, band, steps, every, law, p, st, cap);
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
#define R2F2_STORAGE_ARGS const void *pay_in, const int *k_in, void *pay_out, int *k_out, int bytes, int round
#define R2F2_STORAGE r2f2::Storage{pay_in, k_in, pay_out, k_out, bytes, round}
#define R2F2_CAPTURE_ARGS int *cap_out, int cap_e_lo, int cap_bins, int cap_rows, int cap_cols
#define R2F2_CAPTURE r2f2::Capture{cap_out, cap_e_lo, cap_bins, cap_rows, cap_cols}

namespace {

// Storage arguments a launch can run: the payloads' width holds the format,
// a packed input has its split, an input and an output each f32 or packed,
// rounding only in a megakernel.
bool storage_ok(const void* u_in, const float* u_out, R2F2_STORAGE_ARGS, int eb, int mb, int fx, bool mega) {
  return (bytes == 1 || bytes == 2 || bytes == 4) && 1 + eb + mb + fx <= 8 * bytes &&
         (pay_in == nullptr || k_in != nullptr) && ((pay_in != nullptr) != (u_in != nullptr)) &&
         ((pay_out != nullptr) != (u_out != nullptr)) && (mega || !round);
}

}  // namespace

// heat2d (K5a, K5d): one cluster of `cluster` CTAs of `band` interior rows
// (kernels/pde_steps.py::heat2d_cluster_plan) a member, `members` ensemble
// members in one launch, every array leading with the member.
extern "C" int r2f2_heat2d_sweep(const float* u_in, float* u_out, float* ev, const int* k_floor, int members, int nx,
                                 int ny, int steps, float c0, float c1, int cluster, int band, R2F2_POLICY_ARGS,
                                 R2F2_STORAGE_ARGS, R2F2_CAPTURE_ARGS, void* stream) {
  int per_thread, threads;
  size_t smem;
  const r2f2::Capture cap = R2F2_CAPTURE;
  if (members < 1 || !heat2d_plan(nx, ny, cluster, band, per_thread, threads, smem) || !r2f2::capture_ok(cap) ||
      !storage_ok(u_in, u_out, pay_in, k_in, pay_out, k_out, bytes, round, eb, mb, fx, false))
    return static_cast<int>(cudaErrorInvalidValue);
  smem += r2f2::hist_bytes(cap, 2);
  R2F2_HEAT2D_DISPATCH(heat2d_sweep, cluster, members, threads, smem, stream, u_in, u_out, ev, k_floor,
                       Consts{nx, ny, c0, c1}, band, steps, R2F2_POLICY, R2F2_STORAGE, cap)
}

extern "C" int r2f2_heat2d_mega(const float* u_in, float* u_out, float* snaps, float* ev, int* trk_k, float* trk_hi,
                                float* trk_lo, int* trk_ov, int* trk_sh, const int* site_cfg, int evolve,
                                int members, int nx, int ny, int steps, int every, float c0, float c1, int cluster,
                                int band, float ema, float one_minus, int headroom, R2F2_POLICY_ARGS, R2F2_STORAGE_ARGS,
                                R2F2_CAPTURE_ARGS, void* stream) {
  int per_thread, threads;
  size_t smem;
  const r2f2::Capture cap = R2F2_CAPTURE;
  if (members < 1 || !heat2d_plan(nx, ny, cluster, band, per_thread, threads, smem) || every < 1 ||
      !r2f2::capture_ok(cap) ||
      !storage_ok(u_in, u_out, pay_in, k_in, pay_out, k_out, bytes, round, eb, mb, fx, true) ||
      (pay_out != nullptr && !round))
    return static_cast<int>(cudaErrorInvalidValue);
  const Policy p = R2F2_POLICY;
  const AdjustLaw law{ema, one_minus, headroom, p.eb, p.fx};
  smem += r2f2::hist_bytes(cap, 2);
  R2F2_HEAT2D_DISPATCH(heat2d_mega, cluster, members, threads, smem, stream, u_in, u_out, snaps, ev, trk_k, trk_hi,
                       trk_lo, trk_ov, trk_sh, site_cfg, evolve, Consts{nx, ny, c0, c1}, band, steps, every, law, p,
                       R2F2_STORAGE, cap)
}

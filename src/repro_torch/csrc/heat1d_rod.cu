// Kernels K2 and K4 (heat1d) of repro_torch, for sm_90a: one device body, the
// explicit-FD substep of a (br, nx) row block, on the launch shape that
// kernels/heat_stencil.py::heat1d_plan gives the block:
//
//   K2  replaces repro/kernels/fused.py::fused_sweep with
//       repro/kernels/heat_stencil.py::_heat1d_body (heat1d_sweep)
//   K4  replaces repro/kernels/mega.py::mega_sweep with heat1d_mega
//
// A substep: lap = (u[i-1] - 2u[i]) + u[i+1] on each row's interior and its
// block max; flux = alpha*lap at the lap max's split (site 0) and its block
// max; u += flux*dtodx2 at the flux max's split (site 1), in the f32 family
// u = fma(lap, fl(alpha*dtodx2), u), as the compiled reference folds and
// fuses it. K2 runs `steps` substeps per row block with per-block evidence
// and a carried floor (the host pads the rows, so a pad row is a zero row of
// the block and enters its maxima as 0); K4 runs the whole horizon of one
// rod with kernel K4's contract (mega_pde.cu): snapshots at every `every`-th
// substep, the adjust unit ticking each substep, the datapath floor latched
// to the tracker's split at snapshot boundaries.
//
// Bound: the serial chain of a substep (two block maxima, two split
// selections, the rounding of every product), not bytes or operations (the
// main path's 128-cell rod is 512 B and ~800 f32 operations a substep). The
// design shortens the chain:
//   warp shape (br * nx <= 2048 cells): one CTA a block of W <= 8 warps, one
//     a 32 cells (one a scheduler at the main path's 128 cells), lane l of
//     the CTA holding cells [l*G, l*G + G) of the flattened block in
//     registers; neighbours come by shuffle, each block max is a
//     __reduce_max_sync over the magnitude bit patterns and one over the
//     warps' words, whose result every lane has, so every lane selects the
//     splits itself. Three CTA barriers a substep (the two maxima, the
//     warps' edge cells).
//   grid shape (larger blocks): a cooperative grid of `ctas` CTAs a block,
//     the field in global memory (the 50 MB L2 holds it) in two buffers;
//     each thread holds G cells (strided by the grid's threads) and their
//     laplacians in registers from the neighbours' loads, all in flight
//     before the first use, to the update (a block beyond ctas * 256 * G cells
//     walks batches of them, the laplacians through a third buffer); each
//     block max is an atomicMax into a per-block slot of a ring of two
//     substeps (an integer max of bit patterns, so arrival order does not
//     matter), and three grid barriers a substep (lap max, flux max,
//     update), each one release-add and acquire spin on a 64-bit counter.
//     It has no size limit.
// Both products of a substep come from a per-launch table of r2f2::ConstMul
// (the constant rounded and the split's formats built for every k of the
// table), read at the uniform split, with the product's variant
// (ConstMul::kind) fixed per launch (warp shape: a template parameter) or
// per pass (grid shape: r2f2::with_kind), so a lane's cells run
// straight-line code with no per-element quantize_em branch. The warp shape
// starts each pass's products at the split of the last substep while the
// block max reduces (Guess), and redoes them only where the split moved.
// The adjust unit ticks in every thread on the uniform evidence, so the
// floor each thread reads needs no broadcast. The C entry point returns the
// launch's cudaError_t.
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::AdjustLaw;
using r2f2::ConstMul;
using r2f2::Policy;
using r2f2::SiteState;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;      // warps of a warp-shape block (kernels/heat_stencil.py::WARP_MAX)
constexpr int kGridThreads = 256;  // threads of a grid-shape CTA
constexpr int kTable = 8;          // splits of the product table: every k of a format (eb >= 2, eb + fx <= 8)

struct Heat1DArgs {
  const float* u_in;
  float* u_out;
  float* snaps;     // (steps / every, n) or null
  float* ev;        // (blocks, steps, 2, 2) or null
  float* work;      // grid shape: per block the other field buffer and the laplacian, 2n floats
  uint32_t* maxes;  // grid shape: (blocks, 2, 2) zeroed: the lap and flux maxima of a ring of two substeps
  unsigned long long* count;  // grid shape: (blocks,) zeroed: a launch's barrier counter (at its first block)
  int* trk_k;       // the floor's start (the carried or pinned split; K2's k_floor), null for none
  float* trk_hi;
  float* trk_lo;
  int* trk_ov;
  int* trk_sh;
  const int* site_cfg;  // (2, 3): op, k_lo, k_hi, read with an evolving tracker
  int evolve;           // tick the tracker rows and latch the floor at boundaries
  int blocks, n, nx, steps, every;  // every = 0: no snapshots
  float alpha, dtodx2;
};

// The substep's two products at every split of the table, one per CTA (a
// variable of the file, so a read needs no generic-to-shared conversion).
struct MulTable {
  ConstMul flux[kTable], upd[kTable];
};

__shared__ MulTable mul_table;

// The launch's constants, the evidence of the two constant operands and the
// product table (filled before the first substep).
struct Step {
  float folded;  // fl(alpha * dtodx2), the f32 family's fused update
  int e_alpha, e_dtodx2;
  bool fold;
  float alpha, dtodx2;
  Policy p;
  r2f2::TileQuant fixed;

  __device__ Step(const Heat1DArgs& a, const Policy& p_) : p(p_) {
    alpha = a.alpha, dtodx2 = a.dtodx2;
    folded = __fmul_rn(alpha, dtodx2);
    e_alpha = r2f2::mag_exponent(r2f2::finite_mag_bits(alpha));
    e_dtodx2 = r2f2::mag_exponent(r2f2::finite_mag_bits(dtodx2));
    fold = p.family == r2f2::kF32;
    fixed = r2f2::tile_quant(p.fe, p.fm, -1);
    if (threadIdx.x < kTable) {
      mul_table.flux[threadIdx.x] = ConstMul(alpha, threadIdx.x, p, fixed);
      mul_table.upd[threadIdx.x] = ConstMul(dtodx2, threadIdx.x, p, fixed);
    }
    __syncthreads();
  }

  __device__ ConstMul flux_at(int k) const {
    return k >= 0 && k < kTable ? mul_table.flux[k] : ConstMul(alpha, k, p, fixed);
  }
  __device__ ConstMul upd_at(int k) const {
    return k >= 0 && k < kTable ? mul_table.upd[k] : ConstMul(dtodx2, k, p, fixed);
  }
};

// The splits' floor in registers: r2f2::site_k's rule.
struct Floor {
  bool on;
  int k[2];

  __device__ int at(int k_select, int site, const Policy& p) const {
    if (!on) return k_select;
    return p.pinned ? k[site] : max(k_select, k[site]);
  }
};

// The tracker rows, each thread's own copy, and the adjust unit's table.
struct Tracker {
  SiteState st[2];
  int cfg[6];

  __device__ void load(const Heat1DArgs& a) {
    for (int j = 0; j < 2; ++j) st[j] = SiteState{a.trk_k[j], a.trk_hi[j], a.trk_lo[j], a.trk_ov[j], a.trk_sh[j]};
    for (int j = 0; j < 6; ++j) cfg[j] = a.site_cfg[j];
  }

  __device__ void tick(const int (&e)[4], const AdjustLaw& law) {
    for (int j = 0; j < 2; ++j) {
      r2f2::adjust_tick(st[j], static_cast<float>(e[2 * j]), static_cast<float>(e[2 * j + 1]), cfg[3 * j],
                        cfg[3 * j + 1], cfg[3 * j + 2], law);
    }
  }

  __device__ void store(const Heat1DArgs& a) const {
    for (int j = 0; j < 2; ++j) {
      a.trk_k[j] = st[j].k;
      a.trk_hi[j] = st[j].hi;
      a.trk_lo[j] = st[j].lo;
      a.trk_ov[j] = st[j].ov;
      a.trk_sh[j] = st[j].sh;
    }
  }
};

__device__ __forceinline__ float lap3(float l, float c, float r) {
  return __fadd_rn(__fsub_rn(l, __fmul_rn(2.0f, c)), r);
}

// Per-cell selects in bit operations, so a lane's cells stay one basic
// block (no branch around a cell, which would keep the compiler from
// interleaving the cells' chains): all ones where bit g of `bits` is set.
__device__ __forceinline__ uint32_t cell_mask(uint32_t bits, int g) { return 0u - ((bits >> g) & 1u); }

__device__ __forceinline__ float pick(uint32_t mask, float a, float b) {
  return __uint_as_float((__float_as_uint(a) & mask) | (__float_as_uint(b) & ~mask));
}

// Evidence of one substep: (e_alpha, e_lap), (e_flux, e_dtodx2), one 16-byte store.
__device__ __forceinline__ void write_evidence(float* ev, const int (&e)[4]) {
  *reinterpret_cast<float4*>(ev) =
      make_float4(static_cast<float>(e[0]), static_cast<float>(e[1]), static_cast<float>(e[2]), static_cast<float>(e[3]));
}

// The launch's floor and tracker from the arguments.
__device__ __forceinline__ Floor load_floor(const Heat1DArgs& a, Tracker& trk) {
  Floor f{a.trk_k != nullptr, {0, 0}};
  if (f.on) f.k[0] = a.trk_k[0], f.k[1] = a.trk_k[1];
  if (a.evolve) trk.load(a);
  return f;
}

// ---------------------------------------------------------------------------
// warp shape

// A pass's product at the split the last substep ran it at. The split rarely
// moves from one substep to the next, so a substep starts its products at
// that split while its block max is still being reduced, and redoes them
// only where the max gives another split: the same bits, with the products
// and the table read off the chain (without it a substep of the main path's
// rod took 1.7x as long on an H100, PERF.md section 6).
// `fast`: the product is of the kernel's kind K (ConstMul::kind), so the
// straight-line apply<K> gives its bits.
template <int K>
struct Guess {
  int k;
  ConstMul mul;
  bool fast;

  __device__ Guess(int k_, const ConstMul& m) : k(k_), mul(m), fast(m.kind() == K) {}
};

// What the warps of one block share: each warp's block-max word of the lap
// and of the flux, and its edge cells (its first lane's first cell and its
// last lane's last cell) for the neighbour warps' laplacians. Three CTA
// barriers a substep (the two maxima and the edges); each slot is written
// again only after the barrier that follows every read of it.
struct Warps {
  uint32_t lap[kMaxWarps], flux[kMaxWarps];
  float edge[kMaxWarps][2];
};

__shared__ Warps warps;

// One block's cells on the W warps of a CTA: lane l of warp w holds cells
// [(32w + l) * G, (32w + l) * G + G) of the flattened (br, nx) block (zeros
// past its end), and bit g of `interior` says whether such a cell is an
// interior cell of its row. K is the kind of the products the launch's table
// holds (r2f2::ConstMul::kind; 0 is the f32 family, whose update is the
// folded fma), so the cells' loops have no branch; a split whose product is
// of another kind takes the generic one (kind 3) in that pass.
template <int G, int K>
struct Rod {
  float u[G];
  uint32_t interior;
  int c0, n, lane, warp, w_count;
  Guess<K> flux_guess, upd_guess;

  __device__ Rod(const float* src, int n_, int nx, const Step& c)
      : c0(static_cast<int>(threadIdx.x) * G), n(n_), lane(threadIdx.x & 31), warp(threadIdx.x >> 5),
        w_count(blockDim.x >> 5), flux_guess(0, c.flux_at(0)), upd_guess(0, c.upd_at(0)) {
    int col = c0 % nx;
    interior = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = c0 + g;
      u[g] = j < n ? src[j] : 0.0f;
      if (j < n && col >= 1 && col <= nx - 2) interior |= 1u << g;
      if (++col == nx) col = 0;
    }
    publish_edges();
  }

  // The warp's edge cells for its neighbours, behind a CTA barrier.
  __device__ void publish_edges() {
    if (lane == 0) warps.edge[warp][0] = u[0];
    if (lane == 31) warps.edge[warp][1] = u[G - 1];
    __syncthreads();
  }

  // The block max of the lanes' magnitude bits `mx`, in every lane.
  __device__ uint32_t block_max(uint32_t mx, uint32_t* slots) const {
    mx = __reduce_max_sync(kFull, mx);
    if (lane == 0) slots[warp] = mx;
    __syncthreads();
    return __reduce_max_sync(kFull, lane < w_count ? slots[lane] : 0u);
  }

  __device__ void store(float* dst) const {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (c0 + g < n) dst[c0 + g] = u[g];
  }

  // w = m(x) over the cells as a product of kind J; returns the max of |w|
  // over the interior.
  template <int J>
  __device__ uint32_t products(const ConstMul& m, const float (&x)[G], float (&w)[G]) const {
    uint32_t mx = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      w[g] = m.apply<J>(x[g]);
      mx = max(mx, r2f2::finite_mag_bits(w[g]) & cell_mask(interior, g));
    }
    return mx;
  }

  template <int J>
  __device__ void updates(const ConstMul& m, const float (&w)[G], float (&next)[G]) const {
#pragma unroll
    for (int g = 0; g < G; ++g) next[g] = __fadd_rn(u[g], m.apply<J>(w[g]));
  }

  // One substep; every lane returns the same evidence.
  __device__ void substep(const Step& c, const Floor& f, int (&e)[4]) {
    float left = __shfl_up_sync(kFull, u[G - 1], 1);
    float right = __shfl_down_sync(kFull, u[0], 1);
    if (lane == 0 && warp > 0) left = warps.edge[warp - 1][1];
    if (lane == 31 && warp + 1 < w_count) right = warps.edge[warp + 1][0];
    float v[G], w[G], next[G];  // lap, flux, the updated cells
    uint32_t mx = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      v[g] = lap3(g == 0 ? left : u[g - 1], u[g], g == G - 1 ? right : u[g + 1]);
      mx = max(mx, r2f2::finite_mag_bits(v[g]) & cell_mask(interior, g));
    }
    const int e_lap = r2f2::mag_exponent(block_max(mx, warps.lap));
    mx = products<K>(flux_guess.mul, v, w);
    const int k_flux = f.at(r2f2::select_k_mul(c.e_alpha, e_lap, c.p), 0, c.p);
    if (k_flux != flux_guess.k || !flux_guess.fast) {
      flux_guess = Guess<K>(k_flux, c.flux_at(k_flux));
      mx = flux_guess.fast ? products<K>(flux_guess.mul, v, w) : products<3>(flux_guess.mul, v, w);
    }
    const int e_flux = r2f2::mag_exponent(block_max(mx, warps.flux));
    if constexpr (K == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) next[g] = __fmaf_rn(v[g], c.folded, u[g]);
    } else {
      updates<K>(upd_guess.mul, w, next);
      const int k_upd = f.at(r2f2::select_k_mul(e_flux, c.e_dtodx2, c.p), 1, c.p);
      if (k_upd != upd_guess.k || !upd_guess.fast) {
        upd_guess = Guess<K>(k_upd, c.upd_at(k_upd));
        if (upd_guess.fast) {
          updates<K>(upd_guess.mul, w, next);
        } else {
          updates<3>(upd_guess.mul, w, next);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) u[g] = pick(cell_mask(interior, g), next[g], u[g]);
    publish_edges();
    e[0] = c.e_alpha, e[1] = e_lap, e[2] = e_flux, e[3] = c.e_dtodx2;
  }
};

// One CTA of `threads` / 32 warps a block.
template <int G, int K>
__global__ void __launch_bounds__(kMaxWarps * 32) heat1d_warp_kernel(Heat1DArgs a, AdjustLaw law, Policy p) {
  const Step c(a, p);
  const int b = blockIdx.x;
  const size_t base = static_cast<size_t>(b) * a.n;
  Rod<G, K> rod(a.u_in + base, a.n, a.nx, c);
  const bool lead = threadIdx.x == 0;
  Tracker trk;
  Floor f = load_floor(a, trk);
  int e[4];
  for (int s = 0, until = a.every, snap = 0; s < a.steps; ++s) {
    rod.substep(c, f, e);
    if (a.ev != nullptr && lead) write_evidence(a.ev + (static_cast<size_t>(b) * a.steps + s) * 4, e);
    if (a.evolve) trk.tick(e, law);
    if (--until == 0) {  // a snapshot boundary
      until = a.every;
      if (a.evolve) f.k[0] = trk.st[0].k, f.k[1] = trk.st[1].k;
      rod.store(a.snaps + static_cast<size_t>(snap++) * a.n);
    }
  }
  rod.store(a.u_out + base);
  if (a.evolve && lead) trk.store(a);
}

// ---------------------------------------------------------------------------
// grid shape

// A barrier over the cooperative grid: once the CTA's threads are past their
// writes (the CTA barrier), its thread 0 adds one to the launch's counter
// with release semantics and spins on acquire loads until the counter
// reaches `target`; the CTA barrier after it lets the CTA go on. The counter
// only grows, so the n-th barrier of a launch waits for n times its CTAs; it
// is 64-bit, so it does not wrap (three barriers a substep on 132 CTAs would
// wrap 32 bits in 11 million substeps). (The same pattern as CUTLASS's
// generic barrier; cooperative_groups' grid.sync() adds a full fence on each
// side.)
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

// One grid barrier's worth of a block's cells for one thread: cells first +
// (batch * G + g) * stride, g < G, with their values (u), laplacians (v) and
// interior bits. A thread holds one batch in registers; where a block needs
// more (batches > 1), each pass walks them, and the laplacians go through the
// block's lap buffer between passes.
template <int G>
struct GridBatch {
  float u[G], v[G];
  uint32_t interior;

  __device__ uint32_t mask(int g) const { return cell_mask(interior, g); }

  // u from src and the interior bits of batch `bi`, advancing the running
  // column; with neighbours, v = the laplacian (returned: its max bits),
  // else v from the lap buffer. Every load reads a cell of the block (its
  // index clamped to [1, n - 2]) and the masks drop what is not wanted, so
  // all of them are in flight before the first use.
  __device__ uint32_t load(const float* src, const float* lap, int bi, int first, int stride, int dcol, int n, int nx,
                           int& col, bool neighbours) {
    float l[G], r[G];
    interior = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = first + (bi * G + g) * stride, at = min(max(j, 1), n - 2);
      interior |= static_cast<uint32_t>(j < n && col >= 1 && col <= nx - 2) << g;
      col = col + dcol >= nx ? col + dcol - nx : col + dcol;
      u[g] = __ldcg(src + min(j, n - 1));
      if (neighbours) {
        l[g] = __ldcg(src + at - 1);
        r[g] = __ldcg(src + at + 1);
      } else {
        v[g] = __ldcg(lap + at);
      }
    }
    uint32_t mx = 0u;
    if (neighbours) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        v[g] = lap3(l[g], u[g], r[g]);
        mx = max(mx, r2f2::finite_mag_bits(v[g]) & mask(g));
      }
    }
    return mx;
  }
};

template <int G>
__global__ void __launch_bounds__(kGridThreads) heat1d_grid_kernel(Heat1DArgs a, int ctas, AdjustLaw law, Policy p) {
  const Step c(a, p);
  const int b = blockIdx.x / ctas, part = blockIdx.x % ctas;
  const int first = part * kGridThreads + threadIdx.x, stride = ctas * kGridThreads;
  const int batches = (a.n + G * stride - 1) / (G * stride);
  const int col0 = first % a.nx, dcol = stride % a.nx;
  const bool lead = part == 0 && threadIdx.x == 0;
  const size_t base = static_cast<size_t>(b) * a.n;
  uint32_t* ring = a.maxes + static_cast<size_t>(b) * 4;  // the lap and flux maxima of substeps s & 1
  float* other = a.work + 2 * base;
  float* lap = other + a.n;
  const float* src = a.u_in + base;
  if (a.steps == 0) {
    for (int j = first; j < a.n; j += stride) a.u_out[base + j] = src[j];
    return;
  }
  Tracker trk;
  Floor f = load_floor(a, trk);
  // the block max of a pass: a warp's max by redux, then one atomic a warp
  const auto publish = [&](uint32_t mx, uint32_t* slot) {
    mx = __reduce_max_sync(kFull, mx);
    if ((threadIdx.x & 31) == 0) atomicMax(slot, mx);
  };
  GridBatch<G> cells;
  int e[4];
  unsigned long long passed = 0ull;  // the grid barriers behind
  const auto grid_sync = [&] { grid_barrier(a.count, ++passed * gridDim.x); };
  for (int s = 0, until = a.every, snap = 0; s < a.steps; ++s) {
    float* dst = ((a.steps - 1 - s) & 1) == 0 ? a.u_out + base : other;
    uint32_t* slot = ring + (s & 1) * 2;

    uint32_t mx = 0u;
    for (int bi = 0, col = col0; bi < batches; ++bi) {
      mx = max(mx, cells.load(src, lap, bi, first, stride, dcol, a.n, a.nx, col, true));
      if (batches > 1) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (first + (bi * G + g) * stride < a.n) __stcg(lap + first + (bi * G + g) * stride, cells.v[g]);
      }
    }
    publish(mx, slot);
    grid_sync();

    const int e_lap = r2f2::mag_exponent(__ldcg(slot));
    const ConstMul flux_of = c.flux_at(f.at(r2f2::select_k_mul(c.e_alpha, e_lap, c.p), 0, c.p));
    mx = 0u;
    for (int bi = 0, col = col0; bi < batches; ++bi) {
      if (batches > 1) cells.load(src, lap, bi, first, stride, dcol, a.n, a.nx, col, false);
      r2f2::with_kind(flux_of, [&](auto kind) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          mx = max(mx, r2f2::finite_mag_bits(flux_of.apply<decltype(kind)::value>(cells.v[g])) & cells.mask(g));
      });
    }
    publish(mx, slot + 1);
    grid_sync();

    const int e_flux = r2f2::mag_exponent(__ldcg(slot + 1));
    const ConstMul upd_of = c.upd_at(f.at(r2f2::select_k_mul(e_flux, c.e_dtodx2, c.p), 1, c.p));
    const bool boundary = --until == 0;
    float* snap_at = boundary ? a.snaps + static_cast<size_t>(snap) * a.n : nullptr;
    for (int bi = 0, col = col0; bi < batches; ++bi) {
      if (batches > 1) cells.load(src, lap, bi, first, stride, dcol, a.n, a.nx, col, false);
      float next[G];
      if (c.fold) {
#pragma unroll
        for (int g = 0; g < G; ++g) next[g] = __fmaf_rn(cells.v[g], c.folded, cells.u[g]);
      } else {
        r2f2::with_kind(flux_of, [&](auto fk) {
          r2f2::with_kind(upd_of, [&](auto uk) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float flux = flux_of.apply<decltype(fk)::value>(cells.v[g]);
              next[g] = __fadd_rn(cells.u[g], upd_of.apply<decltype(uk)::value>(flux));
            }
          });
        });
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = first + (bi * G + g) * stride;
        if (j < a.n) {
          const float v = pick(cells.mask(g), next[g], cells.u[g]);
          __stcg(dst + j, v);
          if (snap_at != nullptr) snap_at[j] = v;
        }
      }
    }
    e[0] = c.e_alpha, e[1] = e_lap, e[2] = e_flux, e[3] = c.e_dtodx2;
    if (a.ev != nullptr && lead) write_evidence(a.ev + (static_cast<size_t>(b) * a.steps + s) * 4, e);
    if (a.evolve) trk.tick(e, law);
    if (boundary) {
      until = a.every;
      ++snap;
      if (a.evolve) f.k[0] = trk.st[0].k, f.k[1] = trk.st[1].k;
    }
    // the next substep's slots, beside the field's stores: every read of them
    // (substep s - 1) is behind the barriers passed, every write (substep
    // s + 1) behind the next
    if (lead) ring[2 - (s & 1) * 2] = 0u, ring[3 - (s & 1) * 2] = 0u;
    grid_sync();  // the next laplacian reads the neighbours written above
    src = dst;
  }
  if (a.evolve && blockIdx.x == 0 && threadIdx.x == 0) trk.store(a);
}

template <int G, int K>
cudaError_t launch_warp(const Heat1DArgs& a, int threads, const AdjustLaw& law, const Policy& p, cudaStream_t stream) {
  heat1d_warp_kernel<G, K><<<a.blocks, threads, 0, stream>>>(a, law, p);
  return cudaGetLastError();
}

// The kind (r2f2::ConstMul::kind) the launch's products run at: 0 f32, 1
// bf16, 2 the fixed family's and the rr splits' formats on quantize_tile_fast
// (a split whose formats are not takes the generic product in that pass:
// its Guess is not `fast`).
int table_kind(const Policy& p) { return p.family == r2f2::kF32 || p.family == r2f2::kBF16 ? p.family : 2; }

// The grid shape: `ctas` CTAs a block, as many blocks a cooperative launch as
// the card holds at once (a grid barrier needs every CTA resident), launched
// in turn.
template <int G>
cudaError_t launch_grid(Heat1DArgs a, int ctas, const AdjustLaw& law, const Policy& p, cudaStream_t stream) {
  const auto kernel = heat1d_grid_kernel<G>;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGridThreads, 0);
  if (err != cudaSuccess) return err;
  if (!coop || ctas < 1 || ctas > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  const int group = per_sm * sms / ctas, blocks = a.blocks;
  for (int b0 = 0; b0 < blocks; b0 += group) {
    Heat1DArgs g = a;
    const size_t at = static_cast<size_t>(b0) * a.n;
    g.blocks = min(group, blocks - b0);
    g.u_in = a.u_in + at;
    g.u_out = a.u_out + at;
    g.work = a.work + 2 * at;
    g.maxes = a.maxes + static_cast<size_t>(b0) * 4;
    g.count = a.count + b0;
    if (a.ev != nullptr) g.ev = a.ev + static_cast<size_t>(b0) * a.steps * 4;
    void* args[] = {&g, &ctas, const_cast<AdjustLaw*>(&law), const_cast<Policy*>(&p)};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(g.blocks * ctas), dim3(kGridThreads),
                                      args, 0, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int G>
struct Cells {
  static constexpr int value = G;
};

// fn(Cells<G>{}) for a plan's cells a lane or thread (heat_stencil.CELLS).
template <typename Fn>
cudaError_t with_cells(int cells, Fn&& fn) {
  switch (cells) {
    case 1: return fn(Cells<1>{});
    case 2: return fn(Cells<2>{});
    case 4: return fn(Cells<4>{});
    case 8: return fn(Cells<8>{});
    case 16: return fn(Cells<16>{});
    case 32: return fn(Cells<32>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `blocks` row blocks of n = br * nx cells, contiguous from u_in; shape 0 is
// the warp shape on `threads` / 32 warps with `cells` (G) cells a lane,
// shape 1 the grid shape with `ctas` CTAs a block and `cells` a thread
// (kernels/heat_stencil.py::heat1d_plan). K2 passes its k_floor as trk_k,
// evolve 0 and every 0; K4 one block and its tracker rows.
extern "C" int r2f2_heat1d(const float* u_in, float* u_out, float* snaps, float* ev, float* work, unsigned int* maxes,
                           unsigned long long* count, int* trk_k, float* trk_hi, float* trk_lo, int* trk_ov, int* trk_sh,
                           const int* site_cfg, int evolve, int blocks, int n, int nx, int steps, int every, int shape,
                           int threads, int cells, int ctas, float alpha, float dtodx2, float ema, float one_minus,
                           int headroom, int family, int eb, int mb, int fx, int fe, int fm, int tail_approx, int pinned,
                           void* stream) {
  if (blocks < 1 || nx < 3 || n < nx || n % nx != 0 || every < 0 || (every > 0 && snaps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Heat1DArgs a{u_in, u_out, snaps, ev, work, maxes, count, trk_k, trk_hi, trk_lo, trk_ov, trk_sh, site_cfg,
                     evolve, blocks, n, nx, steps, every, alpha, dtodx2};
  const AdjustLaw law{ema, one_minus, headroom, eb, fx};
  const Policy p{family, eb, mb, fx, fe, fm, tail_approx, pinned};
  const auto s = static_cast<cudaStream_t>(stream);
  if (shape == 1) {
    if (work == nullptr || maxes == nullptr || count == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(with_cells(cells, [&](auto g) { return launch_grid<decltype(g)::value>(a, ctas, law, p, s); }));
  }
  if (shape != 0 || threads % 32 != 0 || threads < 32 || threads > 32 * kMaxWarps || n > threads * cells || cells > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_cells(cells, [&](auto g) {
    constexpr int G = decltype(g)::value;
    if constexpr (G > 8) {
      return cudaErrorInvalidValue;
    } else {
      switch (table_kind(p)) {
        case 0: return launch_warp<G, 0>(a, threads, law, p, s);
        case 1: return launch_warp<G, 1>(a, threads, law, p, s);
        default: return launch_warp<G, 2>(a, threads, law, p, s);
      }
    }
  }));
}

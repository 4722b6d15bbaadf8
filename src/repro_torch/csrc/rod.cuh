// The explicit stencil kernels of repro_torch on a rod, for sm_90a (file
// heat1d_rod.cu before the 1-D K5 bodies and heat2d's grid joined it; now
// this header, rod_warp.cuh for the warp shape and rod_grid.cuh for the grid
// shape, and a translation unit for each body's launcher of each shape,
// which nvcc compiles side by side; rod_grid.cu holds the C entry): one
// substep body per workload, each on the launch shape that
// kernels/rod.py::rod_plan gives its field, flattened to a rod of n cells:
//
//   K2   replaces repro/kernels/fused.py::fused_sweep with heat_stencil.py::_heat1d_body
//   K4   replaces repro/kernels/mega.py::mega_sweep with heat1d_mega
//   K5b, K5e   fused_sweep with pde_steps.py::_advection1d_body; mega_sweep with advection1d_mega
//   K5c, K5f   fused_sweep with pde_steps.py::_burgers1d_body; mega_sweep with burgers1d_mega
//   K5a, K5d   fused_sweep with pde_steps.py::_heat2d_body; mega_sweep with heat2d_mega,
//              on a field beyond heat2d's thread-block cluster (pde_steps.cu)
//
// The bodies (Body), each a substep of the field at splits selected from
// field-wide maxima of magnitude bits:
//   heat1d   lap = (u[i-1] - 2u[i]) + u[i+1] on each row's interior and its
//            max; flux = alpha*lap at the lap max's split (site 0) and its
//            max; u += flux*dtodx2 at the flux max's split (site 1), in the
//            f32 family u = fma(lap, fl(alpha*dtodx2), u), as the compiled
//            reference folds and fuses it. Fixed ends; K2 runs (br, nx) row
//            blocks, a pad row a zero row of its block.
//   heat2d   the same on the flattened (nx, ny) field with the 5-point
//            laplacian ((N + S) + W) + E - 4u, the boundary pinned.
//   advection1d  (periodic) max of u; f = speed*u at that split (site 0);
//            df = f - f[i-1] (in the f32 family fma(speed, u, -f[i-1])) and
//            its max; u = family_mul_add(-dtodx, df, u) (site 1).
//   burgers1d  (periodic) max of u; uu = u*u (site 0) and its max; f =
//            0.5*uu (site 1); w = 0.5*(u[i+1] + u[i-1]) - cdt*(f[i+1] -
//            f[i-1]), rounded twice, the new state.
// A periodic body needs the neighbours' u, not their products: each thread
// recomputes a neighbour's f (or uu and f) from its u at the uniform split,
// so the exchange of u and the max of u (taken where u is written: at the
// load and in the update) share one barrier, two a substep in all.
// K2 and K5a-c run `steps` substeps per block with per-block evidence and a
// carried floor; K4 and K5d-f run a whole horizon of one block with kernel
// K4's contract (mega_pde.cu): snapshots at every `every`-th substep, the
// adjust unit ticking each substep, the datapath floor latched to the
// tracker's split at snapshot boundaries.
//
// Bound: the serial chain of a substep (two field-wide maxima, two split
// selections, the rounding of every product), not bytes or operations (the
// main path's rods, 128 and 256 cells, are 1 KB and a few thousand f32
// operations a substep). The design shortens the chain:
//   warp shape (a 1-D block of at most 2048 cells): one CTA a block of W <= 8
//     warps, one a 32 cells, lane l of the CTA holding cells [l*G, l*G + G)
//     of the flattened block in registers; neighbours come by shuffle (the
//     warps' edge cells and a periodic rod's wrap through shared memory),
//     each field max is a __reduce_max_sync over the magnitude bit patterns
//     and one over the warps' words, whose result every lane has, so every
//     lane selects the splits itself. CTA barriers a substep: heat1d three
//     (the two maxima, the warps' edge cells), a periodic rod two.
//   grid shape (larger blocks, and heat2d's fields beyond its cluster): a
//     cooperative grid of `ctas` CTAs a block, the field in global memory (the
//     50 MB L2 holds it) in two buffers; each thread holds G cells (strided
//     by the grid's threads) and their neighbours in registers from loads all
//     in flight before the first use (a block beyond ctas * 256 * G cells
//     walks batches of them: heat's laplacians go through a third buffer, a
//     periodic body reloads and recomputes); each field max is an atomicMax
//     into a slot of a ring of two substeps (an integer max of bit patterns,
//     so arrival order does not matter), and r2f2::grid_barrier (release-add
//     and acquire spin on a 64-bit counter) separates the passes: heat three
//     a substep (lap max, flux max, update), a periodic body two. It has no
//     size limit.
// The products of a substep come from a per-launch table (r2f2::ConstMul for
// a constant operand, r2f2::PairMul for u*u; the constant rounded and the
// split's formats built for every k of the table), read at the uniform split,
// with the product's variant (kind) fixed per launch (warp shape: a template
// parameter) or per pass (grid shape: r2f2::with_kind), so a lane's cells run
// straight-line code with no per-element quantize_em branch. The warp shape
// starts each pass's products at the split of the last substep while the
// field max reduces (Guess), and redoes them only where the split moved. The
// adjust unit ticks in every thread on the uniform evidence, so the floor
// each thread reads needs no broadcast. The C entry point (rod_grid.cu)
// returns the launch's cudaError_t.
//
// Capture (r2f2::Capture, RodHist): each CTA bins, every substep, the
// operands the reference's body passes its two sites, over the cells it
// updates (heat: lap and flux over the interior cells, the constants alpha
// and dtodx2 once a cell; a periodic rod: every cell), into a shared-memory
// histogram it adds to the launch's slot at each snapshot boundary (a
// megakernel's interval i) and after the last substep (a fused sweep's one
// slot, or a megakernel's remainder). The f32 family's folded update never
// forms flux = alpha*lap, so both shapes compute it there for the bins
// (the warp shape already does, for the flux max). With capture off the
// histogram pointer is null and the branch around the binning is uniform.
//
// Packed storage (r2f2::Storage, one block): a packed input is decoded at
// its split where the cells are first loaded (the grid shape: into a third
// buffer, behind one more grid barrier); a packed output is encoded from the
// cells after the last substep, at a split picked from their finite max (a
// fused sweep; the warp shape one more reduction, the grid shape one more
// grid barrier) or at the carried split kst (a megakernel). A megakernel
// with storage rounding takes, at each snapshot boundary after the update,
// the block's finite max over every cell (the pinned ends too), its split
// kst, and rounds the cells there before the snapshot and the next substep
// (the warp shape: a reduction and a republish of the edges, two CTA
// barriers; the grid shape: one grid barrier and a pass over its cells),
// and does so once more after a remainder.
//
// Ensembles (Simulation.run_ensemble): each of `members` members runs the
// launch's blocks as it would alone, member member0 + blockIdx.y, every array
// moved to its own by member_args (a member's blocks, evidence, tracker rows,
// storage splits, histograms, scratch and barrier counters); the grid
// shape runs as many members at once as the card holds their CTAs, in waves.
#pragma once

#include <cuda_runtime.h>

#include "r2f2_device.cuh"

namespace rod {

// The bodies (kernels/rod.py::BODIES).
enum Body : int { kHeat1D = 0, kAdvection1D = 1, kBurgers1D = 2, kHeat2D = 3 };

struct RodArgs {
  const float* u_in;
  float* u_out;
  float* snaps;     // (steps / every, n) or null
  float* ev;        // (blocks, steps, 2, 2) or null
  float* work;      // grid shape: per block the other field buffer and the laplacian, 2n floats
  uint32_t* maxes;  // grid shape: (blocks, 2, 2) zeroed: a substep's two maxima, a ring of two substeps
  unsigned long long* count;  // grid shape: (blocks,) zeroed: a launch's barrier counter (at its first block)
  int* trk_k;       // the floor's start (the carried or pinned split; K2's k_floor), null for none
  float* trk_hi;
  float* trk_lo;
  int* trk_ov;
  int* trk_sh;
  const int* site_cfg;  // (2, 3): op, k_lo, k_hi, read with an evolving tracker
  int evolve;           // tick the tracker rows and latch the floor at boundaries
  int blocks, n, row, steps, every;  // row: cells a row (heat1d nx, heat2d ny, a periodic rod n); every = 0: no snapshots
  int members, member0, mblocks;     // ensemble members, the wave's first, a member's blocks (blocks: a launch's)
  float c0, c1;  // heat alpha, dtodx2; advection1d speed, dtodx; burgers1d dt/(2dx), 0.5
  r2f2::Storage st;  // packed input and output, storage rounding, the output split (one block)
  r2f2::Capture cap;  // the operand histograms, (slots, 2, 2, n_bins); cap.out null: capture off
};

// Member member0 + blockIdx.y of an ensemble launch: every array moved to
// the member's (a member's mblocks blocks of n cells; the host may have moved
// the block arrays to a group of its blocks already), the adjust table shared.
__device__ inline RodArgs member_args(RodArgs a) {
  const size_t m = static_cast<size_t>(a.member0) + blockIdx.y;
  const size_t cells = static_cast<size_t>(a.mblocks) * a.n;
  const int slots = a.every > 0 ? a.steps / a.every + 1 : 1;
  a.u_in = r2f2::at_member(a.u_in, m, cells);
  a.u_out = r2f2::at_member(a.u_out, m, cells);
  a.snaps = r2f2::at_member(a.snaps, m, a.every > 0 ? static_cast<size_t>(a.steps / a.every) * cells : 0);
  a.ev = r2f2::at_member(a.ev, m, static_cast<size_t>(a.mblocks) * a.steps * 4);
  a.work = r2f2::at_member(a.work, m, (a.st.pay_in != nullptr ? 3 : 2) * cells);
  a.maxes = r2f2::at_member(a.maxes, m, static_cast<size_t>(a.mblocks) * 4 + 2);
  a.count = r2f2::at_member(a.count, m, a.mblocks);
  a.trk_k = r2f2::at_member(a.trk_k, m, 2);
  a.trk_hi = r2f2::at_member(a.trk_hi, m, 2);
  a.trk_lo = r2f2::at_member(a.trk_lo, m, 2);
  a.trk_ov = r2f2::at_member(a.trk_ov, m, 2);
  a.trk_sh = r2f2::at_member(a.trk_sh, m, 2);
  a.st = r2f2::member_storage(a.st, m, cells, a.mblocks);
  a.cap = r2f2::member_capture(a.cap, m, slots, 2);
  return a;
}

// The warp shape's launchers (rod_warp.cuh, one translation unit a body):
// `threads` / 32 warps of one CTA a block, `cells` cells a lane.
#define ROD_DECLARE_WARP(NAME)                                                                             \
  cudaError_t NAME(const RodArgs& a, int threads, int cells, const r2f2::AdjustLaw& law, const r2f2::Policy& p, \
                   cudaStream_t stream);
ROD_DECLARE_WARP(launch_warp_heat1d)
ROD_DECLARE_WARP(launch_warp_advection1d)
ROD_DECLARE_WARP(launch_warp_burgers1d)

// The grid shape's launchers (rod_grid.cuh): `ctas` CTAs a block, `cells` a thread.
#define ROD_DECLARE_GRID(NAME)                                                                            \
  cudaError_t NAME(const RodArgs& a, int cells, int ctas, const r2f2::AdjustLaw& law, const r2f2::Policy& p, \
                   cudaStream_t stream);
ROD_DECLARE_GRID(launch_grid_heat1d)
ROD_DECLARE_GRID(launch_grid_heat2d)
ROD_DECLARE_GRID(launch_grid_advection1d)
ROD_DECLARE_GRID(launch_grid_burgers1d)

}  // namespace rod

// What every translation unit uses, each its own copy (the product table is a
// CTA's shared memory).
namespace {

using r2f2::AdjustLaw;
using r2f2::ConstMul;
using r2f2::PairMul;
using r2f2::Policy;
using r2f2::SiteState;
using namespace rod;  // the bodies and their arguments

template <int B>
constexpr bool kPeriodic = B == kAdvection1D || B == kBurgers1D;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;      // warps of a warp-shape block (kernels/rod.py::WARP_MAX)
constexpr int kGridThreads = 256;  // threads of a grid-shape CTA
constexpr int kTable = 8;          // splits of the product table: every k of a format (eb >= 2, eb + fx <= 8)
constexpr int kPeriodicGridCells = 8;  // cells a thread of a periodic body's grid holds (kernels/rod.py::rod_plan)

// The substep's products at every split of the table, one per CTA (a
// variable of the file, so a read needs no generic-to-shared conversion):
// the constant products of site 0 and site 1, and the pair product u*u.
struct MulTable {
  ConstMul site[2][kTable];
  PairMul pair[kTable];
};

__shared__ MulTable mul_table;

// The launch's constants, the evidence of the two constant operands and the
// product table (filled before the first substep). A body's constant
// products: heat alpha (site 0) and dtodx2 (site 1), advection1d speed and
// -dtodx (its update is u - dtodx*df), burgers1d 0.5 (site 1; site 0 is u*u).
template <int B>
struct Step {
  float c0, c1;
  float folded;  // heat: fl(alpha * dtodx2), the f32 family's fused update
  int e0, e1;    // the constants' exponents: evidence
  bool fold;
  Policy p;
  r2f2::TileQuant fixed;

  __device__ Step(const RodArgs& a, const Policy& p_) : p(p_) {
    c0 = a.c0, c1 = a.c1;
    folded = __fmul_rn(c0, c1);
    e0 = r2f2::mag_exponent(r2f2::finite_mag_bits(c0));
    e1 = r2f2::mag_exponent(r2f2::finite_mag_bits(c1));
    fold = p.family == r2f2::kF32;
    fixed = r2f2::tile_quant(p.fe, p.fm, -1);
    if (threadIdx.x < kTable) {
      mul_table.site[0][threadIdx.x] = ConstMul(const0(), threadIdx.x, p, fixed);
      mul_table.site[1][threadIdx.x] = ConstMul(const1(), threadIdx.x, p, fixed);
      mul_table.pair[threadIdx.x] = PairMul(threadIdx.x, p, fixed);
    }
    __syncthreads();
  }

  __device__ float const0() const { return c0; }
  __device__ float const1() const { return B == kAdvection1D ? -c1 : c1; }

  __device__ ConstMul at0(int k) const {
    return k >= 0 && k < kTable ? mul_table.site[0][k] : ConstMul(const0(), k, p, fixed);
  }
  __device__ ConstMul at1(int k) const {
    return k >= 0 && k < kTable ? mul_table.site[1][k] : ConstMul(const1(), k, p, fixed);
  }
  __device__ PairMul pair_at(int k) const { return k >= 0 && k < kTable ? mul_table.pair[k] : PairMul(k, p, fixed); }
};

// The capture histogram of a rod kernel's CTA (r2f2::Hist over the body's two
// sites; rows 2 * site + operand) and each thread's count of the valid lanes
// of the constant operands since the last flush: heat alpha (row 0) and
// dtodx2 (row 3), advection1d speed (row 0) and -dtodx (row 2, its exponent
// is dtodx's), burgers1d 0.5 (row 2).
template <int B>
struct RodHist : r2f2::Hist {
  int n_const = 0;

  // Zeroed (capture on) before the CTA barrier of Step's constructor.
  __device__ RodHist(const RodArgs& a, int* smem) : r2f2::Hist(a.cap, smem, 2) {
    if (on()) zero();
  }

  // The constants' lanes, then the CTA's words into slot `slot` (every thread).
  __device__ void flush_at(int slot, const Step<B>& c) {
    if constexpr (B == kBurgers1D) {
      add_n(2, c.const1(), n_const);
    } else if constexpr (B == kAdvection1D) {
      add_n(0, c.const0(), n_const);
      add_n(2, c.const1(), n_const);
    } else {
      add_n(0, c.const0(), n_const);
      add_n(3, c.const1(), n_const);
    }
    n_const = 0;
    flush(slot);
  }

  // After the last substep: a fused sweep's one slot, or a megakernel's
  // remainder (slot steps / every) where there is one.
  __device__ void flush_end(const RodArgs& a, const Step<B>& c) {
    if (on() && (a.every == 0 || a.steps % a.every != 0)) flush_at(a.every == 0 ? 0 : a.steps / a.every, c);
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

  __device__ void load(const RodArgs& a) {
    for (int j = 0; j < 2; ++j) st[j] = SiteState{a.trk_k[j], a.trk_hi[j], a.trk_lo[j], a.trk_ov[j], a.trk_sh[j]};
    for (int j = 0; j < 6; ++j) cfg[j] = a.site_cfg[j];
  }

  __device__ void tick(const int (&e)[4], const AdjustLaw& law) {
    for (int j = 0; j < 2; ++j) {
      r2f2::adjust_tick(st[j], static_cast<float>(e[2 * j]), static_cast<float>(e[2 * j + 1]), cfg[3 * j],
                        cfg[3 * j + 1], cfg[3 * j + 2], law);
    }
  }

  __device__ void store(const RodArgs& a) const {
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

// pde/heat2d.py's add order: ((N + S) + W) + E - 4u.
__device__ __forceinline__ float lap5(float n, float s, float w, float e, float c) {
  return __fsub_rn(__fadd_rn(__fadd_rn(__fadd_rn(n, s), w), e), __fmul_rn(4.0f, c));
}

// burgers1d's update, rounded twice: 0.5*(ur + ul) - cdt*(fr - fl).
__device__ __forceinline__ float lax_friedrichs(float ul, float ur, float fl, float fr, float cdt) {
  return __fsub_rn(__fmul_rn(0.5f, __fadd_rn(ur, ul)), __fmul_rn(cdt, __fsub_rn(fr, fl)));
}

// advection1d's upwind difference: in the f32 family (a product of kind 0)
// the flux product fused into it, fma(speed, u, -f[i-1]).
template <int J>
__device__ __forceinline__ float upwind(const ConstMul& m, float u, float f_prev) {
  if constexpr (J == 0) {
    return __fmaf_rn(m.c, u, -f_prev);
  } else {
    return __fsub_rn(m.apply<J>(u), f_prev);
  }
}

// Per-cell selects in bit operations, so a lane's cells stay one basic
// block (no branch around a cell, which would keep the compiler from
// interleaving the cells' chains): all ones where bit g of `bits` is set.
__device__ __forceinline__ uint32_t cell_mask(uint32_t bits, int g) { return 0u - ((bits >> g) & 1u); }

__device__ __forceinline__ float pick(uint32_t mask, float a, float b) {
  return __uint_as_float((__float_as_uint(a) & mask) | (__float_as_uint(b) & ~mask));
}

// Evidence of one substep, the two sites' operand exponents, one 16-byte store.
__device__ __forceinline__ void write_evidence(float* ev, const int (&e)[4]) {
  *reinterpret_cast<float4*>(ev) =
      make_float4(static_cast<float>(e[0]), static_cast<float>(e[1]), static_cast<float>(e[2]), static_cast<float>(e[3]));
}

// The launch's floor and tracker from the arguments.
__device__ __forceinline__ Floor load_floor(const RodArgs& a, Tracker& trk) {
  Floor f{a.trk_k != nullptr, {0, 0}};
  if (f.on) f.k[0] = a.trk_k[0], f.k[1] = a.trk_k[1];
  if (a.evolve) trk.load(a);
  return f;
}

template <int G>
struct Cells {
  static constexpr int value = G;
};

// fn(Cells<G>{}) for a plan's cells a lane or thread (kernels/rod.py::CELLS).
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

// The megakernel plane of repro_torch for swe2d (kernel K4), for sm_90a: a
// whole simulation horizon in one launch, with the adjust unit on the card.
//
//   swe2d_band_kernel   replaces repro/kernels/mega.py::mega_sweep with swe2d_mega
//
// (heat1d's K4 is the rod, rod.cuh.) It follows mega_sweep's contract for f32 storage
// without capture: the body runs on the whole field as one split block; with
// an evolving tracker each site's row ticks every substep (r2f2::adjust_tick)
// while the datapath floor `ka` latches to the row's split only at snapshot
// boundaries; the state is snapshot at every boundary and the remainder
// substeps run after the last one. The C entry point returns the launch's
// cudaError_t.
//
// swe2d: the (3, nx, ny) state does not fit one SM (3x128x128 f32 alone is
// 196,608 B), so a cooperative grid of CTAs (kernels/mega.py::swe2d_plan)
// cuts it into bands of rows: CTA b of C owns rows [r0, r1) = [b*nx/C,
// (b+1)*nx/C) (one row at the main path's 128x128, 127 CTAs) and keeps them,
// with the halo row r1 below them, in its band arrays (shared memory, or a
// per-CTA slice of device memory where the band does not fit). A substep
// runs in three phases and two grid barriers:
//   A  Ux on the band's own rows (the last one reads the halo row) into the
//      band and into a global ring, the fluxes G on rows r0..r1, and the
//      maxima of |Ux.hu|, |Ux.h|; barrier 1 arrives, then Uy and Gy on rows
//      r0..r1 (all from the band) while it completes;
//   B  t1 = hu*hu and t3 = h*h on the policy at k11/k33 and their maxima, and
//      Fx's f32 components, on the own Ux rows; barrier 2 arrives, then the
//      same on the halo Fx rows r0-1 and r1 (their Ux read from the ring);
//   C+D Fx's momentum component through the policy's quotient and mul_add at
//      k_div/k_gq3 on rows r0-1..r1, a CTA barrier, then the update of rows
//      r0..r1 (the walls as the interior value they mirror) into the band's
//      other U buffer; the own rows go to the snapshot and the output. The
//      halo row r1 is the next band's row r1, recomputed bit for bit from the
//      same values, so the next A needs no barrier before it.
// Storage rounding (r2f2::Storage.round, "quantized" and "packed"): at a
// snapshot boundary D also takes the max of the finite magnitudes of its own
// rows (all three components: the stacked leaf has one split), a third grid
// barrier (its own row of words) gives the field's max and its split kst,
// and each CTA rounds the band's rows, the halo row included (the next
// band rounds the same values at the same split), before the snapshot and
// the output; once more after a remainder. The state stays f32: the host
// packs it at kst (kernel K1).
// Capture (r2f2::Capture): each product is binned once, by the band that owns
// its Ux row (rows r0 .. r0 + xr - 1; a band recomputes the halo row below
// it, and that row's products are the next band's to count): B bins q1 (q1q1,
// both operands) and q3 (q3q3 both, the quotient's divisor), C bins t3 (gq3)
// and t1 (the dividend) and counts the constant g/2 a product. The CTA's
// shared-memory histogram (after its band arrays, or alone where the bands
// live in device memory) goes to slot i of the launch's at the end of
// interval i, and to the last slot after a remainder.
// Every value comes from the device functions and operation order of the
// four-phase grid it replaces; Fx's halo rows and row r1 are recomputed, not
// exchanged. The policy products run as r2f2::PairMul / ConstMul of one kind
// a pass (family_mul, family_div, family_mul_add bit for bit). Each CTA's
// thread 0 ticks the adjust unit on the same evidence (deterministic), so the
// latch is CTA-local; CTA 0 alone writes the evidence and the tracker rows.
//
// Hazards the two grid barriers leave open, and what covers each:
//   Ux     a fast CTA's A of substep s+1 writes Ux rows that its neighbour's
//          B-gap of substep s may still read for its halo Fx: Ux is a ring
//          of two substeps (a slot is written again in s+2, behind barrier 1
//          of s+1, which waits for every CTA's substep s).
//   maxima each CTA posts its maxima in its own word of the barrier's row,
//          and a row is posted again only behind the other barrier, which no
//          CTA passes before every CTA has read the row (grid_arrive).
//   ka     the floor was a global word latched behind a barrier; it is now
//          per CTA in shared memory, written by thread 0 after the CTA's
//          last read of the substep (behind the CTA barrier in C+D).
//   walls  row 0 mirrors row 1 (CTA 0 holds row 1, its own or its halo);
//          row nx-1 mirrors row nx-2, and the plan gives the last band two
//          rows or more (C <= nx - 1).
//   Gy, t1, t3 of the halo rows are the band's own work, so no other CTA's
//          copy is read.
// Any field: a band loops over its rows and columns with the CTA's threads,
// and fields with more rows than CTAs take taller bands and CTAs of up to
// 512 threads (kernels/mega.py::swe2d_plan).
// Ensembles (Simulation.run_ensemble): member member0 + blockIdx.y runs on
// its own grid of gridDim.x CTAs, every array (state, snapshots, evidence,
// Ux ring, band arrays, maxima words, the barrier counter, tracker rows,
// histograms) its own (member_args), so its grid barriers wait only on its
// own CTAs. The plan gives each member taller bands so that every member's
// CTAs are resident at once, and beyond that the members run in waves of
// cooperative launches.
//
// It is bound by the latency of its chain of phases, not by bytes or
// operations (the main path's 128x128 state is 196 KB and ~2.5 MFLOP a
// substep): at 128x128 each of the ten steps of a substep (the phases, each
// barrier's arrive with its release fence, each wait with its two L2 round
// trips) takes 0.5-1 us. The maxima are maxima of exponent fields, so their
// fold gives the same answer in every order.
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::AdjustLaw;
using r2f2::Policy;
using r2f2::SiteState;

namespace {

constexpr int kSweMaxThreads = 512;  // threads of a CTA, at most (a multiple of 32)
constexpr int kSweMaxWarps = kSweMaxThreads / 32;

struct SweArgs {
  const float* u_in;
  float* u_out;
  float* snaps;
  float* ev;        // (steps, 4, 2) or null
  float* ux;        // Ux in a ring of two substeps, (2, 3, nx-1, ny)
  float* bands;     // the CTAs' band arrays in device memory, or null: in shared memory
  uint32_t* words;  // (3, CTAs): each CTA's maxima at a substep's two grid barriers and the storage max
  unsigned long long* count;  // the launch's barrier counter, zeroed
  const int* ka;    // the datapath floor (4) the run starts from, null when untracked
  int* trk_k;
  float* trk_hi;
  float* trk_lo;
  int* trk_ov;
  int* trk_sh;
  const int* site_cfg;
  int evolve;
  int nx, ny, steps, every;
  int rows;  // the tallest band's rows
  float cx2, cy2, cx, cy, c;  // dt/(2dx), dt/(2dy), dt/dx, dt/dy, g/2, each rounded once to f32
  r2f2::Storage st;           // the storage rounding and the carried split out (f32 in and out)
  r2f2::Capture cap;          // the operand histograms, (slots, 4, 2, n_bins); cap.out null: capture off
  int member0;                // the wave's first ensemble member (blockIdx.y counts from it)
};

// Floats of one CTA's band arrays for bands of up to `rows` rows (mega.py::swe2d_band_floats).
__host__ __device__ __forceinline__ size_t band_floats(int rows, int ny) {
  return static_cast<size_t>(16 * rows + 21) * ny;
}

// The f32 momentum flux q1*q1/q3 + c*(q3*q3), its sum fused into the product
// as the compiled reference computes it.
__device__ __forceinline__ float mom32(float q1, float q3, float c) {
  const float t2 = __fdiv_rn(__fmul_rn(q1, q1), q3);
  return __fmaf_rn(c, __fmul_rn(q3, q3), t2);
}

__device__ __forceinline__ float cross(float hu, float hv, float h) { return __fdiv_rn(__fmul_rn(hu, hv), h); }

// One half step: 0.5*(a1 + a0) - k*(f1 - f0), five roundings.
__device__ __forceinline__ float half_step(float a1, float a0, float f1, float f0, float k) {
  return __fsub_rn(__fmul_rn(0.5f, __fadd_rn(a1, a0)), __fmul_rn(k, __fsub_rn(f1, f0)));
}

// The interior update of one component: U - cx*dFx - cy*dGy, each product
// fused into its subtraction as the compiled reference computes it.
__device__ __forceinline__ float lw_update(float u, float fx1, float fx0, float gy1, float gy0, float cx, float cy) {
  const float v = __fmaf_rn(-cx, __fsub_rn(fx1, fx0), u);
  return __fmaf_rn(-cy, __fsub_rn(gy1, gy0), v);
}

// Walls: h mirrors; hu flips at the x walls (rows), hv at the y walls (columns).
__device__ __forceinline__ bool wall_flips(int comp, int i, int j, int nx, int ny) {
  return (comp == 1 && (i == 0 || i == nx - 1)) || (comp == 2 && (j == 0 || j == ny - 1));
}

__device__ __forceinline__ uint32_t warp_max(uint32_t v) { return __reduce_max_sync(0xffffffffu, v); }

// The substep's evidence rows: q1q1 (e1, e1), q3q3 (e3, e3), gq3 (ec, et3), div (et1, e3).
struct Evidence {
  float e[8];

  __device__ Evidence(int e1, int e3, int ec, int et1, int et3) {
    const int v[8] = {e1, e1, e3, e3, ec, et3, et1, e3};
    for (int w = 0; w < 8; ++w) e[w] = static_cast<float>(v[w]);
  }

  __device__ void write(float* ev, int s) const {
    for (int w = 0; w < 8; ++w) ev[static_cast<size_t>(s) * 8 + w] = e[w];
  }
};

__device__ __forceinline__ void load_rows(SiteState* st, int n, const int* k, const float* hi, const float* lo,
                                          const int* ov, const int* sh) {
  for (int j = 0; j < n; ++j) st[j] = SiteState{k[j], hi[j], lo[j], ov[j], sh[j]};
}

__device__ __forceinline__ void store_rows(const SiteState* st, int n, int* k, float* hi, float* lo, int* ov,
                                           int* sh) {
  for (int j = 0; j < n; ++j) {
    k[j] = st[j].k;
    hi[j] = st[j].hi;
    lo[j] = st[j].lo;
    ov[j] = st[j].ov;
    sh[j] = st[j].sh;
  }
}

// A grid barrier that carries two maxima, as exponent fields. grid_arrive:
// the CTA's maxima of (v0, v1), magnitude bit patterns, fold to one word,
// f0 | f1 << 8, that thread 0 stores in the CTA's own slot of the
// barrier's row of `words`; then it adds one to the counter with release
// semantics, the one atomic a CTA makes on a shared address. Work between
// grid_arrive and grid_wait overlaps the barrier; its writes are published
// by the next grid_arrive. grid_wait: warp 0 spins on acquire loads until
// the counter reaches `target`, then reads every CTA's word (each lane a few
// CTAs) and folds them; every thread gets the two exponents. Barrier 1 of
// a substep takes row 0, barrier 2 row 1: a CTA writes a row again only
// after the other barrier, which no CTA passes before every CTA has read
// the row.
constexpr int kMaxWordsPerLane = 8;  // a grid of up to 256 CTAs

__device__ __forceinline__ void grid_arrive(uint32_t v0, uint32_t v1, uint32_t* words, uint32_t (*red)[2],
                                            unsigned long long* count) {
  v0 = warp_max(v0);
  v1 = warp_max(v1);
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5][0] = v0;
    red[threadIdx.x >> 5][1] = v1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      v0 = max(v0, red[w][0]);
      v1 = max(v1, red[w][1]);
    }
    __stcg(words + blockIdx.x, (v0 >> 23) | (v1 >> 23) << 8);
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(count) : "memory");
  }
}

// The unbiased exponents of the two maxima.
__device__ __forceinline__ int2 grid_wait(const uint32_t* words, uint32_t* seen, unsigned long long* count,
                                          unsigned long long target) {
  if (threadIdx.x < 32) {
    unsigned long long now = 0ull;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(now) : "l"(count) : "memory");
    } while (now < target);
    uint32_t w[kMaxWordsPerLane];
#pragma unroll
    for (int i = 0; i < kMaxWordsPerLane; ++i) {  // every load in flight at once
      const int b = threadIdx.x + 32 * i;
      w[i] = b < static_cast<int>(gridDim.x) ? __ldcg(words + b) : 0u;
    }
    uint32_t f0 = 0u, f1 = 0u;
#pragma unroll
    for (int i = 0; i < kMaxWordsPerLane; ++i) {
      f0 = max(f0, w[i] & 0xFFu);
      f1 = max(f1, w[i] >> 8);
    }
    f0 = warp_max(f0);
    f1 = warp_max(f1);
    if (threadIdx.x == 0) {
      seen[0] = f0;
      seen[1] = f1;
    }
  }
  __syncthreads();
  return make_int2(static_cast<int>(seen[0]) - 127, static_cast<int>(seen[1]) - 127);
}

// Member member0 + blockIdx.y: its state, snapshots, evidence, scratch, its
// own barrier counter and maxima words, tracker rows and histograms.
__device__ inline SweArgs member_args(SweArgs a) {
  const size_t m = static_cast<size_t>(a.member0) + blockIdx.y, C = gridDim.x;
  const size_t n3 = 3 * static_cast<size_t>(a.nx) * a.ny;
  a.u_in = r2f2::at_member(a.u_in, m, n3);
  a.u_out = r2f2::at_member(a.u_out, m, n3);
  a.snaps = r2f2::at_member(a.snaps, m, static_cast<size_t>(a.steps / a.every) * n3);
  a.ev = r2f2::at_member(a.ev, m, static_cast<size_t>(a.steps) * 8);
  a.ux = r2f2::at_member(a.ux, m, 2 * 3 * static_cast<size_t>(a.nx - 1) * a.ny);
  a.bands = r2f2::at_member(a.bands, m, C * band_floats(a.rows, a.ny));
  a.words = r2f2::at_member(a.words, m, 3 * C);
  a.count = r2f2::at_member(a.count, m, 1);
  a.ka = r2f2::at_member(a.ka, m, 4);
  a.trk_k = r2f2::at_member(a.trk_k, m, 4);
  a.trk_hi = r2f2::at_member(a.trk_hi, m, 4);
  a.trk_lo = r2f2::at_member(a.trk_lo, m, 4);
  a.trk_ov = r2f2::at_member(a.trk_ov, m, 4);
  a.trk_sh = r2f2::at_member(a.trk_sh, m, 4);
  a.st = r2f2::member_storage(a.st, m, n3, 1);
  a.cap = r2f2::member_capture(a.cap, m, a.steps / a.every + 1, 4);
  return a;
}

template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) swe2d_band_kernel(SweArgs args, AdjustLaw law, Policy p) {
  const SweArgs a = member_args(args);
  extern __shared__ __align__(16) float band_smem[];
  __shared__ uint32_t red[kSweMaxWarps][2];
  __shared__ uint32_t seen[2];
  __shared__ int floor_k[4];      // the latched datapath floor, CTA-local
  __shared__ SiteState st[4];     // the tracker rows, thread 0's
  const int nx = a.nx, ny = a.ny, n = nx * ny, nxm = (nx - 1) * ny, R = a.rows, T = blockDim.x;
  const int tid = threadIdx.x;
  const int C = gridDim.x, b = blockIdx.x;
  const int r0 = static_cast<int>(static_cast<long long>(b) * nx / C);
  const int r1 = static_cast<int>(static_cast<long long>(b + 1) * nx / C);
  const int own = r1 - r0;
  const int ur = own + (r1 < nx ? 1 : 0);  // U rows held: the own rows and the halo row r1
  const int xr = min(r1, nx - 1) - r0;     // own Ux rows r0 .. r0 + xr - 1
  const int f_lo = max(r0 - 1, 0), f_hi = min(r1, nx - 2);  // Fx rows
  const int g_lo = max(r0, 1), g_hi = min(r1, nx - 2);      // Gy rows
  const bool lead = b == 0 && tid == 0;
  // band arrays: U (2 buffers x 3 planes of R+1 rows), Fx rows r0-1..r1 (3 planes
  // of R+2 rows: Ux's hu, h, hv, then Fx), t1 and t3 there, Gy and G's two
  // flux components on rows r0..r1
  const size_t up = static_cast<size_t>(R + 1) * ny, fp = static_cast<size_t>(R + 2) * ny;
  float* band = a.bands != nullptr ? a.bands + b * band_floats(R, ny) : band_smem;
  float* ub = band;
  float* fx = ub + 6 * up;
  float* tt = fx + 3 * fp;
  float* gy = tt + 2 * fp;
  float* gf = gy + 3 * up;
  // local offsets: U and Gy row i at (i - r0) * ny, Fx and t row i at (i - r0 + 1) * ny
  const int ec = r2f2::mag_exponent(r2f2::finite_mag_bits(a.c));
  const r2f2::TileQuant fixed = p.family == r2f2::kFixed ? r2f2::tile_quant(p.fe, p.fm, -1) : r2f2::TileQuant{};
  const bool has_floor = a.ka != nullptr;
  const int* fk = has_floor ? floor_k : nullptr;
  // capture's histogram after the band arrays (alone where they live in device
  // memory), a view built where capture is on; zeroed before the CTA barrier below
  auto hist = [&] {
    return r2f2::Hist(a.cap, reinterpret_cast<int*>(band_smem + (a.bands != nullptr ? 0 : band_floats(R, ny))), 4);
  };
  if (a.cap.out != nullptr) hist().zero();
  // the constant g/2 over this thread's products of `n_sub` substeps, then the CTA's words into slot `slot`
  auto flush_hist = [&](int slot, int n_sub) {
    const r2f2::Hist h = hist();
    h.add_n(4, a.c, r2f2::strided_count(tid, xr * ny, T) * n_sub);
    h.flush(slot);
  };

  if (a.steps == 0) {
    for (int c = 0; c < 3; ++c)
      for (int q = tid; q < own * ny; q += T) a.u_out[c * n + r0 * ny + q] = a.u_in[c * n + r0 * ny + q];
    if (lead && a.st.k_out != nullptr) a.st.k_out[0] = 0;
    return;
  }
  for (int c = 0; c < 3; ++c)
    for (int q = tid; q < ur * ny; q += T) ub[c * up + q] = a.u_in[c * n + r0 * ny + q];
  if (tid == 0) {
    if (a.evolve) load_rows(st, 4, a.trk_k, a.trk_hi, a.trk_lo, a.trk_ov, a.trk_sh);
    for (int j = 0; j < 4; ++j) floor_k[j] = has_floor ? a.ka[j] : 0;
  }
  __syncthreads();

  unsigned long long passed = 0ull;  // grid barriers behind
  int kst = 0;                       // the carried storage split
  // The storage rounding of the band's rows [r0, r0 + held) of `v` (each
  // thread its own elements; `mx` its max of their finite magnitudes)
  // behind the third grid barrier; rows below `own` go to the snapshot and
  // the output where given.
  auto round_band = [&](float* v, uint32_t mx, int held, float* snap, float* out) {
    grid_arrive(mx, 0u, a.words + 2 * C, red, a.count);
    const int2 w = grid_wait(a.words + 2 * C, seen, a.count, ++passed * C);
    kst = r2f2::storage_k(static_cast<uint32_t>(w.x + 127) << 23, p.eb, p.fx);
    const r2f2::Codec at(kst, p);
    for (int q = tid; q < held * ny; q += T) {
      const int l = q / ny;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float r = at.round(v[c * up + q]);
        v[c * up + q] = r;
        if (l < own) {
          const size_t g = static_cast<size_t>(c) * n + r0 * ny + q;
          if (snap != nullptr) snap[g] = r;
          if (out != nullptr) out[g] = r;
        }
      }
    }
  };
  for (int s = 0; s < a.steps; ++s) {
    const float* u = ub + (s & 1) * 3 * up;
    float* un = ub + ((s + 1) & 1) * 3 * up;
    float* uxs = a.ux + static_cast<size_t>(s & 1) * 3 * nxm;

    // A: Ux on the own rows, and the fluxes G (its second component is F's
    // third) on rows r0..r1, which Uy reads
    uint32_t m1 = 0u, m3 = 0u;
    for (int q = tid; q < xr * ny; q += T) {
      const float h = u[q], hu = u[up + q], hv = u[2 * up + q];
      const float hd = u[q + ny], hud = u[up + q + ny], hvd = u[2 * up + q + ny];
      const float f1 = mom32(hu, h, a.c), f2 = cross(hu, hv, h), fd2 = cross(hud, hvd, hd);
      const float x0 = half_step(hd, h, hud, hu, a.cx2);
      const float x1 = half_step(hud, hu, mom32(hud, hd, a.c), f1, a.cx2);
      const float x2 = half_step(hvd, hv, fd2, f2, a.cx2);
      gf[q] = f2;
      gf[up + q] = mom32(hv, h, a.c);
      if (q >= (xr - 1) * ny) {  // the last Ux row also gives G of the row below it
        gf[ny + q] = fd2;
        gf[up + ny + q] = mom32(hvd, hd, a.c);
      }
      const int g = r0 * ny + q;
      __stcg(uxs + g, x0);
      __stcg(uxs + nxm + g, x1);
      __stcg(uxs + 2 * nxm + g, x2);
      fx[ny + q] = x1;
      fx[fp + ny + q] = x0;
      fx[2 * fp + ny + q] = x2;
      m3 = max(m3, r2f2::finite_mag_bits(x0));
      m1 = max(m1, r2f2::finite_mag_bits(x1));
    }
    grid_arrive(m1, m3, a.words, red, a.count);
    // while barrier 1 completes: Uy and Gy on rows g_lo..g_hi
    const int gw = ny - 1;
    for (int q = tid; q < (g_hi - g_lo + 1) * gw; q += T) {
      const int l = q / gw, j = q - l * gw;
      const int at = (g_lo - r0 + l) * ny + j;
      const float h = u[at], hu = u[up + at], hv = u[2 * up + at];
      const float hr = u[at + 1], hur = u[up + at + 1], hvr = u[2 * up + at + 1];
      const float y0 = half_step(hr, h, hvr, hv, a.cy2);
      const float y1 = half_step(hur, hu, gf[at + 1], gf[at], a.cy2);
      const float y2 = half_step(hvr, hv, gf[up + at + 1], gf[up + at], a.cy2);
      gy[at] = y2;
      gy[up + at] = cross(y1, y2, y0);
      gy[2 * up + at] = mom32(y2, y0, a.c);
    }
    const int2 w1 = grid_wait(a.words, seen, a.count, ++passed * C);

    // B: the policy products and Fx's f32 components on the own Ux rows
    const int e1 = w1.x, e3 = w1.y;
    const int k11 = r2f2::site_k(r2f2::select_k_mul(e1, e1, p), fk, 0, p);
    const int k33 = r2f2::site_k(r2f2::select_k_mul(e3, e3, p), fk, 1, p);
    // the products with their formats built once, in the variant (kind) the
    // two splits share: family_mul bit for bit
    const r2f2::PairMul m11(k11, p, fixed), m33(k33, p, fixed);
    uint32_t mt1 = 0u, mt3 = 0u;
    r2f2::with_kinds(m11, m33, [&](auto kind) {
      constexpr int K = decltype(kind)::value;
      for (int q = tid; q < xr * ny; q += T) {
        const int at = ny + q;
        const float q1 = fx[at], q3 = fx[fp + at];
        const float t1 = m11.template mul<K>(q1, q1), t3 = m33.template mul<K>(q3, q3);
        tt[at] = t1;
        tt[fp + at] = t3;
        fx[2 * fp + at] = cross(q1, fx[2 * fp + at], q3);
        mt1 = max(mt1, r2f2::finite_mag_bits(t1));
        mt3 = max(mt3, r2f2::finite_mag_bits(t3));
      }
    });
    grid_arrive(mt1, mt3, a.words + C, red, a.count);
    if (a.cap.out != nullptr) {  // while barrier 2 completes: q1q1 (q1, q1), q3q3 (q3, q3), div's divisor q3 on the own rows
      const r2f2::Hist h = hist();
      for (int q = tid; q < xr * ny; q += T) {
        const float q1 = fx[ny + q], q3 = fx[fp + ny + q];
        h.add(0, q1, true);
        h.add(1, q1, true);
        h.add(2, q3, true);
        h.add(3, q3, true);
        h.add(7, q3, true);
      }
    }
    // while barrier 2 completes: the same on the halo Fx rows r0-1 and r1,
    // their Ux from the neighbours' slots of the ring
    const int halo_top = r0 > 0 ? 1 : 0, halo_bot = r1 <= nx - 2 ? 1 : 0;
    r2f2::with_kinds(m11, m33, [&](auto kind) {
      constexpr int K = decltype(kind)::value;
      for (int q = tid; q < (halo_top + halo_bot) * ny; q += T) {
        const bool top = halo_top && q < ny;
        const int j = top || !halo_top ? q : q - ny;
        const int i = top ? r0 - 1 : r1;
        const int at = (i - r0 + 1) * ny + j, g = i * ny + j;
        const float h = __ldcg(uxs + g), hu = __ldcg(uxs + nxm + g), hv = __ldcg(uxs + 2 * nxm + g);
        tt[at] = m11.template mul<K>(hu, hu);
        tt[fp + at] = m33.template mul<K>(h, h);
        fx[at] = hu;
        fx[fp + at] = h;
        fx[2 * fp + at] = cross(hu, hv, h);
      }
    });
    const int2 w2 = grid_wait(a.words + C, seen, a.count, ++passed * C);

    // C: Fx's momentum component on the policy, and the adjust unit's tick
    const int et1 = w2.x, et3 = w2.y;
    const int k_gq3 = r2f2::site_k(r2f2::select_k_mul(ec, et3, p), fk, 2, p);
    const int k_div = r2f2::site_k(r2f2::select_k_div(et1, e3, p), fk, 3, p);
    if (tid == 0) {
      const Evidence ev(e1, e3, ec, et1, et3);
      if (lead && a.ev != nullptr) ev.write(a.ev, s);
      if (a.evolve) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int* cfg = a.site_cfg + 3 * j;
          r2f2::adjust_tick(st[j], ev.e[2 * j], ev.e[2 * j + 1], cfg[0], cfg[1], cfg[2], law);
        }
      }
    }
    // family_div and family_mul_add bit for bit, as in B
    const r2f2::ConstMul mg(a.c, k_gq3, p, fixed);
    const r2f2::PairMul md(k_div, p, fixed);
    const int f0 = (f_lo - r0 + 1) * ny;
    r2f2::with_kinds(mg, md, [&](auto kind) {
      constexpr int K = decltype(kind)::value;
      for (int q = tid; q < (f_hi - f_lo + 1) * ny; q += T) {
        const int at = f0 + q;
        fx[fp + at] = mg.template mul_add<K>(tt[fp + at], md.template div<K>(tt[at], fx[fp + at]));
      }
    });
    if (a.cap.out != nullptr) {  // gq3's t3 and div's t1 on the own rows (tt holds them until the next B)
      const r2f2::Hist h = hist();
      for (int q = tid; q < xr * ny; q += T) {
        h.add(5, tt[fp + ny + q], true);
        h.add(6, tt[ny + q], true);
      }
    }
    __syncthreads();

    // D: the update of rows r0..r1; each wall cell takes the interior value it mirrors
    const bool boundary = (s + 1) % a.every == 0;
    const bool rounding = boundary && a.st.round;
    float* snap = boundary ? a.snaps + static_cast<size_t>((s + 1) / a.every - 1) * 3 * n : nullptr;
    float* out = s == a.steps - 1 ? a.u_out : nullptr;
    uint32_t ms = 0u;  // the storage max of the own rows, at a rounding boundary
    for (int q = tid; q < ur * ny; q += T) {
      const int l = q / ny, j = q - l * ny, i = r0 + l;
      const int ci = min(max(i, 1), nx - 2), cj = min(max(j, 1), ny - 2);
      const int at = (ci - r0) * ny + cj;  // U and Gy at (ci, cj); Fx at (ci, cj) is at + ny
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* fc = fx + c * fp;
        const float* gc = gy + c * up;
        float v = lw_update(u[c * up + at], fc[at + ny], fc[at], gc[at], gc[at - 1], a.cx, a.cy);
        if (wall_flips(c, i, j, nx, ny)) v = -v;
        un[c * up + q] = v;
        if (l < own) {
          ms = max(ms, r2f2::finite_mag_bits(v));
          const size_t g = static_cast<size_t>(c) * n + r0 * ny + q;
          if (snap != nullptr && !rounding) snap[g] = v;
          if (out != nullptr && !rounding) out[g] = v;
        }
      }
    }
    if (rounding) round_band(un, ms, ur, snap, out);
    if (boundary && a.evolve && tid == 0) {  // read again only behind the next barrier
      for (int j = 0; j < 4; ++j) floor_k[j] = st[j].k;
    }
    __syncthreads();
    if (boundary && a.cap.out != nullptr) flush_hist((s + 1) / a.every - 1, a.every);
  }
  if (a.cap.out != nullptr && a.steps % a.every != 0) flush_hist(a.steps / a.every, a.steps % a.every);
  if (a.st.round && a.steps % a.every != 0) {  // the remainder's rounding of the final state
    float* u = ub + (a.steps & 1) * 3 * up;
    uint32_t ms = 0u;
    for (int q = tid; q < own * ny; q += T)
      for (int c = 0; c < 3; ++c) ms = max(ms, r2f2::finite_mag_bits(u[c * up + q]));
    round_band(u, ms, own, nullptr, a.u_out);
  }
  if (lead && a.st.k_out != nullptr) a.st.k_out[0] = kst;
  if (a.evolve && lead) store_rows(st, 4, a.trk_k, a.trk_hi, a.trk_lo, a.trk_ov, a.trk_sh);
}

// The kernel for CTAs of up to `threads` threads: the 256-thread instance
// keeps up to 255 registers a thread, the 384-thread one 170, the
// 512-thread one 128.
// The members run in waves of `wave` members (blockIdx.y), each wave one
// cooperative grid of ctas x wave CTAs; wave 0 takes as many as fit.
template <int kMaxThreads>
cudaError_t launch_bands(int ctas, int threads, size_t smem, cudaStream_t stream, SweArgs a, int members, int wave,
                         const AdjustLaw& law, const Policy& p) {
  static size_t smem_allowed[r2f2::kMaxDevices] = {};
  cudaError_t err = r2f2::allow_dynamic_smem(swe2d_band_kernel<kMaxThreads>, smem, smem_allowed);
  int capacity = 0;
  if (err == cudaSuccess) err = r2f2::cooperative_capacity(swe2d_band_kernel<kMaxThreads>, threads, smem, capacity);
  if (err != cudaSuccess) return err;
  const int fit = r2f2::member_wave(members, ctas, capacity);
  if (wave == 0) wave = fit;
  if (fit == 0 || wave > fit) return cudaErrorCooperativeLaunchTooLarge;
  for (int m0 = 0; m0 < members; m0 += wave) {
    a.member0 = m0;
    const dim3 grid(ctas, min(wave, members - m0));
    err = r2f2::launch_cooperative(swe2d_band_kernel<kMaxThreads>, grid, dim3(threads), smem, stream, a, law, p);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int kMaxThreads>
int capacity_of(int threads, size_t smem) {
  static size_t smem_allowed[r2f2::kMaxDevices] = {};
  cudaError_t err = r2f2::allow_dynamic_smem(swe2d_band_kernel<kMaxThreads>, smem, smem_allowed);
  int capacity = 0;
  if (err == cudaSuccess) err = r2f2::cooperative_capacity(swe2d_band_kernel<kMaxThreads>, threads, smem, capacity);
  return err == cudaSuccess ? capacity : -static_cast<int>(err);
}

}  // namespace

// The CTAs of `threads` threads and `smem` bytes of band arrays (0: in device
// memory) that one cooperative grid of the band kernel holds on the current
// device, the histogram of `cap_bins` bins included (kernels/mega.py::swe2d_plan
// plans the members' bands against it); a negative cudaError_t on failure.
extern "C" int r2f2_swe2d_capacity(int threads, int smem, int cap_bins) {
  if (threads < 32 || threads > kSweMaxThreads || threads % 32 != 0 || smem < 0 || cap_bins < 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(smem) + static_cast<size_t>(cap_bins) * 4 * 2 * sizeof(int);
  if (threads <= 256) return capacity_of<256>(threads, total);
  return threads <= 384 ? capacity_of<384>(threads, total) : capacity_of<kSweMaxThreads>(threads, total);
}

// A cooperative grid of `ctas` CTAs of `threads` threads, one band each
// (bands of up to `rows` rows; the last band two rows or more), with the
// band arrays in `smem` bytes of shared memory, or in `bands` (device
// memory) when smem is 0; ux, words and count are its scratch. `members`
// ensemble members run in waves of `wave` (0: as many as the card holds at
// once), each member on its own grid of ctas CTAs (blockIdx.y) with its own
// scratch, barrier counter and arrays, every array leading with the member.
extern "C" int r2f2_swe2d_mega(const float* u_in, float* u_out, float* snaps, float* ev, float* ux, float* bands,
                               unsigned int* words, unsigned long long* count, const int* ka, int* trk_k,
                               float* trk_hi, float* trk_lo, int* trk_ov, int* trk_sh, const int* site_cfg,
                               int evolve, int members, int wave, int nx, int ny, int steps, int every, int ctas,
                               int threads, int rows, int smem, float cx2, float cy2, float cx, float cy, float c,
                               float ema, float one_minus, int headroom, int family, int eb, int mb, int fx, int fe,
                               int fm, int tail_approx, int pinned, const void* pay_in, const int* k_in, void* pay_out,
                               int* k_out, int bytes, int round, int* cap_out, int cap_e_lo, int cap_bins, int cap_rows,
                               int cap_cols, void* stream) {
  const r2f2::Capture cap{cap_out, cap_e_lo, cap_bins, cap_rows, cap_cols};
  // storage: rounding and the carried split only; the state comes and goes in f32
  if (pay_in != nullptr || k_in != nullptr || pay_out != nullptr || (bytes != 1 && bytes != 2 && bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (members < 1 || members > 65535 || wave < 0 || nx < 3 || ny < 3 || every < 1 || ux == nullptr ||
      words == nullptr || count == nullptr || ctas < 1 || ctas > nx - 1 || ctas > 32 * kMaxWordsPerLane ||
      rows < (nx + ctas - 1) / ctas || threads < 32 || threads > kSweMaxThreads || threads % 32 != 0 ||
      (smem == 0) != (bands != nullptr) ||
      (smem != 0 && static_cast<size_t>(smem) < band_floats(rows, ny) * sizeof(float)) || !r2f2::capture_ok(cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const SweArgs a{u_in, u_out, snaps, ev, ux, bands, words, count, ka, trk_k, trk_hi, trk_lo, trk_ov, trk_sh,
                  site_cfg, evolve, nx, ny, steps, every, rows, cx2, cy2, cx, cy, c,
                  r2f2::Storage{nullptr, nullptr, nullptr, k_out, bytes, round}, cap, 0};
  const AdjustLaw law{ema, one_minus, headroom, eb, fx};
  const Policy p{family, eb, mb, fx, fe, fm, tail_approx, pinned};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = static_cast<size_t>(smem) + r2f2::hist_bytes(cap, 4);  // the histogram after the bands
  return static_cast<int>(threads <= 256   ? launch_bands<256>(ctas, threads, total, s, a, members, wave, law, p)
                          : threads <= 384 ? launch_bands<384>(ctas, threads, total, s, a, members, wave, law, p)
                                           : launch_bands<kSweMaxThreads>(ctas, threads, total, s, a, members, wave,
                                                                          law, p));
}

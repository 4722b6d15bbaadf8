// The grid shape of the rod kernels (csrc/rod.cuh says what they compute
// and why): a cooperative grid over the block, the field in global memory.
// Each body's launcher is its own translation unit (rod_grid.cu heat1d and
// the C entry point of every rod launch, rod_grid_heat2d.cu,
// rod_grid_periodic.cu advection1d and burgers1d), so that nvcc compiles
// the bodies' template instances side by side.
#pragma once

#include "rod.cuh"

namespace {

// The running position of a thread's cells in its row and, for heat2d, its
// row of the field, advanced by the grid's stride without division.
struct Walk {
  int col, r, dcol, dr, row;

  __device__ Walk(int first, int stride, int row_) : row(row_) {
    col = first % row, r = first / row;
    dcol = stride % row, dr = stride / row;
  }

  __device__ void next() {
    col += dcol, r += dr;
    if (col >= row) col -= row, ++r;
  }
};

// One grid barrier's worth of a heat block's cells for one thread: cells
// first + (batch * G + g) * stride, g < G, with their values (u), laplacians
// (v) and interior bits. A thread holds one batch in registers; where a block
// needs more (batches > 1), each pass walks them, and the laplacians go
// through the block's lap buffer between passes.
template <int B, int G>
struct HeatBatch {
  float u[G], v[G];
  uint32_t live;

  __device__ uint32_t mask(int g) const { return cell_mask(live, g); }

  // u from src and the interior bits of batch `bi`, advancing the walk; with
  // neighbours, v = the laplacian (returned: its max bits), else v from the
  // lap buffer. Every load reads a cell of the block (its index clamped to
  // where every neighbour lies in the block) and the masks drop what is not
  // wanted, so all of them are in flight before the first use.
  __device__ uint32_t load(const float* src, const float* lap, int bi, int first, int stride, int n, Walk& w,
                           bool neighbours) {
    const int row = w.row, rows = n / row;
    float l[G], r[G], up[G], down[G];
    live = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = first + (bi * G + g) * stride;
      int at;
      if constexpr (B == kHeat2D) {
        at = min(max(j, row), n - row - 1);
        live |= static_cast<uint32_t>(j < n && w.r >= 1 && w.r <= rows - 2 && w.col >= 1 && w.col <= row - 2) << g;
      } else {
        at = min(max(j, 1), n - 2);
        live |= static_cast<uint32_t>(j < n && w.col >= 1 && w.col <= row - 2) << g;
      }
      w.next();
      u[g] = __ldcg(src + min(j, n - 1));
      if (neighbours) {
        l[g] = __ldcg(src + at - 1);
        r[g] = __ldcg(src + at + 1);
        if constexpr (B == kHeat2D) {
          up[g] = __ldcg(src + at - row);
          down[g] = __ldcg(src + at + row);
        }
      } else {
        v[g] = __ldcg(lap + at);
      }
    }
    uint32_t mx = 0u;
    if (neighbours) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if constexpr (B == kHeat2D) {
          v[g] = lap5(up[g], down[g], l[g], r[g], u[g]);
        } else {
          v[g] = lap3(l[g], u[g], r[g]);
        }
        mx = max(mx, r2f2::finite_mag_bits(v[g]) & mask(g));
      }
    }
    return mx;
  }
};

// A periodic rod's cells for one thread, as HeatBatch: their values and
// both neighbours' (indices taken mod n), and which are cells of the rod.
template <int G>
struct RodBatch {
  float u[G], l[G], r[G];
  uint32_t live;

  __device__ uint32_t mask(int g) const { return cell_mask(live, g); }

  __device__ void load(const float* src, int bi, int first, int stride, int n, bool neighbours) {
    live = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = min(first + (bi * G + g) * stride, n);  // n: past the rod, read as cell n - 1
      live |= static_cast<uint32_t>(j < n) << g;
      const int at = min(j, n - 1);
      u[g] = __ldcg(src + at);
      if (neighbours) {
        l[g] = __ldcg(src + (at == 0 ? n - 1 : at - 1));
        r[g] = __ldcg(src + (at + 1 == n ? 0 : at + 1));
      }
    }
  }

  __device__ uint32_t max_u() const {
    uint32_t mx = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) mx = max(mx, r2f2::finite_mag_bits(u[g]) & mask(g));
    return mx;
  }
};

// What every grid-shape kernel shares: its block, its cells' stride, the
// ring of maxima, the barrier, the floor and the tracker.
template <int G>
struct Grid {
  int b, first, stride, batches;
  bool lead;
  size_t base;
  uint32_t* ring;  // the block's two maxima of substeps s & 1
  uint32_t* smax;  // the storage maxima, two slots used in turn (storage runs one block)
  int rounds = 0;  // the storage maxima taken
  unsigned long long passed = 0ull;  // the grid barriers behind
  unsigned long long* count;

  __device__ Grid(const RodArgs& a, int ctas) {
    b = blockIdx.x / ctas;
    const int part = blockIdx.x % ctas;
    first = part * kGridThreads + threadIdx.x, stride = ctas * kGridThreads;
    batches = (a.n + G * stride - 1) / (G * stride);
    lead = part == 0 && threadIdx.x == 0;
    base = static_cast<size_t>(b) * a.n;
    ring = a.maxes + static_cast<size_t>(b) * 4;
    smax = a.maxes + static_cast<size_t>(a.blocks) * 4;
    count = a.count;
  }

  // A field max: a warp's max by redux, then one atomic a warp.
  __device__ void publish(uint32_t mx, uint32_t* slot) const {
    mx = __reduce_max_sync(kFull, mx);
    if ((threadIdx.x & 31) == 0) atomicMax(slot, mx);
  }

  __device__ void sync() { r2f2::grid_barrier(count, ++passed * gridDim.x); }

  // The block's storage split from the threads' maxima of their cells'
  // finite magnitudes, behind one grid barrier. The slot used before is
  // zeroed for the next: every read of it was before this barrier.
  __device__ int storage_split(uint32_t mx, const Policy& p) {
    uint32_t* slot = smax + (rounds & 1);
    publish(mx, slot);
    sync();
    const int k = r2f2::storage_k(__ldcg(slot), p.eb, p.fx);
    if (lead) smax[(rounds & 1) ^ 1] = 0u;
    ++rounds;
    return k;
  }

  // A packed input decoded at its split into `stage`, behind one grid barrier.
  __device__ const float* decode_input(const RodArgs& a, float* stage, const Policy& p) {
    const r2f2::Codec in(a.st.k_in[0], p);
    for (int j = first; j < a.n; j += stride) stage[j] = in.decode(r2f2::load_payload(a.st.pay_in, j, a.st.bytes));
    sync();
    return stage;
  }

  // The state's output after the last substep (`res`: its buffer, the input
  // after no substep), with the storage parts: the remainder's rounding
  // (round && rem) or a fused sweep's fresh split (a packed output without
  // rounding), each one grid barrier; then the cells encoded at the split,
  // or rounded, or copied into u_out, and the split out.
  __device__ void finish(const RodArgs& a, const float* res, int kst, const Policy& p) {
    const bool rem = a.st.round && a.every > 0 && a.steps % a.every != 0;
    if (rem || (a.st.pay_out != nullptr && !a.st.round)) {
      uint32_t mx = 0u;
      for (int j = first; j < a.n; j += stride) mx = max(mx, r2f2::finite_mag_bits(__ldcg(res + j)));
      kst = storage_split(mx, p);
    }
    const r2f2::Codec at(kst, p);
    for (int j = first; j < a.n; j += stride) {
      const float v = __ldcg(res + j);
      if (a.st.pay_out != nullptr) {
        r2f2::store_payload(a.st.pay_out, base + j, a.st.bytes, at.pack(v));
      } else if (rem) {
        a.u_out[base + j] = at.round(v);
      } else if (res != a.u_out + base) {
        a.u_out[base + j] = v;
      }
    }
    if (a.st.k_out != nullptr && lead) a.st.k_out[0] = kst;
  }

  // The substep's end: evidence, the tracker's tick and the latch.
  __device__ void end_substep(const RodArgs& a, int s, const int (&e)[4], bool boundary, Tracker& trk, Floor& f,
                              const AdjustLaw& law) const {
    if (a.ev != nullptr && lead) write_evidence(a.ev + (static_cast<size_t>(b) * a.steps + s) * 4, e);
    if (a.evolve) trk.tick(e, law);
    if (boundary && a.evolve) f.k[0] = trk.st[0].k, f.k[1] = trk.st[1].k;
  }
};

// heat1d and heat2d: three passes a substep (lap, flux, update), each behind
// a grid barrier.
template <int B, int G>
__global__ void __launch_bounds__(kGridThreads) heat_grid_kernel(RodArgs args, int ctas, AdjustLaw law, Policy p) {
  const RodArgs a = member_args(args);  // blockIdx.y: the member, of the wave from member0
  extern __shared__ int rod_hist[];
  RodHist<B> hist(a, rod_hist);  // zeroed before Step's CTA barrier
  const Step<B> c(a, p);
  Grid<G> grid(a, ctas);
  const size_t base = grid.base;
  uint32_t* ring = grid.ring;
  float* other = a.work + 2 * base;
  float* lap = other + a.n;
  const int first = grid.first, stride = grid.stride, batches = grid.batches;
  const float* src = a.st.pay_in != nullptr ? grid.decode_input(a, other + 2 * a.n, c.p) : a.u_in + base;
  Tracker trk;
  Floor f = load_floor(a, trk);
  HeatBatch<B, G> cells;
  int e[4];
  int kst = 0;  // the carried storage split
  for (int s = 0, until = a.every, snap = 0; s < a.steps; ++s) {
    float* dst = ((a.steps - 1 - s) & 1) == 0 ? a.u_out + base : other;
    uint32_t* slot = ring + (s & 1) * 2;

    uint32_t mx = 0u;
    {
      Walk w(first, stride, a.row);
      for (int bi = 0; bi < batches; ++bi) {
        mx = max(mx, cells.load(src, lap, bi, first, stride, a.n, w, true));
        if (batches > 1) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (first + (bi * G + g) * stride < a.n) __stcg(lap + first + (bi * G + g) * stride, cells.v[g]);
        }
      }
    }
    grid.publish(mx, slot);
    grid.sync();

    const int e_lap = r2f2::mag_exponent(__ldcg(slot));
    const ConstMul flux_of = c.at0(f.at(r2f2::select_k_mul(c.e0, e_lap, c.p), 0, c.p));
    mx = 0u;
    {
      Walk w(first, stride, a.row);
      for (int bi = 0; bi < batches; ++bi) {
        if (batches > 1) cells.load(src, lap, bi, first, stride, a.n, w, false);
        r2f2::with_kind(flux_of, [&](auto kind) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float flux = flux_of.apply<decltype(kind)::value>(cells.v[g]);
            mx = max(mx, r2f2::finite_mag_bits(flux) & cells.mask(g));
            if (hist.on()) {  // site 0 (alpha, lap), site 1 (flux, dtodx2)
              hist.add(1, cells.v[g], (cells.live >> g) & 1u);
              hist.add(2, flux, (cells.live >> g) & 1u);
            }
          }
        });
        hist.n_const += __popc(cells.live);
      }
    }
    grid.publish(mx, slot + 1);
    grid.sync();

    const int e_flux = r2f2::mag_exponent(__ldcg(slot + 1));
    const ConstMul upd_of = c.at1(f.at(r2f2::select_k_mul(e_flux, c.e1, c.p), 1, c.p));
    const bool boundary = --until == 0;
    const bool rounding = boundary && a.st.round;
    float* snap_at = boundary ? a.snaps + static_cast<size_t>(snap) * a.n : nullptr;
    uint32_t smx = 0u;  // the storage max of the updated cells, at a rounding boundary
    {
      Walk w(first, stride, a.row);
      for (int bi = 0; bi < batches; ++bi) {
        if (batches > 1) cells.load(src, lap, bi, first, stride, a.n, w, false);
        float next[G];
        if (c.fold) {
#pragma unroll
          for (int g = 0; g < G; ++g) next[g] = __fmaf_rn(cells.v[g], c.folded, cells.u[g]);
        } else {
          r2f2::with_kinds(flux_of, upd_of, [&](auto kind) {
            constexpr int J = decltype(kind)::value;
#pragma unroll
            for (int g = 0; g < G; ++g) next[g] = __fadd_rn(cells.u[g], upd_of.apply<J>(flux_of.apply<J>(cells.v[g])));
          });
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int j = first + (bi * G + g) * stride;
          if (j < a.n) {
            const float v = pick(cells.mask(g), next[g], cells.u[g]);
            __stcg(dst + j, v);
            smx = max(smx, r2f2::finite_mag_bits(v));
            if (snap_at != nullptr && !rounding) snap_at[j] = v;
          }
        }
      }
    }
    if (rounding) {  // the boundary's storage rounding, in place, then the snapshot
      kst = grid.storage_split(smx, c.p);
      const r2f2::Codec at(kst, c.p);
      for (int j = first; j < a.n; j += stride) {
        const float v = at.round(__ldcg(dst + j));
        __stcg(dst + j, v);
        snap_at[j] = v;
      }
    }
    e[0] = c.e0, e[1] = e_lap, e[2] = e_flux, e[3] = c.e1;
    grid.end_substep(a, s, e, boundary, trk, f, law);
    if (boundary && hist.on()) hist.flush_at(snap, c);
    if (boundary) until = a.every, ++snap;
    // the next substep's slots, beside the field's stores: every read of them
    // (substep s - 1) is behind the barriers passed, every write (substep
    // s + 1) behind the next
    if (grid.lead) ring[2 - (s & 1) * 2] = 0u, ring[3 - (s & 1) * 2] = 0u;
    grid.sync();  // the next laplacian reads the neighbours written above
    src = dst;
  }
  hist.flush_end(a, c);
  grid.finish(a, src, kst, c.p);
  if (a.evolve && blockIdx.x == 0 && threadIdx.x == 0) trk.store(a);
}

// advection1d and burgers1d (one block): two passes a substep, each behind a
// grid barrier. The max of u that selects a substep's first split is taken
// in the update of the substep before (once from the load), into the ring.
template <int B, int G>
__global__ void __launch_bounds__(kGridThreads) periodic_grid_kernel(RodArgs args, int ctas, AdjustLaw law, Policy p) {
  const RodArgs a = member_args(args);  // blockIdx.y: the member, of the wave from member0
  extern __shared__ int rod_hist[];
  RodHist<B> hist(a, rod_hist);  // zeroed before Step's CTA barrier
  const Step<B> c(a, p);
  Grid<G> grid(a, ctas);
  const int n = a.n, first = grid.first, stride = grid.stride, batches = grid.batches;
  uint32_t* ring = grid.ring;  // substep s & 1: {max |u|, max |df| or max |uu|}
  float* other = a.work;
  const float* src = a.st.pay_in != nullptr ? grid.decode_input(a, a.work + 2 * n, c.p) : a.u_in;
  if (a.steps == 0) {
    grid.finish(a, src, 0, c.p);
    return;
  }
  Tracker trk;
  Floor f = load_floor(a, trk);
  RodBatch<G> cells;
  uint32_t mx = 0u;
  for (int bi = 0; bi < batches; ++bi) {
    cells.load(src, bi, first, stride, n, true);
    mx = max(mx, cells.max_u());
  }
  grid.publish(mx, ring);
  grid.sync();
  int e[4];
  int kst = 0;  // the carried storage split
  for (int s = 0, until = a.every, snap = 0; s < a.steps; ++s) {
    float* dst = ((a.steps - 1 - s) & 1) == 0 ? a.u_out : other;
    uint32_t* slot = ring + (s & 1) * 2;
    uint32_t* next_slot = ring + 2 - (s & 1) * 2;
    // the next substep's slots: every read of them (substep s - 1) is behind
    // the barrier passed, every write (this substep's update, the next
    // substep's first pass) behind the next
    if (grid.lead) next_slot[0] = 0u, next_slot[1] = 0u;
    const int e_u = r2f2::mag_exponent(__ldcg(slot));
    const int k0 = f.at(B == kAdvection1D ? r2f2::select_k_mul(c.e0, e_u, c.p) : r2f2::select_k_mul(e_u, e_u, c.p), 0, c.p);
    const ConstMul flux_of = c.at0(k0);  // advection1d: speed*u
    const PairMul square_of = c.pair_at(k0);  // burgers1d: u*u

    // pass 1: advection1d df and its max; burgers1d uu and its max
    mx = 0u;
    for (int bi = 0; bi < batches; ++bi) {
      if (batches > 1 || s > 0) cells.load(src, bi, first, stride, n, true);
      if constexpr (B == kAdvection1D) {
        r2f2::with_kind(flux_of, [&](auto kind) {
          constexpr int J = decltype(kind)::value;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float df = upwind<J>(flux_of, cells.u[g], flux_of.apply<J>(cells.l[g]));
            mx = max(mx, r2f2::finite_mag_bits(df) & cells.mask(g));
            if (hist.on()) {  // site 0 (speed, u), site 1 (-dtodx, df)
              hist.add(1, cells.u[g], (cells.live >> g) & 1u);
              hist.add(3, df, (cells.live >> g) & 1u);
            }
          }
        });
      } else {
        r2f2::with_kind(square_of, [&](auto kind) {
          constexpr int J = decltype(kind)::value;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float uu = square_of.mul<J>(cells.u[g], cells.u[g]);
            mx = max(mx, r2f2::finite_mag_bits(uu) & cells.mask(g));
            if (hist.on()) {  // site 0 (u, u), site 1 (0.5, uu)
              hist.add(0, cells.u[g], (cells.live >> g) & 1u);
              hist.add(1, cells.u[g], (cells.live >> g) & 1u);
              hist.add(3, uu, (cells.live >> g) & 1u);
            }
          }
        });
      }
      hist.n_const += __popc(cells.live);
    }
    grid.publish(mx, slot + 1);
    grid.sync();

    // pass 2: the update, and the max of the new u
    const int e2 = r2f2::mag_exponent(__ldcg(slot + 1));
    const ConstMul upd_of = c.at1(f.at(r2f2::select_k_mul(c.e1, e2, c.p), 1, c.p));
    const bool boundary = --until == 0;
    const bool rounding = boundary && a.st.round;
    float* snap_at = boundary && !rounding ? a.snaps + static_cast<size_t>(snap) * n : nullptr;
    mx = 0u;
    for (int bi = 0; bi < batches; ++bi) {
      if (batches > 1) cells.load(src, bi, first, stride, n, true);
      float next[G];
      if constexpr (B == kAdvection1D) {
        r2f2::with_kinds(flux_of, upd_of, [&](auto kind) {
          constexpr int J = decltype(kind)::value;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float df = upwind<J>(flux_of, cells.u[g], flux_of.apply<J>(cells.l[g]));
            next[g] = upd_of.mul_add<J>(df, cells.u[g]);
          }
        });
      } else {
        r2f2::with_kinds(square_of, upd_of, [&](auto kind) {
          constexpr int J = decltype(kind)::value;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float fl = upd_of.apply<J>(square_of.mul<J>(cells.l[g], cells.l[g]));
            const float fr = upd_of.apply<J>(square_of.mul<J>(cells.r[g], cells.r[g]));
            next[g] = lax_friedrichs(cells.l[g], cells.r[g], fl, fr, c.c0);
          }
        });
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = first + (bi * G + g) * stride;
        mx = max(mx, r2f2::finite_mag_bits(next[g]) & cells.mask(g));
        if (j < n) {
          __stcg(dst + j, next[g]);
          if (snap_at != nullptr) snap_at[j] = next[g];
        }
      }
    }
    if (rounding) {
      // the boundary's storage rounding: the max of u just taken is the
      // storage max (every cell, finite); the rounded cells' max selects the
      // next substep's first split
      kst = grid.storage_split(mx, c.p);
      const r2f2::Codec at(kst, c.p);
      float* snap_to = a.snaps + static_cast<size_t>(snap) * n;
      mx = 0u;
      for (int j = first; j < n; j += stride) {
        const float v = at.round(__ldcg(dst + j));
        __stcg(dst + j, v);
        snap_to[j] = v;
        mx = max(mx, r2f2::finite_mag_bits(v));
      }
    }
    grid.publish(mx, next_slot);
    if constexpr (B == kAdvection1D) {
      e[0] = c.e0, e[1] = e_u, e[2] = c.e1, e[3] = e2;
    } else {
      e[0] = e_u, e[1] = e_u, e[2] = c.e1, e[3] = e2;
    }
    grid.end_substep(a, s, e, boundary, trk, f, law);
    if (boundary && hist.on()) hist.flush_at(snap, c);
    if (boundary) until = a.every, ++snap;
    grid.sync();  // the next substep reads the neighbours written above
    src = dst;
  }
  hist.flush_end(a, c);
  grid.finish(a, src, kst, c.p);
  if (a.evolve && blockIdx.x == 0 && threadIdx.x == 0) trk.store(a);
}

// The grid shape: `ctas` CTAs a block, as many blocks a cooperative launch as
// the card holds at once (a grid barrier needs every CTA resident), launched
// in turn.
template <int B, int G>
cudaError_t launch_grid(RodArgs a, int ctas, const AdjustLaw& law, const Policy& p, cudaStream_t stream) {
  const auto kernel = [] {
    if constexpr (kPeriodic<B>) {
      return periodic_grid_kernel<B, G>;
    } else {
      return heat_grid_kernel<B, G>;
    }
  }();
  const size_t smem = r2f2::hist_bytes(a.cap, 2);
  int capacity = 0;
  cudaError_t err = r2f2::cooperative_capacity(kernel, kGridThreads, smem, capacity);
  if (err != cudaSuccess) return err;
  if (ctas < 1 || ctas > capacity) return cudaErrorCooperativeLaunchTooLarge;
  // a member's blocks in groups the card holds at once; members whose blocks
  // fit one group in waves of as many members as fit (blockIdx.y)
  const int group = capacity / ctas, blocks = a.blocks;
  const int wave = blocks <= group ? r2f2::member_wave(a.members, blocks * ctas, capacity) : 1;
  for (int m0 = 0; m0 < a.members; m0 += wave) {
    for (int b0 = 0; b0 < blocks; b0 += group) {
      RodArgs g = a;
      const size_t at = static_cast<size_t>(b0) * a.n;
      g.member0 = m0;
      g.blocks = min(group, blocks - b0);
      g.u_in = a.u_in + at;
      g.u_out = a.u_out + at;
      g.work = a.work + 2 * at;
      g.maxes = a.maxes + static_cast<size_t>(b0) * 4;
      g.count = a.count + b0;
      if (a.ev != nullptr) g.ev = a.ev + static_cast<size_t>(b0) * a.steps * 4;
      const dim3 grid(g.blocks * ctas, min(wave, a.members - m0));
      err = r2f2::launch_cooperative(kernel, grid, dim3(kGridThreads), smem, stream, g, ctas, law, p);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

template <int B>
cudaError_t launch_grid_shape(const RodArgs& a, int cells, int ctas, const AdjustLaw& law, const Policy& p,
                              cudaStream_t s) {
  return with_cells(cells, [&](auto g) {
    constexpr int G = decltype(g)::value;
    if constexpr (kPeriodic<B> && G > kPeriodicGridCells) {
      return cudaErrorInvalidValue;
    } else {
      return launch_grid<B, G>(a, ctas, law, p, s);
    }
  });
}

}  // namespace

// The grid shape's launcher of body B, as rod::NAME (rod.cuh).
#define ROD_GRID_LAUNCHER(NAME, B)                                                                             \
  cudaError_t rod::NAME(const RodArgs& a, int cells, int ctas, const AdjustLaw& law, const Policy& p,          \
                        cudaStream_t s) {                                                                      \
    return launch_grid_shape<B>(a, cells, ctas, law, p, s);                                                    \
  }

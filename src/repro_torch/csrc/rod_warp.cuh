// The warp shape of the rod kernels (csrc/rod.cuh says what they compute
// and why): one CTA of up to eight warps a block, the cells in registers.
// Each body's launcher is its own translation unit (rod_warp.cu heat1d,
// rod_warp_advection.cu, rod_warp_burgers.cu), so that nvcc compiles the
// bodies' template instances side by side.
#pragma once

#include "rod.cuh"

namespace {

// A pass's products at the split the last substep ran it at. The split rarely
// moves from one substep to the next, so a substep starts its products at
// that split while its field max is still being reduced, and redoes them
// only where the max gives another split: the same bits, with the products
// and the table read off the chain (without it a substep of the main path's
// heat1d rod took 1.7x as long on an H100, PERF.md section 6).
// `fast`: the product is of the kernel's kind K (its kind()), so the
// straight-line code of kind K gives its bits.
template <int K, typename Mul>
struct Guess {
  int k;
  Mul mul;
  bool fast;

  __device__ Guess(int k_, const Mul& m) : k(k_), mul(m), fast(m.kind() == K) {}
};

// What the warps of one block share: each warp's words of the substep's
// maxima, its edge cells (its first lane's first cell and its last lane's
// last cell) for the neighbour warps, and for a periodic rod the max of u
// and the wrap (u[n - 1], the left neighbour of cell 0, and u[0], the right
// neighbour of cell n - 1). Each slot is written again only after the CTA
// barrier that follows every read of it.
struct Warps {
  uint32_t max0[kMaxWarps], max1[kMaxWarps], umax[kMaxWarps], smax[kMaxWarps];
  float edge[kMaxWarps][2];
  float wrap[2];
};

__shared__ Warps warps;

// One block's cells on the W warps of a CTA: lane l of warp w holds cells
// [(32w + l) * G, (32w + l) * G + G) of the flattened block (zeros past its
// end), and bit g of `live` says whether such a cell is updated: an interior
// cell of its row (heat1d) or a cell of the rod (periodic; a pad cell stays
// 0, so it adds nothing to a max). K is the kind of the products the launch's
// table holds (0 is the f32 family), so the cells' loops have no branch; a
// split whose product is of another kind takes the generic one (kind 3) in
// that pass.
template <int B, int G, int K>
struct Rod {
  float u[G];
  uint32_t live, last;  // last: the bit of cell n - 1 (a periodic rod), in the lane that holds it
  int c0, n, lane, warp, w_count;
  Guess<K, ConstMul> g0, g1;
  Guess<K, PairMul> gp;

  // The cells of block b: from f32 input, or decoded from a packed input at
  // its split.
  __device__ Rod(const RodArgs& a, int b, const Step<B>& c)
      : c0(static_cast<int>(threadIdx.x) * G), n(a.n), lane(threadIdx.x & 31), warp(threadIdx.x >> 5),
        w_count(blockDim.x >> 5), g0(0, c.at0(0)), g1(0, c.at1(0)), gp(0, c.pair_at(0)) {
    const int row = a.row;
    const size_t base = static_cast<size_t>(b) * n;
    const bool packed = a.st.pay_in != nullptr;
    const r2f2::Codec in = packed ? r2f2::Codec(a.st.k_in[b], c.p) : r2f2::Codec();
    int col = c0 % row;
    live = last = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = c0 + g;
      if (j >= n) {
        u[g] = 0.0f;
      } else {
        u[g] = packed ? in.decode(r2f2::load_payload(a.st.pay_in, base + j, a.st.bytes)) : a.u_in[base + j];
      }
      if constexpr (kPeriodic<B>) {
        live |= static_cast<uint32_t>(j < n) << g;
        last |= static_cast<uint32_t>(j == n - 1) << g;
      } else {
        if (j < n && col >= 1 && col <= row - 2) live |= 1u << g;
        if (++col == row) col = 0;
      }
    }
    publish();
  }

  // The warp's edge cells for its neighbours (a periodic rod: also the wrap
  // and the max of u), behind a CTA barrier.
  __device__ void publish() {
    if (lane == 0) warps.edge[warp][0] = u[0];
    if (lane == 31) warps.edge[warp][1] = u[G - 1];
    if constexpr (kPeriodic<B>) {
      uint32_t mx = 0u;
      float tail = 0.0f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        mx = max(mx, r2f2::finite_mag_bits(u[g]));
        tail = pick(cell_mask(last, g), u[g], tail);
      }
      if (c0 == 0) warps.wrap[1] = u[0];
      if (last != 0u) warps.wrap[0] = tail;
      mx = __reduce_max_sync(kFull, mx);
      if (lane == 0) warps.umax[warp] = mx;
    }
    __syncthreads();
  }

  // The field max of the words the warps wrote to `slots` (after the CTA
  // barrier that follows the writes), in every lane.
  __device__ uint32_t gather(const uint32_t* slots) const {
    return __reduce_max_sync(kFull, lane < w_count ? slots[lane] : 0u);
  }

  // The block max of the lanes' magnitude bits `mx`, in every lane.
  __device__ uint32_t block_max(uint32_t mx, uint32_t* slots) const {
    mx = __reduce_max_sync(kFull, mx);
    if (lane == 0) slots[warp] = mx;
    __syncthreads();
    return gather(slots);
  }

  // The neighbours of the lane's first and last cells; a periodic rod's cell
  // 0 takes cell n - 1 as its left (cell n - 1's right, the wrap, is picked
  // per cell by the body).
  __device__ void neighbours(float& left, float& right) const {
    left = __shfl_up_sync(kFull, u[G - 1], 1);
    right = __shfl_down_sync(kFull, u[0], 1);
    if (lane == 0 && warp > 0) left = warps.edge[warp - 1][1];
    if (lane == 31 && warp + 1 < w_count) right = warps.edge[warp + 1][0];
    if constexpr (kPeriodic<B>) {
      if (c0 == 0) left = warps.wrap[0];
    }
  }

  __device__ void store(float* dst) const {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (c0 + g < n) dst[c0 + g] = u[g];
  }

  // The cells encoded at one split into payload elements from `base`.
  __device__ void store_packed(const r2f2::Storage& st, size_t base, const r2f2::Codec& out) const {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (c0 + g < n) r2f2::store_payload(st.pay_out, base + c0 + g, st.bytes, out.pack(u[g]));
  }

  // The block's storage split: from the finite max over every cell (cells
  // past n hold 0), in every lane.
  __device__ int storage_split(const Policy& p) const {
    uint32_t mx = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) mx = max(mx, r2f2::finite_mag_bits(u[g]));
    return r2f2::storage_k(block_max(mx, warps.smax), p.eb, p.fx);
  }

  // The storage rounding of the block at its split (returned), with the
  // edges, the wrap and the max of u published again for the next substep.
  __device__ int round_all(const Policy& p) {
    const int k = storage_split(p);
    const r2f2::Codec at(k, p);
#pragma unroll
    for (int g = 0; g < G; ++g) u[g] = at.round(u[g]);
    publish();
    return k;
  }

  // w = m(x) over the cells as a product of kind J; returns the max of |w|
  // over the live cells.
  template <int J>
  __device__ uint32_t products(const ConstMul& m, const float (&x)[G], float (&w)[G]) const {
    uint32_t mx = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      w[g] = m.apply<J>(x[g]);
      mx = max(mx, r2f2::finite_mag_bits(w[g]) & cell_mask(live, g));
    }
    return mx;
  }

  template <int J>
  __device__ void updates(const ConstMul& m, const float (&w)[G], float (&next)[G]) const {
#pragma unroll
    for (int g = 0; g < G; ++g) next[g] = __fadd_rn(u[g], m.apply<J>(w[g]));
  }

  // One substep; every lane returns the same evidence.
  __device__ void substep(const Step<B>& c, const Floor& f, int (&e)[4], RodHist<B>& h) {
    if constexpr (B == kHeat1D) {
      heat(c, f, e, h);
    } else if constexpr (B == kAdvection1D) {
      advection(c, f, e, h);
    } else {
      burgers(c, f, e, h);
    }
  }

  // Capture: x of the lane's live cells into row `row`.
  __device__ void bin(const r2f2::Hist& h, int row, const float (&x)[G]) const {
#pragma unroll
    for (int g = 0; g < G; ++g) h.add(row, x[g], (live >> g) & 1u);
  }

  __device__ void heat(const Step<B>& c, const Floor& f, int (&e)[4], RodHist<B>& h) {
    float left, right;
    neighbours(left, right);
    float v[G], w[G], next[G];  // lap, flux, the updated cells
    uint32_t mx = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      v[g] = lap3(g == 0 ? left : u[g - 1], u[g], g == G - 1 ? right : u[g + 1]);
      mx = max(mx, r2f2::finite_mag_bits(v[g]) & cell_mask(live, g));
    }
    const int e_lap = r2f2::mag_exponent(block_max(mx, warps.max0));
    mx = products<K>(g0.mul, v, w);
    const int k_flux = f.at(r2f2::select_k_mul(c.e0, e_lap, c.p), 0, c.p);
    if (k_flux != g0.k || !g0.fast) {
      g0 = Guess<K, ConstMul>(k_flux, c.at0(k_flux));
      mx = g0.fast ? products<K>(g0.mul, v, w) : products<3>(g0.mul, v, w);
    }
    const int e_flux = r2f2::mag_exponent(block_max(mx, warps.max1));
    if (h.on()) {  // site 0 (alpha, lap), site 1 (flux, dtodx2)
      bin(h, 1, v);
      bin(h, 2, w);
      h.n_const += __popc(live);
    }
    if constexpr (K == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) next[g] = __fmaf_rn(v[g], c.folded, u[g]);
    } else {
      updates<K>(g1.mul, w, next);
      const int k_upd = f.at(r2f2::select_k_mul(e_flux, c.e1, c.p), 1, c.p);
      if (k_upd != g1.k || !g1.fast) {
        g1 = Guess<K, ConstMul>(k_upd, c.at1(k_upd));
        if (g1.fast) {
          updates<K>(g1.mul, w, next);
        } else {
          updates<3>(g1.mul, w, next);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) u[g] = pick(cell_mask(live, g), next[g], u[g]);
    publish();
    e[0] = c.e0, e[1] = e_lap, e[2] = e_flux, e[3] = c.e1;
  }

  // df over the cells at the flux product m of kind J (left: cell 0's left
  // neighbour); returns the max of |df|.
  template <int J>
  __device__ uint32_t upwinds(const ConstMul& m, float left, float (&df)[G]) const {
    float f_prev[G];
    f_prev[0] = m.apply<J>(left);
#pragma unroll
    for (int g = 1; g < G; ++g) f_prev[g] = m.apply<J>(u[g - 1]);
    uint32_t mx = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      df[g] = upwind<J>(m, u[g], f_prev[g]);
      mx = max(mx, r2f2::finite_mag_bits(df[g]) & cell_mask(live, g));
    }
    return mx;
  }

  template <int J>
  __device__ void mul_adds(const ConstMul& m, const float (&df)[G], float (&next)[G]) const {
#pragma unroll
    for (int g = 0; g < G; ++g) next[g] = m.mul_add<J>(df[g], u[g]);
  }

  __device__ void advection(const Step<B>& c, const Floor& f, int (&e)[4], RodHist<B>& h) {
    float left, right;
    neighbours(left, right);
    const int e_u = r2f2::mag_exponent(gather(warps.umax));
    float df[G], next[G];
    uint32_t mx = upwinds<K>(g0.mul, left, df);
    const int k_flux = f.at(r2f2::select_k_mul(c.e0, e_u, c.p), 0, c.p);
    if (k_flux != g0.k || !g0.fast) {
      g0 = Guess<K, ConstMul>(k_flux, c.at0(k_flux));
      mx = g0.fast ? upwinds<K>(g0.mul, left, df) : upwinds<3>(g0.mul, left, df);
    }
    const int e_df = r2f2::mag_exponent(block_max(mx, warps.max0));
    mul_adds<K>(g1.mul, df, next);
    const int k_upd = f.at(r2f2::select_k_mul(c.e1, e_df, c.p), 1, c.p);
    if (k_upd != g1.k || !g1.fast) {
      g1 = Guess<K, ConstMul>(k_upd, c.at1(k_upd));
      if (g1.fast) {
        mul_adds<K>(g1.mul, df, next);
      } else {
        mul_adds<3>(g1.mul, df, next);
      }
    }
    if (h.on()) {  // site 0 (speed, u), site 1 (-dtodx, df)
      bin(h, 1, u);
      bin(h, 3, df);
      h.n_const += __popc(live);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) u[g] = pick(cell_mask(live, g), next[g], u[g]);
    publish();
    e[0] = c.e0, e[1] = e_u, e[2] = c.e1, e[3] = e_df;
  }

  // uu = u*u over the cells and the neighbours (x[0], x[G + 1]: the lane's
  // left and right, x[G + 2]: the wrap) at the pair product m of kind J;
  // returns the max of |uu| over the cells.
  template <int J>
  __device__ uint32_t squares(const PairMul& m, const float (&x)[G + 3], float (&uu)[G + 3]) const {
    uint32_t mx = 0u;
#pragma unroll
    for (int g = 0; g < G + 3; ++g) {
      uu[g] = m.mul<J>(x[g], x[g]);
      if (g >= 1 && g <= G) mx = max(mx, r2f2::finite_mag_bits(uu[g]));
    }
    return mx;
  }

  template <int J>
  __device__ void fluxes(const ConstMul& m, const float (&uu)[G + 3], float (&fx)[G + 3]) const {
#pragma unroll
    for (int g = 0; g < G + 3; ++g) fx[g] = m.apply<J>(uu[g]);
  }

  __device__ void burgers(const Step<B>& c, const Floor& f, int (&e)[4], RodHist<B>& h) {
    // x: the lane's left neighbour, its cells, its right neighbour, the wrap
    float x[G + 3], uu[G + 3], fx[G + 3];
    neighbours(x[0], x[G + 1]);
#pragma unroll
    for (int g = 0; g < G; ++g) x[g + 1] = u[g];
    x[G + 2] = warps.wrap[1];
    const int e_u = r2f2::mag_exponent(gather(warps.umax));
    uint32_t mx = squares<K>(gp.mul, x, uu);
    const int k_uu = f.at(r2f2::select_k_mul(e_u, e_u, c.p), 0, c.p);
    if (k_uu != gp.k || !gp.fast) {
      gp = Guess<K, PairMul>(k_uu, c.pair_at(k_uu));
      mx = gp.fast ? squares<K>(gp.mul, x, uu) : squares<3>(gp.mul, x, uu);
    }
    const int e_uu = r2f2::mag_exponent(block_max(mx, warps.max0));
    fluxes<K>(g1.mul, uu, fx);
    const int k_flux = f.at(r2f2::select_k_mul(c.e1, e_uu, c.p), 1, c.p);
    if (k_flux != g1.k || !g1.fast) {
      g1 = Guess<K, ConstMul>(k_flux, c.at1(k_flux));
      if (g1.fast) {
        fluxes<K>(g1.mul, uu, fx);
      } else {
        fluxes<3>(g1.mul, uu, fx);
      }
    }
    if (h.on()) {  // site 0 (u, u), site 1 (0.5, uu)
      bin(h, 0, u);
      bin(h, 1, u);
#pragma unroll
      for (int g = 0; g < G; ++g) h.add(3, uu[g + 1], (live >> g) & 1u);
      h.n_const += __popc(live);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint32_t wraps = cell_mask(last, g);  // cell n - 1: its right is cell 0
      const float ur = pick(wraps, x[G + 2], x[g + 2]), fr = pick(wraps, fx[G + 2], fx[g + 2]);
      u[g] = pick(cell_mask(live, g), lax_friedrichs(x[g], ur, fx[g], fr, c.c0), u[g]);
    }
    publish();
    e[0] = e_u, e[1] = e_u, e[2] = c.e1, e[3] = e_uu;
  }
};

// One CTA of `threads` / 32 warps a block.
template <int B, int G, int K>
__global__ void __launch_bounds__(kMaxWarps * 32) rod_warp_kernel(RodArgs args, AdjustLaw law, Policy p) {
  const RodArgs a = member_args(args);  // blockIdx.y: the member
  extern __shared__ int rod_hist[];
  RodHist<B> hist(a, rod_hist);  // zeroed before Step's CTA barrier
  const Step<B> c(a, p);
  const int b = blockIdx.x;
  const size_t base = static_cast<size_t>(b) * a.n;
  Rod<B, G, K> rod(a, b, c);
  const bool lead = threadIdx.x == 0;
  Tracker trk;
  Floor f = load_floor(a, trk);
  int e[4];
  int kst = 0;  // the carried storage split
  for (int s = 0, until = a.every, snap = 0; s < a.steps; ++s) {
    rod.substep(c, f, e, hist);
    if (a.ev != nullptr && lead) write_evidence(a.ev + (static_cast<size_t>(b) * a.steps + s) * 4, e);
    if (a.evolve) trk.tick(e, law);
    if (--until == 0) {  // a snapshot boundary
      until = a.every;
      if (a.st.round) kst = rod.round_all(c.p);
      if (a.evolve) f.k[0] = trk.st[0].k, f.k[1] = trk.st[1].k;
      if (hist.on()) hist.flush_at(snap, c);
      rod.store(a.snaps + static_cast<size_t>(snap++) * a.n);
    }
  }
  hist.flush_end(a, c);
  if (a.st.round && a.every > 0 && a.steps % a.every != 0) kst = rod.round_all(c.p);  // the remainder's
  if (a.st.pay_out != nullptr) {
    if (!a.st.round) kst = rod.storage_split(c.p);  // a fused sweep picks its split afresh
    rod.store_packed(a.st, base, r2f2::Codec(kst, c.p));
  } else {
    rod.store(a.u_out + base);
  }
  if (a.st.k_out != nullptr && lead) a.st.k_out[b] = kst;
  if (a.evolve && lead) trk.store(a);
}


template <int B, int G, int K>
cudaError_t launch_warp(const RodArgs& a, int threads, const AdjustLaw& law, const Policy& p, cudaStream_t stream) {
  rod_warp_kernel<B, G, K><<<dim3(a.blocks, a.members), threads, r2f2::hist_bytes(a.cap, 2), stream>>>(a, law, p);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_body(const RodArgs& a, int threads, int cells, const AdjustLaw& law, const Policy& p,
                        cudaStream_t s) {
  return with_cells(cells, [&](auto g) {
    constexpr int G = decltype(g)::value;
    if constexpr (G > 8) {
      return cudaErrorInvalidValue;
    } else {
      switch (r2f2::table_kind(p)) {
        case 0: return launch_warp<B, G, 0>(a, threads, law, p, s);
        case 1: return launch_warp<B, G, 1>(a, threads, law, p, s);
        default: return launch_warp<B, G, 2>(a, threads, law, p, s);
      }
    }
  });
}

}  // namespace

// The warp shape's launcher of body B, as rod::NAME (rod.cuh).
#define ROD_WARP_LAUNCHER(NAME, B)                                                                              \
  cudaError_t rod::NAME(const RodArgs& a, int threads, int cells, const AdjustLaw& law, const Policy& p,        \
                        cudaStream_t s) {                                                                      \
    if (threads % 32 != 0 || threads < 32 || threads > 32 * kMaxWarps || a.n > threads * cells || cells > 8) \
      return cudaErrorInvalidValue;                                                                            \
    return launch_body<B>(a, threads, cells, law, p, s);                                                       \
  }

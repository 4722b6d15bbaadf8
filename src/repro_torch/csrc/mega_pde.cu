// The megakernel plane of repro_torch for swe2d (kernel K4), for sm_90a: a
// whole simulation horizon in one launch, with the adjust unit on the card.
//
//   swe2d_grid_kernel   replaces repro/kernels/mega.py::mega_sweep with swe2d_mega
//
// (heat1d's K4 is the rod, rod.cuh.) It follows mega_sweep's contract for f32 storage
// without capture: the body runs on the whole field as one split block; with
// an evolving tracker each site's row ticks every substep (r2f2::adjust_tick)
// while the datapath floor `ka` latches to the row's split only at snapshot
// boundaries; the state is snapshot at every boundary and the remainder
// substeps run after the last one. The C entry point returns the launch's
// cudaError_t.
//
// swe2d: the (3, nx, ny) state and the Lax-Wendroff intermediates do not fit
// one SM's shared memory (3x128x128 f32 alone is 196,608 B), so they live in
// global memory, which the 50 MB L2 holds. A cooperative grid of CTAs
// (kernels/mega.py::swe2d_plan) walks each substep in four phases, each a
// grid-stride loop behind an r2f2::grid_barrier:
//   A  Ux, Uy from U (the f32 fluxes F, G at each point), and the field-wide
//      maxima of |Ux.hu|, |Ux.h|;
//   B  t1 = hu*hu and t3 = h*h on the policy at k11/k33 and their maxima; Gy;
//   C  Fx through the policy's quotient and mul_add at k_div/k_gq3; CTA 0
//      ticks the four sites;
//   D  the interior update as two fmas into the other state buffer, the walls
//      as the interior value they mirror, the snapshot and the latch.
// It is bound by the latency of four grid barriers a substep, not by bytes or
// operations (the main path's 128x128 state is 196 KB and ~2.5 MFLOP a
// substep). The maxima are integer maxima of magnitude bit patterns, so an
// atomicMax into a ring of two substeps gives the same answer in every order.
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::AdjustLaw;
using r2f2::Policy;
using r2f2::SiteState;

namespace {

constexpr int kSweThreads = 256;  // threads of a CTA

struct SweArgs {
  const float* u_in;
  float* u_out;
  float* snaps;
  float* ev;        // (steps, 4, 2) or null
  float* work;      // 17 * nx * ny floats of intermediates
  uint32_t* maxes;  // (2, 4) zeroed: |Ux.hu|, |Ux.h|, |t1|, |t3| of a ring of two substeps
  unsigned long long* count;  // the launch's barrier counter, zeroed
  int* ka;          // the datapath floor (4), null when untracked
  int* trk_k;
  float* trk_hi;
  float* trk_lo;
  int* trk_ov;
  int* trk_sh;
  const int* site_cfg;
  int evolve;
  int nx, ny, steps, every;
  float cx2, cy2, cx, cy, c;  // dt/(2dx), dt/(2dy), dt/dx, dt/dy, g/2, each rounded once to f32
};

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

__device__ __forceinline__ uint32_t warp_max(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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

// The site's split: the selection floored at the latched split (read through
// L2: the lead thread latches it behind a grid barrier), or that split when pinned.
__device__ __forceinline__ int grid_site_k(int k_select, const int* ka, int site, const Policy& p) {
  if (ka == nullptr) return k_select;
  const int f = __ldcg(ka + site);
  return p.pinned ? f : max(k_select, f);
}

__global__ void __launch_bounds__(kSweThreads) swe2d_grid_kernel(SweArgs a, AdjustLaw law, Policy p) {
  const int nx = a.nx, ny = a.ny, n = nx * ny;
  const int nxm = (nx - 1) * ny, nym = nx * (ny - 1);
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  float* tmp = a.work;         // the other state buffer, 3n
  float* ux = tmp + 3 * n;     // (3, nx-1, ny)
  float* uy = ux + 3 * n;      // (3, nx, ny-1)
  float* t1b = uy + 3 * n;     // (nx-1, ny)
  float* t3b = t1b + n;        // (nx-1, ny)
  float* gy = t3b + n;         // (3, nx, ny-1)
  float* fx = gy + 3 * n;      // (3, nx-1, ny)
  const int ec = r2f2::mag_exponent(r2f2::finite_mag_bits(a.c));
  SiteState st[4];
  if (a.evolve && lead) load_rows(st, 4, a.trk_k, a.trk_hi, a.trk_lo, a.trk_ov, a.trk_sh);

  if (a.steps == 0) {
    for (int q = tid; q < 3 * n; q += stride) a.u_out[q] = a.u_in[q];
    return;
  }
  unsigned long long passed = 0ull;  // the grid barriers behind
  const auto grid_sync = [&] { r2f2::grid_barrier(a.count, ++passed * gridDim.x); };
  const float* src = a.u_in;
  for (int s = 0; s < a.steps; ++s) {
    float* dst = ((a.steps - 1 - s) & 1) == 0 ? a.u_out : tmp;
    uint32_t* mx = a.maxes + (s & 1) * 4;
    // the next substep's slots: every read of them (substep s - 1) is behind
    // the barriers passed, every write (substep s + 1) behind the next
    if (lead) {
      for (int w = 0; w < 4; ++w) a.maxes[4 - (s & 1) * 4 + w] = 0u;
    }

    // A: the half steps
    uint32_t m1 = 0u, m3 = 0u;
    for (int q = tid; q < n; q += stride) {
      const int i = q / ny, j = q % ny;
      const float h = __ldcg(src + q), hu = __ldcg(src + n + q), hv = __ldcg(src + 2 * n + q);
      const float f1 = mom32(hu, h, a.c), f2 = cross(hu, hv, h);
      const float g1 = f2, g2 = mom32(hv, h, a.c);
      if (i < nx - 1) {
        const int d = q + ny;
        const float hd = __ldcg(src + d), hud = __ldcg(src + n + d), hvd = __ldcg(src + 2 * n + d);
        const float x0 = half_step(hd, h, hud, hu, a.cx2);
        const float x1 = half_step(hud, hu, mom32(hud, hd, a.c), f1, a.cx2);
        const float x2 = half_step(hvd, hv, cross(hud, hvd, hd), f2, a.cx2);
        __stcg(ux + q, x0);
        __stcg(ux + nxm + q, x1);
        __stcg(ux + 2 * nxm + q, x2);
        m3 = max(m3, r2f2::finite_mag_bits(x0));
        m1 = max(m1, r2f2::finite_mag_bits(x1));
      }
      if (j < ny - 1) {
        const int r = q + 1, o = i * (ny - 1) + j;
        const float hr = __ldcg(src + r), hur = __ldcg(src + n + r), hvr = __ldcg(src + 2 * n + r);
        __stcg(uy + o, half_step(hr, h, hvr, hv, a.cy2));
        __stcg(uy + nym + o, half_step(hur, hu, cross(hur, hvr, hr), g1, a.cy2));
        __stcg(uy + 2 * nym + o, half_step(hvr, hv, mom32(hvr, hr, a.c), g2, a.cy2));
      }
    }
    m1 = warp_max(m1);
    m3 = warp_max(m3);
    if ((threadIdx.x & 31) == 0) {
      atomicMax(mx + 0, m1);
      atomicMax(mx + 1, m3);
    }
    grid_sync();

    // B: the policy products and Gy
    const int e1 = r2f2::mag_exponent(__ldcg(mx + 0));
    const int e3 = r2f2::mag_exponent(__ldcg(mx + 1));
    const int k11 = grid_site_k(r2f2::select_k_mul(e1, e1, p), a.ka, 0, p);
    const int k33 = grid_site_k(r2f2::select_k_mul(e3, e3, p), a.ka, 1, p);
    uint32_t mt1 = 0u, mt3 = 0u;
    for (int q = tid; q < n; q += stride) {
      if (q < nxm) {
        const float q1 = __ldcg(ux + nxm + q), q3 = __ldcg(ux + q);
        const float t1 = r2f2::family_mul(q1, q1, k11, p), t3 = r2f2::family_mul(q3, q3, k33, p);
        __stcg(t1b + q, t1);
        __stcg(t3b + q, t3);
        mt1 = max(mt1, r2f2::finite_mag_bits(t1));
        mt3 = max(mt3, r2f2::finite_mag_bits(t3));
      }
      if (q < nym) {
        const float h = __ldcg(uy + q), hu = __ldcg(uy + nym + q), hv = __ldcg(uy + 2 * nym + q);
        __stcg(gy + q, hv);
        __stcg(gy + nym + q, cross(hu, hv, h));
        __stcg(gy + 2 * nym + q, mom32(hv, h, a.c));
      }
    }
    mt1 = warp_max(mt1);
    mt3 = warp_max(mt3);
    if ((threadIdx.x & 31) == 0) {
      atomicMax(mx + 2, mt1);
      atomicMax(mx + 3, mt3);
    }
    grid_sync();

    // C: Fx on the policy, and the adjust unit's tick
    const int et1 = r2f2::mag_exponent(__ldcg(mx + 2));
    const int et3 = r2f2::mag_exponent(__ldcg(mx + 3));
    const int k_gq3 = grid_site_k(r2f2::select_k_mul(ec, et3, p), a.ka, 2, p);
    const int k_div = grid_site_k(r2f2::select_k_div(et1, e3, p), a.ka, 3, p);
    const Evidence ev(e1, e3, ec, et1, et3);
    if (lead) {
      if (a.ev != nullptr) ev.write(a.ev, s);
      if (a.evolve) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int* cfg = a.site_cfg + 3 * j;
          r2f2::adjust_tick(st[j], ev.e[2 * j], ev.e[2 * j + 1], cfg[0], cfg[1], cfg[2], law);
        }
      }
    }
    for (int q = tid; q < nxm; q += stride) {
      const float h = __ldcg(ux + q), hu = __ldcg(ux + nxm + q), hv = __ldcg(ux + 2 * nxm + q);
      const float t2 = r2f2::family_div(__ldcg(t1b + q), h, k_div, p);
      __stcg(fx + q, hu);
      __stcg(fx + nxm + q, r2f2::family_mul_add(a.c, __ldcg(t3b + q), t2, k_gq3, p));
      __stcg(fx + 2 * nxm + q, cross(hu, hv, h));
    }
    grid_sync();

    // D: the update; each wall cell takes the interior value it mirrors
    const bool boundary = (s + 1) % a.every == 0;
    float* snap = boundary ? a.snaps + static_cast<size_t>((s + 1) / a.every - 1) * 3 * n : nullptr;
    for (int q = tid; q < n; q += stride) {
      const int i = q / ny, j = q % ny;
      const int ci = min(max(i, 1), nx - 2), cj = min(max(j, 1), ny - 2);
      const int at = ci * ny + cj, fx_at = ci * ny + cj, gy_at = ci * (ny - 1) + cj;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* fc = fx + c * nxm;
        const float* gc = gy + c * nym;
        float v = lw_update(__ldcg(src + c * n + at), __ldcg(fc + fx_at), __ldcg(fc + fx_at - ny), __ldcg(gc + gy_at),
                            __ldcg(gc + gy_at - 1), a.cx, a.cy);
        if (wall_flips(c, i, j, nx, ny)) v = -v;
        __stcg(dst + c * n + q, v);
        if (snap != nullptr) snap[c * n + q] = v;
      }
    }
    if (boundary && a.evolve && lead) {  // read again only after the next barrier
      for (int j = 0; j < 4; ++j) a.ka[j] = st[j].k;
    }
    grid_sync();
    src = dst;
  }
  if (a.evolve && lead) store_rows(st, 4, a.trk_k, a.trk_hi, a.trk_lo, a.trk_ov, a.trk_sh);
}

}  // namespace

// A cooperative grid of up to `ctas` CTAs (as many as the card holds at once),
// with work, maxes and count as its scratch.
extern "C" int r2f2_swe2d_mega(const float* u_in, float* u_out, float* snaps, float* ev, float* work,
                               unsigned int* maxes, unsigned long long* count, int* ka, int* trk_k, float* trk_hi,
                               float* trk_lo, int* trk_ov, int* trk_sh, const int* site_cfg, int evolve, int nx,
                               int ny, int steps, int every, int ctas, float cx2, float cy2, float cx, float cy,
                               float c, float ema, float one_minus, int headroom, int family, int eb, int mb, int fx,
                               int fe, int fm, int tail_approx, int pinned, void* stream) {
  if (nx < 3 || ny < 3 || every < 1 || work == nullptr || maxes == nullptr || count == nullptr || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  SweArgs a{u_in, u_out, snaps, ev, work, maxes, count, ka, trk_k, trk_hi, trk_lo, trk_ov, trk_sh, site_cfg, evolve,
            nx, ny, steps, every, cx2, cy2, cx, cy, c};
  const AdjustLaw law{ema, one_minus, headroom, eb, fx};
  const Policy p{family, eb, mb, fx, fe, fm, tail_approx, pinned};
  int capacity = 0;
  const cudaError_t err = r2f2::cooperative_capacity(swe2d_grid_kernel, kSweThreads, 0, capacity);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (capacity < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return static_cast<int>(r2f2::launch_cooperative(swe2d_grid_kernel, dim3(min(ctas, capacity)), dim3(kSweThreads), 0,
                                                   static_cast<cudaStream_t>(stream), a, law, p));
}

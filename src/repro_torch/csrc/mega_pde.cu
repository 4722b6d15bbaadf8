// The megakernel plane of repro_torch (kernel K4), for sm_90a: a whole
// simulation horizon in one launch, with the adjust unit on the card.
//
//   swe2d_mega_kernel   replaces repro/kernels/mega.py::mega_sweep with swe2d_mega
//
// (heat1d's K4 is heat1d_rod.cu.) It follows mega_sweep's contract for f32
// storage without capture: the body runs on the whole field as one split
// block; with an evolving tracker each site's row ticks every substep
// (r2f2::adjust_tick) while the datapath floor `ka` latches to the row's split
// only at snapshot boundaries; the state is snapshot at every boundary and
// the remainder substeps run after the last one. The C entry point returns
// the launch's cudaError_t.
//
// swe2d: the (3, nx, ny) state and the Lax-Wendroff intermediates do not fit
// one SM's shared memory (3x128x128 f32 alone is 196,608 B), so they live in
// global memory, which the 50 MB L2 holds. A cooperative grid of CTAs walks
// each substep in four phases separated by grid-wide barriers:
//   A  Ux, Uy from U (the f32 fluxes F, G recomputed at each point), and the
//      grid-wide maxima of |Ux.hu|, |Ux.h|;
//   B  t1 = hu*hu and t3 = h*h on the policy at k11/k33 and their maxima; Gy;
//   C  Fx through family_div/family_mul_add at k_div/k_gq3; CTA 0 ticks the
//      four sites;
//   D  the interior update as two fmas into the other state buffer, the walls
//      as the interior value they mirror, the snapshot and the latch.
// The maxima are integer maxima of magnitude bit patterns, so an atomicMax
// into a per-substep slot gives the same answer in every order; the host
// zeroes the slots, so the kernel resets nothing. It is bound by the latency
// of four grid barriers per substep, not by bytes or operations.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

namespace cg = cooperative_groups;
using r2f2::AdjustLaw;
using r2f2::Policy;
using r2f2::SiteState;

namespace {

constexpr int kSweThreads = 256;

Policy make_policy(int family, int eb, int mb, int fx, int fe, int fm, int tail_approx, int pinned) {
  return Policy{family, eb, mb, fx, fe, fm, tail_approx, pinned};
}

// site_cfg rows are (op, k_lo, k_hi); trk_* hold the n_sites carried rows.
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

// ---------------------------------------------------------------------------
// swe2d

struct SweArgs {
  const float* u_in;
  float* u_out;
  float* snaps;
  float* ev;        // (steps, 4, 2) or null
  float* work;      // 17 * nx * ny floats of intermediates
  uint32_t* maxes;  // (steps, 4) zeroed: |Ux.hu|, |Ux.h|, |t1|, |t3|
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

__device__ __forceinline__ uint32_t warp_max(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kSweThreads) swe2d_mega_kernel(SweArgs a, AdjustLaw law, Policy p) {
  cg::grid_group grid = cg::this_grid();
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
  const float* src = a.u_in;
  for (int s = 0; s < a.steps; ++s) {
    float* dst = ((a.steps - 1 - s) & 1) == 0 ? a.u_out : tmp;
    uint32_t* mx = a.maxes + static_cast<size_t>(s) * 4;

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
        ux[q] = x0;
        ux[nxm + q] = x1;
        ux[2 * nxm + q] = x2;
        m3 = max(m3, r2f2::finite_mag_bits(x0));
        m1 = max(m1, r2f2::finite_mag_bits(x1));
      }
      if (j < ny - 1) {
        const int r = q + 1, o = i * (ny - 1) + j;
        const float hr = __ldcg(src + r), hur = __ldcg(src + n + r), hvr = __ldcg(src + 2 * n + r);
        uy[o] = half_step(hr, h, hvr, hv, a.cy2);
        uy[nym + o] = half_step(hur, hu, cross(hur, hvr, hr), g1, a.cy2);
        uy[2 * nym + o] = half_step(hvr, hv, mom32(hvr, hr, a.c), g2, a.cy2);
      }
    }
    m1 = warp_max(m1);
    m3 = warp_max(m3);
    if ((threadIdx.x & 31) == 0) {
      atomicMax(mx + 0, m1);
      atomicMax(mx + 1, m3);
    }
    grid.sync();

    // B: the policy products and Gy
    const int e1 = r2f2::mag_exponent(__ldcg(mx + 0));
    const int e3 = r2f2::mag_exponent(__ldcg(mx + 1));
    const int k11 = r2f2::site_k(r2f2::select_k_mul(e1, e1, p), a.ka, 0, p);
    const int k33 = r2f2::site_k(r2f2::select_k_mul(e3, e3, p), a.ka, 1, p);
    uint32_t mt1 = 0u, mt3 = 0u;
    for (int q = tid; q < n; q += stride) {
      if (q < nxm) {
        const float q1 = __ldcg(ux + nxm + q), q3 = __ldcg(ux + q);
        const float t1 = r2f2::family_mul(q1, q1, k11, p), t3 = r2f2::family_mul(q3, q3, k33, p);
        t1b[q] = t1;
        t3b[q] = t3;
        mt1 = max(mt1, r2f2::finite_mag_bits(t1));
        mt3 = max(mt3, r2f2::finite_mag_bits(t3));
      }
      if (q < nym) {
        const float h = __ldcg(uy + q), hu = __ldcg(uy + nym + q), hv = __ldcg(uy + 2 * nym + q);
        gy[q] = hv;
        gy[nym + q] = cross(hu, hv, h);
        gy[2 * nym + q] = mom32(hv, h, a.c);
      }
    }
    mt1 = warp_max(mt1);
    mt3 = warp_max(mt3);
    if ((threadIdx.x & 31) == 0) {
      atomicMax(mx + 2, mt1);
      atomicMax(mx + 3, mt3);
    }
    grid.sync();

    // C: Fx on the policy, and the adjust unit's tick
    const int et1 = r2f2::mag_exponent(__ldcg(mx + 2));
    const int et3 = r2f2::mag_exponent(__ldcg(mx + 3));
    const int k_gq3 = r2f2::site_k(r2f2::select_k_mul(ec, et3, p), a.ka, 2, p);
    const int k_div = r2f2::site_k(r2f2::select_k_div(et1, e3, p), a.ka, 3, p);
    if (lead) {
      const float ev[8] = {static_cast<float>(e1), static_cast<float>(e1), static_cast<float>(e3),
                           static_cast<float>(e3), static_cast<float>(ec), static_cast<float>(et3),
                           static_cast<float>(et1), static_cast<float>(e3)};
      if (a.ev != nullptr) {
        for (int w = 0; w < 8; ++w) a.ev[static_cast<size_t>(s) * 8 + w] = ev[w];
      }
      if (a.evolve) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int* cfg = a.site_cfg + 3 * j;
          r2f2::adjust_tick(st[j], ev[2 * j], ev[2 * j + 1], cfg[0], cfg[1], cfg[2], law);
        }
      }
    }
    for (int q = tid; q < nxm; q += stride) {
      const float h = __ldcg(ux + q), hu = __ldcg(ux + nxm + q), hv = __ldcg(ux + 2 * nxm + q);
      const float t2 = r2f2::family_div(__ldcg(t1b + q), h, k_div, p);
      fx[q] = hu;
      fx[nxm + q] = r2f2::family_mul_add(a.c, __ldcg(t3b + q), t2, k_gq3, p);
      fx[2 * nxm + q] = cross(hu, hv, h);
    }
    grid.sync();

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
        float v = __fmaf_rn(-a.cx, __fsub_rn(__ldcg(fc + fx_at), __ldcg(fc + fx_at - ny)), __ldcg(src + c * n + at));
        v = __fmaf_rn(-a.cy, __fsub_rn(__ldcg(gc + gy_at), __ldcg(gc + gy_at - 1)), v);
        // walls: h mirrors; hu flips at the x walls (rows), hv at the y walls (columns)
        if ((c == 1 && (i == 0 || i == nx - 1)) || (c == 2 && (j == 0 || j == ny - 1))) v = -v;
        dst[c * n + q] = v;
        if (snap != nullptr) snap[c * n + q] = v;
      }
    }
    if (boundary && a.evolve && lead) {  // read again only after the next barrier
      for (int j = 0; j < 4; ++j) a.ka[j] = st[j].k;
    }
    grid.sync();
    src = dst;
  }
  if (a.evolve && lead) store_rows(st, 4, a.trk_k, a.trk_hi, a.trk_lo, a.trk_ov, a.trk_sh);
}

}  // namespace

// The cooperative grid: at most one CTA per 256 positions, and no more than
// can be resident at once (a grid barrier needs every CTA on the card).
extern "C" int r2f2_swe2d_mega(const float* u_in, float* u_out, float* snaps, float* ev, float* work,
                               unsigned int* maxes, int* ka, int* trk_k, float* trk_hi, float* trk_lo, int* trk_ov,
                               int* trk_sh, const int* site_cfg, int evolve, int nx, int ny, int steps, int every,
                               float cx2, float cy2, float cx, float cy, float c, float ema, float one_minus,
                               int headroom, int family, int eb, int mb, int fx, int fe, int fm, int tail_approx,
                               int pinned, void* stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, swe2d_mega_kernel, kSweThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int want = (nx * ny + kSweThreads - 1) / kSweThreads;
  const int blocks = want < per_sm * sms ? want : per_sm * sms;
  SweArgs a{u_in, u_out, snaps, ev, work, maxes, ka, trk_k, trk_hi, trk_lo, trk_ov, trk_sh, site_cfg, evolve,
            nx, ny, steps, every, cx2, cy2, cx, cy, c};
  AdjustLaw law{ema, one_minus, headroom, eb, fx};
  Policy p = make_policy(family, eb, mb, fx, fe, fm, tail_approx, pinned);
  void* args[] = {&a, &law, &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(swe2d_mega_kernel), dim3(blocks), dim3(kSweThreads),
                                    args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

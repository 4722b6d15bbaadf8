// Kernel K5 of repro_torch, for sm_90a: the fused sweeps and the megakernels
// of the three beyond-paper workloads, as two templates over three device
// bodies.
//
//   fused_sweep_kernel<Heat2D>       K5a  replaces repro/kernels/fused.py::fused_sweep
//   fused_sweep_kernel<Advection1D>  K5b    with repro/kernels/pde_steps.py::_heat2d_body,
//   fused_sweep_kernel<Burgers1D>    K5c    _advection1d_body, _burgers1d_body
//   mega_sweep_kernel<Heat2D>        K5d  replace repro/kernels/mega.py::mega_sweep
//   mega_sweep_kernel<Advection1D>   K5e    with heat2d_mega, advection1d_mega,
//   mega_sweep_kernel<Burgers1D>     K5f    burgers1d_mega
//
// Every body keeps the whole field in one split block, so each kernel is one
// CTA holding the field in shared memory: the 2-D field flattened row-major
// (64x64 f32 is 16 KB a row of buffers), each periodic rod as one row (256
// f32 is 1 KB). A substep is a few passes over the field, each ending in a
// block-wide max of magnitude bits where a policy product needs its split;
// neighbours (the stencil's and the periodic wrap at (i - 1 + n) % n and
// (i + 1) % n) are read from shared memory behind a barrier. A body updates
// the state in place where every thread reads only its own cell in the last
// pass (heat2d, advection1d), or into a second state row (burgers1d, whose
// average reads both neighbours).
//
// The megakernel adds kernel K4's contract (mega_pde.cu): with an evolving
// tracker each site's row ticks every substep (r2f2::adjust_tick) while the
// datapath floor `ka` latches to the row's split only at snapshot boundaries;
// a pinned tracker's row is the fixed split; snapshots at every boundary; the
// remainder substeps after the last boundary in the same launch.
//
// Rounding follows the compiled reference (the plain versions in
// pde/heat2d.py, advection1d.py and burgers1d.py say where): in the f32 family
// heat2d's update is fma(lap, alpha*dtodx2, u) and advection1d's difference is
// fma(speed, u, -f[i-1]); advection1d's update is a family_mul_add; burgers1d
// rounds its update twice. At the main path's sizes a substep moves no bytes
// from device memory and does a few thousand f32 operations: the kernels are
// bound by the latency of the serial substep chain and its block reductions.
// Each C entry point returns the launch's cudaError_t.
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

// heat2d: lap over the interior (nx-2, ny-2), flux = alpha*lap (site 0),
// upd = flux*dtodx2 (site 1), u += upd on the interior, the boundary pinned.
// t holds lap, then flux; in the f32 family t keeps lap, since the update
// there is the folded and fused fma(lap, alpha*dtodx2, u).
struct Heat2D {
  static constexpr int kThreads = 512;
  static constexpr int kRows = 2;  // u, t

  __device__ static float* substep(const Consts& c, float* u, float*, float* t, const int* floor, const Policy& p,
                                   uint32_t* scratch, Evidence& ev) {
    const int ny = c.ny, mi = ny - 2, n_int = (c.nx - 2) * mi;
    const float alpha = c.c0, dtodx2 = c.c1;
    uint32_t mx = 0u;
    for (int i = threadIdx.x; i < n_int; i += blockDim.x) {
      const int at = (i / mi + 1) * ny + i % mi + 1;
      const float s = __fadd_rn(__fadd_rn(__fadd_rn(u[at - ny], u[at + ny]), u[at - 1]), u[at + 1]);
      const float lap = __fsub_rn(s, __fmul_rn(4.0f, u[at]));
      t[at] = lap;
      mx = max(mx, r2f2::finite_mag_bits(lap));
    }
    const int e_alpha = scalar_exp(alpha), e_lap = r2f2::block_max_exp(mx, scratch);
    const int k_flux = r2f2::site_k(r2f2::select_k_mul(e_alpha, e_lap, p), floor, 0, p);
    const bool fold = p.family == r2f2::kF32;
    mx = 0u;
    for (int i = threadIdx.x; i < n_int; i += blockDim.x) {
      const int at = (i / mi + 1) * ny + i % mi + 1;
      const float flux = r2f2::family_mul(alpha, t[at], k_flux, p);
      if (!fold) t[at] = flux;
      mx = max(mx, r2f2::finite_mag_bits(flux));
    }
    const int e_dtodx2 = scalar_exp(dtodx2), e_flux = r2f2::block_max_exp(mx, scratch);
    const int k_upd = r2f2::site_k(r2f2::select_k_mul(e_flux, e_dtodx2, p), floor, 1, p);
    const float folded = __fmul_rn(alpha, dtodx2);
    for (int i = threadIdx.x; i < n_int; i += blockDim.x) {
      const int at = (i / mi + 1) * ny + i % mi + 1;
      u[at] = fold ? __fmaf_rn(t[at], folded, u[at]) : __fadd_rn(u[at], r2f2::family_mul(t[at], dtodx2, k_upd, p));
    }
    ev = Evidence{{e_alpha, e_lap, e_flux, e_dtodx2}};
    return u;
  }
};

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

__device__ __forceinline__ void write_evidence(float* ev, int s, const Evidence& e) {
  float* d = ev + static_cast<size_t>(s) * 4;
  for (int j = 0; j < 4; ++j) d[j] = static_cast<float>(e.e[j]);
}

// K5a-c: `steps` substeps of one body on the (1, nx*ny) field in one CTA;
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

// K5d-f: the whole horizon of one body in one CTA, with the adjust unit.
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

R2F2_K5_ENTRIES(heat2d, Heat2D)
R2F2_K5_ENTRIES(advection1d, Advection1D)
R2F2_K5_ENTRIES(burgers1d, Burgers1D)

// The fused-plane PDE kernels of repro_torch, for sm_90a:
//
//   K2 heat1d_sweep_kernel  replaces repro/kernels/fused.py::fused_sweep with
//                           repro/kernels/heat_stencil.py::_heat1d_body
//   K3 swe_flux_kernel      replaces repro/kernels/fused.py::fused_sweep with
//                           repro/kernels/swe_flux.py::_swe_flux_body
//
// The host driver (kernels/fused.py::fused_sweep) pads the field and fixes the
// split blocks; each kernel gives one split block to one CTA, so every block
// max spans exactly the reference's block, pad lanes included. Evidence is
// written per block as (gi, gj, steps, n_sites, 2) floats and max-reduced
// across blocks on the host. Each C entry point returns cudaGetLastError().
#include <cuda_runtime.h>

#include "r2f2_device.cuh"

using r2f2::Policy;

namespace {

constexpr int kHeatThreads = 128;
constexpr int kSweThreads = 512;

// K2: `steps` explicit-FD substeps of one (br, nx) row block, held in shared
// memory for the whole chunk. Per substep: the interior laplacian and its
// block max; flux = alpha*lap at the block's split (site 0) and its block max;
// upd = flux*dtodx2 (site 1); u += upd on the interior, ends pinned. In the
// f32 family the update is fma(lap, alpha*dtodx2, u), as the compiled
// reference folds the two constant products and fuses the add.
__global__ void __launch_bounds__(kHeatThreads)
heat1d_sweep_kernel(const float* __restrict__ u_in, float* __restrict__ u_out, float* __restrict__ ev,
                    const int* __restrict__ k_floor, int nx, int br, int steps, float alpha, float dtodx2,
                    Policy p) {
  extern __shared__ float smem[];
  __shared__ uint32_t scratch[32];
  float* u = smem;            // the block, br * nx
  float* t = smem + br * nx;  // lap, then flux, then upd, at the same index
  const int n = br * nx;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) u[i] = u_in[base + i];
  __syncthreads();

  const int e_alpha = r2f2::mag_exponent(r2f2::finite_mag_bits(alpha));
  const int e_dtodx2 = r2f2::mag_exponent(r2f2::finite_mag_bits(dtodx2));
  const bool fold = p.family == r2f2::kF32;  // t keeps lap for fma(lap, alpha*dtodx2, u)
  const float folded = __fmul_rn(alpha, dtodx2);
  const int ni = nx - 2;
  const int n_int = br * ni;
  for (int s = 0; s < steps; ++s) {
    uint32_t mx = 0u;
    for (int i = threadIdx.x; i < n_int; i += blockDim.x) {
      const int at = (i / ni) * nx + i % ni + 1;
      const float lap = __fadd_rn(__fsub_rn(u[at - 1], __fmul_rn(2.0f, u[at])), u[at + 1]);
      t[at] = lap;
      mx = max(mx, r2f2::finite_mag_bits(lap));
    }
    const int e_lap = r2f2::block_max_exp(mx, scratch);
    const int k_flux = r2f2::site_k(r2f2::select_k_mul(e_alpha, e_lap, p), k_floor, 0, p);
    mx = 0u;
    for (int i = threadIdx.x; i < n_int; i += blockDim.x) {
      const int at = (i / ni) * nx + i % ni + 1;
      const float flux = r2f2::family_mul(alpha, t[at], k_flux, p);
      if (!fold) t[at] = flux;
      mx = max(mx, r2f2::finite_mag_bits(flux));
    }
    const int e_flux = r2f2::block_max_exp(mx, scratch);
    const int k_upd = r2f2::site_k(r2f2::select_k_mul(e_flux, e_dtodx2, p), k_floor, 1, p);
    for (int i = threadIdx.x; i < n_int; i += blockDim.x) {
      const int at = (i / ni) * nx + i % ni + 1;
      u[at] = fold ? __fmaf_rn(t[at], folded, u[at]) : __fadd_rn(u[at], r2f2::family_mul(t[at], dtodx2, k_upd, p));
    }
    if (ev != nullptr && threadIdx.x == 0) {
      float* e = ev + (static_cast<size_t>(blockIdx.x) * steps + s) * 4;
      e[0] = static_cast<float>(e_alpha);
      e[1] = static_cast<float>(e_lap);
      e[2] = static_cast<float>(e_flux);
      e[3] = static_cast<float>(e_dtodx2);
    }
    __syncthreads();  // the next laplacian reads neighbours written above
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) u_out[base + i] = u[i];
}

// K3: the momentum flux q1*q1/q3 + c*(q3*q3) over one (br, bw) split tile.
// Sites: 0 q1*q1, 1 q3*q3, 2 c*t3, 3 t1/q3. Three passes over the tile, each
// ending in block maxes; the products are recomputed in the last pass.
__global__ void __launch_bounds__(kSweThreads)
swe_flux_kernel(const float* __restrict__ q1, const float* __restrict__ q3, float* __restrict__ out,
                float* __restrict__ ev, const int* __restrict__ k_floor, int width, int br, int bw, float c,
                Policy p) {
  __shared__ uint32_t scratch[32];
  const int n = br * bw;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * br;
  const int col0 = blockIdx.x * bw;
  auto at = [&](int i) { return (row0 + i / bw) * width + col0 + i % bw; };

  uint32_t m1 = 0u, m3 = 0u;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t g = at(i);
    m1 = max(m1, r2f2::finite_mag_bits(q1[g]));
    m3 = max(m3, r2f2::finite_mag_bits(q3[g]));
  }
  const int e1 = r2f2::block_max_exp(m1, scratch);
  const int e3 = r2f2::block_max_exp(m3, scratch);
  const int k11 = r2f2::site_k(r2f2::select_k_mul(e1, e1, p), k_floor, 0, p);
  const int k33 = r2f2::site_k(r2f2::select_k_mul(e3, e3, p), k_floor, 1, p);

  uint32_t mt1 = 0u, mt3 = 0u;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t g = at(i);
    const float a = q1[g], h = q3[g];
    mt1 = max(mt1, r2f2::finite_mag_bits(r2f2::family_mul(a, a, k11, p)));
    mt3 = max(mt3, r2f2::finite_mag_bits(r2f2::family_mul(h, h, k33, p)));
  }
  const int et1 = r2f2::block_max_exp(mt1, scratch);
  const int et3 = r2f2::block_max_exp(mt3, scratch);
  const int ec = r2f2::mag_exponent(r2f2::finite_mag_bits(c));
  const int k_gq3 = r2f2::site_k(r2f2::select_k_mul(ec, et3, p), k_floor, 2, p);
  const int k_div = r2f2::site_k(r2f2::select_k_div(et1, e3, p), k_floor, 3, p);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t g = at(i);
    const float a = q1[g], h = q3[g];
    const float t1 = r2f2::family_mul(a, a, k11, p);
    const float t3 = r2f2::family_mul(h, h, k33, p);
    out[g] = r2f2::family_mul_add(c, t3, r2f2::family_div(t1, h, k_div, p), k_gq3, p);
  }
  if (ev != nullptr && threadIdx.x == 0) {
    float* e = ev + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 8;
    e[0] = static_cast<float>(e1);
    e[1] = static_cast<float>(e1);
    e[2] = static_cast<float>(e3);
    e[3] = static_cast<float>(e3);
    e[4] = static_cast<float>(ec);
    e[5] = static_cast<float>(et3);
    e[6] = static_cast<float>(et1);
    e[7] = static_cast<float>(e3);
  }
}

Policy make_policy(int family, int eb, int mb, int fx, int fe, int fm, int tail_approx, int pinned) {
  return Policy{family, eb, mb, fx, fe, fm, tail_approx, pinned};
}

}  // namespace

extern "C" int r2f2_heat1d_sweep(const float* u_in, float* u_out, float* ev, const int* k_floor, int rows, int nx,
                                 int br, int steps, float alpha, float dtodx2, int family, int eb, int mb, int fx,
                                 int fe, int fm, int tail_approx, int pinned, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(br) * nx * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(heat1d_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  heat1d_sweep_kernel<<<rows / br, kHeatThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u_in, u_out, ev, k_floor, nx, br, steps, alpha, dtodx2,
      make_policy(family, eb, mb, fx, fe, fm, tail_approx, pinned));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int r2f2_swe_flux(const float* q1, const float* q3, float* out, float* ev, const int* k_floor, int rows,
                             int width, int br, int bw, float c, int family, int eb, int mb, int fx, int fe, int fm,
                             int tail_approx, int pinned, void* stream) {
  const dim3 grid(width / bw, rows / br);
  swe_flux_kernel<<<grid, kSweThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q1, q3, out, ev, k_floor, width, br, bw, c, make_policy(family, eb, mb, fx, fe, fm, tail_approx, pinned));
  return static_cast<int>(cudaGetLastError());
}

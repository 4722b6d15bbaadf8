// The grid shape of the rod kernels: heat1d's launcher (rod_grid.cuh), and the
// C entry point of every rod launch.
#include "rod_grid.cuh"

ROD_GRID_LAUNCHER(launch_grid_heat1d, kHeat1D)

// `blocks` blocks of n cells, contiguous from u_in, of `body`
// (kernels/rod.py::BODIES): heat1d row blocks of n = br * row cells, a
// periodic rod (one block, row = n), heat2d's (nx, ny) field (one block, row
// = ny, the grid shape only). Shape 0 is the warp shape on `threads` / 32
// warps with `cells` (G) cells a lane, shape 1 the grid shape with `ctas`
// CTAs a block and `cells` a thread (kernels/rod.py::rod_plan). The fused
// sweeps pass their k_floor as trk_k, evolve 0 and every 0; a megakernel one
// block and its tracker rows. cap_out (null: capture off) takes the operand
// histograms, (slots, 2, 2, cap_bins) int32 zeroed: slot 0 a fused sweep's,
// slot i a megakernel's interval i and slot steps / every its remainder.
// `members` ensemble members run the same blocks in one launch, every array
// leading with the member (rod.cuh::member_args).
extern "C" int r2f2_rod(int body, const float* u_in, float* u_out, float* snaps, float* ev, float* work,
                        unsigned int* maxes, unsigned long long* count, int* trk_k, float* trk_hi, float* trk_lo,
                        int* trk_ov, int* trk_sh, const int* site_cfg, int evolve, int blocks, int members, int n,
                        int row, int steps, int every, int shape, int threads, int cells, int ctas, float c0, float c1,
                        float ema, float one_minus, int headroom, int family, int eb, int mb, int fx, int fe, int fm,
                        int tail_approx, int pinned, const void* pay_in, const int* k_in, void* pay_out, int* k_out,
                        int bytes, int round, int* cap_out, int cap_e_lo, int cap_bins, int cap_rows,
                        int cap_cols, void* stream) {
  const bool periodic = body == kAdvection1D || body == kBurgers1D;
  const bool storage = pay_in != nullptr || pay_out != nullptr || round != 0 || k_out != nullptr;
  bool ok = blocks >= 1 && members >= 1 && row >= 1 && n >= row && n % row == 0 && every >= 0 &&
            (every == 0 || snaps != nullptr);
  ok = ok && (periodic ? blocks == 1 && n == row : row >= 3);
  ok = ok && (body != kHeat2D || (blocks == 1 && n / row >= 3));
  // storage: one block; the payloads' width holds the format; rounding in a megakernel; a packed input
  // with its split; an f32 input or output where there is no packed one (the grid shape's output
  // always: its last substep lands there)
  ok = ok && (!storage || blocks == 1) && (bytes == 1 || bytes == 2 || bytes == 4) && 1 + eb + mb + fx <= 8 * bytes;
  ok = ok && (!round || every > 0) && (pay_in == nullptr || k_in != nullptr) && (pay_in != nullptr || u_in != nullptr);
  ok = ok && (u_out != nullptr || (pay_out != nullptr && shape == 0));
  const r2f2::Capture cap{cap_out, cap_e_lo, cap_bins, cap_rows, cap_cols};
  ok = ok && r2f2::capture_ok(cap);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const r2f2::Storage st{pay_in, k_in, pay_out, k_out, bytes, round};
  const RodArgs a{u_in, u_out, snaps, ev, work, maxes, count, trk_k, trk_hi, trk_lo, trk_ov, trk_sh, site_cfg,
                  evolve, blocks, n, row, steps, every, members, 0, blocks, c0, c1, st, cap};
  const AdjustLaw law{ema, one_minus, headroom, eb, fx};
  const Policy p{family, eb, mb, fx, fe, fm, tail_approx, pinned};
  const auto s = static_cast<cudaStream_t>(stream);
  if (shape == 0) {
    switch (body) {
      case kHeat1D: return static_cast<int>(rod::launch_warp_heat1d(a, threads, cells, law, p, s));
      case kAdvection1D: return static_cast<int>(rod::launch_warp_advection1d(a, threads, cells, law, p, s));
      case kBurgers1D: return static_cast<int>(rod::launch_warp_burgers1d(a, threads, cells, law, p, s));
      default: return static_cast<int>(cudaErrorInvalidValue);  // heat2d takes its cluster (pde_steps.cu) or the grid
    }
  }
  if (shape != 1 || work == nullptr || maxes == nullptr || count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (body) {
    case kHeat1D: return static_cast<int>(rod::launch_grid_heat1d(a, cells, ctas, law, p, s));
    case kAdvection1D: return static_cast<int>(rod::launch_grid_advection1d(a, cells, ctas, law, p, s));
    case kBurgers1D: return static_cast<int>(rod::launch_grid_burgers1d(a, cells, ctas, law, p, s));
    case kHeat2D: return static_cast<int>(rod::launch_grid_heat2d(a, cells, ctas, law, p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernels K8 and K9: any fused body, traced on the host into a tape
// (kernels/tape.py), run on the card.
//
//   K8  r2f2_generic_sweep  fused_sweep: `steps` substeps of the body on the
//                           (br, bw) split blocks, one CTA per (block, member);
//   K9  r2f2_generic_mega   mega_sweep: a whole horizon of the body, one CTA per
//                           member, with the adjust unit (adjust_tick) per site
//                           per substep, snapshots every `every`, the floor
//                           latched at snapshot boundaries, the storage rounding
//                           there and packed I/O.
//
// A tape is rows of int32 (kernels/tape.py::ROW): COPY, ARITH (one IEEE f32 op),
// and each policy operation as STATS (the block maxima of its broadcast
// operands, the split, the evidence and the operand histogram) then APPLY (the
// family op at that split). Every operand is a strided view of one of four
// spaces: the current state, the CTA's scratch of fresh values, the constants,
// and the next state. Every thread walks each row's elements with a stride of
// the CTA, and a CTA barrier follows each row. Intermediates live in device
// memory, so no field is too large. At the main path's sizes the kernels are
// bound neither by bytes nor by operations but by the latency of that serial
// chain of rows (a heat1d substep is 12 rows, swe2d's Lax-Wendroff step 92),
// which the hand-written kernels K2-K5 cut by keeping a body's state in
// registers or shared memory: a simple design, not a fast one (PERF.md,
// ROADMAP "Held, not queued").
//
// Replaces the TPU kernels repro/kernels/fused.py::_sweep_kernel and
// repro/kernels/mega.py::_mega_kernel for bodies that have no kernel of their own.
#include "r2f2_device.cuh"

namespace r2f2 {
namespace generic {

constexpr int kRank = 5;
constexpr int kDesc = 2 + kRank;
constexpr int kRow = 4 + kRank + 4 * kDesc;
constexpr int kMaxLeaves = 8;
constexpr int kMaxSites = 64;

enum Kind : int { kCopy = 0, kArith = 1, kStats = 2, kApply = 3 };
enum Arith : int { kNeg = 0, kAdd = 1, kSub = 2, kMul = 3, kDiv = 4, kFma = 5 };
enum PolicyOp : int { kPMul = 0, kPDiv = 1, kPAdd = 2, kPRsqrt = 3, kPMulAdd = 4 };

// What a CTA's rows read and write.
struct Ctx {
  float* space[4];       // state, scratch, constants, next state
  Policy pol;
  const int* k_floor;    // per site (the member's row, or the latched floor); null: none
  int* ks;               // shared: the split of each site's last STATS
  float* sev;            // shared: each site's evidence (ae, be) of this substep
  float* ev;             // this substep's evidence row (n_sites, 2) in device memory; null: not collected
  unsigned* smax;        // shared: two words for the block maxima
  const Hist* hist;      // null: capture off
  int row0, col0;        // the block's first row and column in the padded field (K8)
  int valid_rows, valid_cols;  // the unpadded extent (0: that axis has no padding)
};

struct Operands {
  float* p[4];
  int st[4][kRank];
};

__device__ __forceinline__ void load_operands(const int* row, const Ctx& c, Operands& o) {
  for (int j = 0; j < 4; ++j) {
    const int* d = row + 4 + kRank + j * kDesc;
    o.p[j] = d[0] < 0 ? nullptr : c.space[d[0]] + d[1];
    for (int i = 0; i < kRank; ++i) o.st[j][i] = d[2 + i];
  }
}

// Element e of a row's shape: each operand's offset, and the last two indices.
__device__ __forceinline__ void locate(int e, const int* shape, const Operands& o, int (&off)[4], int& r, int& col) {
  off[0] = off[1] = off[2] = off[3] = 0;
  r = col = 0;
  for (int d = kRank - 1; d >= 0; --d) {
    const int n = shape[d];
    if (n == 1) continue;
    const int q = e % n;
    e /= n;
    if (d == kRank - 1) col = q;
    if (d == kRank - 2) r = q;
    for (int j = 0; j < 4; ++j) off[j] += q * o.st[j][d];
  }
}

// -x as a sign flip: no flush of a subnormal input, as the CPU negates
__device__ __forceinline__ float neg(float x) { return __uint_as_float(__float_as_uint(x) ^ 0x80000000u); }

__device__ __forceinline__ float arith(int op, float a, float b, float c) {
  switch (op) {
    case kNeg: return neg(a);
    case kAdd: return __fadd_rn(a, b);
    case kSub: return __fsub_rn(a, b);
    case kMul: return __fmul_rn(a, b);
    case kDiv: return __fdiv_rn(a, b);
    default: return __fmaf_rn(a, b, c);
  }
}

__device__ __forceinline__ float apply_policy(int op, float a, float b, float c, int k, const Policy& p) {
  switch (op) {
    case kPMul: return family_mul(a, b, k, p);
    case kPDiv: return family_div(a, b, k, p);
    case kPAdd: return family_add(a, b, k, p);
    case kPRsqrt: return family_rsqrt(a, k, p);
    default: return family_mul_add(a, b, c, k, p);
  }
}

__device__ __forceinline__ int select_k_policy(int op, int ae, int be, const Policy& p) {
  switch (op) {
    case kPDiv: return select_k_div(ae, be, p);
    case kPAdd: return select_k_add(ae, be, p);
    case kPRsqrt: return select_k_rsqrt(ae, p);
    default: return select_k_mul(ae, be, p);
  }
}

// The max of two words over the CTA (a warp reduction, then a shared atomic a
// warp); every thread reaches it, and gets both maxima back.
__device__ __forceinline__ void cta_max2(unsigned& a, unsigned& b, unsigned* smax) {
  a = __reduce_max_sync(0xffffffffu, a);
  b = __reduce_max_sync(0xffffffffu, b);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(smax, a);
    atomicMax(smax + 1, b);
  }
  __syncthreads();
  a = smax[0];
  b = smax[1];
}

// Run `n` rows; a CTA barrier after each.
__device__ void run_rows(const int* code, int n, const Ctx& c) {
  for (int i = 0; i < n; ++i) {
    const int* row = code + static_cast<size_t>(i) * kRow;
    const int kind = row[0], op = row[1], site = row[2], count = row[3];
    const int* shape = row + 4;
    Operands o;
    load_operands(row, c, o);
    int off[4], r, col;
    if (kind == kStats) {
      if (threadIdx.x == 0) c.smax[0] = c.smax[1] = 0u;
      __syncthreads();
      unsigned ma = 0u, mb = 0u;
      for (int e = threadIdx.x; e < count; e += blockDim.x) {
        locate(e, shape, o, off, r, col);
        const float a = o.p[1][off[1]], b = o.p[2][off[2]];
        ma = max(ma, finite_mag_bits(a));
        mb = max(mb, finite_mag_bits(b));
        if (c.hist != nullptr) {  // the valid lanes of a padded grid only (tape.py checks the shapes)
          const bool valid = (c.valid_rows == 0 || c.row0 + r < c.valid_rows) &&
                             (c.valid_cols == 0 || c.col0 + col < c.valid_cols);
          c.hist->add(2 * site, a, valid);
          c.hist->add(2 * site + 1, b, valid);
        }
      }
      cta_max2(ma, mb, c.smax);
      if (threadIdx.x == 0) {
        const int ae = mag_exponent(ma), be = mag_exponent(mb);
        c.ks[site] = site_k(select_k_policy(op, ae, be, c.pol), c.k_floor, site, c.pol);
        c.sev[2 * site] = static_cast<float>(ae);
        c.sev[2 * site + 1] = static_cast<float>(be);
        if (c.ev != nullptr) {
          c.ev[2 * site] = static_cast<float>(ae);
          c.ev[2 * site + 1] = static_cast<float>(be);
        }
      }
    } else if (kind == kApply) {
      const int k = c.ks[site];
      for (int e = threadIdx.x; e < count; e += blockDim.x) {
        locate(e, shape, o, off, r, col);
        const float cv = o.p[3] != nullptr ? o.p[3][off[3]] : 0.0f;
        o.p[0][off[0]] = apply_policy(op, o.p[1][off[1]], o.p[2][off[2]], cv, k, c.pol);
      }
    } else if (kind == kArith) {
      for (int e = threadIdx.x; e < count; e += blockDim.x) {
        locate(e, shape, o, off, r, col);
        const float a = o.p[1][off[1]];
        const float b = o.p[2] != nullptr ? o.p[2][off[2]] : 0.0f;
        const float cv = o.p[3] != nullptr ? o.p[3][off[3]] : 0.0f;
        o.p[0][off[0]] = arith(op, a, b, cv);
      }
    } else {
      for (int e = threadIdx.x; e < count; e += blockDim.x) {
        locate(e, shape, o, off, r, col);
        o.p[0][off[0]] = o.p[1][off[1]];
      }
    }
    __syncthreads();
  }
}

// The largest finite magnitude of n values over the CTA, as a bit pattern.
__device__ __forceinline__ unsigned cta_max_mag(const float* x, int n, unsigned* smax) {
  if (threadIdx.x == 0) smax[0] = smax[1] = 0u;
  __syncthreads();
  unsigned m = 0u, unused = 0u;
  for (int e = threadIdx.x; e < n; e += blockDim.x) m = max(m, finite_mag_bits(x[e]));
  cta_max2(m, unused, smax);
  __syncthreads();  // every thread has read smax before it is reset
  return m;
}

struct Tape {
  const int* code;
  int n_code;
  const int* out_code;
  int n_out_code;
  const float* consts;
};

struct SweepArgs {
  Tape tape;
  float* work;                 // per CTA: current and next state, then the scratch
  long long work_stride;       // floats a CTA
  int state_size, scratch_size;
  const void* in[kMaxLeaves];  // (members, rows, width) f32 leaves, or payloads
  void* out[kMaxLeaves];
  int n_state, n_out;
  const int* k_in;             // packed: (n_state, members) splits of the payloads in
  int* k_out;                  // packed: (n_out, members) splits of the payloads out
  int bytes, packed;
  float* ev;                   // (members, gi, gj, steps, n_sites, 2); null: not collected
  const int* k_floor;          // (members, n_sites); null: none
  int members, rows, width, br, bw, gi, gj, steps, n_sites;
  Policy pol;
  Capture cap;
};

__global__ void __launch_bounds__(1024) sweep_kernel(SweepArgs a) {
  extern __shared__ int hist_smem[];
  __shared__ int ks[kMaxSites];
  __shared__ float sev[2 * kMaxSites];
  __shared__ unsigned smax[2];
  const int m = blockIdx.y, blk = blockIdx.x, bi = blk / a.gj, bj = blk % a.gj;
  const int bb = a.br * a.bw;
  float* base = a.work + static_cast<size_t>(static_cast<size_t>(m) * a.gi * a.gj + blk) * a.work_stride;
  float* cur = base;
  float* nxt = base + a.state_size;
  const size_t field = static_cast<size_t>(a.rows) * a.width, at_m = static_cast<size_t>(m) * field;
  const Capture cap = member_capture(a.cap, m, 1, a.n_sites);
  const Hist hist(cap, hist_smem, a.n_sites);
  if (hist.on()) hist.zero();
  for (int l = 0; l < a.n_state; ++l) {  // the prologue: the block's leaves (decoded when packed)
    const Codec codec = a.packed ? Codec(a.k_in[l * a.members + m], a.pol) : Codec();
    for (int e = threadIdx.x; e < bb; e += blockDim.x) {
      const size_t g = at_m + static_cast<size_t>(bi * a.br + e / a.bw) * a.width + bj * a.bw + e % a.bw;
      cur[l * bb + e] = a.packed ? codec.decode(load_payload(a.in[l], g, a.bytes)) : static_cast<const float*>(a.in[l])[g];
    }
  }
  __syncthreads();
  Ctx c;
  c.space[1] = base + 2 * static_cast<size_t>(a.state_size);
  c.space[2] = const_cast<float*>(a.tape.consts);
  c.pol = a.pol;
  c.k_floor = a.k_floor != nullptr ? a.k_floor + static_cast<size_t>(m) * a.n_sites : nullptr;
  c.ks = ks;
  c.sev = sev;
  c.smax = smax;
  c.hist = hist.on() ? &hist : nullptr;
  c.row0 = bi * a.br;
  c.col0 = bj * a.bw;
  c.valid_rows = cap.rows;
  c.valid_cols = cap.cols;
  for (int s = 0; s < a.steps; ++s) {
    c.space[0] = cur;
    c.space[3] = nxt;
    c.ev = a.ev != nullptr
               ? a.ev + ((static_cast<size_t>(m * a.gi + bi) * a.gj + bj) * a.steps + s) * a.n_sites * 2
               : nullptr;
    run_rows(a.tape.code, a.tape.n_code, c);
    run_rows(a.tape.out_code, a.tape.n_out_code, c);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int l = 0; l < a.n_out; ++l) {  // the epilogue: the block out (encoded at a fresh split when packed)
    const float* v = cur + l * bb;
    Codec codec;
    if (a.packed) {
      const int k = storage_k(cta_max_mag(v, bb, smax), a.pol.eb, a.pol.fx);
      codec = Codec(k, a.pol);
      if (threadIdx.x == 0) a.k_out[l * a.members + m] = k;
    }
    for (int e = threadIdx.x; e < bb; e += blockDim.x) {
      const size_t g = at_m + static_cast<size_t>(bi * a.br + e / a.bw) * a.width + bj * a.bw + e % a.bw;
      if (a.packed) {
        store_payload(a.out[l], g, a.bytes, codec.pack(v[e]));
      } else {
        static_cast<float*>(a.out[l])[g] = v[e];
      }
    }
  }
  if (hist.on()) hist.flush(0);
}

struct MegaArgs {
  Tape tape;
  float* work;
  long long work_stride;
  int state_size, scratch_size;
  const void* in[kMaxLeaves];  // (members, *leaf) f32 leaves, or payloads
  void* out[kMaxLeaves];
  float* snaps[kMaxLeaves];    // (members, steps // every, *leaf)
  int leaf_off[kMaxLeaves], leaf_n[kMaxLeaves];
  int n_state;
  const int* k_in;             // packed io: (n_state, members)
  int* kst;                    // (members, n_state) carried storage splits; null: no rounding out
  int bytes, packed, round;
  float* ev;                   // (members, steps, n_sites, 2); null: not collected
  int *k, *ov, *sh;            // tracker rows (members, n_sites): evolved in place, or the pinned floor
  float *hi, *lo;
  const int* table;            // (n_sites, 3): op code, k_lo, k_hi
  int evolve, has_floor;
  int members, steps, every, n_sites;
  AdjustLaw law;
  Policy pol;
  Capture cap;
};

// The storage rounding of every leaf at its own split (mega_sweep_plain's round_all).
__device__ void round_all(const MegaArgs& a, float* cur, int* kst, unsigned* smax) {
  for (int l = 0; l < a.n_state; ++l) {
    float* v = cur + a.leaf_off[l];
    const int k = storage_k(cta_max_mag(v, a.leaf_n[l], smax), a.pol.eb, a.pol.fx);
    const Codec codec(k, a.pol);
    for (int e = threadIdx.x; e < a.leaf_n[l]; e += blockDim.x) v[e] = codec.round(v[e]);
    if (threadIdx.x == 0) kst[l] = k;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(1024) mega_kernel(MegaArgs a) {
  extern __shared__ int hist_smem[];
  __shared__ int ks[kMaxSites], kfloor[kMaxSites], kst[kMaxLeaves];
  __shared__ float sev[2 * kMaxSites];
  __shared__ SiteState site[kMaxSites];
  __shared__ unsigned smax[2];
  const int m = blockIdx.x;
  float* base = a.work + static_cast<size_t>(m) * a.work_stride;
  float* cur = base;
  float* nxt = base + a.state_size;
  const int n_out = a.steps / a.every;
  const Capture cap = member_capture(a.cap, m, n_out + 1, a.n_sites);
  const Hist hist(cap, hist_smem, a.n_sites);
  if (hist.on()) hist.zero();
  const size_t row = static_cast<size_t>(m) * a.n_sites;
  if (threadIdx.x == 0) {
    for (int j = 0; j < a.n_sites; ++j) {
      if (a.evolve) site[j] = SiteState{a.k[row + j], a.hi[row + j], a.lo[row + j], a.ov[row + j], a.sh[row + j]};
      if (a.evolve || a.has_floor) kfloor[j] = a.k[row + j];
    }
    for (int l = 0; l < a.n_state; ++l) kst[l] = 0;
  }
  for (int l = 0; l < a.n_state; ++l) {  // the prologue (packed io: decoded at the carried split)
    const Codec codec = a.packed ? Codec(a.k_in[l * a.members + m], a.pol) : Codec();
    const size_t at = static_cast<size_t>(m) * a.leaf_n[l];
    for (int e = threadIdx.x; e < a.leaf_n[l]; e += blockDim.x) {
      cur[a.leaf_off[l] + e] = a.packed ? codec.decode(load_payload(a.in[l], at + e, a.bytes))
                                        : static_cast<const float*>(a.in[l])[at + e];
    }
  }
  __syncthreads();
  Ctx c;
  c.space[1] = base + 2 * static_cast<size_t>(a.state_size);
  c.space[2] = const_cast<float*>(a.tape.consts);
  c.pol = a.pol;
  c.k_floor = a.evolve || a.has_floor ? kfloor : nullptr;
  c.ks = ks;
  c.sev = sev;
  c.smax = smax;
  c.hist = hist.on() ? &hist : nullptr;
  c.row0 = c.col0 = c.valid_rows = c.valid_cols = 0;
  for (int s = 0; s < a.steps; ++s) {
    c.space[0] = cur;
    c.space[3] = nxt;
    c.ev = a.ev != nullptr ? a.ev + (static_cast<size_t>(m) * a.steps + s) * a.n_sites * 2 : nullptr;
    run_rows(a.tape.code, a.tape.n_code, c);
    run_rows(a.tape.out_code, a.tape.n_out_code, c);
    float* t = cur;
    cur = nxt;
    nxt = t;
    if (a.evolve && threadIdx.x == 0) {  // the adjust unit: one tick per site per substep
      for (int j = 0; j < a.n_sites; ++j) {
        adjust_tick(site[j], sev[2 * j], sev[2 * j + 1], a.table[3 * j], a.table[3 * j + 1], a.table[3 * j + 2], a.law);
      }
    }
    if ((s + 1) % a.every == 0) {
      if (a.round) round_all(a, cur, kst, smax);
      if (a.evolve && threadIdx.x == 0) {  // the datapath floor latches at the boundary
        for (int j = 0; j < a.n_sites; ++j) kfloor[j] = site[j].k;
      }
      const int b = (s + 1) / a.every - 1;
      for (int l = 0; l < a.n_state; ++l) {
        float* dst = a.snaps[l] + (static_cast<size_t>(m) * n_out + b) * a.leaf_n[l];
        for (int e = threadIdx.x; e < a.leaf_n[l]; e += blockDim.x) dst[e] = cur[a.leaf_off[l] + e];
      }
      if (hist.on()) hist.flush(b);
    }
    __syncthreads();
  }
  if (a.round && a.steps % a.every != 0) round_all(a, cur, kst, smax);
  if (hist.on()) hist.flush(n_out);
  for (int l = 0; l < a.n_state; ++l) {  // the epilogue (packed io: encoded at the carried split)
    const Codec codec = a.packed ? Codec(kst[l], a.pol) : Codec();
    const size_t at = static_cast<size_t>(m) * a.leaf_n[l];
    for (int e = threadIdx.x; e < a.leaf_n[l]; e += blockDim.x) {
      const float v = cur[a.leaf_off[l] + e];
      if (a.packed) {
        store_payload(a.out[l], at + e, a.bytes, codec.pack(v));
      } else {
        static_cast<float*>(a.out[l])[at + e] = v;
      }
    }
  }
  if (threadIdx.x == 0) {
    if (a.kst != nullptr) {
      for (int l = 0; l < a.n_state; ++l) a.kst[static_cast<size_t>(m) * a.n_state + l] = kst[l];
    }
    if (a.evolve) {
      for (int j = 0; j < a.n_sites; ++j) {
        a.k[row + j] = site[j].k, a.hi[row + j] = site[j].hi, a.lo[row + j] = site[j].lo;
        a.ov[row + j] = site[j].ov, a.sh[row + j] = site[j].sh;
      }
    }
  }
}

// K1's harness for its policy ops: out[i] = op(a[i], b[i]) at split k, op 0 the
// bare __frsqrt_rn, 1 family_add, 2 family_rsqrt (chip_smoke.py holds them
// against the plain versions on the CPU).
__global__ void family_op_kernel(int op, const float* a, const float* b, float* out, int n, int k, Policy p) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    out[i] = op == 0 ? __frsqrt_rn(a[i]) : op == 1 ? family_add(a[i], b[i], k, p) : family_rsqrt(a[i], k, p);
  }
}

inline bool shape_ok(int threads, int n_sites, int leaves, const Capture& cap) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0 && n_sites <= kMaxSites && leaves <= kMaxLeaves &&
         capture_ok(cap);
}

}  // namespace generic
}  // namespace r2f2

using r2f2::Capture;
using r2f2::Policy;

extern "C" int r2f2_generic_sweep(const int* code, int n_code, const int* out_code, int n_out_code, const float* consts,
                                  float* work, long long work_stride, int state_size, int scratch_size,
                                  const void* const* in, void* const* out, int n_state, int n_out, const int* k_in,
                                  int* k_out, int bytes, int packed, float* ev, const int* k_floor, int members,
                                  int rows, int width, int br, int bw, int gi, int gj, int steps, int n_sites,
                                  int threads, int family, int eb, int mb, int fx, int fe, int fm, int tail_approx,
                                  int pinned, int* cap_out, int e_lo, int n_bins, int cap_rows, int cap_cols,
                                  void* stream) {
  namespace g = r2f2::generic;
  const Capture cap{cap_out, e_lo, n_bins, cap_rows, cap_cols};
  if (!g::shape_ok(threads, n_sites, n_state > n_out ? n_state : n_out, cap) || members < 1 || gi < 1 || gj < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g::SweepArgs a{};
  a.tape = g::Tape{code, n_code, out_code, n_out_code, consts};
  a.work = work, a.work_stride = work_stride, a.state_size = state_size, a.scratch_size = scratch_size;
  for (int l = 0; l < n_state; ++l) a.in[l] = in[l];
  for (int l = 0; l < n_out; ++l) a.out[l] = out[l];
  a.n_state = n_state, a.n_out = n_out, a.k_in = k_in, a.k_out = k_out, a.bytes = bytes, a.packed = packed;
  a.ev = ev, a.k_floor = k_floor;
  a.members = members, a.rows = rows, a.width = width, a.br = br, a.bw = bw, a.gi = gi, a.gj = gj, a.steps = steps;
  a.n_sites = n_sites;
  a.pol = Policy{family, eb, mb, fx, fe, fm, tail_approx, pinned};
  a.cap = cap;
  const size_t smem = r2f2::hist_bytes(cap, n_sites);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(g::sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  g::sweep_kernel<<<dim3(gi * gj, members), threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int r2f2_generic_mega(const int* code, int n_code, const int* out_code, int n_out_code, const float* consts,
                                 float* work, long long work_stride, int state_size, int scratch_size,
                                 const void* const* in, void* const* out, float* const* snaps, const int* leaf_off,
                                 const int* leaf_n, int n_state, const int* k_in, int* kst, int bytes, int packed,
                                 int round, float* ev, int* k, float* hi, float* lo, int* ov, int* sh,
                                 const int* table, int evolve, int has_floor, int members, int steps, int every,
                                 int n_sites, int threads, float ema, float one_minus, int headroom, int family,
                                 int eb, int mb, int fx, int fe, int fm, int tail_approx, int pinned, int* cap_out,
                                 int e_lo, int n_bins, int cap_rows, int cap_cols, void* stream) {
  namespace g = r2f2::generic;
  const Capture cap{cap_out, e_lo, n_bins, cap_rows, cap_cols};
  if (!g::shape_ok(threads, n_sites, n_state, cap) || members < 1 || every < 1 || steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g::MegaArgs a{};
  a.tape = g::Tape{code, n_code, out_code, n_out_code, consts};
  a.work = work, a.work_stride = work_stride, a.state_size = state_size, a.scratch_size = scratch_size;
  for (int l = 0; l < n_state; ++l) {
    a.in[l] = in[l], a.out[l] = out[l], a.snaps[l] = snaps[l];
    a.leaf_off[l] = leaf_off[l], a.leaf_n[l] = leaf_n[l];
  }
  a.n_state = n_state, a.k_in = k_in, a.kst = kst, a.bytes = bytes, a.packed = packed, a.round = round;
  a.ev = ev, a.k = k, a.hi = hi, a.lo = lo, a.ov = ov, a.sh = sh, a.table = table;
  a.evolve = evolve, a.has_floor = has_floor;
  a.members = members, a.steps = steps, a.every = every, a.n_sites = n_sites;
  a.law = r2f2::AdjustLaw{ema, one_minus, headroom, eb, fx};
  a.pol = Policy{family, eb, mb, fx, fe, fm, tail_approx, pinned};
  a.cap = cap;
  const size_t smem = r2f2::hist_bytes(cap, n_sites);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(g::mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  g::mega_kernel<<<members, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int r2f2_family_op(int op, const float* a, const float* b, float* out, int n, int k, int family, int eb,
                              int mb, int fx, int fe, int fm, int tail_approx, int pinned, void* stream) {
  if (op < 0 || op > 2 || n < 0 || (op == 1 && b == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = n > 0 ? (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096 : 1;
  r2f2::generic::family_op_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      op, a, b, out, n, k, Policy{family, eb, mb, fx, fe, fm, tail_approx, pinned});
  return static_cast<int>(cudaGetLastError());
}

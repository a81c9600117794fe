// K4 plan_dp: the frame-level decisions of the all-intra plan after the
// per-size RD, and the quadtree DP and emission of the P/B-picture plan.
//
// Replaces the rest of `_plan_device` (hm16_2_tpu/encode/intra_rd.py:421-575):
// the chroma candidates and fold (:424-447), the 64x64 mode from the
// quad-summed TU32 SATD and its cost (:449-469), the bottom-up quadtree DP
// (:471-497) and the dense emission of the packed (7, h/4, w/4) int8 plan
// (:499-575), with the border rules for frames that are not a multiple of
// 64.  For the P/B-picture plan (hm16_2_tpu/encode/inter_plan.py
// `_emit_plan`, :978-1101) the DP with SPLIT_BITS = 3 over K8's CU costs and
// the packed (24, h/4, w/4) int16 plan from K8's per-CU records, with the
// border rules of frames that are not a multiple of 64 and no intra at 64x64.
//
// What bounds it on the H100: launches.  At 1080p the grids hold 8k-130k
// entries of a handful of operations each, so the work is microseconds and
// the host's enqueue of each launch costs more than the launch runs.  The
// first design ran a one-thread-per-entry kernel per stage and DP level (13
// launches per AI frame, 4 per P/B picture).  Everything after K3 stays
// inside one 64x64 CTU, border CTUs included: the chroma fold of the 8/16/32
// entries, the 64x64 cost, every DP level (a parent reads only its four
// children) and the CTU's parts of the emission.  So the AI plan is two
// launches: `plan_pre_kernel` (the chroma candidates of sizes 8-32 and the
// 64x64 modes, which K3 needs first) over a flat index, then
// `plan_ctu_kernel`, a CTA per pair of horizontally adjacent CTUs that
// stages the pair's costs in shared memory, folds the chroma, runs the DP
// levels bottom-up between barriers and writes the pair's tile of the seven
// int8 planes (a warp writes one 32-byte row of 32 parts: a CTU's row alone
// would be half a sector).  The P/B plan is one launch, `emit_inter_kernel`:
// a CTA per CTU, its DP in shared memory, then its tile of the 24 int16
// planes (a CTU row is 32 bytes).
//
// Float steps follow XLA:CPU's rounding (the file is built with
// --fmad=false; fused steps are __fmaf_rn), each element in the reference's
// order; the DP comparisons are strict; argmins give ties to the lowest
// index.
#include <cuda_runtime.h>

namespace hm {

// ---------------------------------------------------------------------------
// the all-intra plan
// ---------------------------------------------------------------------------

struct PlanPre {
  const int* dm[3];        // DM modes of the chroma sizes 8, 16, 32 (n: 0 absent)
  int n[3];
  int* modes5[3];          // (n, 5) chroma candidates
  int base[4];
  const int* satd32;       // (nby32, nbx32, 35); null: no 64x64 level
  int nbx32, nby64, nbx64;
  int* mode64;             // (nby64, nbx64)
  int* pm64;               // (2 nby64 * 2 nbx64): mode64 of each TU32
};

__global__ void plan_pre_kernel(const __grid_constant__ PlanPre a) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = 0; k < 3; ++k) {
    if (q < a.n[k]) {
      const int d = a.dm[k][q];
      int* o = a.modes5[k] + (size_t)q * 5;
      for (int j = 0; j < 4; ++j) o[j] = d == a.base[j] ? 34 : a.base[j];
      o[4] = d;
      return;
    }
    q -= a.n[k];
  }
  if (!a.satd32 || q >= a.nby64 * a.nbx64) return;
  const int i = q / a.nbx64, j = q % a.nbx64;
  const int* s00 = a.satd32 + ((size_t)(2 * i) * a.nbx32 + 2 * j) * 35;
  const int* s10 = s00 + (size_t)a.nbx32 * 35;
  int best = 0, best_v = 0;
  for (int m = 0; m < 35; ++m) {
    int v = s00[m] + s00[35 + m] + s10[m] + s10[35 + m];
    if (m == 0 || v < best_v) { best = m; best_v = v; }
  }
  a.mode64[q] = best;
  const int w = 2 * a.nbx64;
  for (int y = 0; y < 2; ++y)
    for (int x = 0; x < 2; ++x) a.pm64[(2 * i + y) * w + 2 * j + x] = best;
}

// level l = 0..4 is the grid of size 4 << l
struct PlanCtu {
  int nby[5], nbx[5];
  float lam, cw, nxn_bits, split_bits, bits64;
  float mode_bits[5];
  const float* cost[4];        // sizes 4..32 (nby * nbx); null: empty grid
  const int* mode[5];          // sizes 4..64 (64: with the 64x64 level)
  const int* cand[4];          // sizes 4..32 (nby * nbx, 3)
  const float* chroma[3][4];   // sizes 8..32: d_cb, b_cb, d_cr, b_cr (n, 5); null: none
  const float *d64, *b64;      // (2 nby64 * 2 nbx64); null: no 64x64 level
};

constexpr int kCtuX = 2;                 // CTUs side by side per CTA
constexpr int kCtuThreads = 256 * kCtuX; // one per 4x4 part

__device__ __forceinline__ float quad4(const float* c, int w, int y, int x) {
  const float* r0 = c + (2 * y) * w + 2 * x;
  const float* r1 = r0 + w;
  return __fadd_rn(__fadd_rn(__fadd_rn(r0[0], r0[1]), r1[0]), r1[1]);
}

__global__ void __launch_bounds__(kCtuThreads)
plan_ctu_kernel(const __grid_constant__ PlanCtu g, signed char* __restrict__ out) {
  // the pair's entries of levels 0..3 (a CTU holds 16 >> l of each side),
  // the DP flags (NxN at level 1, split at 2 and 3), the chroma picks
  __shared__ float c0[16 * 16 * kCtuX], c1[8 * 8 * kCtuX], c2[4 * 4 * kCtuX],
      c3[2 * 2 * kCtuX], add3[2 * 2 * kCtuX], c64[kCtuX];
  __shared__ unsigned char f1[8 * 8 * kCtuX], f2[4 * 4 * kCtuX],
      f3[2 * 2 * kCtuX], f64[kCtuX];
  __shared__ signed char cm1[8 * 8 * kCtuX], cm2[4 * 4 * kCtuX],
      cm3[2 * 2 * kCtuX];
  float* const cl[4] = {c0, c1, c2, c3};
  unsigned char* const fl[4] = {nullptr, f1, f2, f3};
  signed char* const cml[4] = {nullptr, cm1, cm2, cm3};
  const int t = threadIdx.x, I = blockIdx.y, J0 = blockIdx.x * kCtuX;

  // costs, with the chroma fold at sizes 8..32
  {
    const int wl = 16 * kCtuX, gy = 16 * I + t / wl, gx = 16 * J0 + t % wl;
    c0[t] = g.cost[0] && gy < g.nby[0] && gx < g.nbx[0]
                ? g.cost[0][gy * g.nbx[0] + gx] : 0.f;
  }
  for (int l = 1, e = t; l <= 3; ++l) {
    const int k = 16 >> l, wl = k * kCtuX, n = k * wl;
    if (e >= 0 && e < n) {
      const int gy = k * I + e / wl, gx = k * J0 + e % wl;
      float c = 0.f, add = 0.f;
      int cm = 4;
      if (g.cost[l] && gy < g.nby[l] && gx < g.nbx[l]) {
        const int i = gy * g.nbx[l] + gx;
        c = g.cost[l][i];
        const float* const* ch = g.chroma[l - 1];
        if (ch[0]) {
          for (int j = 0; j < 5; ++j) {
            const int q = i * 5 + j;
            // Cb's d * cw is rounded before the add; every other product
            // is fused
            float v = __fadd_rn(__fmul_rn(g.lam, g.mode_bits[j]),
                                __fmul_rn(ch[0][q], g.cw));
            v = __fmaf_rn(g.lam, ch[1][q], v);
            v = __fmaf_rn(ch[2][q], g.cw, v);
            v = __fmaf_rn(g.lam, ch[3][q], v);
            if (j == 0 || v < add) { cm = j; add = v; }
          }
          c = __fadd_rn(c, add);
        }
      }
      cl[l][e] = c;
      cml[l][e] = (signed char)cm;
      if (l == 3) add3[e] = add;
    }
    e -= n;
  }
  __syncthreads();

  // the DP, bottom-up: level l from its children at l - 1; a level runs
  // where both grids exist (then every parent has its four children)
  auto level = [&](int l, float bits) {
    const int k = 16 >> l, wl = k * kCtuX;
    if (t >= k * wl) return;
    const int gy = k * I + t / wl, gx = k * J0 + t % wl;
    unsigned char flag = 0;
    if (g.cost[l - 1] && g.cost[l] && gy < g.nby[l] && gx < g.nbx[l]) {
      const float quad = __fadd_rn(quad4(cl[l - 1], 2 * wl, t / wl, t % wl),
                                   __fmul_rn(g.lam, bits));
      const float par = cl[l][t];
      flag = quad < par;
      cl[l][t] = quad < par ? quad : par;
    }
    fl[l][t] = flag;
  };
  level(1, g.nxn_bits);
  if (t >= 128 && t < 128 + kCtuX) {      // the 64x64 CU's cost
    const int j = t - 128, x64 = J0 + j;
    float c = 0.f;
    if (g.d64 && I < g.nby[4] && x64 < g.nbx[4]) {
      const int w = 2 * g.nbx[4];
      float cc[4];
      for (int y = 0; y < 2; ++y)
        for (int x = 0; x < 2; ++x) {
          const int e = (2 * I + y) * w + 2 * x64 + x;
          cc[y * 2 + x] = __fmaf_rn(g.lam, g.b64[e], g.d64[e]);
        }
      c = __fadd_rn(__fadd_rn(__fadd_rn(cc[0], cc[1]), cc[2]), cc[3]);
      c = __fadd_rn(c, __fmul_rn(g.lam, g.bits64));
      if (g.chroma[2][0]) c = __fadd_rn(c, quad4(add3, 2 * kCtuX, 0, j));
    }
    c64[j] = c;
  }
  __syncthreads();
  level(2, g.split_bits);
  __syncthreads();
  level(3, g.split_bits);
  __syncthreads();
  if (t < kCtuX) {                        // the 64x64 CU wins: par < quad
    const int x64 = J0 + t;
    f64[t] = g.d64 && I < g.nby[4] && x64 < g.nbx[4] &&
             c64[t] < __fadd_rn(quad4(c3, 2 * kCtuX, 0, t),
                                __fmul_rn(g.lam, g.split_bits));
  }
  __syncthreads();

  // the emission: one part per thread, a warp per 32-part row
  const int iy = 16 * I + t / (16 * kCtuX), ix = 16 * J0 + t % (16 * kCtuX);
  const int h4 = g.nby[0], w4 = g.nbx[0];
  if (iy >= h4 || ix >= w4) return;
  // a level's shared entry at grid position (y, x) of that level
  auto at = [&](int l, int y, int x) {
    const int k = 16 >> l;
    return (y - k * I) * (k * kCtuX) + x - k * J0;
  };
  auto in = [&](int l, int y, int x) { return y < g.nby[l] && x < g.nbx[l]; };
  auto c64f = [&](int x) { return f64[x - J0] != 0; };
  auto leaf32 = [&](int y, int x) {
    return in(3, y, x) && !c64f(x >> 1) && !f3[at(3, y, x)];
  };
  auto desc32 = [&](int y, int x) {
    return in(3, y, x) && !c64f(x >> 1) && f3[at(3, y, x)];
  };
  auto active16 = [&](int y, int x) {
    bool border = y >= 2 * g.nby[3] || x >= 2 * g.nbx[3];
    return in(2, y, x) && (desc32(y >> 1, x >> 1) || border);
  };
  auto active8 = [&](int y, int x) {
    bool border = y >= 2 * g.nby[2] || x >= 2 * g.nbx[2];
    bool desc16 = active16(y >> 1, x >> 1) && f2[at(2, y >> 1, x >> 1)];
    return in(1, y, x) && (desc16 || border);
  };
  const int x64 = ix >> 4, y32 = iy >> 3, x32 = ix >> 3;
  const int y16 = iy >> 2, x16 = ix >> 2, y8 = iy >> 1, x8 = ix >> 1;
  const bool m64 = c64f(x64);
  const bool m32 = leaf32(y32, x32);
  const bool m16 = active16(y16, x16) && !f2[at(2, y16, x16)];
  const bool a8 = active8(y8, x8);
  const bool nxn = in(1, y8, x8) && f1[at(1, y8, x8)];
  const bool m8 = a8 && !nxn, mN = a8 && nxn;

  const int depth = m64 ? 0 : m32 ? 1 : m16 ? 2 : (m8 || mN) ? 3 : -1;
  int mode = -1;
  if (m64) mode = g.mode[4][I * g.nbx[4] + x64];
  if (m32) mode = g.mode[3][y32 * g.nbx[3] + x32];
  if (m16) mode = g.mode[2][y16 * g.nbx[2] + x16];
  if (m8) mode = g.mode[1][y8 * g.nbx[1] + x8];
  if (mN) mode = g.mode[0][iy * w4 + ix];

  int cand[3] = {-1, -1, -1};
  const int* src = nullptr;
  if (m32 && !(iy & 7) && !(ix & 7)) src = g.cand[3] + (size_t)(y32 * g.nbx[3] + x32) * 3;
  if (m16 && !(iy & 3) && !(ix & 3)) src = g.cand[2] + (size_t)(y16 * g.nbx[2] + x16) * 3;
  if (m8 && !(iy & 1) && !(ix & 1)) src = g.cand[1] + (size_t)(y8 * g.nbx[1] + x8) * 3;
  if (mN) src = g.cand[0] + (size_t)(iy * w4 + ix) * 3;
  if (src)
    for (int k = 0; k < 3; ++k) cand[k] = src[k];

  int cmode = 4;
  if (m32 && g.chroma[2][0]) cmode = cm3[at(3, y32, x32)];
  if (m16 && g.chroma[1][0]) cmode = cm2[at(2, y16, x16)];
  if (m8 && g.chroma[0][0]) cmode = cm1[at(1, y8, x8)];

  const bool cov = m64 || m32 || m16 || m8 || mN;
  const int flags = (mN && !(iy & 1) && !(ix & 1) ? 1 : 0) | (cov ? 2 : 0) |
                    (m64 && !(iy & 15) && !(ix & 15) ? 4 : 0);
  const size_t plane = (size_t)h4 * w4, q = (size_t)iy * w4 + ix;
  out[q] = (signed char)depth;
  out[plane + q] = (signed char)mode;
  out[2 * plane + q] = (signed char)cmode;
  for (int k = 0; k < 3; ++k) out[(3 + k) * plane + q] = (signed char)cand[k];
  out[6 * plane + q] = (signed char)flags;
}

// ---------------------------------------------------------------------------
// the P/B-picture plan
// ---------------------------------------------------------------------------

// per size (index 0..3 = 8, 16, 32, 64) the CU grid, K8's costs and
// records (null: the size is absent)
struct InterCtu {
  int ny[4], nx[4];
  int h4, w4;
  float lam, split_bits;
  const float* cost[4];       // (ny * nx)
  const int* rec[4];          // (ny * nx, 24)
};

enum { REC_KIND, REC_MSRC, REC_DIR, REC_SKIP, REC_INTRA, REC_IMODE,
       REC_MV0Y, REC_MV0X, REC_MV1Y, REC_MV1X, REC_REF0, REC_REF1, REC_C0,
       REC_PART = 15, REC_PU = 16, REC_N = 24 };

__global__ void __launch_bounds__(256)
emit_inter_kernel(const __grid_constant__ InterCtu g, short* __restrict__ out) {
  // the CTU's costs of sizes 8..64 (8, 4, 2, 1 of a side) and split flags
  __shared__ float c[85];
  __shared__ unsigned char f[85];
  const int off[4] = {0, 64, 80, 84};
  const int t = threadIdx.x, I = blockIdx.y, J = blockIdx.x;
  if (t < 85) {
    const int l = t < 64 ? 0 : t < 80 ? 1 : t < 84 ? 2 : 3;
    const int k = 8 >> l, e = t - off[l];
    const int gy = k * I + e / k, gx = k * J + e % k;
    c[t] = g.cost[l] && gy < g.ny[l] && gx < g.nx[l]
               ? g.cost[l][gy * g.nx[l] + gx] : 0.f;
    f[t] = 0;
  }
  __syncthreads();
  // level l from l - 1, where every size up to l exists: flag = quad <
  // parent, the parent's cost the lesser
  for (int l = 1; l <= 3; ++l) {
    const int k = 8 >> l;
    bool run = true;
    for (int m = 0; m <= l; ++m) run = run && g.cost[m];
    if (run && t < k * k) {
      const int gy = k * I + t / k, gx = k * J + t % k;
      if (gy < g.ny[l] && gx < g.nx[l]) {
        const float quad = __fadd_rn(quad4(c + off[l - 1], 2 * k, t / k, t % k),
                                     __fmul_rn(g.lam, g.split_bits));
        const float par = c[off[l] + t];
        f[off[l] + t] = quad < par;
        c[off[l] + t] = quad < par ? quad : par;
      }
    }
    __syncthreads();
  }

  const int iy = 16 * I + t / 16, ix = 16 * J + t % 16;
  if (iy >= g.h4 || ix >= g.w4) return;
  auto in = [&](int l, int y, int x) { return y < g.ny[l] && x < g.nx[l]; };
  auto split = [&](int l, int y, int x) {
    const int k = 8 >> l;
    return in(l, y, x) && f[off[l] + (y - k * I) * k + x - k * J];
  };
  // leaf / descend of the 64 level; active = descended into, or border
  auto desc64 = [&](int y, int x) { return split(3, y, x); };
  auto active32 = [&](int y, int x) {
    bool border = y >= 2 * g.ny[3] || x >= 2 * g.nx[3];
    return in(2, y, x) && (desc64(y >> 1, x >> 1) || border);
  };
  auto desc32 = [&](int y, int x) { return active32(y, x) && split(2, y, x); };
  auto active16 = [&](int y, int x) {
    bool border = y >= 2 * g.ny[2] || x >= 2 * g.nx[2];
    return in(1, y, x) && (desc32(y >> 1, x >> 1) || border);
  };
  auto leaf8 = [&](int y, int x) {
    bool border = y >= 2 * g.ny[1] || x >= 2 * g.nx[1];
    bool desc16 = active16(y >> 1, x >> 1) && split(1, y >> 1, x >> 1);
    return in(0, y, x) && (desc16 || border);
  };
  const int ys[4] = {iy >> 1, iy >> 2, iy >> 3, iy >> 4};
  const int xs[4] = {ix >> 1, ix >> 2, ix >> 3, ix >> 4};
  bool m[4];
  m[3] = in(3, ys[3], xs[3]) && !desc64(ys[3], xs[3]);
  m[2] = active32(ys[2], xs[2]) && !split(2, ys[2], xs[2]);
  m[1] = active16(ys[1], xs[1]) && !split(1, ys[1], xs[1]);
  m[0] = leaf8(ys[0], xs[0]);
  const int k = m[3] ? 3 : m[2] ? 2 : m[1] ? 1 : m[0] ? 0 : -1;
  const int* r = k >= 0 && g.rec[k] ? g.rec[k] + (size_t)(ys[k] * g.nx[k] + xs[k]) * REC_N
                                    : nullptr;
  auto fld = [&](int field, int dflt) { return r ? r[field] : dflt; };
  const int intra = k == 3 ? 0 : fld(REC_INTRA, 0);
  const int cov = k >= 0 ? 1 : 0;
  int ch[24];
  ch[0] = k >= 0 ? 3 - k : -1;
  ch[1] = cov | (intra << 1) | (fld(REC_SKIP, 0) << 2);
  ch[2] = fld(REC_KIND, 0);
  ch[3] = fld(REC_MSRC, 0);
  ch[4] = fld(REC_DIR, 1);
  ch[5] = fld(REC_MV0X, 0);
  ch[6] = fld(REC_MV0Y, 0);
  ch[7] = fld(REC_MV1X, 0);
  ch[8] = fld(REC_MV1Y, 0);
  ch[9] = fld(REC_REF0, -1);
  ch[10] = fld(REC_REF1, -1);
  ch[11] = fld(REC_IMODE, 0);
  for (int j = 0; j < 3; ++j) ch[12 + j] = k == 3 ? -1 : fld(REC_C0 + j, -1);
  ch[15] = fld(REC_PART, 0);
  for (int j = 0; j < 8; ++j) ch[16 + j] = fld(REC_PU + j, 0);
  const size_t plane = (size_t)g.h4 * g.w4, q = (size_t)iy * g.w4 + ix;
  for (int j = 0; j < 24; ++j) out[j * plane + q] = (short)ch[j];
}

}  // namespace hm

extern "C" int hm_plan_pre(const hm::PlanPre* a, void* stream) {
  long long n = (long long)a->n[0] + a->n[1] + a->n[2];
  if (a->satd32) n += (long long)a->nby64 * a->nbx64;
  if (n <= 0 || n > 0x7fffffff || a->n[0] < 0 || a->n[1] < 0 || a->n[2] < 0)
    return (int)cudaErrorInvalidValue;
  hm::plan_pre_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                        (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int hm_plan_ctu(const hm::PlanCtu* g, signed char* out,
                           void* stream) {
  if (g->nby[0] <= 0 || g->nbx[0] <= 0 || !g->cost[0])
    return (int)cudaErrorInvalidValue;
  const int cy = (g->nby[0] + 15) / 16, cx = (g->nbx[0] + 15) / 16;
  hm::plan_ctu_kernel<<<dim3((cx + hm::kCtuX - 1) / hm::kCtuX, cy),
                        hm::kCtuThreads, 0, (cudaStream_t)stream>>>(*g, out);
  return (int)cudaGetLastError();
}

extern "C" int hm_emit_inter_plan(const hm::InterCtu* g, short* out,
                                  void* stream) {
  if (g->h4 <= 0 || g->w4 <= 0) return (int)cudaErrorInvalidValue;
  hm::emit_inter_kernel<<<dim3((g->w4 + 15) / 16, (g->h4 + 15) / 16), 256, 0,
                          (cudaStream_t)stream>>>(*g, out);
  return (int)cudaGetLastError();
}

// the argument structs' sizes, checked against their ctypes mirrors
extern "C" size_t hm_sizeof_plan_pre() { return sizeof(hm::PlanPre); }
extern "C" size_t hm_sizeof_plan_ctu() { return sizeof(hm::PlanCtu); }
extern "C" size_t hm_sizeof_inter_ctu() { return sizeof(hm::InterCtu); }

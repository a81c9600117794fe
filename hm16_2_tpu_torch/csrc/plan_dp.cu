// K4 plan_dp: the frame-level decisions of the all-intra plan after the
// per-size RD, and the quadtree DP and emission of the P-picture plan.
//
// Replaces the rest of `_plan_device` (hm16_2_tpu/encode/intra_rd.py:421-575):
// the chroma candidates and fold (:424-447), the 64x64 mode from the
// quad-summed TU32 SATD and its cost (:449-469), the bottom-up quadtree DP
// (:471-497) and the dense emission of the packed (7, h/4, w/4) int8 plan
// (:499-575), with the border rules for frames that are not a multiple of
// 64.  Torch only allocates and gathers the 64x64 level's TU32 inputs.
// For the P-picture plan (hm16_2_tpu/encode/inter_plan.py `_emit_plan`,
// :978-1101) the same DP level kernel runs with SPLIT_BITS = 3 on the CU
// costs of K8, and `emit_inter_kernel` writes the packed (24, h/4, w/4)
// int16 plan from K8's per-CU records, with the border rules of frames that
// are not a multiple of 64 and no intra at 64x64.
//
// What bounds it: kernel launches.  At 1080p the grids hold 8k-130k
// entries and each entry costs a handful of operations, so every launch is
// microseconds.  Design: one thread per grid entry, one launch per DP level
// and one per stage; float32 steps follow XLA:CPU's rounding (the file is
// built with --fmad=false; fused steps are __fmaf_rn); argmins give ties to
// the lowest index.
#include <cuda_runtime.h>

namespace hm {

__global__ void chroma_modes5_kernel(const int* __restrict__ dm, int n,
                                     int4 base, int* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int d = dm[i];
  int b[4] = {base.x, base.y, base.z, base.w};
  for (int j = 0; j < 4; ++j) out[i * 5 + j] = d == b[j] ? 34 : b[j];
  out[i * 5 + 4] = d;
}

__global__ void chroma_fold_kernel(const float* __restrict__ d_cb,
                                   const float* __restrict__ b_cb,
                                   const float* __restrict__ d_cr,
                                   const float* __restrict__ b_cr,
                                   const float* __restrict__ cost_in,
                                   const float* __restrict__ mode_bits,
                                   int n, float lam, float cw,
                                   float* __restrict__ cost_out,
                                   float* __restrict__ add_out,
                                   int* __restrict__ cmode_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int best = 0;
  float best_v = 0.f;
  for (int j = 0; j < 5; ++j) {
    int e = i * 5 + j;
    // Cb's d * cw is rounded before the add; every other product is fused
    float t = __fadd_rn(__fmul_rn(lam, mode_bits[j]), __fmul_rn(d_cb[e], cw));
    t = __fmaf_rn(lam, b_cb[e], t);
    t = __fmaf_rn(d_cr[e], cw, t);
    t = __fmaf_rn(lam, b_cr[e], t);
    if (j == 0 || t < best_v) { best = j; best_v = t; }
  }
  cost_out[i] = __fadd_rn(cost_in[i], best_v);
  add_out[i] = best_v;
  cmode_out[i] = best;
}

__global__ void mode64_kernel(const int* __restrict__ satd32, int nbx32,
                              int nby64, int nbx64, int* __restrict__ mode64,
                              int* __restrict__ pm64) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nby64 * nbx64) return;
  int i = q / nbx64, j = q % nbx64;
  const int* s00 = satd32 + ((size_t)(2 * i) * nbx32 + 2 * j) * 35;
  const int* s10 = s00 + (size_t)nbx32 * 35;
  int best = 0, best_v = 0;
  for (int m = 0; m < 35; ++m) {
    int v = s00[m] + s00[35 + m] + s10[m] + s10[35 + m];
    if (m == 0 || v < best_v) { best = m; best_v = v; }
  }
  mode64[q] = best;
  int w = 2 * nbx64;
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2; ++b) pm64[(2 * i + a) * w + 2 * j + b] = best;
}

__device__ __forceinline__ float quad_sum(const float* a, int stride, int i,
                                          int j) {
  const float* r0 = a + (size_t)(2 * i) * stride + 2 * j;
  const float* r1 = r0 + stride;
  return __fadd_rn(__fadd_rn(__fadd_rn(r0[0], r0[1]), r1[0]), r1[1]);
}

__global__ void cost64_kernel(const float* __restrict__ d64,
                              const float* __restrict__ b64,
                              const float* __restrict__ chroma_add32,
                              int nbx32, int nby64, int nbx64, float lam,
                              float ovh_bits, float* __restrict__ cost64) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nby64 * nbx64) return;
  int i = q / nbx64, j = q % nbx64, w = 2 * nbx64;
  float cc[4];
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2; ++b) {
      int e = (2 * i + a) * w + 2 * j + b;
      cc[a * 2 + b] = __fmaf_rn(lam, b64[e], d64[e]);
    }
  float c = __fadd_rn(__fadd_rn(__fadd_rn(cc[0], cc[1]), cc[2]), cc[3]);
  c = __fadd_rn(c, __fmul_rn(lam, ovh_bits));
  if (chroma_add32) c = __fadd_rn(c, quad_sum(chroma_add32, nbx32, i, j));
  cost64[q] = c;
}

// one DP level: quad = sum of the 2x2 children + lam * ovh_bits;
// mode 0: flag = quad < parent, cost_out = min(parent, quad) (split wins);
// mode 1: flag = parent < quad (the 64x64 CU wins)
__global__ void dp_level_kernel(const float* __restrict__ child, int wc,
                                const float* __restrict__ parent, int hp,
                                int wp, float lam, float ovh_bits, int mode,
                                unsigned char* __restrict__ flag,
                                float* __restrict__ cost_out) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= hp * wp) return;
  int i = q / wp, j = q % wp;
  float quad = __fadd_rn(quad_sum(child, wc, i, j), __fmul_rn(lam, ovh_bits));
  float par = parent[q];
  if (mode == 0) {
    flag[q] = quad < par;
    cost_out[q] = quad < par ? quad : par;
  } else {
    flag[q] = par < quad;
  }
}

struct PlanGrids {
  int h4, w4;
  int nby4, nbx4, nby8, nbx8, nby16, nbx16, nby32, nbx32, nby64, nbx64;
  const unsigned char *c64, *split32, *split16, *nxn;   // null: all false
  const int *mode4, *mode8, *mode16, *mode32, *mode64;
  const int *cand4, *cand8, *cand16, *cand32;
  const int *cmode8, *cmode16, *cmode32;                // null: no chroma
};

__device__ __forceinline__ bool flag_at(const unsigned char* f, int y, int x,
                                        int h, int w) {
  return f && y < h && x < w && f[y * w + x];
}

__global__ void emit_kernel(PlanGrids g, signed char* __restrict__ out) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= g.h4 * g.w4) return;
  int iy = q / g.w4, ix = q % g.w4;
  auto c64 = [&](int y, int x) { return flag_at(g.c64, y, x, g.nby64, g.nbx64); };
  auto in32 = [&](int y, int x) { return y < g.nby32 && x < g.nbx32; };
  auto leaf32 = [&](int y, int x) {
    return in32(y, x) && !c64(y >> 1, x >> 1) &&
           !flag_at(g.split32, y, x, g.nby32, g.nbx32);
  };
  auto desc32 = [&](int y, int x) {
    return in32(y, x) && !c64(y >> 1, x >> 1) &&
           flag_at(g.split32, y, x, g.nby32, g.nbx32);
  };
  auto active16 = [&](int y, int x) {
    bool border = y >= 2 * g.nby32 || x >= 2 * g.nbx32;
    return y < g.nby16 && x < g.nbx16 && (desc32(y >> 1, x >> 1) || border);
  };
  auto active8 = [&](int y, int x) {
    bool border = y >= 2 * g.nby16 || x >= 2 * g.nbx16;
    bool desc16 = active16(y >> 1, x >> 1) &&
                  flag_at(g.split16, y >> 1, x >> 1, g.nby16, g.nbx16);
    return y < g.nby8 && x < g.nbx8 && (desc16 || border);
  };
  int y64 = iy >> 4, x64 = ix >> 4, y32 = iy >> 3, x32 = ix >> 3;
  int y16 = iy >> 2, x16 = ix >> 2, y8 = iy >> 1, x8 = ix >> 1;
  bool m64 = c64(y64, x64);
  bool m32 = leaf32(y32, x32);
  bool m16 = active16(y16, x16) &&
             !flag_at(g.split16, y16, x16, g.nby16, g.nbx16);
  bool a8 = active8(y8, x8);
  bool nxn = flag_at(g.nxn, y8, x8, g.nby8, g.nbx8);
  bool m8 = a8 && !nxn, mN = a8 && nxn;
  bool in4 = iy < g.nby4 && ix < g.nbx4;

  int depth = m64 ? 0 : m32 ? 1 : m16 ? 2 : (m8 || mN) ? 3 : -1;
  int mode = -1;
  if (g.mode64 && m64) mode = g.mode64[y64 * g.nbx64 + x64];
  if (m32) mode = g.mode32[y32 * g.nbx32 + x32];
  if (m16) mode = g.mode16[y16 * g.nbx16 + x16];
  if (m8) mode = g.mode8[y8 * g.nbx8 + x8];
  if (mN) mode = in4 ? g.mode4[iy * g.nbx4 + ix] : -1;

  int cand[3] = {-1, -1, -1};
  const int* src = nullptr;
  if (m32 && !(iy & 7) && !(ix & 7)) src = g.cand32 + (size_t)(y32 * g.nbx32 + x32) * 3;
  if (m16 && !(iy & 3) && !(ix & 3)) src = g.cand16 + (size_t)(y16 * g.nbx16 + x16) * 3;
  if (m8 && !(iy & 1) && !(ix & 1)) src = g.cand8 + (size_t)(y8 * g.nbx8 + x8) * 3;
  if (mN && in4) src = g.cand4 + (size_t)(iy * g.nbx4 + ix) * 3;
  if (src)
    for (int k = 0; k < 3; ++k) cand[k] = src[k];

  int cmode = 4;
  if (m32 && g.cmode32) cmode = g.cmode32[y32 * g.nbx32 + x32];
  if (m16 && g.cmode16) cmode = g.cmode16[y16 * g.nbx16 + x16];
  if (m8 && g.cmode8) cmode = g.cmode8[y8 * g.nbx8 + x8];

  bool cov = m64 || m32 || m16 || m8 || mN;
  int flags = (mN && !(iy & 1) && !(ix & 1) ? 1 : 0) | (cov ? 2 : 0) |
              (m64 && !(iy & 15) && !(ix & 15) ? 4 : 0);
  size_t plane = (size_t)g.h4 * g.w4;
  out[q] = (signed char)depth;
  out[plane + q] = (signed char)mode;
  out[2 * plane + q] = (signed char)cmode;
  for (int k = 0; k < 3; ++k) out[(3 + k) * plane + q] = (signed char)cand[k];
  out[6 * plane + q] = (signed char)flags;
}

// the P-picture plan: per size (index 0..3 = 8, 16, 32, 64) the CU grid,
// its K8 records (null: the size is absent) and the DP split flags
struct InterGrids {
  int h4, w4;
  int ny[4], nx[4];
  const unsigned char *split16, *split32, *split64;   // null: all false
  const int* rec[4];                                  // (ny*nx, 24)
};

enum { REC_KIND, REC_MSRC, REC_DIR, REC_SKIP, REC_INTRA, REC_IMODE,
       REC_MV0Y, REC_MV0X, REC_MV1Y, REC_MV1X, REC_REF0, REC_REF1, REC_C0,
       REC_PART = 15, REC_PU = 16, REC_N = 24 };

__global__ void emit_inter_kernel(InterGrids g, short* __restrict__ out) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= g.h4 * g.w4) return;
  int iy = q / g.w4, ix = q % g.w4;
  auto in = [&](int k, int y, int x) { return y < g.ny[k] && x < g.nx[k]; };
  auto split = [&](const unsigned char* f, int k, int y, int x) {
    return f && in(k, y, x) && f[y * g.nx[k] + x];
  };
  // leaf / descend of the 64 level; active = descended into, or border
  auto desc64 = [&](int y, int x) { return split(g.split64, 3, y, x); };
  auto active32 = [&](int y, int x) {
    bool border = y >= 2 * g.ny[3] || x >= 2 * g.nx[3];
    return in(2, y, x) && (desc64(y >> 1, x >> 1) || border);
  };
  auto desc32 = [&](int y, int x) {
    return active32(y, x) && split(g.split32, 2, y, x);
  };
  auto active16 = [&](int y, int x) {
    bool border = y >= 2 * g.ny[2] || x >= 2 * g.nx[2];
    return in(1, y, x) && (desc32(y >> 1, x >> 1) || border);
  };
  auto leaf8 = [&](int y, int x) {
    bool border = y >= 2 * g.ny[1] || x >= 2 * g.nx[1];
    bool desc16 = active16(y >> 1, x >> 1) && split(g.split16, 1, y >> 1, x >> 1);
    return in(0, y, x) && (desc16 || border);
  };
  int ys[4] = {iy >> 1, iy >> 2, iy >> 3, iy >> 4};
  int xs[4] = {ix >> 1, ix >> 2, ix >> 3, ix >> 4};
  bool m[4];
  m[3] = in(3, ys[3], xs[3]) && !desc64(ys[3], xs[3]);
  m[2] = active32(ys[2], xs[2]) && !split(g.split32, 2, ys[2], xs[2]);
  m[1] = active16(ys[1], xs[1]) && !split(g.split16, 1, ys[1], xs[1]);
  m[0] = leaf8(ys[0], xs[0]);
  int k = m[3] ? 3 : m[2] ? 2 : m[1] ? 1 : m[0] ? 0 : -1;
  const int* r = k >= 0 && g.rec[k] ? g.rec[k] + (size_t)(ys[k] * g.nx[k] + xs[k]) * REC_N
                                    : nullptr;
  auto f = [&](int field, int dflt) { return r ? r[field] : dflt; };
  int intra = k == 3 ? 0 : f(REC_INTRA, 0);
  int cov = k >= 0 ? 1 : 0;
  int ch[24];
  ch[0] = k >= 0 ? 3 - k : -1;
  ch[1] = cov | (intra << 1) | (f(REC_SKIP, 0) << 2);
  ch[2] = f(REC_KIND, 0);
  ch[3] = f(REC_MSRC, 0);
  ch[4] = f(REC_DIR, 1);
  ch[5] = f(REC_MV0X, 0);
  ch[6] = f(REC_MV0Y, 0);
  ch[7] = f(REC_MV1X, 0);
  ch[8] = f(REC_MV1Y, 0);
  ch[9] = f(REC_REF0, -1);
  ch[10] = f(REC_REF1, -1);
  ch[11] = f(REC_IMODE, 0);
  for (int c = 0; c < 3; ++c) ch[12 + c] = k == 3 ? -1 : f(REC_C0 + c, -1);
  ch[15] = f(REC_PART, 0);
  for (int c = 0; c < 8; ++c) ch[16 + c] = f(REC_PU + c, 0);
  size_t plane = (size_t)g.h4 * g.w4;
  for (int c = 0; c < 24; ++c) out[c * plane + q] = (short)ch[c];
}

static unsigned blocks_for(long long n) { return (unsigned)((n + 255) / 256); }

}  // namespace hm

extern "C" int hm_chroma_modes5(const int* dm, int n, int b0, int b1, int b2,
                                int b3, int* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  hm::chroma_modes5_kernel<<<hm::blocks_for(n), 256, 0, (cudaStream_t)stream>>>(
      dm, n, make_int4(b0, b1, b2, b3), out);
  return (int)cudaGetLastError();
}

extern "C" int hm_chroma_fold(const float* d_cb, const float* b_cb,
                              const float* d_cr, const float* b_cr,
                              const float* cost_in, const float* mode_bits,
                              int n, float lam, float cw, float* cost_out,
                              float* add_out, int* cmode_out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  hm::chroma_fold_kernel<<<hm::blocks_for(n), 256, 0, (cudaStream_t)stream>>>(
      d_cb, b_cb, d_cr, b_cr, cost_in, mode_bits, n, lam, cw, cost_out,
      add_out, cmode_out);
  return (int)cudaGetLastError();
}

extern "C" int hm_mode64(const int* satd32, int nbx32, int nby64, int nbx64,
                         int* mode64, int* pm64, void* stream) {
  if (nby64 <= 0 || nbx64 <= 0) return (int)cudaErrorInvalidValue;
  hm::mode64_kernel<<<hm::blocks_for((long long)nby64 * nbx64), 256, 0,
                      (cudaStream_t)stream>>>(satd32, nbx32, nby64, nbx64,
                                              mode64, pm64);
  return (int)cudaGetLastError();
}

extern "C" int hm_cost64(const float* d64, const float* b64,
                         const float* chroma_add32, int nbx32, int nby64,
                         int nbx64, float lam, float ovh_bits, float* cost64,
                         void* stream) {
  if (nby64 <= 0 || nbx64 <= 0) return (int)cudaErrorInvalidValue;
  hm::cost64_kernel<<<hm::blocks_for((long long)nby64 * nbx64), 256, 0,
                      (cudaStream_t)stream>>>(d64, b64, chroma_add32, nbx32,
                                              nby64, nbx64, lam, ovh_bits,
                                              cost64);
  return (int)cudaGetLastError();
}

extern "C" int hm_dp_level(const float* child, int wc, const float* parent,
                           int hp, int wp, float lam, float ovh_bits,
                           int mode, unsigned char* flag, float* cost_out,
                           void* stream) {
  if (hp <= 0 || wp <= 0) return (int)cudaErrorInvalidValue;
  hm::dp_level_kernel<<<hm::blocks_for((long long)hp * wp), 256, 0,
                        (cudaStream_t)stream>>>(child, wc, parent, hp, wp,
                                                lam, ovh_bits, mode, flag,
                                                cost_out);
  return (int)cudaGetLastError();
}

extern "C" int hm_emit_plan(const hm::PlanGrids* g, signed char* out,
                            void* stream) {
  if (g->h4 <= 0 || g->w4 <= 0) return (int)cudaErrorInvalidValue;
  hm::emit_kernel<<<hm::blocks_for((long long)g->h4 * g->w4), 256, 0,
                    (cudaStream_t)stream>>>(*g, out);
  return (int)cudaGetLastError();
}

extern "C" int hm_emit_inter_plan(const hm::InterGrids* g, short* out,
                                  void* stream) {
  if (g->h4 <= 0 || g->w4 <= 0) return (int)cudaErrorInvalidValue;
  hm::emit_inter_kernel<<<hm::blocks_for((long long)g->h4 * g->w4), 256, 0,
                          (cudaStream_t)stream>>>(*g, out);
  return (int)cudaGetLastError();
}

// the argument structs' sizes, checked against their ctypes mirrors
extern "C" size_t hm_sizeof_plan_grids() { return sizeof(hm::PlanGrids); }
extern "C" size_t hm_sizeof_inter_grids() { return sizeof(hm::InterGrids); }

// K7 inter_uni and K8 inter_cu_rd: the per-CU pricing of the P-picture
// plan.
//
// K7 replaces `_frac_refine` and `_gather_pred` (hm16_2_tpu/encode/
// inter_plan.py:340-398) and the per-list best reference (:498-548, rect
// PUs :822-873): 49 quarter-pel SATDs + lams * MVD bins around each
// (reference, block)'s integer MV, read from the 16 phase planes; then, per
// block, the list entry with the least SATD + lams * (MVD + reference +
// direction bins), entries past nref masked.  The refinement takes an
// optional reference index per block, so the B-slice refinement
// (`_frac_refine_any`, :401) can reuse it.
//
// K8 replaces the rest of `_plan_device`'s per-size body (:553-934): the P
// merge set (left and above neighbours' list winners, the prior, zero),
// merge against uni-prediction, the residual trial of the winner (one TU
// for s <= 32, four 32x32 TUs at 64) and its zero-residual alternative,
// the 2NxN / Nx2N shapes with their composite prediction and trial, and the
// comparison with the intra alternative (K2's cost).  It writes one record
// of REC_FIELDS and one cost per CU.
//
// What bounds them: integer ALU work.  K7 does 49 8x8 Hadamards per
// (reference, 8x8 tile); K8 four candidate SATDs and up to three transform
// trials per CU.  Design, simple first: K7 is one CTA per (block,
// reference) with one 8x8 tile of one candidate per thread and integer
// atomics into 49 shared sums; K8 is one CTA per CU reading the
// neighbours' K7 results from global memory, with the trial's transforms
// in shared memory (intra_common.cuh's chain, one TU at a time).  Float
// steps follow XLA:CPU's rounding of the reference program (file built with
// --fmad=false): fused multiply-adds where XLA fuses (`__fmaf_rn`), a
// separately rounded scalar product in the merge and intra-extra costs;
// argmins keep the lowest index, the merge update is a strict <.
#include "intra_common.cuh"

namespace hm {

constexpr int kMargin = 80;
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// phase plane and top-left sample of a quarter-pel MV for the block at
// (y, x): plane index into the stacked (R*16, Hp, Wp) planes
struct PredAt {
  const short* plane;
  int y, x, stride;
  __device__ int at(int i, int j) const { return plane[(size_t)(y + i) * stride + x + j]; }
};

__device__ __forceinline__ PredAt pred_at(const short* sub, int Hp, int Wp,
                                          int uref, int mvy, int mvx, int y,
                                          int x) {
  int ph = uref * 16 + (mvy & 3) * 4 + (mvx & 3);
  return PredAt{sub + (size_t)ph * Hp * Wp, y + (mvy >> 2) + kMargin,
                x + (mvx >> 2) + kMargin, Wp};
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// grid (N, Rb): block n of batch entry rb; its reference is uref[n] when
// given, else rb.  mv_int / pred4: (Rb, N, 2) full-pel MV / quarter-pel
// MVD anchor; target: (N, bh, bw) int32 when given, else the current plane.
__global__ void frac_refine_kernel(const short* __restrict__ sub, int Hp,
                                   int Wp, const int* __restrict__ cur, int w,
                                   const int* __restrict__ target, int bh,
                                   int bw, int Nx,
                                   const int* __restrict__ mv_int,
                                   const int* __restrict__ pred4,
                                   const int* __restrict__ uref, float lam,
                                   int* __restrict__ mv4,
                                   float* __restrict__ satd_out) {
  __shared__ int satd[49];
  int n = blockIdx.x, N = gridDim.x;
  size_t e = (size_t)blockIdx.y * N + n;
  int ref = uref ? uref[n] : blockIdx.y;
  for (int q = threadIdx.x; q < 49; q += blockDim.x) satd[q] = 0;
  __syncthreads();
  int by = (n / Nx) * bh, bx = (n % Nx) * bw;
  int my = mv_int[e * 2], mx = mv_int[e * 2 + 1];
  int tw = bw / 8, ntiles = (bh / 8) * tw;
  for (int t = threadIdx.x; t < 49 * ntiles; t += blockDim.x) {
    int k = t / ntiles, tile = t % ntiles;
    int qy = k / 7 - 3, qx = k % 7 - 3;
    PredAt p = pred_at(sub, Hp, Wp, ref, 4 * my + qy, 4 * mx + qx, by, bx);
    int ty = (tile / tw) * 8, tx = (tile % tw) * 8;
    int v[64];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int o = target ? target[((size_t)n * bh + ty + i) * bw + tx + j]
                       : cur[(size_t)(by + ty + i) * w + bx + tx + j];
        v[i * 8 + j] = o - p.at(ty + i, tx + j);
      }
    atomicAdd(&satd[k], satd8x8(v));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int ay = pred4[e * 2], ax = pred4[e * 2 + 1];
    int best = 0;
    float best_v = 0.f;
    for (int k = 0; k < 49; ++k) {
      int m4y = 4 * my + k / 7 - 3, m4x = 4 * mx + k % 7 - 3;
      float c = __fmaf_rn(lam, mvd_bits(m4x - ax, m4y - ay),
                          __int2float_rn(satd[k]));
      if (k == 0 || c < best_v) { best = k; best_v = c; }
    }
    mv4[e * 2] = 4 * my + best / 7 - 3;
    mv4[e * 2 + 1] = 4 * mx + best % 7 - 3;
    satd_out[e] = __int2float_rn(satd[best]);
  }
}

__global__ void uni_select_kernel(const int* __restrict__ mvq,
                                  const float* __restrict__ satd,
                                  const int* __restrict__ pred4,
                                  const int* __restrict__ lmap, int mr,
                                  int nref, int N, float lam,
                                  int* __restrict__ ridx,
                                  int* __restrict__ uref,
                                  int* __restrict__ mv,
                                  float* __restrict__ satd_o,
                                  float* __restrict__ bits_o,
                                  float* __restrict__ cost_o,
                                  int* __restrict__ anchor) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int best = 0;
  float best_c = 0.f, best_b = 0.f;
  for (int i = 0; i < mr; ++i) {
    size_t e = (size_t)lmap[i] * N + n;
    float mb = mvd_bits(mvq[e * 2 + 1] - pred4[e * 2 + 1],
                        mvq[e * 2] - pred4[e * 2]);
    int rb = nref > 1 ? min(i + 1, nref - 1) : 0;
    float bits = __fadd_rn(__fadd_rn(mb, __int2float_rn(rb)), 4.0f);
    float c = i < nref ? __fmaf_rn(lam, bits, satd[e]) : inf_f();
    if (i == 0 || c < best_c) { best = i; best_c = c; best_b = bits; }
  }
  size_t e = (size_t)lmap[best] * N + n;
  ridx[n] = best;
  uref[n] = lmap[best];
  mv[n * 2] = mvq[e * 2];
  mv[n * 2 + 1] = mvq[e * 2 + 1];
  satd_o[n] = satd[e];
  bits_o[n] = best_b;
  cost_o[n] = best_c;
  anchor[n * 2] = pred4[e * 2];
  anchor[n * 2 + 1] = pred4[e * 2 + 1];
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

struct UniRes {                  // uni_select's outputs for one CU shape
  const int *mv, *uref, *ridx;
  const float *bits, *cost;
};

struct CuRdArgs {
  const int* cur;
  int h, w;
  const short* sub;
  int Hp, Wp;
  int nx;
  UniRes uni;                    // squares of size s
  const int* tmvp4;              // (N, 2) prior on list 0's first entry
  int ref0;
  UniRes rect[2];                // 2NxN, Nx2N PUs (has_rect)
  int has_rect;
  const int *i_mode, *i_top3;    // intra alternative (has_intra)
  const float* i_cost;
  int has_intra;
  float lamf, lams;
  int nmerge;
  TqParams tq;                   // the TU chain (T = min(s, 32)), offset 85
  const int* tm;                 // DCT of size T
  const float* model;
  int* rec;                      // (N, 24)
  float* cost;                   // (N,)
};

// a motion hypothesis covering the CU: one (uref, mv) per half (equal
// halves for a 2Nx2N prediction); part 1 splits rows, part 2 columns
struct Hyp {
  int part, uref[2], mvy[2], mvx[2];
};

template <int S>
__device__ __forceinline__ int hyp_pred(const CuRdArgs& a, const Hyp& hp,
                                        int y0, int x0, int i, int j) {
  int k = hp.part == 1 ? (i >= S / 2) : hp.part == 2 ? (j >= S / 2) : 0;
  PredAt p = pred_at(a.sub, a.Hp, a.Wp, hp.uref[k], hp.mvy[k], hp.mvx[k],
                     y0, x0);
  return p.at(i, j);
}

template <int S>
__device__ int cu_satd(const CuRdArgs& a, const Hyp& hp, int y0, int x0,
                       int* acc) {
  constexpr int T = S / 8, NT = T * T;
  if (threadIdx.x == 0) *acc = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < NT; t += blockDim.x) {
    int ty = (t / T) * 8, tx = (t % T) * 8;
    int v[64];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[i * 8 + j] = a.cur[(size_t)(y0 + ty + i) * a.w + x0 + tx + j] -
                       hyp_pred<S>(a, hp, y0, x0, ty + i, tx + j);
    atomicAdd(acc, satd8x8(v));
  }
  __syncthreads();
  int r = *acc;
  __syncthreads();
  return r;
}

// residual trial of a CU hypothesis: (sse_rec, bits, sse_zero) on thread 0
template <int S>
__device__ void cu_trial(const CuRdArgs& a, const Hyp& hp, int y0, int x0,
                         BlockSmem<(S < 32 ? S : 32), 1>& sm,
                         unsigned int* zacc, float* sr, float* br,
                         float* sz) {
  constexpr int T = S < 32 ? S : 32, NTU = (S / T) * (S / T);
  const int maxv = a.tq.maxv;
  if (threadIdx.x == 0) *zacc = 0;
  __syncthreads();
  float bits = 0.f;
  unsigned int rec_sse = 0;
  for (int tu = 0; tu < NTU; ++tu) {
    int ty = (tu / (S / T)) * T, tx = (tu % (S / T)) * T;
    for (int q = threadIdx.x; q < T * T; q += blockDim.x) {
      int i = ty + q / T, j = tx + q % T;
      int o = a.cur[(size_t)(y0 + i) * a.w + x0 + j];
      int p = hyp_pred<S>(a, hp, y0, x0, i, j);
      sm.orig[0][q] = o;
      sm.pred[0][q] = p;
      sm.wa[0][q] = o - p;
      int dz = o - clampi(p, 0, maxv);
      atomicAdd(zacc, (unsigned int)(dz * dz));
    }
    __syncthreads();
    transform_chain<T, 1>(sm, a.tq);
    if (threadIdx.x == 0) {
      float b = take_bits<T, 1>(sm, 0, a.model);
      bits = tu == 0 ? b : __fadd_rn(bits, b);
      rec_sse += sm.dist[0];
      sm.dist[0] = 0;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *sr = __int2float_rn((int)rec_sse);
    *br = bits;
    *sz = __int2float_rn((int)*zacc);
  }
  __syncthreads();
}

template <int S>
__global__ void __launch_bounds__(kThreads) cu_rd_kernel(CuRdArgs a) {
  constexpr int T = S < 32 ? S : 32;
  __shared__ BlockSmem<T, 1> sm;
  __shared__ int sacc;
  __shared__ unsigned int zacc;
  __shared__ float t_sr, t_br, t_sz;
  const int n = blockIdx.x, N = gridDim.x;
  const int ci = n / a.nx, cj = n % a.nx, y0 = ci * S, x0 = cj * S;
  for (int q = threadIdx.x; q < T * T; q += blockDim.x) sm.tm[q] = a.tm[q];
  if (threadIdx.x == 0) {
    sm.dist[0] = 0;
    sm.nnz[0] = sm.gt1[0] = sm.esc[0] = 0;
    sm.last_x[0] = sm.last_y[0] = -1;
  }
  __syncthreads();

  // ---- merge set: left, above, prior, zero; strict < keeps the first ----
  float m_cost = 0.f, m_bits = 0.f;
  int m_sel = 0;
  Hyp m_hyp{};
  int m_ridx = 0;
  for (int m = 0; m < 4; ++m) {
    Hyp hp{};
    int ridx = 0;
    bool invalid = false;
    if (m < 2) {
      int nb = m == 0 ? (cj > 0 ? n - 1 : n + a.nx - 1)
                      : (ci > 0 ? n - a.nx : n + (N - a.nx));
      invalid = m == 0 ? cj == 0 : ci == 0;
      hp.uref[0] = a.uni.uref[nb];
      hp.mvy[0] = a.uni.mv[nb * 2];
      hp.mvx[0] = a.uni.mv[nb * 2 + 1];
      ridx = a.uni.ridx[nb];
    } else {
      hp.uref[0] = a.ref0;
      hp.mvy[0] = m == 2 ? a.tmvp4[n * 2] : 0;
      hp.mvx[0] = m == 2 ? a.tmvp4[n * 2 + 1] : 0;
    }
    int satd = cu_satd<S>(a, hp, y0, x0, &sacc);
    float bits = __fadd_rn(__int2float_rn(min(m + 1, a.nmerge - 1) + 1), 1.0f);
    float c = __fadd_rn(__fadd_rn(__int2float_rn(satd), __fmul_rn(a.lams, bits)),
                        invalid ? inf_f() : 0.f);
    if (m == 0 || c < m_cost) {
      m_cost = c; m_bits = bits; m_sel = m; m_hyp = hp; m_ridx = ridx;
    }
  }

  // ---- kind: uni-L0 only when strictly cheaper ----
  bool use_uni = a.uni.cost[n] < m_cost;
  Hyp best = m_hyp;
  int ref0c = m_ridx;
  float bits_motion = m_bits;
  if (use_uni) {
    best.uref[0] = a.uni.uref[n];
    best.mvy[0] = a.uni.mv[n * 2];
    best.mvx[0] = a.uni.mv[n * 2 + 1];
    ref0c = a.uni.ridx[n];
    bits_motion = a.uni.bits[n];
  }
  best.part = 0;
  cu_trial<S>(a, best, y0, x0, sm, &zacc, &t_sr, &t_br, &t_sz);
  float cost_coded = __fmaf_rn(a.lamf, __fadd_rn(__fadd_rn(t_br, bits_motion), 2.0f), t_sr);
  float bits_zero = __fsub_rn(__fadd_rn(bits_motion, use_uni ? 1.0f : 0.0f), 0.0f);
  float cost_zero = __fmaf_rn(a.lamf, bits_zero, t_sz);
  bool skip = cost_zero <= cost_coded;
  float inter = fminf(cost_coded, cost_zero);

  // ---- 2NxN / Nx2N ----
  int part_ch = 0;
  int pu[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (a.has_rect) {
    float rc[2];
    int pus[2][8];
    for (int pi = 0; pi < 2; ++pi) {
      const UniRes& e = a.rect[pi];
      int k0, k1;
      if (pi == 0) { k0 = (2 * ci) * a.nx + cj; k1 = k0 + a.nx; }
      else { k0 = ci * 2 * a.nx + 2 * cj; k1 = k0 + 1; }
      Hyp hp{};
      hp.part = pi + 1;
      int ks[2] = {k0, k1};
      for (int u = 0; u < 2; ++u) {
        hp.uref[u] = e.uref[ks[u]];
        hp.mvy[u] = e.mv[ks[u] * 2];
        hp.mvx[u] = e.mv[ks[u] * 2 + 1];
        pus[pi][u * 4] = 1;
        pus[pi][u * 4 + 1] = hp.mvy[u];
        pus[pi][u * 4 + 2] = hp.mvx[u];
        pus[pi][u * 4 + 3] = e.ridx[ks[u]];
      }
      float bits_cu = __fadd_rn(__fadd_rn(e.bits[k0], e.bits[k1]), 1.5f);
      cu_trial<S>(a, hp, y0, x0, sm, &zacc, &t_sr, &t_br, &t_sz);
      float cc = __fmaf_rn(a.lamf, __fadd_rn(__fadd_rn(t_br, bits_cu), 2.0f), t_sr);
      float cz = __fmaf_rn(a.lamf, __fadd_rn(bits_cu, 1.0f), t_sz);
      rc[pi] = fminf(cc, cz);
    }
    bool use_b = rc[1] < rc[0];
    float rect_cost = fminf(rc[0], rc[1]);
    part_ch = rect_cost < inter ? (use_b ? 2 : 1) : 0;
    for (int f = 0; f < 8; ++f) pu[f] = pus[use_b ? 1 : 0][f];
    inter = fminf(inter, rect_cost);
  }

  // ---- intra alternative ----
  int intra = 0, imode = 0, c3[3] = {0, 0, 0};
  float cu_cost = inter;
  if (a.has_intra) {
    float icost = __fadd_rn(a.i_cost[n], __fmul_rn(a.lamf, 3.0f));
    intra = icost < inter;
    imode = a.i_mode[n];
    for (int k = 0; k < 3; ++k) c3[k] = a.i_top3[n * 3 + k];
    cu_cost = fminf(inter, icost);
  }

  if (threadIdx.x == 0) {
    int* r = a.rec + (size_t)n * 24;
    int vals[24] = {use_uni ? 1 : 0, m_sel, 1, skip ? 1 : 0, intra, imode,
                    best.mvy[0], best.mvx[0], 0, 0, ref0c, -1,
                    c3[0], c3[1], c3[2], part_ch,
                    pu[0], pu[1], pu[2], pu[3], pu[4], pu[5], pu[6], pu[7]};
    for (int f = 0; f < 24; ++f) r[f] = vals[f];
    a.cost[n] = cu_cost;
  }
}

}  // namespace hm

extern "C" int hm_frac_refine(const short* sub, int Hp, int Wp, const int* cur,
                              int w, const int* target, int bh, int bw,
                              int Ny, int Nx, int Rb, const int* mv_int,
                              const int* pred4, const int* uref, float lam,
                              int* mv4, float* satd, void* stream) {
  if (Ny <= 0 || Nx <= 0 || Rb <= 0 || bh % 8 || bw % 8)
    return (int)cudaErrorInvalidValue;
  dim3 grid(Ny * Nx, Rb);
  hm::frac_refine_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      sub, Hp, Wp, cur, w, target, bh, bw, Nx, mv_int, pred4, uref, lam, mv4,
      satd);
  return (int)cudaGetLastError();
}

extern "C" int hm_uni_select(const int* mvq, const float* satd,
                             const int* pred4, const int* lmap, int mr,
                             int nref, int N, float lam, int* ridx, int* uref,
                             int* mv, float* satd_o, float* bits_o,
                             float* cost_o, int* anchor, void* stream) {
  if (N <= 0 || mr <= 0) return (int)cudaErrorInvalidValue;
  hm::uni_select_kernel<<<(N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      mvq, satd, pred4, lmap, mr, nref, N, lam, ridx, uref, mv, satd_o,
      bits_o, cost_o, anchor);
  return (int)cudaGetLastError();
}

extern "C" int hm_cu_rd(const hm::CuRdArgs* a, int s, int N, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (s) {
    case 8: hm::cu_rd_kernel<8><<<N, hm::kThreads, 0, st>>>(*a); break;
    case 16: hm::cu_rd_kernel<16><<<N, hm::kThreads, 0, st>>>(*a); break;
    case 32: hm::cu_rd_kernel<32><<<N, hm::kThreads, 0, st>>>(*a); break;
    case 64: hm::cu_rd_kernel<64><<<N, hm::kThreads, 0, st>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K7 inter_uni and K8 inter_cu_rd: the per-CU pricing of the P- and
// B-picture plans.
//
// K7 replaces `_frac_refine` and `_gather_pred` (hm16_2_tpu/encode/
// inter_plan.py:340-398) and the per-list best reference (:498-548, rect
// PUs :822-873): 49 quarter-pel SATDs + lams * MVD bins around each
// (reference, block)'s integer MV, read from the 16 phase planes; then, per
// block, the list entry with the least SATD + lams * (MVD + reference +
// direction bins), entries past nref masked.  Its per-block-reference mode
// (launch count `inter_bi_refine`) replaces `_frac_refine_any` (:401-433),
// one pass of the B plan's bi refinement: a quarter-pel start MV, one
// reference per block, and the bi target against the other list's
// prediction.
//
// K8 replaces the rest of `_plan_device`'s per-size body (:553-934).  P mode:
// the merge set (left and above neighbours' list winners, the prior, zero),
// merge against uni-prediction, the residual trial of the winner (one TU
// for s <= 32, four 32x32 TUs at 64) and its zero-residual alternative,
// the 2NxN / Nx2N shapes with their composite prediction and trial, and the
// comparison with the intra alternative (K2's cost).  B mode (launch count
// `inter_cu_rd_b`, the reference with is_b=True): six bi merge candidates
// (A1 / B1 / B0 / A0 rolls with edge masks, the priors, zero), the kinds
// merge / uni-L0 / uni-L1 / bi where bi is the list winners' average or the
// pair refined by K7 where strictly cheaper, and each rect PU from the
// cheaper list.  It writes one record of REC_FIELDS and one cost per CU.
//
// What bounds them: integer ALU work.  K7 does 49 8x8 Hadamards per
// (reference, 8x8 tile); K8 four (P) or eight (B) candidate SATDs and up to
// three transform trials per CU.  Design, simple first: K7 is one CTA per
// (block, reference) with one 8x8 tile of one candidate per thread and
// integer atomics into 49 shared sums; K8 is one CTA per CU reading the
// neighbours' K7 results from global memory, with the trial's transforms
// in shared memory (intra_common.cuh's chain, one TU at a time).  Float
// steps follow XLA:CPU's rounding of the reference programs (file built
// with --fmad=false): fused multiply-adds where XLA fuses (`__fmaf_rn`: the
// refinement, list-pick, bi and trial costs), a separately rounded scalar
// product in the merge and intra-extra costs; argmins keep the lowest
// index, the merge update is a strict <.
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
// given, else rb.  mv: (Rb, N, 2) full-pel MV, or, with qstart, a
// quarter-pel MV whose window centres on mv >> 2 (arithmetic: floors toward
// -inf); pred4: (Rb, N, 2) quarter-pel MVD anchor.  The block is matched
// against the current plane, or, when o_uref is given (the bi refinement),
// against the bi target 2 * orig - pred(o_uref[n], o_mv4[n]).
//
// The bi target is formed here from the other list's hypothesis, not
// materialised by the caller: a materialised target would be one (N, s, s)
// int32 tensor written and read back per pass plus a gather launch, while
// here it costs one more int16 read of the phase planes per sample (the
// same planes the candidates read, so mostly cache hits).  Its range is
// [-maxv, 2 * maxv] and a difference to a prediction [-2 * maxv, 2 * maxv]:
// int32 throughout.
__global__ void frac_refine_kernel(const short* __restrict__ sub, int Hp,
                                   int Wp, const int* __restrict__ cur, int w,
                                   int bh, int bw, int Nx,
                                   const int* __restrict__ mv, int qstart,
                                   const int* __restrict__ pred4,
                                   const int* __restrict__ uref,
                                   const int* __restrict__ o_uref,
                                   const int* __restrict__ o_mv4, float lam,
                                   int* __restrict__ mv4,
                                   float* __restrict__ satd_out) {
  __shared__ int satd[49];
  int n = blockIdx.x, N = gridDim.x;
  size_t e = (size_t)blockIdx.y * N + n;
  int ref = uref ? uref[n] : blockIdx.y;
  for (int q = threadIdx.x; q < 49; q += blockDim.x) satd[q] = 0;
  __syncthreads();
  int by = (n / Nx) * bh, bx = (n % Nx) * bw;
  int my = mv[e * 2], mx = mv[e * 2 + 1];
  if (qstart) {
    my >>= 2;
    mx >>= 2;
  }
  const bool bi = o_uref != nullptr;
  PredAt po{};
  if (bi) po = pred_at(sub, Hp, Wp, o_uref[n], o_mv4[n * 2], o_mv4[n * 2 + 1], by, bx);
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
        int o = cur[(size_t)(by + ty + i) * w + bx + tx + j];
        if (bi) o = 2 * o - po.at(ty + i, tx + j);
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
  UniRes uni;                    // list 0's squares of size s
  const int* tmvp4;              // (N, 2) prior on list 0's first entry
  int ref0;                      // list 0's first entry
  UniRes rect[2];                // list 0's 2NxN, Nx2N PUs (has_rect)
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
  // B mode only
  UniRes uni1;                   // list 1's squares
  const int* tmvp4_1;            // (N, 2) prior on list 1's first entry
  int ref1;                      // list 1's first entry
  UniRes rect1[2];               // list 1's rect PUs (has_rect)
  const int *anchor0, *anchor1;  // (N, 2) MVD anchors of the list winners
  const int *mvb0, *mvb1;        // (N, 2) bi-refined MVs (K7 refine-any)
  int nref0, nref1;              // live entries per list
};

// a motion hypothesis covering the CU.  bi: the average of hypotheses 0
// (list 0) and 1 (list 1) over the whole CU; else one (uref, mv) per half
// (equal halves for a 2Nx2N prediction), part 1 splitting rows, part 2
// columns
struct Hyp {
  int part, bi, uref[2], mvy[2], mvx[2];
};

template <int S>
__device__ __forceinline__ int hyp_pred(const CuRdArgs& a, const Hyp& hp,
                                        int y0, int x0, int i, int j) {
  if (hp.bi) {
    int p0 = pred_at(a.sub, a.Hp, a.Wp, hp.uref[0], hp.mvy[0], hp.mvx[0], y0, x0).at(i, j);
    int p1 = pred_at(a.sub, a.Hp, a.Wp, hp.uref[1], hp.mvy[1], hp.mvx[1], y0, x0).at(i, j);
    return (p0 + p1 + 1) >> 1;
  }
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

__device__ __forceinline__ void set_hyp(Hyp& hp, int l, const UniRes& u,
                                        int k) {
  hp.uref[l] = u.uref[k];
  hp.mvy[l] = u.mv[k * 2];
  hp.mvx[l] = u.mv[k * 2 + 1];
}

// reference-index bins of a list entry: min(ridx + 1, nref - 1), or 0 for
// a list with one live entry
__device__ __forceinline__ float ref_bits(int ridx, int nref) {
  return nref > 1 ? __int2float_rn(min(ridx + 1, nref - 1)) : 0.f;
}

// one CTA per CU of size S.  P mode (B false): the merge set is the left
// and above neighbours' list-0 winners, the prior, zero; the kinds merge and
// uni-L0.  B mode: six bi merge candidates (the A1 / B1 / B0 / A0
// neighbours' winners of both lists, the priors, zero), the kinds merge,
// uni-L0, uni-L1 and bi (the list winners' average, or the refined pair
// where strictly cheaper), and rect PUs from the cheaper list.
template <int S, bool B>
__global__ void __launch_bounds__(kThreads) cu_rd_kernel(CuRdArgs a) {
  constexpr int T = S < 32 ? S : 32;
  constexpr int NL = B ? 2 : 1;              // reference lists
  constexpr int NR = B ? 4 : 2;              // rolled neighbours
  __shared__ BlockSmem<T, 1> sm;
  __shared__ int sacc;
  __shared__ unsigned int zacc;
  __shared__ float t_sr, t_br, t_sz;
  const int n = blockIdx.x, N = gridDim.x;
  const int ny = N / a.nx;
  const int ci = n / a.nx, cj = n % a.nx, y0 = ci * S, x0 = cj * S;
  for (int q = threadIdx.x; q < T * T; q += blockDim.x) sm.tm[q] = a.tm[q];
  if (threadIdx.x == 0) {
    sm.dist[0] = 0;
    sm.nnz[0] = sm.gt1[0] = sm.esc[0] = 0;
    sm.last_x[0] = sm.last_y[0] = -1;
  }
  __syncthreads();

  // ---- merge set; strict < keeps the first ----
  const int roll_dy[4] = {0, 1, 1, -1}, roll_dx[4] = {1, 0, -1, 1};
  float m_cost = 0.f, m_bits = 0.f;
  int m_sel = 0, m_ridx[2] = {0, 0};
  Hyp m_hyp{};
  for (int m = 0; m < NR + 2; ++m) {
    Hyp hp{};
    hp.bi = B;
    int ridx[2] = {0, 0};
    bool invalid = false;
    if (m < NR) {
      // torch.roll / jnp.roll by (dy, dx): the CU reads the winner at
      // (ci - dy, cj - dx), wrapped; a wrapped read is invalid
      int dy = roll_dy[m], dx = roll_dx[m];
      int nb = ((ci - dy + ny) % ny) * a.nx + (cj - dx + a.nx) % a.nx;
      invalid = (dy > 0 && ci == 0) || (dy < 0 && ci == ny - 1) ||
                (dx > 0 && cj == 0) || (dx < 0 && cj == a.nx - 1);
      for (int l = 0; l < NL; ++l) {
        const UniRes& u = l ? a.uni1 : a.uni;
        set_hyp(hp, l, u, nb);
        ridx[l] = u.ridx[nb];
      }
    } else {
      bool prior = m == NR;
      hp.uref[0] = a.ref0;
      hp.mvy[0] = prior ? a.tmvp4[n * 2] : 0;
      hp.mvx[0] = prior ? a.tmvp4[n * 2 + 1] : 0;
      if (B) {
        hp.uref[1] = a.ref1;
        hp.mvy[1] = prior ? a.tmvp4_1[n * 2] : 0;
        hp.mvx[1] = prior ? a.tmvp4_1[n * 2 + 1] : 0;
      }
    }
    int satd = cu_satd<S>(a, hp, y0, x0, &sacc);
    float bits = __fadd_rn(__int2float_rn(min(m + 1, a.nmerge - 1) + 1), 1.0f);
    float c = __fadd_rn(__fadd_rn(__int2float_rn(satd), __fmul_rn(a.lams, bits)),
                        invalid ? inf_f() : 0.f);
    if (m == 0 || c < m_cost) {
      m_cost = c; m_bits = bits; m_sel = m; m_hyp = hp;
      m_ridx[0] = ridx[0];
      m_ridx[1] = ridx[1];
    }
  }

  // ---- kind: the first least of merge, uni-L0 (, uni-L1, bi) ----
  int kind = 0;
  float kcost = m_cost, bits_motion = m_bits;
  Hyp best = m_hyp;
  int mv0y = m_hyp.mvy[0], mv0x = m_hyp.mvx[0], mv1y = 0, mv1x = 0;
  int ref0c = m_ridx[0], ref1c = -1, dirv = B ? 3 : 1;
  if (B) {
    mv1y = m_hyp.mvy[1];
    mv1x = m_hyp.mvx[1];
    ref1c = m_ridx[1];
  }
  if (a.uni.cost[n] < kcost) {
    kind = 1; kcost = a.uni.cost[n]; bits_motion = a.uni.bits[n];
    best = Hyp{};
    set_hyp(best, 0, a.uni, n);
    mv0y = best.mvy[0]; mv0x = best.mvx[0]; mv1y = mv1x = 0;
    ref0c = a.uni.ridx[n]; ref1c = -1; dirv = 1;
  }
  if (B) {
    if (a.uni1.cost[n] < kcost) {
      kind = 2; kcost = a.uni1.cost[n]; bits_motion = a.uni1.bits[n];
      best = Hyp{};
      set_hyp(best, 0, a.uni1, n);
      mv0y = mv0x = 0; mv1y = best.mvy[0]; mv1x = best.mvx[0];
      ref0c = -1; ref1c = a.uni1.ridx[n]; dirv = 2;
    }
    // bi from the two list winners, and from the refined pair
    Hyp hb{};
    hb.bi = 1;
    set_hyp(hb, 0, a.uni, n);
    set_hyp(hb, 1, a.uni1, n);
    float bb = __fadd_rn(__fadd_rn(a.uni.bits[n], a.uni1.bits[n]), -2.0f);
    float cb = __fmaf_rn(a.lams, bb, __int2float_rn(cu_satd<S>(a, hb, y0, x0, &sacc)));
    Hyp hi = hb;
    hi.mvy[0] = a.mvb0[n * 2]; hi.mvx[0] = a.mvb0[n * 2 + 1];
    hi.mvy[1] = a.mvb1[n * 2]; hi.mvx[1] = a.mvb1[n * 2 + 1];
    float mb = __fadd_rn(
        mvd_bits(hi.mvx[0] - a.anchor0[n * 2 + 1], hi.mvy[0] - a.anchor0[n * 2]),
        mvd_bits(hi.mvx[1] - a.anchor1[n * 2 + 1], hi.mvy[1] - a.anchor1[n * 2]));
    float bi_it = __fadd_rn(__fadd_rn(__fadd_rn(mb, ref_bits(a.uni.ridx[n], a.nref0)),
                                      ref_bits(a.uni1.ridx[n], a.nref1)), 6.0f);
    float ci_ = __fmaf_rn(a.lams, bi_it, __int2float_rn(cu_satd<S>(a, hi, y0, x0, &sacc)));
    bool it = ci_ < cb;
    if ((it ? ci_ : cb) < kcost) {
      kind = 3; bits_motion = it ? bi_it : bb;
      best = it ? hi : hb;
      mv0y = best.mvy[0]; mv0x = best.mvx[0];
      mv1y = best.mvy[1]; mv1x = best.mvx[1];
      ref0c = a.uni.ridx[n]; ref1c = a.uni1.ridx[n]; dirv = 3;
    }
  }
  best.part = 0;
  const bool is_merge = kind == 0;
  cu_trial<S>(a, best, y0, x0, sm, &zacc, &t_sr, &t_br, &t_sz);
  float cost_coded = __fmaf_rn(a.lamf, __fadd_rn(__fadd_rn(t_br, bits_motion), 2.0f), t_sr);
  float bits_zero = __fsub_rn(__fadd_rn(bits_motion, is_merge ? 0.0f : 1.0f), 0.0f);
  float cost_zero = __fmaf_rn(a.lamf, bits_zero, t_sz);
  bool skip = cost_zero <= cost_coded;
  float inter = fminf(cost_coded, cost_zero);

  // ---- 2NxN / Nx2N; in B mode each PU takes list 1 where strictly
  // cheaper ----
  int part_ch = 0;
  int pu[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (a.has_rect) {
    float rc[2];
    int pus[2][8];
    for (int pi = 0; pi < 2; ++pi) {
      int k0, k1;
      if (pi == 0) { k0 = (2 * ci) * a.nx + cj; k1 = k0 + a.nx; }
      else { k0 = ci * 2 * a.nx + 2 * cj; k1 = k0 + 1; }
      Hyp hp{};
      hp.part = pi + 1;
      int ks[2] = {k0, k1};
      float pb[2];
      for (int u = 0; u < 2; ++u) {
        int k = ks[u];
        bool use1 = B && a.rect1[pi].cost[k] < a.rect[pi].cost[k];
        const UniRes& e = use1 ? a.rect1[pi] : a.rect[pi];
        set_hyp(hp, u, e, k);
        pb[u] = e.bits[k];
        pus[pi][u * 4] = use1 ? 2 : 1;
        pus[pi][u * 4 + 1] = hp.mvy[u];
        pus[pi][u * 4 + 2] = hp.mvx[u];
        pus[pi][u * 4 + 3] = e.ridx[k];
      }
      float bits_cu = __fadd_rn(__fadd_rn(pb[0], pb[1]), 1.5f);
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
    int vals[24] = {kind, m_sel, dirv, skip ? 1 : 0, intra, imode,
                    mv0y, mv0x, mv1y, mv1x, ref0c, ref1c,
                    c3[0], c3[1], c3[2], part_ch,
                    pu[0], pu[1], pu[2], pu[3], pu[4], pu[5], pu[6], pu[7]};
    for (int f = 0; f < 24; ++f) r[f] = vals[f];
    a.cost[n] = cu_cost;
  }
}

}  // namespace hm

extern "C" int hm_frac_refine(const short* sub, int Hp, int Wp, const int* cur,
                              int w, int bh, int bw, int Ny, int Nx, int Rb,
                              const int* mv, int qstart, const int* pred4,
                              const int* uref, const int* o_uref,
                              const int* o_mv4, float lam, int* mv4,
                              float* satd, void* stream) {
  if (Ny <= 0 || Nx <= 0 || Rb <= 0 || bh % 8 || bw % 8 ||
      (o_uref && (!uref || !o_mv4)))
    return (int)cudaErrorInvalidValue;
  dim3 grid(Ny * Nx, Rb);
  hm::frac_refine_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      sub, Hp, Wp, cur, w, bh, bw, Nx, mv, qstart, pred4, uref, o_uref, o_mv4,
      lam, mv4, satd);
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

template <bool B>
static int launch_cu_rd(const hm::CuRdArgs* a, int s, int N, cudaStream_t st) {
  switch (s) {
    case 8: hm::cu_rd_kernel<8, B><<<N, hm::kThreads, 0, st>>>(*a); break;
    case 16: hm::cu_rd_kernel<16, B><<<N, hm::kThreads, 0, st>>>(*a); break;
    case 32: hm::cu_rd_kernel<32, B><<<N, hm::kThreads, 0, st>>>(*a); break;
    case 64: hm::cu_rd_kernel<64, B><<<N, hm::kThreads, 0, st>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// is_b selects the B mode (list 1, bi, six merge candidates)
extern "C" int hm_cu_rd(const hm::CuRdArgs* a, int s, int N, int is_b,
                        void* stream) {
  if (N <= 0 || a->nx <= 0 || N % a->nx) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_b ? launch_cu_rd<true>(a, s, N, st) : launch_cu_rd<false>(a, s, N, st);
}

// the argument structs' sizes, checked against their ctypes mirrors
extern "C" size_t hm_sizeof_cu_rd_args() { return sizeof(hm::CuRdArgs); }
extern "C" size_t hm_sizeof_uni_res() { return sizeof(hm::UniRes); }

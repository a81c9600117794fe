// K7 inter_uni and K8 inter_cu_rd: the per-CU pricing of the P- and
// B-picture plans.
//
// K7 replaces `_frac_refine` and `_gather_pred` (hm16_2_tpu/encode/
// inter_plan.py:340-398) and the per-list best reference (:498-548, rect
// PUs :822-873): 49 quarter-pel SATDs + lams * MVD bins around each
// (reference, block)'s integer MV, read from the 16 phase planes; then, per
// block, the list entry with the least SATD + lams * (MVD + reference +
// direction bins), entries past nref masked: every (size, shape, list) of a
// picture in one launch (launch count `inter_pick`), since each pick is a
// thread's argmin over at most four entries and the host's enqueue of one
// launch per entry cost ~25x their device time.  Its per-block-reference mode
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
// What bounds them on the H100.  K7 does 49 8x8 Hadamards (~600 int32
// operations each) per (reference, 8x8 tile) and reads, per block, a
// (16, bh + 1, bw + 1) window of phase planes (20x the samples of an 8x8
// block, 4x those of a 64x64).  K7 once read each candidate's 64 target
// and 64 prediction samples from global memory with a row stride (and
// re-formed the bi target for every candidate), and left 79 of 128 threads
// idle on an 8x8 block.  Now a CTA of 8 x 49 threads stages, per block,
// the one window that holds all 49 candidates and the int32 target, formed
// once, in shared memory (172 KB for 64x64, opted in as dynamic shared
// memory).  The window moves as the aligned 16-byte chunks that hold its
// rows, by asynchronous copies (cp.async), so that all of a CTA's bytes
// are in flight at once and no register holds them.  A thread owns one
// candidate and 1-8 of its tiles and sums their SATDs in a register; small
// blocks pack eight (8x8) to two (16x16) to a CTA; a warp per block takes
// the 49-way argmin.
//
// K8 prices four (P) or eight (B: six merge, two bi) hypotheses per CU and
// runs up to three transform trials (the winner's, the two rect shapes'),
// each one to four TUs: latency-bound per-CU chains of int32 work.  Its
// first design was one CTA of 256 threads per CU: one thread per 8x8 tile
// summed each SATD (1 of 256 busy at s = 8, 64 at s = 64) from predictions
// gathered out of global memory, the candidates one after another with two
// barriers each, and the trials one TU at a time through intra_common.cuh's
// chain, which counts its statistics with a shared-memory atomic per
// coefficient and per sample.  Now a CTA takes 32 (s = 8), 8, 2 or 1 (s =
// 64, 512 threads) CUs and runs each stage over all of them at once: the
// blocks staged once by cp.async; every hypothesis's prediction staged as
// int16 in shared memory by coalesced row reads; the (hypothesis, 8x8
// tile) SATDs spread over the threads and summed in registers and warp
// shuffles; a thread per CU walks the finished costs in the reference's
// order; then every TU of every trial (a trial unit) goes through the four
// transform stages together, each stage a shared-memory matrix product
// whose threads own a column and 2-4 rows (16-byte loads of the row
// operand, the column operand across the lanes: D is kept beside its
// transpose so that no stage reads a column with a stride), and the level
// statistics and SSEs are warp reductions (__reduce_add/max_sync), one
// partial per warp and unit.  A thread per trial then sums its TUs' bits in
// TU order.  The transforms stay on the int32 pipes: stage-2 inputs of up
// to 16 bits do not fit the tensor cores' fp16 or int8 operands exactly.
// Float steps follow XLA:CPU's rounding of the reference programs
// (file built with --fmad=false): fused multiply-adds where XLA fuses
// (`__fmaf_rn`: the refinement, list-pick, bi and trial costs) over
// __int2float_rn of the integer SATD sums (any order: integers), a
// separately rounded scalar product in the merge and intra-extra costs;
// argmins keep the lowest index (K7's warp argmin compares (cost, index)
// pairs), the merge update and the kind picks are a strict <.
//
// Resources (ptxas -v, printed by chip_smoke.py with each kernel's dynamic
// shared memory): K8 85 registers at s = 8, 88 at 16-64, no spills; 40,192
// (s = 8) to 152,704 (s = 64) bytes of shared memory per CTA, opted in.
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

// The CTA: frac_blocks(ntiles) blocks, each 49 candidates x frac_tpc(ntiles)
// threads (8 x 49 threads in all); a thread sums the SATDs of the tiles
// tpc apart of one candidate.
__host__ __device__ constexpr int frac_tpc(int ntiles) {
  return ntiles < 8 ? ntiles : 8;
}
__host__ __device__ constexpr int frac_blocks(int ntiles) {
  return 8 / frac_tpc(ntiles);
}
constexpr int kFracThreads = 8 * 49;

// shared memory of one CTA in bytes: the windows, each row the 16-byte
// aligned chunks that hold its bw + 1 samples; the int32 targets; the rows'
// first samples in the windows; the per-thread sums, the 49 SATDs and costs
// per block; the blocks' (reference, my, mx, anchor y, anchor x)
__host__ __device__ inline size_t frac_smem_bytes(int bh, int bw) {
  size_t nt = (bh / 8) * (bw / 8), nb = frac_blocks(nt);
  size_t rows = nb * 16 * (bh + 1), nch = bw / 8 + 1;
  return 16 * rows * nch +
         sizeof(int) * (nb * bh * bw + rows + nb * 49 * frac_tpc(nt) +
                        nb * 49 * 2 + nb * 5);
}

// blocks e = rb * N + n: block n of batch entry rb; its reference is
// uref[n] when given, else rb.  mv: (Rb, N, 2) full-pel MV, or, with
// qstart, a quarter-pel MV whose window centres on mv >> 2 (arithmetic:
// floors toward -inf); pred4: (Rb, N, 2) quarter-pel MVD anchor.  The block
// is matched against the current plane, or, when o_uref is given (the bi
// refinement), against the bi target 2 * orig - pred(o_uref[n], o_mv4[n]).
// bh, bw: powers of two from 8 to 64.
//
// The 49 candidates 4 * mv + (qy, qx), qy, qx in -3..3, read the phase
// plane (qy & 3, qx & 3) at the integer offset (qy >> 2, qx >> 2) in
// {-1, 0}: all of them lie in the (16, bh + 1, bw + 1) window of the 16
// planes at (mv - 1).  The window, copied asynchronously as the 16-byte
// chunks that hold each of its rows (bw / 8 + 1 per row), and the target
// (the block, or the bi target formed once from the other list's
// hypothesis: range [-maxv, 2 * maxv], int32) are staged in shared memory,
// and every Hadamard reads them there.
__global__ void __launch_bounds__(kFracThreads, 2)
frac_refine_kernel(const short* __restrict__ sub, int Hp, int Wp,
                   const int* __restrict__ cur, int w, int bh, int bw,
                   int Rb, int N, int Nx, const int* __restrict__ mv,
                   int qstart, const int* __restrict__ pred4,
                   const int* __restrict__ uref,
                   const int* __restrict__ o_uref,
                   const int* __restrict__ o_mv4, float lam,
                   int* __restrict__ mv4, float* __restrict__ satd_out) {
  extern __shared__ uint4 smem_u4[];
  const int ltw = __ffs(bw) - 4, ntiles = (bh / 8) << ltw;
  const int tpc = frac_tpc(ntiles), nb = frac_blocks(ntiles);
  const int ph = bh + 1, nch = bw / 8 + 1, rows = nb * 16 * ph;
  const int lbw = __ffs(bw) - 1, npx = bh * bw, lnpx = __ffs(npx) - 1;
  uint4* win = smem_u4;                         // [nb][16][ph][nch]
  int* tgt = (int*)(win + rows * nch);          // [nb][bh][bw]
  int* rowsm = tgt + nb * npx;                  // [nb][16][ph]
  int* part = rowsm + rows;                     // [nb][49][tpc]
  int* satd = part + nb * 49 * tpc;             // [nb][49]
  float* cost = (float*)(satd + nb * 49);       // [nb][49]
  int* meta = (int*)(cost + nb * 49);           // [nb]: ref, my, mx, ay, ax
  const short* planes = (const short*)win;
  const uint4* sub4 = (const uint4*)((uintptr_t)sub & ~(uintptr_t)15);
  const int sub_sh = (int)((uintptr_t)sub & 15) >> 1;
  const int e0 = blockIdx.x * nb, total = Rb * N;
  const int tid = threadIdx.x, nthr = blockDim.x;

  if (tid < nb) {
    int e = e0 + tid, *m = meta + tid * 5;
    m[0] = -1;
    if (e < total) {
      int n = e % N, my = mv[e * 2], mx = mv[e * 2 + 1];
      m[0] = uref ? uref[n] : e / N;
      m[1] = qstart ? my >> 2 : my;
      m[2] = qstart ? mx >> 2 : mx;
      m[3] = pred4[e * 2];
      m[4] = pred4[e * 2 + 1];
    }
  }
  // the window rows: a thread per row copies its chunks and notes where its
  // first sample lands
  for (int rr = tid; rr < rows; rr += nthr) {
    int b = rr / (16 * ph), pl = (rr / ph) & 15, i = rr % ph, e = e0 + b;
    if (e >= total) continue;
    int n = e % N, my = mv[e * 2], mx = mv[e * 2 + 1];
    if (qstart) {
      my >>= 2;
      mx >>= 2;
    }
    int ref = uref ? uref[n] : e / N;
    long long a = sub_sh + ((long long)(ref * 16 + pl) * Hp + (n / Nx) * bh +
                            my - 1 + kMargin + i) * Wp +
                  (n % Nx) * bw + mx - 1 + kMargin;
    rowsm[rr] = rr * nch * 8 + (int)(a & 7);
    const uint4* src = sub4 + (a >> 3);
    for (int c = 0; c < nch; ++c) cp_async16(win + rr * nch + c, src + c);
  }
  // the targets
  for (int q = tid; q < nb * npx; q += nthr) {
    int e = e0 + (q >> lnpx);
    if (e >= total) continue;
    int n = e % N, by = (n / Nx) * bh, bx = (n % Nx) * bw;
    int i = (q & (npx - 1)) >> lbw, j = q & (bw - 1);
    int o = cur[(size_t)(by + i) * w + bx + j];
    if (o_uref)
      o = 2 * o - pred_at(sub, Hp, Wp, o_uref[n], o_mv4[n * 2],
                          o_mv4[n * 2 + 1], by, bx).at(i, j);
    tgt[q] = o;
  }
  cp_async_wait_all();
  __syncthreads();

  // one candidate's tiles g, g + tpc, ... per thread, summed in a register
  {
    const int b = tid / (49 * tpc), k = (tid / tpc) % 49, g = tid % tpc;
    if (b < nb && meta[b * 5] >= 0) {
      const int qy = k / 7 - 3, qx = k % 7 - 3;
      const int* rs = rowsm + (b * 16 + (qy & 3) * 4 + (qx & 3)) * ph +
                      1 + (qy >> 2);
      const int ox = 1 + (qx >> 2);
      const int* tt = tgt + b * npx;
      int sum = 0;
      for (int tile = g; tile < ntiles; tile += tpc) {
        int ty = (tile >> ltw) * 8, tx = (tile & ((1 << ltw) - 1)) * 8;
        int v[64];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int4* t4 = (const int4*)(tt + (ty + i) * bw + tx);
          int4 lo = t4[0], hi = t4[1];
          const short* pp = planes + rs[ty + i] + ox + tx;
          int t[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) v[i * 8 + j] = t[j] - pp[j];
        }
        sum += satd8x8(v);
      }
      part[tid] = sum;
    }
  }
  __syncthreads();

  for (int q = tid; q < nb * 49; q += nthr) {
    const int b = q / 49, k = q % 49, *m = meta + b * 5;
    if (m[0] < 0) continue;
    int s = 0;
    for (int g = 0; g < tpc; ++g) s += part[q * tpc + g];
    int m4y = 4 * m[1] + k / 7 - 3, m4x = 4 * m[2] + k % 7 - 3;
    satd[q] = s;
    cost[q] = __fmaf_rn(lam, mvd_bits(m4x - m[4], m4y - m[3]),
                        __int2float_rn(s));
  }
  __syncthreads();

  // the 49-way argmin (the first least cost), a warp per block
  const int b = tid >> 5;
  if (b < nb && meta[b * 5] >= 0) {
    const int best = warp_argmin49(cost + b * 49), e = e0 + b;
    if ((tid & 31) == 0) {
      mv4[e * 2] = 4 * meta[b * 5 + 1] + best / 7 - 3;
      mv4[e * 2 + 1] = 4 * meta[b * 5 + 2] + best % 7 - 3;
      satd_out[e] = __int2float_rn(satd[b * 49 + best]);
    }
  }
}

// the list picks of every (CU size, shape, list) of a picture in one launch:
// one thread per (entry, block) over a flat grid.  An entry holds its
// K7 q-pel outputs mvq (R, N, 2) and satd (R, N), the anchors pred4 (R, N,
// 2), the list map lmap (mr,) and its output offset off (in blocks) into
// two arenas: int32, whose first 2 * total ints hold (ridx N, uref N) at
// 2 * off and whose rest holds int pairs (mv N, anchor N) at pair 2 * off,
// and float32 (satd N, bits N, cost N) at 3 * off.  The wrapper hands out
// each entry's outputs as views, made by one split per region.
constexpr int kMaxPick = 24;

struct PickEntry {
  const int* mvq;
  const float* satd;
  const int* pred4;
  const int* lmap;
  int mr, nref, N, off;
};

struct PickArgs {
  int n, total;
  float lam;
  int* iout;
  float* fout;
  PickEntry e[kMaxPick];
};

__global__ void uni_select_all_kernel(const __grid_constant__ PickArgs a) {
  __shared__ int pre[kMaxPick + 1];
  if (threadIdx.x <= a.n)
    pre[threadIdx.x] = threadIdx.x < a.n ? a.e[threadIdx.x].off : a.total;
  __syncthreads();
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.total) return;
  int k = 0;
  while (q >= pre[k + 1]) ++k;
  const PickEntry& E = a.e[k];
  const int N = E.N, n = q - E.off;
  const int2* mvq = reinterpret_cast<const int2*>(E.mvq);
  const int2* p4 = reinterpret_cast<const int2*>(E.pred4);
  int best = 0;
  float best_c = 0.f, best_b = 0.f;
  for (int i = 0; i < E.mr; ++i) {
    const size_t e = (size_t)E.lmap[i] * N + n;
    const int2 m = mvq[e], p = p4[e];
    float mb = mvd_bits(m.y - p.y, m.x - p.x);
    int rb = E.nref > 1 ? min(i + 1, E.nref - 1) : 0;
    float bits = __fadd_rn(__fadd_rn(mb, __int2float_rn(rb)), 4.0f);
    float c = i < E.nref ? __fmaf_rn(a.lam, bits, E.satd[e]) : inf_f();
    if (i == 0 || c < best_c) { best = i; best_c = c; best_b = bits; }
  }
  const int ref = E.lmap[best];
  const size_t e = (size_t)ref * N + n;
  int* io = a.iout + (size_t)2 * E.off;
  int2* po = reinterpret_cast<int2*>(a.iout + (size_t)2 * a.total) +
             (size_t)2 * E.off;
  float* fo = a.fout + (size_t)3 * E.off;
  io[n] = best;
  io[N + n] = ref;
  po[n] = mvq[e];
  po[N + n] = p4[e];
  fo[n] = E.satd[e];
  fo[N + n] = best_b;
  fo[2 * N + n] = best_c;
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

// prediction sample (i, j) of a hypothesis for the CU of size S at (y0, x0)
template <int S>
__device__ __forceinline__ int hyp_sample(const CuRdArgs& a, const Hyp& hp,
                                          int y0, int x0, int i, int j) {
  if (hp.bi) {
    int p0 = pred_at(a.sub, a.Hp, a.Wp, hp.uref[0], hp.mvy[0], hp.mvx[0], y0, x0).at(i, j);
    int p1 = pred_at(a.sub, a.Hp, a.Wp, hp.uref[1], hp.mvy[1], hp.mvx[1], y0, x0).at(i, j);
    return (p0 + p1 + 1) >> 1;
  }
  int k = hp.part == 1 ? (i >= S / 2) : hp.part == 2 ? (j >= S / 2) : 0;
  return pred_at(a.sub, a.Hp, a.Wp, hp.uref[k], hp.mvy[k], hp.mvx[k], y0,
                 x0).at(i, j);
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

// The CTA of cu_rd_kernel<S, B>: cu_group(S) CUs of size S (consecutive in
// raster order), cu_threads(S) threads
__host__ __device__ constexpr int cu_group(int S) {
  return S == 8 ? 32 : S == 16 ? 8 : S == 32 ? 2 : 1;
}
__host__ __device__ constexpr int cu_threads(int S) {
  return S == 64 ? 512 : 256;
}

// what the walk over a CU's priced hypotheses decided, for its trials'
// results to finish
struct CuState {
  int kind, m_sel, dirv, mv0y, mv0x, mv1y, mv1x, ref0c, ref1c;
  int pus[2][8];
  float bits_motion, bits_cu[2];
};

template <int U, int TT>
struct TrialBufs {
  int a[U][TT], b[U][TT];
  short p[U][TT];
};

// shared memory of one CTA.  A trial unit is one TU of one trial (the
// winner's, then the two rect shapes') of one CU; the transform stages run
// over all of a CTA's units at once
template <int S, bool B>
struct CuRdSmem {
  static constexpr int G = cu_group(S), NTHR = cu_threads(S);
  static constexpr int T = S < 32 ? S : 32, NTU = (S / T) * (S / T);
  static constexpr int NM = B ? 6 : 4;          // merge candidates
  static constexpr int NH = B ? NM + 2 : NM;    // priced hypotheses (+ bi)
  static constexpr int NTR = S >= 16 ? 3 : 1;   // trials per CU at most
  static constexpr int U = G * NTR * NTU;       // trial units at most
  static constexpr int RB = T == 8 ? 2 : 4;     // rows of a stage item
  static constexpr int NCH = T * T / RB / 32;   // warps' items per unit
  static constexpr int NT8 = (S / 8) * (S / 8); // 8x8 tiles of a CU
  static constexpr int TPH = NT8 < NTHR / (G * NH) ? NT8 : NTHR / (G * NH);
  alignas(16) int cur[G][S * S];
  alignas(16) int tm[T * T];                    // the DCT, D[k][j]
  alignas(16) int tmT[T * T];                   // its transpose
  union alignas(16) Work {
    short pred[G][NH][S * S];                   // the priced hypotheses
    TrialBufs<U, T * T> tr;                     // the trial units
  } w;
  Hyp hyp[G][NH];
  Hyp thyp[G][NTR];
  int part[NTHR];                               // SATD partial sums
  int stat[U][NCH][5];                          // nnz, gt1, esc, last x, y
  unsigned int sse[U][NCH][2];                  // reconstruction, zero
  float res[G][NTR][3];                         // sse_rec, bits, sse_zero
  CuState st[G];
};

// G CUs of size S per CTA.  P mode (B false): the merge set is the left
// and above neighbours' list-0 winners, the prior, zero; the kinds merge and
// uni-L0.  B mode: six bi merge candidates (the A1 / B1 / B0 / A0
// neighbours' winners of both lists, the priors, zero), the kinds merge,
// uni-L0, uni-L1 and bi (the list winners' average, or the refined pair
// where strictly cheaper), and rect PUs from the cheaper list.
//
// Stages, each over all of the CTA's CUs: the blocks (cp.async) and the
// hypotheses; the hypotheses' predictions (int16); their SATDs as
// (hypothesis, 8x8 tile) items summed in registers and warp shuffles; a
// thread per CU walks the costs in the reference's order; the trials'
// predictions and residuals; the four transform stages over all trial units,
// the level statistics and SSEs reduced per warp; a thread per trial sums
// its TUs in order; a thread per CU finishes the record.
template <int S, bool B>
__global__ void __launch_bounds__(cu_threads(S), S == 64 ? 1 : 2)
cu_rd_kernel(CuRdArgs a, int N) {
  using Sm = CuRdSmem<S, B>;
  constexpr int G = Sm::G, NTHR = Sm::NTHR, T = Sm::T, TT = T * T;
  constexpr int NTU = Sm::NTU, SPR = S / T, NM = Sm::NM, NH = Sm::NH;
  constexpr int NR = NM - 2, NL = B ? 2 : 1;  // rolled neighbours, lists
  constexpr int RB = Sm::RB, NCH = Sm::NCH, IPU = TT / RB, TPH = Sm::TPH;
  constexpr int WR = TPH < 32 ? TPH : 32, PPH = TPH / WR;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ uint4 cu_smem[];
  Sm& sm = *reinterpret_cast<Sm*>(cu_smem);
  const TqParams& p = a.tq;
  const int tid = threadIdx.x, n0 = blockIdx.x * G;
  const int ng = min(G, N - n0), ny = N / a.nx;
  const int ntr = a.has_rect ? Sm::NTR : 1, nu = ng * ntr * NTU;
  const int roll_dy[4] = {0, 1, 1, -1}, roll_dx[4] = {1, 0, -1, 1};

  // ---- the DCT, the blocks, the hypotheses ----
  for (int q = tid; q < TT; q += NTHR) {
    int v = a.tm[q];
    sm.tm[q] = v;
    sm.tmT[(q % T) * T + q / T] = v;
  }
  if ((((uintptr_t)a.cur | (uintptr_t)a.w * 4) & 15) == 0) {
    for (int q = tid * 4; q < ng * S * S; q += NTHR * 4) {
      int g = q / (S * S), e = q % (S * S), n = n0 + g;
      cp_async16(&sm.cur[g][e], a.cur + (size_t)((n / a.nx) * S + e / S) * a.w
                                    + (n % a.nx) * S + e % S);
    }
  } else {
    for (int q = tid; q < ng * S * S; q += NTHR) {
      int g = q / (S * S), e = q % (S * S), n = n0 + g;
      cp_async4(&sm.cur[g][e], a.cur + (size_t)((n / a.nx) * S + e / S) * a.w
                                   + (n % a.nx) * S + e % S);
    }
  }
  if (tid < ng) {
    const int g = tid, n = n0 + g, ci = n / a.nx, cj = n % a.nx;
    for (int m = 0; m < NM; ++m) {
      Hyp hp{};
      hp.bi = B;
      if (m < NR) {
        // torch.roll / jnp.roll by (dy, dx): the CU reads the winner at
        // (ci - dy, cj - dx), wrapped (a wrapped read costs inf below)
        int nb = ((ci - roll_dy[m] + ny) % ny) * a.nx +
                 (cj - roll_dx[m] + a.nx) % a.nx;
        for (int l = 0; l < NL; ++l) set_hyp(hp, l, l ? a.uni1 : a.uni, nb);
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
      sm.hyp[g][m] = hp;
    }
    if constexpr (B) {
      // bi from the two list winners, and from the refined pair
      Hyp hb{};
      hb.bi = 1;
      set_hyp(hb, 0, a.uni, n);
      set_hyp(hb, 1, a.uni1, n);
      Hyp hi = hb;
      hi.mvy[0] = a.mvb0[n * 2]; hi.mvx[0] = a.mvb0[n * 2 + 1];
      hi.mvy[1] = a.mvb1[n * 2]; hi.mvx[1] = a.mvb1[n * 2 + 1];
      sm.hyp[g][NM] = hb;
      sm.hyp[g][NM + 1] = hi;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- the priced hypotheses' predictions ----
  for (int q = tid; q < ng * NH * S * S; q += NTHR) {
    int gm = q / (S * S), e = q % (S * S), g = gm / NH, n = n0 + g;
    (&sm.w.pred[0][0][0])[q] = (short)hyp_sample<S>(
        a, sm.hyp[g][gm % NH], (n / a.nx) * S, (n % a.nx) * S, e / S, e % S);
  }
  __syncthreads();

  // ---- their SATDs: TPH threads per hypothesis, its tiles TPH apart ----
  {
    const int grp = tid / TPH, lt = tid % TPH;
    int sum = 0;
    if (grp < ng * NH) {
      const int* cb = sm.cur[grp / NH];
      const short* pb = sm.w.pred[grp / NH][grp % NH];
      for (int t = lt; t < Sm::NT8; t += TPH) {
        const int ty = (t / (S / 8)) * 8, tx = (t % (S / 8)) * 8;
        int v[64];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int4* c4 = (const int4*)(cb + (ty + i) * S + tx);
          int4 lo = c4[0], hi = c4[1];
          uint4 pq = *(const uint4*)(pb + (ty + i) * S + tx);
          unsigned int pw[4] = {pq.x, pq.y, pq.z, pq.w};
          int o[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)   // the int16 pair j / 2, low first
            v[i * 8 + j] = o[j] - ((int)(pw[j >> 1] << (16 - 16 * (j & 1))) >> 16);
        }
        sum += satd8x8(v);
      }
    }
#pragma unroll
    for (int off = WR / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (lt % WR == 0) sm.part[tid / WR] = sum;
  }
  __syncthreads();

  // ---- a thread per CU walks the costs in the reference's order ----
  if (tid < ng) {
    const int g = tid, n = n0 + g, ci = n / a.nx, cj = n % a.nx;
    int satd[NH];
#pragma unroll
    for (int m = 0; m < NH; ++m) {
      satd[m] = 0;
      for (int t = 0; t < PPH; ++t) satd[m] += sm.part[(g * NH + m) * PPH + t];
    }
    // merge set; strict < keeps the first
    float m_cost = 0.f, m_bits = 0.f;
    int m_sel = 0, m_ridx[2] = {0, 0};
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      int ridx[2] = {0, 0};
      bool invalid = false;
      if (m < NR) {
        int dy = roll_dy[m], dx = roll_dx[m];
        int nb = ((ci - dy + ny) % ny) * a.nx + (cj - dx + a.nx) % a.nx;
        invalid = (dy > 0 && ci == 0) || (dy < 0 && ci == ny - 1) ||
                  (dx > 0 && cj == 0) || (dx < 0 && cj == a.nx - 1);
        for (int l = 0; l < NL; ++l) ridx[l] = (l ? a.uni1 : a.uni).ridx[nb];
      }
      float bits = __fadd_rn(__int2float_rn(min(m + 1, a.nmerge - 1) + 1), 1.0f);
      float c = __fadd_rn(__fadd_rn(__int2float_rn(satd[m]), __fmul_rn(a.lams, bits)),
                          invalid ? inf_f() : 0.f);
      if (m == 0 || c < m_cost) {
        m_cost = c; m_bits = bits; m_sel = m;
        m_ridx[0] = ridx[0];
        m_ridx[1] = ridx[1];
      }
    }

    // kind: the first least of merge, uni-L0 (, uni-L1, bi)
    CuState s;
    const Hyp& mh = sm.hyp[g][m_sel];
    Hyp best = mh;
    s.kind = 0; s.m_sel = m_sel; s.bits_motion = m_bits;
    s.mv0y = mh.mvy[0]; s.mv0x = mh.mvx[0];
    s.mv1y = B ? mh.mvy[1] : 0; s.mv1x = B ? mh.mvx[1] : 0;
    s.ref0c = m_ridx[0]; s.ref1c = B ? m_ridx[1] : -1; s.dirv = B ? 3 : 1;
    float kcost = m_cost;
    if (a.uni.cost[n] < kcost) {
      s.kind = 1; kcost = a.uni.cost[n]; s.bits_motion = a.uni.bits[n];
      best = Hyp{};
      set_hyp(best, 0, a.uni, n);
      s.mv0y = best.mvy[0]; s.mv0x = best.mvx[0]; s.mv1y = s.mv1x = 0;
      s.ref0c = a.uni.ridx[n]; s.ref1c = -1; s.dirv = 1;
    }
    if constexpr (B) {
      if (a.uni1.cost[n] < kcost) {
        s.kind = 2; kcost = a.uni1.cost[n]; s.bits_motion = a.uni1.bits[n];
        best = Hyp{};
        set_hyp(best, 0, a.uni1, n);
        s.mv0y = s.mv0x = 0; s.mv1y = best.mvy[0]; s.mv1x = best.mvx[0];
        s.ref0c = -1; s.ref1c = a.uni1.ridx[n]; s.dirv = 2;
      }
      const Hyp &hb = sm.hyp[g][NM], &hi = sm.hyp[g][NM + 1];
      float bb = __fadd_rn(__fadd_rn(a.uni.bits[n], a.uni1.bits[n]), -2.0f);
      float cb = __fmaf_rn(a.lams, bb, __int2float_rn(satd[NM]));
      float mb = __fadd_rn(
          mvd_bits(hi.mvx[0] - a.anchor0[n * 2 + 1], hi.mvy[0] - a.anchor0[n * 2]),
          mvd_bits(hi.mvx[1] - a.anchor1[n * 2 + 1], hi.mvy[1] - a.anchor1[n * 2]));
      float bi_it = __fadd_rn(__fadd_rn(__fadd_rn(mb, ref_bits(a.uni.ridx[n], a.nref0)),
                                        ref_bits(a.uni1.ridx[n], a.nref1)), 6.0f);
      float ci_ = __fmaf_rn(a.lams, bi_it, __int2float_rn(satd[NM + 1]));
      bool it = ci_ < cb;
      if ((it ? ci_ : cb) < kcost) {
        s.kind = 3; s.bits_motion = it ? bi_it : bb;
        best = it ? hi : hb;
        s.mv0y = best.mvy[0]; s.mv0x = best.mvx[0];
        s.mv1y = best.mvy[1]; s.mv1x = best.mvx[1];
        s.ref0c = a.uni.ridx[n]; s.ref1c = a.uni1.ridx[n]; s.dirv = 3;
      }
    }
    best.part = 0;
    sm.thyp[g][0] = best;

    // 2NxN / Nx2N; in B mode each PU takes list 1 where strictly cheaper
    if (ntr > 1) {
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
          s.pus[pi][u * 4] = use1 ? 2 : 1;
          s.pus[pi][u * 4 + 1] = hp.mvy[u];
          s.pus[pi][u * 4 + 2] = hp.mvx[u];
          s.pus[pi][u * 4 + 3] = e.ridx[k];
        }
        s.bits_cu[pi] = __fadd_rn(__fadd_rn(pb[0], pb[1]), 1.5f);
        sm.thyp[g][1 + pi] = hp;
      }
    }
    sm.st[g] = s;
  }
  __syncthreads();

  // ---- the trial units' predictions and residuals ----
  for (int q = tid; q < nu * TT; q += NTHR) {
    int u = q / TT, e = q % TT, gk = u / NTU, tu = u % NTU;
    int g = gk / ntr, n = n0 + g;
    int i = (tu / SPR) * T + e / T, j = (tu % SPR) * T + e % T;
    int pv = hyp_sample<S>(a, sm.thyp[g][gk - g * ntr], (n / a.nx) * S,
                           (n % a.nx) * S, i, j);
    sm.w.tr.p[u][e] = (short)pv;
    sm.w.tr.a[u][e] = sm.cur[g][i * S + j] - pv;
  }
  __syncthreads();

  // ---- forward stage 1: b[i][k] = sum_j resi[i][j] * D[k][j] ----
  for (int it = tid; it < nu * IPU; it += NTHR) {
    const int u = it / IPU, rem = it % IPU, c = rem % T, r0 = rem / T;
    int acc[RB];
    mm_item<T, RB>(sm.w.tr.a[u], sm.tmT, r0, c, acc);
#pragma unroll
    for (int q = 0; q < RB; ++q)
      sm.w.tr.b[u][(r0 + q * (T / RB)) * T + c] = p.fwd_s1 > 0
          ? (acc[q] + (1 << (p.fwd_s1 - 1))) >> p.fwd_s1 : acc[q] << (-p.fwd_s1);
  }
  __syncthreads();

  // ---- forward stage 2, quant, statistics (per warp), dequant ----
  for (int it = tid; it < nu * IPU; it += NTHR) {
    const int u = it / IPU, rem = it % IPU, c = rem % T, r0 = rem / T;
    int acc[RB];
    mm_item<T, RB>(sm.tm, sm.w.tr.b[u], r0, c, acc);
    int nnz = 0, gt1 = 0, esc = 0, lx = -1, ly = -1;
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int k = r0 + q * (T / RB);
      int coef = (acc[q] + (1 << (p.fwd_s2 - 1))) >> p.fwd_s2;
      int av = coef < 0 ? -coef : coef;
      int lv = (av * p.q_scale + p.q_add) >> p.q_bits;
      lv = lv < 32767 ? lv : 32767;
      int level = coef < 0 ? -lv : (coef > 0 ? lv : 0);
      if (lv > 0) {
        ++nnz;
        lx = c;
        ly = max(ly, k);
        if (lv > 1) {
          ++gt1;
          esc += 2 * bit_length(lv - 1) + 1;
        }
      }
      int dq = clampi(level, p.dq_min, p.dq_max) * p.dq_scale;
      dq = p.dq_shift > 0 ? (dq + (1 << (p.dq_shift - 1))) >> p.dq_shift
                          : dq << (-p.dq_shift);
      sm.w.tr.a[u][k * T + c] = clampi(dq, -32768, 32767);
    }
    nnz = __reduce_add_sync(kFull, nnz);
    gt1 = __reduce_add_sync(kFull, gt1);
    esc = __reduce_add_sync(kFull, esc);
    lx = __reduce_max_sync(kFull, lx);
    ly = __reduce_max_sync(kFull, ly);
    if ((tid & 31) == 0) {
      int* st = sm.stat[u][rem >> 5];
      st[0] = nnz; st[1] = gt1; st[2] = esc; st[3] = lx; st[4] = ly;
    }
  }
  __syncthreads();

  // ---- inverse stage 1: b[i][k] = clip((sum_j D[j][i] deq[j][k] + 64) >> 7) ----
  for (int it = tid; it < nu * IPU; it += NTHR) {
    const int u = it / IPU, rem = it % IPU, c = rem % T, r0 = rem / T;
    int acc[RB];
    mm_item<T, RB>(sm.tmT, sm.w.tr.a[u], r0, c, acc);
#pragma unroll
    for (int q = 0; q < RB; ++q)
      sm.w.tr.b[u][(r0 + q * (T / RB)) * T + c] =
          clampi((acc[q] + 64) >> 7, -32768, 32767);
  }
  __syncthreads();

  // ---- inverse stage 2, reconstruction; the SSEs (per warp) ----
  for (int it = tid; it < nu * IPU; it += NTHR) {
    const int u = it / IPU, rem = it % IPU, c = rem % T, r0 = rem / T;
    const int tu = u % NTU, g = u / NTU / ntr;
    const int* ob = sm.cur[g] + (tu / SPR) * T * S + (tu % SPR) * T;
    int acc[RB];
    mm_item<T, RB>(sm.w.tr.b[u], sm.tm, r0, c, acc);
    unsigned int rs = 0, zs = 0;
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int i = r0 + q * (T / RB);
      int rres = clampi((acc[q] + (1 << (p.inv_s2 - 1))) >> p.inv_s2,
                        -32768, 32767);
      int pv = sm.w.tr.p[u][i * T + c], o = ob[i * S + c];
      int d = o - clampi(pv + rres, 0, p.maxv);
      int dz = o - clampi(pv, 0, p.maxv);
      rs += (unsigned int)(d * d);
      zs += (unsigned int)(dz * dz);
    }
    rs = __reduce_add_sync(kFull, rs);
    zs = __reduce_add_sync(kFull, zs);
    if ((tid & 31) == 0) {
      sm.sse[u][rem >> 5][0] = rs;
      sm.sse[u][rem >> 5][1] = zs;
    }
  }
  __syncthreads();

  // ---- a thread per trial: its TUs' bits in TU order, its SSEs ----
  if (tid < ng * ntr) {
    float bits = 0.f;
    unsigned int rs = 0, zs = 0;
    for (int tu = 0; tu < NTU; ++tu) {
      const int u = tid * NTU + tu;
      int nnz = 0, gt1 = 0, esc = 0, lx = -1, ly = -1;
      for (int ch = 0; ch < NCH; ++ch) {
        const int* st = sm.stat[u][ch];
        nnz += st[0]; gt1 += st[1]; esc += st[2];
        lx = max(lx, st[3]); ly = max(ly, st[4]);
        rs += sm.sse[u][ch][0];
        zs += sm.sse[u][ch][1];
      }
      float b = bits_estimate(nnz, lx, ly, gt1, esc, a.model);
      bits = tu == 0 ? b : __fadd_rn(bits, b);
    }
    float* r = sm.res[tid / ntr][tid % ntr];
    r[0] = __int2float_rn((int)rs);
    r[1] = bits;
    r[2] = __int2float_rn((int)zs);
  }
  __syncthreads();

  // ---- a thread per CU: skip, rect shapes, intra, the record ----
  if (tid < ng) {
    const int g = tid, n = n0 + g;
    const CuState& s = sm.st[g];
    const float* t0 = sm.res[g][0];
    const bool is_merge = s.kind == 0;
    float cost_coded = __fmaf_rn(a.lamf, __fadd_rn(__fadd_rn(t0[1], s.bits_motion), 2.0f), t0[0]);
    float bits_zero = __fsub_rn(__fadd_rn(s.bits_motion, is_merge ? 0.0f : 1.0f), 0.0f);
    float cost_zero = __fmaf_rn(a.lamf, bits_zero, t0[2]);
    bool skip = cost_zero <= cost_coded;
    float inter = fminf(cost_coded, cost_zero);

    int part_ch = 0;
    int pu[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (ntr > 1) {
      float rc[2];
      for (int pi = 0; pi < 2; ++pi) {
        const float* t = sm.res[g][1 + pi];
        float cc = __fmaf_rn(a.lamf, __fadd_rn(__fadd_rn(t[1], s.bits_cu[pi]), 2.0f), t[0]);
        float cz = __fmaf_rn(a.lamf, __fadd_rn(s.bits_cu[pi], 1.0f), t[2]);
        rc[pi] = fminf(cc, cz);
      }
      bool use_b = rc[1] < rc[0];
      float rect_cost = fminf(rc[0], rc[1]);
      part_ch = rect_cost < inter ? (use_b ? 2 : 1) : 0;
      for (int f = 0; f < 8; ++f) pu[f] = s.pus[use_b ? 1 : 0][f];
      inter = fminf(inter, rect_cost);
    }

    // intra alternative
    int intra = 0, imode = 0, c3[3] = {0, 0, 0};
    float cu_cost = inter;
    if (a.has_intra) {
      float icost = __fadd_rn(a.i_cost[n], __fmul_rn(a.lamf, 3.0f));
      intra = icost < inter;
      imode = a.i_mode[n];
      for (int k = 0; k < 3; ++k) c3[k] = a.i_top3[n * 3 + k];
      cu_cost = fminf(inter, icost);
    }

    int* r = a.rec + (size_t)n * 24;
    int vals[24] = {s.kind, s.m_sel, s.dirv, skip ? 1 : 0, intra, imode,
                    s.mv0y, s.mv0x, s.mv1y, s.mv1x, s.ref0c, s.ref1c,
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
  auto size_ok = [](int v) { return v == 8 || v == 16 || v == 32 || v == 64; };
  if (Ny <= 0 || Nx <= 0 || Rb <= 0 || !size_ok(bh) || !size_ok(bw) ||
      (long long)Rb * Ny * Nx > 0x7fffffff || (o_uref && (!uref || !o_mv4)))
    return (int)cudaErrorInvalidValue;
  size_t bytes = hm::frac_smem_bytes(bh, bw);
  cudaError_t err = cudaFuncSetAttribute(
      hm::frac_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int N = Ny * Nx, nb = hm::frac_blocks((bh / 8) * (bw / 8));
  int ctas = (Rb * N + nb - 1) / nb;
  hm::frac_refine_kernel<<<ctas, hm::kFracThreads, bytes,
                           (cudaStream_t)stream>>>(
      sub, Hp, Wp, cur, w, bh, bw, Rb, N, Nx, mv, qstart, pred4, uref, o_uref,
      o_mv4, lam, mv4, satd);
  return (int)cudaGetLastError();
}

extern "C" int hm_uni_select_all(const hm::PickArgs* a, void* stream) {
  if (a->n <= 0 || a->n > hm::kMaxPick || a->total <= 0 || a->e[0].off != 0)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < a->n; ++k)
    if (a->e[k].N <= 0 || a->e[k].mr <= 0 ||
        a->e[k].off + a->e[k].N != (k + 1 < a->n ? a->e[k + 1].off : a->total))
      return (int)cudaErrorInvalidValue;
  hm::uni_select_all_kernel<<<(a->total + 255) / 256, 256, 0,
                              (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

template <int S, bool B>
static int launch_cu_rd_s(const hm::CuRdArgs* a, int N, cudaStream_t st) {
  using Sm = hm::CuRdSmem<S, B>;
  cudaError_t err = cudaFuncSetAttribute(
      hm::cu_rd_kernel<S, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Sm));
  if (err != cudaSuccess) return (int)err;
  hm::cu_rd_kernel<S, B><<<(N + Sm::G - 1) / Sm::G, Sm::NTHR, sizeof(Sm),
                           st>>>(*a, N);
  return (int)cudaGetLastError();
}

template <bool B>
static int launch_cu_rd(const hm::CuRdArgs* a, int s, int N, cudaStream_t st) {
  switch (s) {
    case 8: return launch_cu_rd_s<8, B>(a, N, st);
    case 16: return launch_cu_rd_s<16, B>(a, N, st);
    case 32: return launch_cu_rd_s<32, B>(a, N, st);
    case 64: return launch_cu_rd_s<64, B>(a, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// is_b selects the B mode (list 1, bi, six merge candidates); rect shapes
// exist from 16x16 up (RECT_SIZES)
extern "C" int hm_cu_rd(const hm::CuRdArgs* a, int s, int N, int is_b,
                        void* stream) {
  if (N <= 0 || a->nx <= 0 || N % a->nx || (a->has_rect && s < 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_b ? launch_cu_rd<true>(a, s, N, st) : launch_cu_rd<false>(a, s, N, st);
}

// K8's dynamic shared memory per CTA in bytes (0 for a size it lacks)
extern "C" size_t hm_cu_rd_smem_bytes(int s, int is_b) {
  switch (s * 2 + (is_b != 0)) {
    case 16: return sizeof(hm::CuRdSmem<8, false>);
    case 17: return sizeof(hm::CuRdSmem<8, true>);
    case 32: return sizeof(hm::CuRdSmem<16, false>);
    case 33: return sizeof(hm::CuRdSmem<16, true>);
    case 64: return sizeof(hm::CuRdSmem<32, false>);
    case 65: return sizeof(hm::CuRdSmem<32, true>);
    case 128: return sizeof(hm::CuRdSmem<64, false>);
    case 129: return sizeof(hm::CuRdSmem<64, true>);
    default: return 0;
  }
}

// the argument structs' sizes, checked against their ctypes mirrors
extern "C" size_t hm_sizeof_cu_rd_args() { return sizeof(hm::CuRdArgs); }
extern "C" size_t hm_sizeof_uni_res() { return sizeof(hm::UniRes); }
extern "C" size_t hm_sizeof_pick_args() { return sizeof(hm::PickArgs); }

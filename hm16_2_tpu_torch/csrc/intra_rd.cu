// K2 intra_size_rd and K3 intra_cand_rd: the per-size intra RD of the
// all-intra frame plan.
//
// Replaces (hm16_2_tpu/encode/intra_rd.py) `_size_rd` (:172) and with it
// `predict_all_modes`, `batched_satd`, `batched_fwd_transform`,
// `batched_quant` (ops/analysis.py:153-273), `batched_dequant` (:48),
// `batched_inv_transform` (:66), `_bits_estimate` (:108) and
// `_topk_argmin` (:159); K3 replaces `_chroma_rd5` (:212) and
// `_size_rd_fixed_mode` (:232).  SATD-only mode (k = 0) serves
// `CtuSearch._premodes` (encode/top.py:3938).  Analysis mode
// (`hm_analysis_step`) replaces `mesh.analysis_step`
// (hm16_2_tpu/parallel/mesh.py:32): the SATD argmin mode (int32, ties to the
// lowest mode), its SATD, the quantised levels of orig - prediction (DST at
// s = 4, the intra offset), and the SATDs summed into one int32 total with
// one atomic add per CTA (integer, so exact in any order).
//
// What bounds them on the H100: int32 ALU work and its latency between
// dependent stages.  Per block the 35 predictions and their Hadamard SATDs
// cost ~35 * 23 * s^2 integer instructions, and each of the k = 3-4
// candidates four s x s matrix products (8 s^3 operations); the input is
// only s^2 + 8s + 2 int32 samples.  Shared-memory atomics and one barrier
// per stage and mode (the first design's) serialise that work, and so do
// column reads at a stride of s words (bank conflicts).
//
// The design: a CTA of 224 threads (7 warps) stages its blocks once by
// cp.async (the 16-byte chunks of the blocks; the (2, 4s+1) buffers, which are
// not 16-byte aligned per block, by 4-byte copies) into rows padded so that
// lanes on different blocks hit different banks.  The SATD stage's item is one
// (block, mode, Hadamard tile): 32, 32, 8 and 2 blocks per CTA at s = 4, 8, 16
// and 32, so that a warp holds one mode of all the CTA's blocks (five modes
// per warp, no divergence between modes) and its lanes the blocks' tiles.  A
// thread forms its tile's prediction in registers from the staged buffers (the
// mode's angle, iidx and frac once per line of the tile), subtracts the staged
// block, runs the 4x4 or 8x8 Hadamard in registers, and the lanes of a block
// add their tiles by warp shuffles: no atomics and no barrier between
// modes.  This stage issues ~23 int32 instructions per sample and mode and sets
// the SATD-only time.  A thread per block then takes the float32 top-k in one
// pass of a sorted insertion (or the integer argmin), ties to the lowest mode:
// with 32 blocks per CTA that is one busy warp, where a warp per block with
// (value, index) shuffles spent ~12x the issue slots (measured on an H100 at
// 1080p: K2 RD at s = 4 0.24 -> 0.14 ms).  The transform chain runs every
// (block, candidate) trial unit of the CTA at once.  At s <= 16 a unit is s
// lanes, lane i owning row i of every stage in registers (prediction,
// residual, the stage-1 row; row i of the coefficients, levels and dequantised
// values; rows of both inverse stages), the rows exchanged through the unit's
// shared-memory tiles within the warp (__syncwarp; no CTA barrier), the level
// statistics and the unsigned SSE by shuffles over the unit's lanes.  At s = 32
// (six units per CTA) the stages are shared-memory matrix products whose
// threads own one column and 4 rows, as in K8 (`mm_item`: the matrix kept
// beside its transpose, so no stage reads a column at a stride), with
// warp-reduced statistics and a thread per unit for its bits.  Integer sums are
// exact in any order.  The analysis mode stops after the quant and writes the
// levels out.  The transforms stay on the int32 pipes: 12-bit residuals do not
// fit the tensor cores' int8 or fp16 operands exactly.  Float steps are the
// reference's: `cost = fma(lam, bits + mode_bits, dist)` and the bits chain
// (file built with --fmad=false).
//
// Resources (ptxas -v and the dynamic shared memory, printed by
// chip_smoke.py): see PERF.md.
#include "intra_common.cuh"

namespace hm {

constexpr int kIntraThreads = 224;                 // 7 warps
constexpr int kIntraWarps = kIntraThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
// the largest block size whose transform chain runs a row per lane
// (chain_rows); larger ones run mm_item stages
constexpr int kRowsMax = 16;

// blocks per CTA of the kernels with the 35-mode SATD stage: G times the
// Hadamard tiles of a block is 32, so a warp holds one mode of every block
__host__ __device__ constexpr int satd_group(int s) {
  return s <= 8 ? 32 : s == 16 ? 8 : 2;
}
// candidates held at once by the RD mode (more run in rounds)
__host__ __device__ constexpr int rd_kc(int s) { return s <= 8 ? 4 : 3; }
// blocks per CTA and candidates held at once by K3
__host__ __device__ constexpr int cand_group(int s) {
  return s == 4 ? 32 : s == 8 ? 16 : 4;
}
__host__ __device__ constexpr int cand_kc(int s) { return s == 32 ? 1 : 5; }

// shared memory of one CTA holding G blocks of size S and G * KC trial
// units (stage tiles a and b; the predictions, statistics and SSE partials
// of the mm_item chain only above kRowsMax)
template <int S, int G, int KC>
struct IntraSmem {
  static constexpr int B = 4 * S + 1;
  static constexpr int BS = 2 * B + 1;   // odd: one bank per block
  static constexpr int OS = S * S + 4;   // 16-byte rows, 4 banks per block
  static constexpr int TT = S * S;
  static constexpr int U = G * KC;                   // trial units
  static constexpr int UA = U > 0 ? U : 1, TA = U > 0 ? TT : 4;
  static constexpr int UM = S > kRowsMax ? UA : 1;   // units of mm_item
  static constexpr int RB = 4;                       // rows of a stage item
  static constexpr int IPU = TT / RB;                // stage items per unit
  static constexpr int NCH = S > kRowsMax ? IPU / 32 : 1;  // warps per unit
  static constexpr int NC = KC > 4 ? KC : 4;
  alignas(16) int orig[G][OS];
  alignas(16) int tm[TT];                            // D[k][j]
  alignas(16) int tmT[TT];                           // its transpose
  alignas(16) int a[UA][TA];
  alignas(16) int b[UA][TA];
  short pr[UM][S > kRowsMax ? TA : 2];               // the predictions
  int buf[G * BS];                                   // unfiltered, filtered
  int satd[G][35];
  int cand[G][NC];
  float cost[G][NC];
  int stat[UM][NCH][5];                              // nnz, gt1, esc, x, y
  unsigned int sse[UM][NCH];
  int ang[18];
  int dcval[G];
};

// the kernels' arguments (one struct for all modes)
struct IntraArgs {
  const int* bufs;       // (n, 2, 4s+1)
  const int* blocks;     // (n, s, s)
  const int* modes;      // K3: (n, k)
  int n, k;              // k: RD candidates (0: SATD-only), K3's modes
  TqParams p;
  const int* tm;
  const int* ang;
  const float* model;
  float lam;
  int want_satd;
  int* mode;
  float* cost;
  int* top3;
  int* satd;
  float* dist;
  float* bits;
  int* levels;
  int* total;
};

// ---------------------------------------------------------------------------
// prediction of one tile, in registers
// ---------------------------------------------------------------------------

// lines l of the tile (rows for a vertical mode, columns for a horizontal
// one): iidx and frac once per line, T + 1 reference samples per line.  A
// tile that is the whole block (s = 4, 8) reads them straight from the
// buffer where the line needs neither the projected side (k < 0) nor the
// clamp at 2S; every lane of a warp then takes the same branch (one mode,
// one tile position).  Smaller tiles' lanes would diverge there (measured
// on an H100: SATD-only 8% slower at s = 16 and 32), so they always index.
template <int S, int T, bool VER>
__device__ __forceinline__ void angular_tile(const int* buf, int angle,
                                             int inv_angle, int ty, int tx,
                                             int (&v)[T * T]) {
  const int l0 = VER ? ty : tx, e0 = VER ? tx : ty;
#pragma unroll
  for (int l = 0; l < T; ++l) {
    const int delta = (l0 + l + 1) * angle;
    const int iidx = delta >> 5, frac = delta & 31, k0 = 1 + iidx + e0;
    int r[T + 1];
    if (S == T && k0 >= 0 && k0 + T <= 2 * S) {
      const int* q = buf + 2 * S + (VER ? k0 : -k0);
#pragma unroll
      for (int e = 0; e <= T; ++e) r[e] = q[VER ? e : -e];
    } else {
#pragma unroll
      for (int e = 0; e <= T; ++e)
        r[e] = buf[ref_main_index<S>(k0 + e, VER, inv_angle)];
    }
#pragma unroll
    for (int e = 0; e < T; ++e) {
      const int val = ((32 - frac) * r[e] + frac * r[e + 1] + 16) >> 5;
      if (VER) v[l * T + e] = val;
      else v[e * T + l] = val;
    }
  }
}

// the T x T tile at (ty, tx) of intra mode `mode`'s prediction of an S x S
// block; bu: the block's unfiltered buffer, the filtered one B words on;
// ang = {ANG_TABLE[9], INV_ANG_TABLE[9]}
template <int S, int T>
__device__ __forceinline__ void pred_tile(const int* bu, const int* ang,
                                          int dcval, int mode, int ty,
                                          int tx, const TqParams& p,
                                          int (&v)[T * T]) {
  constexpr int corner = 2 * S, B = 4 * S + 1;
  constexpr int log2 = S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : 5;
  const int* buf = ((p.filt >> mode) & 1ull) ? bu + B : bu;
  if (mode == 0) {                       // planar
    const int tr = buf[corner + S + 1], bl = buf[corner - S - 1];
    int top[T], left[T];
#pragma unroll
    for (int e = 0; e < T; ++e) {
      top[e] = buf[corner + 1 + tx + e];
      left[e] = buf[corner - 1 - ty - e];
    }
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int r = ty + i, c = tx + j;
        v[i * T + j] = ((S - 1 - c) * left[i] + (c + 1) * tr +
                        (S - 1 - r) * top[j] + (r + 1) * bl + S) >> (log2 + 1);
      }
    return;
  }
  if (mode == 1) {                       // DC, edge-filtered for luma <= 16
#pragma unroll
    for (int q = 0; q < T * T; ++q) v[q] = dcval;
    if (p.edge) {
      if (ty == 0)
#pragma unroll
        for (int j = 0; j < T; ++j)
          v[j] = (bu[corner + 1 + tx + j] + 3 * dcval + 2) >> 2;
      if (tx == 0)
#pragma unroll
        for (int i = 0; i < T; ++i)
          v[i * T] = (bu[corner - 1 - ty - i] + 3 * dcval + 2) >> 2;
      if (ty == 0 && tx == 0)
        v[0] = (bu[corner + 1] + bu[corner - 1] + 2 * dcval + 2) >> 2;
    }
    return;
  }
  const bool is_ver = mode >= 18;
  const int ang_mode = is_ver ? mode - 26 : 10 - mode;
  const int abs_ang = ang_mode < 0 ? -ang_mode : ang_mode;
  const int angle = ang_mode < 0 ? -ang[abs_ang] : ang[abs_ang];
  const int inv_angle = ang[9 + abs_ang];
  if (is_ver) angular_tile<S, T, true>(buf, angle, inv_angle, ty, tx, v);
  else angular_tile<S, T, false>(buf, angle, inv_angle, ty, tx, v);
  if (p.edge) {                          // pure vertical / horizontal edges
    if (mode == 26 && tx == 0)
#pragma unroll
      for (int i = 0; i < T; ++i)
        v[i * T] = clampi(bu[corner + 1] +
                          ((bu[corner - 1 - ty - i] - bu[corner]) >> 1),
                          0, p.maxv);
    if (mode == 10 && ty == 0)
#pragma unroll
      for (int j = 0; j < T; ++j)
        v[j] = clampi(bu[corner - 1] +
                      ((bu[corner + 1 + tx + j] - bu[corner]) >> 1),
                      0, p.maxv);
  }
}

// the T samples (r, c0 .. c0 + T - 1) of intra mode `mode`'s prediction of
// an S x S block (pred_tile's arithmetic, one row)
template <int S, int T>
__device__ __forceinline__ void pred_row(const int* bu, const int* ang,
                                         int dcval, int mode, int r, int c0,
                                         const TqParams& p, int (&v)[T]) {
  constexpr int corner = 2 * S, B = 4 * S + 1;
  constexpr int log2 = S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : 5;
  const int* buf = ((p.filt >> mode) & 1ull) ? bu + B : bu;
  if (mode == 0) {                       // planar
    const int tr = buf[corner + S + 1], bl = buf[corner - S - 1];
    const int left = buf[corner - 1 - r];
#pragma unroll
    for (int e = 0; e < T; ++e) {
      const int c = c0 + e;
      v[e] = ((S - 1 - c) * left + (c + 1) * tr +
              (S - 1 - r) * buf[corner + 1 + c] + (r + 1) * bl + S) >>
             (log2 + 1);
    }
    return;
  }
  if (mode == 1) {                       // DC, edge-filtered for luma <= 16
#pragma unroll
    for (int e = 0; e < T; ++e)
      v[e] = p.edge && r == 0 ? (bu[corner + 1 + c0 + e] + 3 * dcval + 2) >> 2
                              : dcval;
    if (p.edge && c0 == 0)
      v[0] = r == 0 ? (bu[corner + 1] + bu[corner - 1] + 2 * dcval + 2) >> 2
                    : (bu[corner - 1 - r] + 3 * dcval + 2) >> 2;
    return;
  }
  const bool is_ver = mode >= 18;
  const int ang_mode = is_ver ? mode - 26 : 10 - mode;
  const int abs_ang = ang_mode < 0 ? -ang_mode : ang_mode;
  const int angle = ang_mode < 0 ? -ang[abs_ang] : ang[abs_ang];
  const int inv_angle = ang[9 + abs_ang];
  if (is_ver) {                          // the row is one line
    const int delta = (r + 1) * angle;
    const int iidx = delta >> 5, frac = delta & 31, k0 = 1 + iidx + c0;
    int q[T + 1];
#pragma unroll
    for (int e = 0; e <= T; ++e)
      q[e] = buf[ref_main_index<S>(k0 + e, true, inv_angle)];
#pragma unroll
    for (int e = 0; e < T; ++e)
      v[e] = ((32 - frac) * q[e] + frac * q[e + 1] + 16) >> 5;
  } else {                               // a sample of each line
#pragma unroll
    for (int e = 0; e < T; ++e) {
      const int delta = (c0 + e + 1) * angle;
      const int iidx = delta >> 5, frac = delta & 31, k = 1 + iidx + r;
      const int q0 = buf[ref_main_index<S>(k, false, inv_angle)];
      const int q1 = buf[ref_main_index<S>(k + 1, false, inv_angle)];
      v[e] = ((32 - frac) * q0 + frac * q1 + 16) >> 5;
    }
  }
  if (p.edge) {                          // pure vertical / horizontal edges
    if (mode == 26 && c0 == 0)
      v[0] = clampi(bu[corner + 1] + ((bu[corner - 1 - r] - bu[corner]) >> 1),
                    0, p.maxv);
    if (mode == 10 && r == 0)
#pragma unroll
      for (int e = 0; e < T; ++e)
        v[e] = clampi(bu[corner - 1] +
                      ((bu[corner + 1 + c0 + e] - bu[corner]) >> 1),
                      0, p.maxv);
  }
}

// ---------------------------------------------------------------------------
// staging, the SATD stage, the per-block picks
// ---------------------------------------------------------------------------

// the CTA's ng blocks from n0 (buffers, blocks), the transform matrix and
// its transpose, the angle tables, each block's DC value; ends synchronised
template <int S, class Sm>
__device__ void stage_blocks(Sm& sm, const IntraArgs& a, int n0, int ng) {
  constexpr int B = Sm::B, TT = S * S, G = sizeof(sm.dcval) / sizeof(int);
  constexpr int log2 = S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : 5;
  const int tid = threadIdx.x;
  const int* gb = a.bufs + (size_t)n0 * 2 * B;
  for (int q = tid; q < ng * 2 * B; q += kIntraThreads)
    cp_async4(&sm.buf[(q / (2 * B)) * Sm::BS + q % (2 * B)], gb + q);
  const int* go = a.blocks + (size_t)n0 * TT;
  if (((uintptr_t)go & 15) == 0) {
    for (int q = tid * 4; q < ng * TT; q += kIntraThreads * 4)
      cp_async16(&sm.orig[q / TT][q % TT], go + q);
  } else {
    for (int q = tid; q < ng * TT; q += kIntraThreads)
      cp_async4(&sm.orig[q / TT][q % TT], go + q);
  }
  for (int q = tid; q < TT; q += kIntraThreads) {
    const int v = a.tm[q];
    sm.tm[q] = v;
    sm.tmT[(q % S) * S + q / S] = v;
  }
  if (tid < 18) sm.ang[tid] = a.ang[tid];
  cp_async_wait_all();
  __syncthreads();
  if (tid < G) {
    const int* bu = sm.buf + tid * Sm::BS;
    int sum = S;
    for (int i = 0; i < S; ++i) sum += bu[2 * S + 1 + i] + bu[2 * S - 1 - i];
    sm.dcval[tid] = sum >> (log2 + 1);
  }
  __syncthreads();
}

// HM's 4x4 Hadamard SATD of one tile of differences, (sum |H d H| + 1) >> 1
__device__ __forceinline__ int satd4x4(int (&v)[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 1; h < 4; h <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!(i & h)) {
          const int x = v[r * 4 + i], y = v[r * 4 + i + h];
          v[r * 4 + i] = x + y;
          v[r * 4 + i + h] = x - y;
        }
  int sum = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int h = 1; h < 4; h <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!(i & h)) {
          const int x = v[i * 4 + c], y = v[(i + h) * 4 + c];
          v[i * 4 + c] = x + y;
          v[(i + h) * 4 + c] = x - y;
        }
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += abs(v[i * 4 + c]);
  }
  return (sum + 1) >> 1;
}

// sm.satd[g][mode] for every block and mode: warp w takes the modes w,
// w + 7, ...; lane = g * NT + tile; ends synchronised
template <int S, class Sm>
__device__ void satd_stage(Sm& sm, const TqParams& p) {
  constexpr int T = S == 4 ? 4 : 8, TPR = S / T, NT = TPR * TPR;
  const int lane = threadIdx.x & 31, g = lane / NT, t = lane % NT;
  const int ty = (t / TPR) * T, tx = (t % TPR) * T;
  const int* bu = sm.buf + g * Sm::BS;
  const int* o = sm.orig[g] + ty * S + tx;
  const int dc = sm.dcval[g];
  for (int mode = threadIdx.x >> 5; mode < 35; mode += kIntraWarps) {
    int v[T * T];
    pred_tile<S, T>(bu, sm.ang, dc, mode, ty, tx, p, v);
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; j += 4) {
        const int4 x = *(const int4*)(o + i * S + j);
        v[i * T + j] -= x.x;
        v[i * T + j + 1] -= x.y;
        v[i * T + j + 2] -= x.z;
        v[i * T + j + 3] -= x.w;
      }
    int sad;
    if constexpr (T == 8) sad = satd8x8(v);
    else sad = satd4x4(v);
#pragma unroll
    for (int off = NT / 2; off > 0; off >>= 1)
      sad += __shfl_xor_sync(kAll, sad, off);
    if (t == 0) sm.satd[g][mode] = sad;
  }
  __syncthreads();
}

// the N least of the values x added in index order, ascending, ties to the
// lowest index, as the reference's repeated masked argmin: each x goes in
// before the first entry it is strictly less than (branch-free)
template <int N>
struct Least {
  float v[N];
  int k[N];
  __device__ __forceinline__ Least() {
#pragma unroll
    for (int j = 0; j < N; ++j) { v[j] = __int_as_float(0x7f800000); k[j] = 0; }
  }
  __device__ __forceinline__ void add(float x, int i) {
#pragma unroll
    for (int j = N - 1; j > 0; --j) {
      const bool here = x < v[j], above = x < v[j - 1];
      v[j] = above ? v[j - 1] : (here ? x : v[j]);
      k[j] = above ? k[j - 1] : (here ? i : k[j]);
    }
    if (x < v[0]) { v[0] = x; k[0] = i; }
  }
};

// block g's integer SATD argmin, ties to the lowest mode (one thread)
template <class Sm>
__device__ __forceinline__ int argmin35(const Sm& sm, int g) {
  int best = 0, v = sm.satd[g][0];
  for (int m = 1; m < 35; ++m) {
    const int x = sm.satd[g][m];
    if (x < v) { v = x; best = m; }
  }
  return best;
}

// ---------------------------------------------------------------------------
// the transform chain over the CTA's trial units
// ---------------------------------------------------------------------------

// Unit u = j * ng + g (ng = nu / kc) is candidate sm.cand[g][cbase + j] of
// block g, for u < nu: neighbouring units share a candidate rank, which for
// K3's chroma modes (planar, vertical, horizontal, DC, DM) is mostly one
// mode, so a warp's predictions seldom diverge.  FULL: forward transform,
// quant, dequant, inverse, SSE; then, on one thread of the unit, fin(g, j,
// sse, nnz, gt1, esc, last_x, last_y).  Not FULL (the analysis mode, kc =
// 1): forward transform and quant, the levels written to levels[g * s * s
// ...].  The caller synchronises before it reuses sm.cand or the units'
// buffers.
//
// s <= kRowsMax: S lanes per unit, lane i owning row i of each stage in
// registers (its prediction, residual, stage-1 row; then row i of the
// coefficients, levels and dequantised values; row i of both inverse
// stages), the rows exchanged through the unit's shared-memory tiles
// within the warp (__syncwarp, no CTA barrier); the statistics and the SSE
// from shuffles over the unit's lanes.
template <int S, bool FULL, class Sm, class Fin>
__device__ void chain_rows(Sm& sm, const TqParams& p, int nu, int kc,
                           int cbase, int* levels, Fin fin) {
  const int i = threadIdx.x % S, ng = nu / kc;
  const int span = (nu * S + 31) / 32 * 32;  // whole warps: full-mask syncs
  for (int it = threadIdx.x; it < span; it += kIntraThreads) {
    const bool valid = it < nu * S;
    const int u = valid ? it / S : 0, g = u % ng, j = u / ng;
    int v[S], x[S], c[S];
    pred_row<S, S>(sm.buf + g * Sm::BS, sm.ang, sm.dcval[g],
                   sm.cand[g][cbase + j], i, 0, p, v);
    const int* o = sm.orig[g] + i * S;
    int r[S];
#pragma unroll
    for (int e = 0; e < S; e += 4) {
      const int4 q = *(const int4*)(o + e);
      r[e] = q.x - v[e]; r[e + 1] = q.y - v[e + 1];
      r[e + 2] = q.z - v[e + 2]; r[e + 3] = q.w - v[e + 3];
    }
    // forward stage 1, row i: x[k] = sum_e resi[i][e] D[k][e]
#pragma unroll
    for (int k = 0; k < S; ++k) {
      int acc = 0;
#pragma unroll
      for (int e = 0; e < S; e += 4) {
        const int4 t = *(const int4*)(sm.tm + k * S + e);
        acc += r[e] * t.x + r[e + 1] * t.y + r[e + 2] * t.z + r[e + 3] * t.w;
      }
      x[k] = p.fwd_s1 > 0 ? (acc + (1 << (p.fwd_s1 - 1))) >> p.fwd_s1
                          : acc << (-p.fwd_s1);
    }
    int* ta = sm.a[u];
#pragma unroll
    for (int e = 0; e < S; e += 4)
      *(int4*)(ta + i * S + e) = make_int4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    __syncwarp();
    // forward stage 2, row i: c[j] = sum_e D[i][e] x_e[j]; quant
#pragma unroll
    for (int e = 0; e < S; ++e) c[e] = 0;
#pragma unroll
    for (int e = 0; e < S; ++e) {
      const int d = sm.tm[i * S + e];
#pragma unroll
      for (int q = 0; q < S; q += 4) {
        const int4 xr = *(const int4*)(ta + e * S + q);
        c[q] += d * xr.x; c[q + 1] += d * xr.y;
        c[q + 2] += d * xr.z; c[q + 3] += d * xr.w;
      }
    }
    int nnz = 0, gt1 = 0, esc = 0, lx = -1, ly = -1;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int coef = (c[q] + (1 << (p.fwd_s2 - 1))) >> p.fwd_s2;
      const int av = coef < 0 ? -coef : coef;
      int lv = (av * p.q_scale + p.q_add) >> p.q_bits;
      lv = lv < 32767 ? lv : 32767;
      const int level = coef < 0 ? -lv : (coef > 0 ? lv : 0);
      if (lv > 0) {
        ++nnz;
        lx = q;
        ly = i;
        if (lv > 1) {
          ++gt1;
          esc += 2 * bit_length(lv - 1) + 1;
        }
      }
      if (FULL) {
        int dq = clampi(level, p.dq_min, p.dq_max) * p.dq_scale;
        dq = p.dq_shift > 0 ? (dq + (1 << (p.dq_shift - 1))) >> p.dq_shift
                            : dq << (-p.dq_shift);
        c[q] = clampi(dq, -32768, 32767);
      } else {
        c[q] = level;
      }
    }
    if (!FULL) {
      if (valid)
#pragma unroll
        for (int q = 0; q < S; q += 4)
          *(int4*)(levels + (size_t)g * S * S + i * S + q) =
              make_int4(c[q], c[q + 1], c[q + 2], c[q + 3]);
      continue;
    }
    int* tb = sm.b[u];
#pragma unroll
    for (int q = 0; q < S; q += 4)
      *(int4*)(tb + i * S + q) = make_int4(c[q], c[q + 1], c[q + 2], c[q + 3]);
    __syncwarp();
    // inverse stage 1, row i: x[k] = clip((sum_e D[e][i] deq[e][k] + 64) >> 7)
#pragma unroll
    for (int e = 0; e < S; ++e) x[e] = 0;
#pragma unroll
    for (int e = 0; e < S; ++e) {
      const int d = sm.tmT[i * S + e];
#pragma unroll
      for (int q = 0; q < S; q += 4) {
        const int4 br = *(const int4*)(tb + e * S + q);
        x[q] += d * br.x; x[q + 1] += d * br.y;
        x[q + 2] += d * br.z; x[q + 3] += d * br.w;
      }
    }
#pragma unroll
    for (int e = 0; e < S; ++e) x[e] = clampi((x[e] + 64) >> 7, -32768, 32767);
    // inverse stage 2, row i: sum_e x[e] D[e][k]; reconstruction, SSE
#pragma unroll
    for (int e = 0; e < S; ++e) c[e] = 0;
#pragma unroll
    for (int e = 0; e < S; ++e) {
#pragma unroll
      for (int q = 0; q < S; q += 4) {
        const int4 t = *(const int4*)(sm.tm + e * S + q);
        c[q] += x[e] * t.x; c[q + 1] += x[e] * t.y;
        c[q + 2] += x[e] * t.z; c[q + 3] += x[e] * t.w;
      }
    }
    unsigned int sse = 0;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int rres = clampi((c[q] + (1 << (p.inv_s2 - 1))) >> p.inv_s2,
                              -32768, 32767);
      const int d = o[q] - clampi(v[q] + rres, 0, p.maxv);
      sse += (unsigned int)(d * d);
    }
#pragma unroll
    for (int off = 1; off < S; off <<= 1) {
      nnz += __shfl_xor_sync(kAll, nnz, off);
      gt1 += __shfl_xor_sync(kAll, gt1, off);
      esc += __shfl_xor_sync(kAll, esc, off);
      sse += __shfl_xor_sync(kAll, sse, off);
      lx = max(lx, __shfl_xor_sync(kAll, lx, off));
      ly = max(ly, __shfl_xor_sync(kAll, ly, off));
    }
    if (valid && i == 0) fin(g, j, sse, nnz, gt1, esc, lx, ly);
  }
}

template <int S, bool FULL, class Sm, class Fin>
__device__ void chain(Sm& sm, const TqParams& p, int nu, int kc, int cbase,
                      int* levels, Fin fin) {
  if constexpr (S <= kRowsMax) {
    chain_rows<S, FULL>(sm, p, nu, kc, cbase, levels, fin);
  } else {
    constexpr int TT = S * S, RB = Sm::RB, IPU = Sm::IPU, NCH = Sm::NCH;
    constexpr int TPR = S / 8, NT8 = TPR * TPR;
    const int tid = threadIdx.x, ng = nu / kc;

    // ---- predictions (int16) and residuals, an 8x8 tile per item ----
    for (int it = tid; it < nu * NT8; it += kIntraThreads) {
      const int u = it / NT8, t = it % NT8, g = u % ng;
      const int ty = (t / TPR) * 8, tx = (t % TPR) * 8;
      int v[64];
      pred_tile<S, 8>(sm.buf + g * Sm::BS, sm.ang, sm.dcval[g],
                      sm.cand[g][cbase + u / ng], ty, tx, p, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = (ty + i) * S + tx;
        const int4 o0 = *(const int4*)(sm.orig[g] + e);
        const int4 o1 = *(const int4*)(sm.orig[g] + e + 4);
        const int* w = v + i * 8;
        *(int4*)(sm.a[u] + e) = make_int4(o0.x - w[0], o0.y - w[1],
                                          o0.z - w[2], o0.w - w[3]);
        *(int4*)(sm.a[u] + e + 4) = make_int4(o1.x - w[4], o1.y - w[5],
                                              o1.z - w[6], o1.w - w[7]);
        if (FULL)
#pragma unroll
          for (int q = 0; q < 8; ++q) sm.pr[u][e + q] = (short)w[q];
      }
    }
    __syncthreads();

    // ---- forward stage 1: b[i][k] = sum_j resi[i][j] * D[k][j] ----
    for (int it = tid; it < nu * IPU; it += kIntraThreads) {
      const int u = it / IPU, rem = it % IPU, c = rem % S, r0 = rem / S;
      int acc[RB];
      mm_item<S, RB>(sm.a[u], sm.tmT, r0, c, acc);
#pragma unroll
      for (int q = 0; q < RB; ++q)
        sm.b[u][(r0 + q * (S / RB)) * S + c] = p.fwd_s1 > 0
            ? (acc[q] + (1 << (p.fwd_s1 - 1))) >> p.fwd_s1
            : acc[q] << (-p.fwd_s1);
    }
    __syncthreads();

    // ---- forward stage 2, quant; FULL: statistics (per warp), dequant ----
    for (int it = tid; it < nu * IPU; it += kIntraThreads) {
      const int u = it / IPU, rem = it % IPU, c = rem % S, r0 = rem / S;
      int acc[RB];
      mm_item<S, RB>(sm.tm, sm.b[u], r0, c, acc);
      int nnz = 0, gt1 = 0, esc = 0, lx = -1, ly = -1;
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int k = r0 + q * (S / RB);
        const int coef = (acc[q] + (1 << (p.fwd_s2 - 1))) >> p.fwd_s2;
        const int av = coef < 0 ? -coef : coef;
        int lv = (av * p.q_scale + p.q_add) >> p.q_bits;
        lv = lv < 32767 ? lv : 32767;
        const int level = coef < 0 ? -lv : (coef > 0 ? lv : 0);
        if (!FULL) {
          levels[(size_t)u * TT + k * S + c] = level;
          continue;
        }
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
        sm.a[u][k * S + c] = clampi(dq, -32768, 32767);
      }
      if (FULL) {
        nnz = __reduce_add_sync(kAll, nnz);
        gt1 = __reduce_add_sync(kAll, gt1);
        esc = __reduce_add_sync(kAll, esc);
        lx = __reduce_max_sync(kAll, lx);
        ly = __reduce_max_sync(kAll, ly);
        if ((tid & 31) == 0) {
          int* st = sm.stat[u][rem >> 5];
          st[0] = nnz; st[1] = gt1; st[2] = esc; st[3] = lx; st[4] = ly;
        }
      }
    }
    if (!FULL) return;
    __syncthreads();

    // ---- inverse stage 1: b[i][k] = clip((sum_j D[j][i] dq[j][k] + 64) >> 7)
    for (int it = tid; it < nu * IPU; it += kIntraThreads) {
      const int u = it / IPU, rem = it % IPU, c = rem % S, r0 = rem / S;
      int acc[RB];
      mm_item<S, RB>(sm.tmT, sm.a[u], r0, c, acc);
#pragma unroll
      for (int q = 0; q < RB; ++q)
        sm.b[u][(r0 + q * (S / RB)) * S + c] =
            clampi((acc[q] + 64) >> 7, -32768, 32767);
    }
    __syncthreads();

    // ---- inverse stage 2, reconstruction, SSE (per warp) ----
    for (int it = tid; it < nu * IPU; it += kIntraThreads) {
      const int u = it / IPU, rem = it % IPU, c = rem % S, r0 = rem / S;
      const int* ob = sm.orig[u % ng];
      int acc[RB];
      mm_item<S, RB>(sm.b[u], sm.tm, r0, c, acc);
      unsigned int sse = 0;
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int i = r0 + q * (S / RB);
        const int rres = clampi((acc[q] + (1 << (p.inv_s2 - 1))) >> p.inv_s2,
                                -32768, 32767);
        const int d = ob[i * S + c] - clampi(sm.pr[u][i * S + c] + rres, 0,
                                             p.maxv);
        sse += (unsigned int)(d * d);
      }
      sse = __reduce_add_sync(kAll, sse);
      if ((tid & 31) == 0) sm.sse[u][rem >> 5] = sse;
    }
    __syncthreads();

    // ---- a thread per unit ----
    if (tid < nu) {
      int nnz = 0, gt1 = 0, esc = 0, lx = -1, ly = -1;
      unsigned int sse = 0;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int* st = sm.stat[tid][ch];
        nnz += st[0]; gt1 += st[1]; esc += st[2];
        lx = max(lx, st[3]); ly = max(ly, st[4]);
        sse += sm.sse[tid][ch];
      }
      fin(tid % ng, tid / ng, sse, nnz, gt1, esc, lx, ly);
    }
  }
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// K2: RD mode (a.k candidates by SATD, their transform RD, the RD top 3),
// or SATD-only (RD false: the integer SATD argmin)
template <int S, bool RD>
using RdSmem = IntraSmem<S, satd_group(S), RD ? rd_kc(S) : 0>;

template <int S, bool RD>
__global__ void __launch_bounds__(kIntraThreads)
size_rd_kernel(IntraArgs a) {
  using Sm = RdSmem<S, RD>;
  constexpr int G = satd_group(S), KC = RD ? rd_kc(S) : 1;
  extern __shared__ uint4 intra_smem[];
  Sm& sm = *reinterpret_cast<Sm*>(intra_smem);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * G, ng = min(G, a.n - n0);
  stage_blocks<S>(sm, a, n0, ng);
  satd_stage<S>(sm, a.p);
  if (a.want_satd)
    for (int q = tid; q < ng * 35; q += kIntraThreads)
      a.satd[(size_t)n0 * 35 + q] = sm.satd[q / 35][q % 35];
  if (!RD) {                  // SATD-only: integer argmin, ties to the lowest
    if (tid < ng) a.mode[n0 + tid] = argmin35(sm, tid);
    return;
  }
  // top-k modes by float32 SATD, ascending, ties to the lowest mode
  if (tid < ng) {
    Least<4> t;
    for (int m = 0; m < 35; ++m) t.add(__int2float_rn(sm.satd[tid][m]), m);
#pragma unroll
    for (int j = 0; j < 4; ++j) sm.cand[tid][j] = t.k[j];
  }
  __syncthreads();
  // the candidates' transform RD, KC at a time
  const float lam = a.lam, mode_bits = a.model[MODEL_MODE_BITS];
  for (int j0 = 0; j0 < a.k; j0 += KC) {
    const int kc = min(KC, a.k - j0);
    chain<S, true>(sm, a.p, ng * kc, kc, j0, nullptr,
                   [&](int g, int j, unsigned int sse, int nnz, int gt1,
                       int esc, int lx, int ly) {
      const float dist = __int2float_rn((int)sse);
      const float bits = __fadd_rn(
          bits_estimate(nnz, lx, ly, gt1, esc, a.model), mode_bits);
      sm.cost[g][j0 + j] = __fmaf_rn(lam, bits, dist);
    });
    __syncthreads();
  }
  // RD-ranked top 3 of the k candidates
  if (tid < ng) {
    Least<3> t;
    for (int j = 0; j < a.k; ++j) t.add(sm.cost[tid][j], j);
    const size_t nb = n0 + tid;
#pragma unroll
    for (int r = 0; r < 3; ++r) a.top3[nb * 3 + r] = sm.cand[tid][t.k[r]];
    a.mode[nb] = sm.cand[tid][t.k[0]];
    a.cost[nb] = t.v[0];
  }
}

// K3: dist and bits of a.k given modes per block
template <int S>
using CandSmem = IntraSmem<S, cand_group(S), cand_kc(S)>;

template <int S>
__global__ void __launch_bounds__(kIntraThreads)
cand_rd_kernel(IntraArgs a) {
  using Sm = CandSmem<S>;
  constexpr int G = cand_group(S), KC = cand_kc(S);
  extern __shared__ uint4 intra_smem[];
  Sm& sm = *reinterpret_cast<Sm*>(intra_smem);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * G, ng = min(G, a.n - n0), K = a.k;
  stage_blocks<S>(sm, a, n0, ng);
  for (int j0 = 0; j0 < K; j0 += KC) {
    const int kc = min(KC, K - j0);
    for (int q = tid; q < ng * kc; q += kIntraThreads)
      sm.cand[q / kc][q % kc] =
          a.modes[(size_t)(n0 + q / kc) * K + j0 + q % kc];
    __syncthreads();
    chain<S, true>(sm, a.p, ng * kc, kc, 0, nullptr,
                   [&](int g, int j, unsigned int sse, int nnz, int gt1,
                       int esc, int lx, int ly) {
      const size_t o = (size_t)(n0 + g) * K + j0 + j;
      a.dist[o] = __int2float_rn((int)sse);
      a.bits[o] = bits_estimate(nnz, lx, ly, gt1, esc, a.model);
    });
    __syncthreads();
  }
}

// analysis mode: per block the SATD argmin mode, its SATD and the levels of
// its residual; the SATDs summed into *a.total
template <int S>
using AnalysisSmem = IntraSmem<S, satd_group(S), 1>;

template <int S>
__global__ void __launch_bounds__(kIntraThreads)
analysis_kernel(IntraArgs a) {
  using Sm = AnalysisSmem<S>;
  constexpr int G = satd_group(S);
  extern __shared__ uint4 intra_smem[];
  Sm& sm = *reinterpret_cast<Sm*>(intra_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * G, ng = min(G, a.n - n0);
  stage_blocks<S>(sm, a, n0, ng);
  satd_stage<S>(sm, a.p);
  if (tid < ng) {                // ties to the lowest mode
    const int best = argmin35(sm, tid);
    sm.cand[tid][0] = best;
    a.mode[n0 + tid] = best;
    a.satd[n0 + tid] = sm.satd[tid][best];
  }
  __syncthreads();
  if (warp == 0) {             // int32 wrap-around, as the reference's sum
    unsigned int v =
        lane < ng ? (unsigned int)sm.satd[lane][sm.cand[lane][0]] : 0u;
    v = __reduce_add_sync(kAll, v);
    if (lane == 0) atomicAdd((unsigned int*)a.total, v);
  }
  chain<S, false>(sm, a.p, ng, 1, 0, a.levels + (size_t)n0 * S * S,
                  [](int, int, unsigned int, int, int, int, int, int) {});
}

template <class Sm, class Kernel>
static int launch(Kernel kernel, int ctas, const IntraArgs& a,
                  cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Sm));
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, kIntraThreads, sizeof(Sm), st>>>(a);
  return (int)cudaGetLastError();
}

// op 0: RD, 1: SATD-only, 2: K3, 3: analysis
template <int S>
static int launch_op(int op, const IntraArgs& a, cudaStream_t st) {
  const int gs = satd_group(S), gc = cand_group(S);
  switch (op) {
    case 0: return launch<RdSmem<S, true>>(size_rd_kernel<S, true>,
                                           (a.n + gs - 1) / gs, a, st);
    case 1: return launch<RdSmem<S, false>>(size_rd_kernel<S, false>,
                                            (a.n + gs - 1) / gs, a, st);
    case 2: return launch<CandSmem<S>>(cand_rd_kernel<S>,
                                       (a.n + gc - 1) / gc, a, st);
    default: return launch<AnalysisSmem<S>>(analysis_kernel<S>,
                                            (a.n + gs - 1) / gs, a, st);
  }
}

static int launch_intra(int op, const IntraArgs& a, cudaStream_t st) {
  switch (a.p.s) {
    case 4: return launch_op<4>(op, a, st);
    case 8: return launch_op<8>(op, a, st);
    case 16: return launch_op<16>(op, a, st);
    case 32: return launch_op<32>(op, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int S>
static size_t smem_bytes(int op) {
  switch (op) {
    case 0: return sizeof(RdSmem<S, true>);
    case 1: return sizeof(RdSmem<S, false>);
    case 2: return sizeof(CandSmem<S>);
    default: return sizeof(AnalysisSmem<S>);
  }
}

}  // namespace hm

extern "C" int hm_intra_size_rd(const int* bufs, const int* blocks, int n,
                                const hm::TqParams* p, const int* tm,
                                const int* ang, const float* model,
                                float lam, int k, int want_satd,
                                int* out_mode, float* out_cost,
                                int* out_top3, int* out_satd, void* stream) {
  if (n <= 0 || k < 0 || k > 4) return (int)cudaErrorInvalidValue;
  hm::IntraArgs a{};
  a.bufs = bufs; a.blocks = blocks; a.n = n; a.k = k; a.p = *p; a.tm = tm;
  a.ang = ang; a.model = model; a.lam = lam; a.want_satd = want_satd;
  a.mode = out_mode; a.cost = out_cost; a.top3 = out_top3; a.satd = out_satd;
  return hm::launch_intra(k ? 0 : 1, a, (cudaStream_t)stream);
}

extern "C" int hm_intra_cand_rd(const int* bufs, const int* blocks,
                                const int* modes, int n, int K,
                                const hm::TqParams* p, const int* tm,
                                const int* ang, const float* model,
                                float* out_dist, float* out_bits,
                                void* stream) {
  if (n <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  hm::IntraArgs a{};
  a.bufs = bufs; a.blocks = blocks; a.modes = modes; a.n = n; a.k = K;
  a.p = *p; a.tm = tm; a.ang = ang; a.model = model; a.dist = out_dist;
  a.bits = out_bits;
  return hm::launch_intra(2, a, (cudaStream_t)stream);
}

// total: one int32, zeroed by the caller
extern "C" int hm_analysis_step(const int* bufs, const int* blocks, int n,
                                const hm::TqParams* p, const int* tm,
                                const int* ang, int* best, int* cost,
                                int* levels, int* total, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  hm::IntraArgs a{};
  a.bufs = bufs; a.blocks = blocks; a.n = n; a.p = *p; a.tm = tm;
  a.ang = ang; a.mode = best; a.satd = cost; a.levels = levels;
  a.total = total;
  return hm::launch_intra(3, a, (cudaStream_t)stream);
}

// K2's and K3's dynamic shared memory per CTA in bytes (op 0: RD, 1:
// SATD-only, 2: K3, 3: analysis; 0 for a size they lack)
extern "C" size_t hm_intra_smem_bytes(int s, int op) {
  switch (s) {
    case 4: return hm::smem_bytes<4>(op);
    case 8: return hm::smem_bytes<8>(op);
    case 16: return hm::smem_bytes<16>(op);
    case 32: return hm::smem_bytes<32>(op);
    default: return 0;
  }
}

extern "C" const char* hm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// the argument struct's size, checked against its ctypes mirror
extern "C" size_t hm_sizeof_tq_params() { return sizeof(hm::TqParams); }

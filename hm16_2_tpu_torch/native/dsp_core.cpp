// Native DSP hot loops for the encoder's per-TU coding path.
//
// Fused transform -> quant -> dequant -> inverse-transform -> reconstruct,
// exactly mirroring hm16_2_tpu/ops/transforms_ref.py (which itself mirrors
// the normative spec 8.6.3-8.6.5 semantics: 6-bit matrices, HM shift
// schedule, flat scaling lists, 171/512 intra / 85/512 inter rounding).
//
// Built with g++ -O3 -shared -fPIC by hm16_2_tpu.native.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

static const int32_t *g_dct[6] = {0, 0, 0, 0, 0, 0};  // index log2: 2..5
static const int32_t *g_dst4 = 0;
static int32_t g_qscale[6];
static int32_t g_iqscale[6];

extern "C" void set_dsp_tables(const void *d4, const void *d8,
                               const void *d16, const void *d32,
                               const void *dst4, const void *qs,
                               const void *iqs) {
  g_dct[2] = (const int32_t *)d4;
  g_dct[3] = (const int32_t *)d8;
  g_dct[4] = (const int32_t *)d16;
  g_dct[5] = (const int32_t *)d32;
  g_dst4 = (const int32_t *)dst4;
  memcpy(g_qscale, qs, 6 * sizeof(int32_t));
  memcpy(g_iqscale, iqs, 6 * sizeof(int32_t));
}

static inline int64_t clip64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// out[i][j] = sum_k a[i][k] * bT[j][k]   (b transposed), n x n
static void matmul_abt(const int64_t *a, const int32_t *b, int n,
                       int64_t *out) {
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++) {
      int64_t acc = 0;
      const int64_t *ar = a + i * n;
      const int32_t *br = b + j * n;
      for (int k = 0; k < n; k++) acc += ar[k] * (int64_t)br[k];
      out[i * n + j] = acc;
    }
}

// out[i][j] = sum_k t[i][k] * a[k][j]
static void matmul_ta(const int32_t *t, const int64_t *a, int n,
                      int64_t *out) {
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++) {
      int64_t acc = 0;
      for (int k = 0; k < n; k++)
        acc += (int64_t)t[i * n + k] * a[k * n + j];
      out[i * n + j] = acc;
    }
}

// out[i][j] = sum_k tT[k][i] * a[k][j]  (t transposed on the left)
static void matmul_tta(const int32_t *t, const int64_t *a, int n,
                       int64_t *out) {
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++) {
      int64_t acc = 0;
      for (int k = 0; k < n; k++)
        acc += (int64_t)t[k * n + i] * a[k * n + j];
      out[i * n + j] = acc;
    }
}

// out[i][j] = sum_k a[i][k] * t[k][j]
static void matmul_at(const int64_t *a, const int32_t *t, int n,
                      int64_t *out) {
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++) {
      int64_t acc = 0;
      const int64_t *ar = a + i * n;
      for (int k = 0; k < n; k++) acc += ar[k] * (int64_t)t[k * n + j];
      out[i * n + j] = acc;
    }
}

// Fused TU coding.  orig/pred: n*n int32 row-major with given strides
// (elements).  Writes quantized levels (n*n int32, stride lvl_stride) and
// reconstruction (stride rec_stride).  Returns cbf (0/1), or -1 on error.
// HM signBitHidingHDQ (TComTrQuant.cpp:952-1086): per coefficient group
// along the coding scan, force the parity of the absolute sum to encode
// the first nonzero's sign, adjusting the level with the cheapest
// rounding-error delta.
static void sbh_adjust(int32_t *levels, int64_t lvl_stride,
                       const int64_t *coef /* n*n pre-quant, raster */,
                       const int64_t *deltaU /* n*n, raster */, int n,
                       const int32_t *scan) {
  const int num = n * n;
  int lastCG = -1;
  for (int subSet = (num - 1) >> 4; subSet >= 0; subSet--) {
    int subPos = subSet << 4;
    int firstNZ = 16, lastNZ = -1;
    long absSum = 0;
    for (int k = 15; k >= 0; --k) {
      int bp = scan[subPos + k];
      if (levels[(bp / n) * lvl_stride + (bp % n)]) { lastNZ = k; break; }
    }
    for (int k = 0; k < 16; k++) {
      int bp = scan[subPos + k];
      if (levels[(bp / n) * lvl_stride + (bp % n)]) { firstNZ = k; break; }
    }
    for (int k = firstNZ; k <= lastNZ; k++) {
      int bp = scan[subPos + k];
      absSum += levels[(bp / n) * lvl_stride + (bp % n)];
    }
    if (lastNZ >= 0 && lastCG == -1) lastCG = 1;
    if (lastNZ - firstNZ >= 4 /* SBH_THRESHOLD */) {
      int bp_first = scan[subPos + firstNZ];
      int signbit =
          levels[(bp_first / n) * lvl_stride + (bp_first % n)] > 0 ? 0 : 1;
      if (signbit != (int)(absSum & 1)) {
        int64_t minCostInc = INT64_MAX;
        int minPos = -1, finalChange = 0;
        for (int k = (lastCG == 1 ? lastNZ : 15); k >= 0; --k) {
          int bp = scan[subPos + k];
          int32_t q = levels[(bp / n) * lvl_stride + (bp % n)];
          int64_t curCost;
          int curChange = 0;
          if (q != 0) {
            if (deltaU[bp] > 0) {
              curCost = -deltaU[bp];
              curChange = 1;
            } else if (k == firstNZ && (q == 1 || q == -1)) {
              curCost = INT64_MAX;
            } else {
              curCost = deltaU[bp];
              curChange = -1;
            }
          } else if (k < firstNZ) {
            int thisSign = coef[bp] >= 0 ? 0 : 1;
            if (thisSign != signbit) {
              curCost = INT64_MAX;
            } else {
              curCost = -deltaU[bp];
              curChange = 1;
            }
          } else {
            curCost = -deltaU[bp];
            curChange = 1;
          }
          if (curCost < minCostInc) {
            minCostInc = curCost;
            finalChange = curChange;
            minPos = bp;
          }
        }
        int32_t *tgt = &levels[(minPos / n) * lvl_stride + (minPos % n)];
        if (*tgt == 32767 || *tgt == -32768) finalChange = -1;
        if (coef[minPos] >= 0) *tgt += finalChange;
        else *tgt -= finalChange;
      }
    }
    if (lastCG == 1) lastCG = 0;
  }
}

// ---------------------------------------------------------------------------
// RDOQ cost model (rate side of TComTrQuant.cpp:1974-2547's objective;
// flat scaling lists, Main/Main10 path).  The decision ALGORITHM lives
// in rdoq_trellis below — a beam search over the CABAC rate-context
// trellis, not HM's greedy scan.
//
// Context bit costs are supplied by the Python side as per-context
// (bits-for-0, bits-for-1) double pairs derived from the slice-initial
// CABAC states — the classic fixed-estimate approximation of HM's
// estBitsSbac tables.  Scan tables, context-index geometry, and channel
// bases come in an RdoqBlob prepared once per (component, size, scan).
// The helpers below are normative-by-construction: sig-ctx geometry
// (spec 9.3.4.2.5), Golomb-Rice/EG binarization lengths (9.3.3.x) and
// last-position prefix group costs.
// ---------------------------------------------------------------------------

struct RdoqBlob {
  double lambda;        // SSE per bit (per-component)
  double err_scale;     // (levelDouble err)^2 -> SSE:  2^(-2*tshift)/qscale^2
  double cbf_bits0, cbf_bits1;   // block cbf flag cost (0 => skip decision)
  int32_t chan;         // 0 luma / 1 chroma
  int32_t scan_type;    // 0 diag / 1 hor / 2 ver
  int32_t first_sig_ctx;
  int32_t single_ctx;
  int32_t sbh;          // sign-bit hiding enabled
  int32_t off_x, off_y, shift_x, shift_y;   // last-position ctx geometry
  int32_t has_cbf;      // use the block-level cbf decision
  int32_t pad_;
  const double *sig_bits;    // [n_sig_chan][2] channel-local sig ctx costs
  const double *one_bits;    // [16|8][2] channel-local greater1 costs
  const double *abs_bits;    // [4|2][2] channel-local greater2 costs
  const double *cg_bits;     // [2][2] channel-local coded-group flag costs
  const double *lastx_bits;  // [15][2] channel-local last-x prefix ctx costs
  const double *lasty_bits;  // [15][2]
  const int32_t *scan;       // CG-grouped coding scan, n*n raster positions
  const int32_t *scan_cg;    // CG scan, (n/4)^2 raster CG positions
};

static const int RD_GROUP_IDX[32] = {0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6,
                                     6, 7, 7, 7, 7, 8, 8, 8, 8, 8, 8,
                                     8, 8, 9, 9, 9, 9, 9, 9, 9, 9};
static const int RD_MIN_IN_GROUP[10] = {0, 1, 2, 3, 4, 6, 8, 12, 16, 24};
static const int RD_CTX_IND_MAP_4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                           6, 6, 8, 8, 7, 7, 8, 8};
static const int RD_NOT_FIRST_GROUP_OFF[2] = {3, 0};

// significant_coeff_flag context (TComTrQuant::getSigCtxInc), channel-local
static inline int rd_sig_ctx(int pattern, int raster, int log2w, int chan,
                             int first_ctx, int single_ctx) {
  if (single_ctx) return first_ctx;
  int pos_y = raster >> log2w;
  int pos_x = raster - (pos_y << log2w);
  if (pos_x + pos_y == 0) return 0;
  int offset;
  if (log2w == 2) {
    offset = RD_CTX_IND_MAP_4x4[4 * pos_y + pos_x];
  } else {
    int cnt;
    switch (pattern) {
      case 0: {
        int t = (pos_x & 3) + (pos_y & 3);
        cnt = (t >= 3) ? 0 : (t >= 1 ? 1 : 2);
      } break;
      case 1: {
        int py = pos_y & 3;
        cnt = (py >= 2) ? 0 : (py >= 1 ? 1 : 2);
      } break;
      case 2: {
        int px = pos_x & 3;
        cnt = (px >= 2) ? 0 : (px >= 1 ? 1 : 2);
      } break;
      default:
        cnt = 2;
        break;
    }
    int not_first = ((pos_x >> 2) + (pos_y >> 2)) > 0;
    offset = (not_first ? RD_NOT_FIRST_GROUP_OFF[chan] : 0) + cnt;
  }
  return first_ctx + offset;
}

// escape-coded level bits (xGetICRate, golomb-rice + gt1/gt2 flags),
// including the sign bypass bin
static double rd_level_bits(const RdoqBlob *B, int absLevel, int goRice,
                            int c1Idx, int c2Idx, int oneIdx, int absIdx) {
  double rate = 1.0;  // sign (bypass)
  int baseLevel = (c1Idx < 8) ? (2 + (c2Idx < 1 ? 1 : 0)) : 1;
  if (absLevel >= baseLevel) {
    int symbol = absLevel - baseLevel;
    if (symbol < (3 << goRice)) {
      rate += (symbol >> goRice) + 1 + goRice;
    } else {
      int length = goRice;
      symbol -= (3 << goRice);
      while (symbol >= (1 << length)) {
        symbol -= (1 << length);
        length++;
      }
      rate += 3 + length + 1 - goRice + length;
    }
    if (c1Idx < 8) {
      rate += B->one_bits[2 * oneIdx + 1];
      if (c2Idx < 1) rate += B->abs_bits[2 * absIdx + 1];
    }
  } else if (absLevel == 1) {
    rate += B->one_bits[2 * oneIdx + 0];
  } else if (absLevel == 2) {
    rate += B->one_bits[2 * oneIdx + 1] + B->abs_bits[2 * absIdx + 0];
  } else {
    rate = 0.0;  // absLevel 0
  }
  return rate;
}

// last_sig_coeff_x/y bits for a raster position (prefix ctx bins + suffix)
static double rd_last_bits(const RdoqBlob *B, int n, int pos_x, int pos_y) {
  if (B->scan_type == 2) {
    int t = pos_x;
    pos_x = pos_y;
    pos_y = t;
  }
  double bits = 0.0;
  const int gmax = RD_GROUP_IDX[n - 1];
  int gx = RD_GROUP_IDX[pos_x], gy = RD_GROUP_IDX[pos_y];
  for (int i = 0; i < gx; i++)
    bits += B->lastx_bits[2 * (B->off_x + (i >> B->shift_x)) + 1];
  if (gx < gmax)
    bits += B->lastx_bits[2 * (B->off_x + (gx >> B->shift_x)) + 0];
  for (int i = 0; i < gy; i++)
    bits += B->lasty_bits[2 * (B->off_y + (i >> B->shift_y)) + 1];
  if (gy < gmax)
    bits += B->lasty_bits[2 * (B->off_y + (gy >> B->shift_y)) + 0];
  if (gx > 3) bits += (gx - 2) >> 1;
  if (gy > 3) bits += (gy - 2) >> 1;
  return bits;
}

// ---------------------------------------------------------------------------
// Trellis RDOQ — the quantizer-level decision as a beam search over the
// CABAC rate-context trellis, one small dynamic program per 4x4
// coefficient group.  Equal JOB to HM's xRateDistOptQuant (what the
// levels should minimize, same RdoqBlob cost model), different
// ALGORITHM: HM walks the scan once, greedily committing each level
// against the context its earlier choices produced (equivalent to beam
// width 1); here every coefficient keeps up to RDQ_BEAM alternative
// rate-context states alive — (greater1 ctx, #coded, #>1, rice) — and
// the cheapest full-CG path wins, so the trellis is never worse under
// the model.  CG zeroing, the truncation point and the cbf decision are
// then evaluated from the chosen path's per-position cost decomposition.
// ---------------------------------------------------------------------------

#define RDQ_BEAM 6

struct RdqState {
  uint8_t c1, nco, ngt1, rice;   // rate context after the path's prefix
  int16_t lvl;                   // level chosen at this step
  int16_t prev;                  // parent state index at the previous step
  double cost;                   // dist + lambda*bits along the path
};

static int rdoq_trellis(const RdoqBlob *B, const int64_t *coef, int n,
                        int log2n, int qp, int bit_depth, int32_t *levels,
                        int64_t lvl_stride, int64_t *deltaU) {
  const int per = qp / 6, rem = qp % 6;
  const int tshift = 15 - bit_depth - log2n;
  const int qbits = 14 + per + tshift;
  const int64_t qscale = g_qscale[rem];
  const int num = n * n;
  const int wg = n >> 2 ? n >> 2 : 1, hg = wg;
  const double lam = B->lambda;

  int64_t levelDbl[1024];
  int lastScanPos = -1;
  for (int sp = num - 1; sp >= 0; sp--) {
    int64_t c = coef[B->scan[sp]];
    int64_t ld = (c < 0 ? -c : c) * qscale;
    levelDbl[sp] = ld;
    if (lastScanPos < 0 && ((ld + ((int64_t)1 << (qbits - 1))) >> qbits) > 0)
      lastScanPos = sp;
  }
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++) levels[i * lvl_stride + j] = 0;
  if (lastScanPos < 0) return 0;
  const int lastCG = lastScanPos >> 4;

  // per-position decomposition of the chosen solution
  static thread_local int32_t absOut[1024];
  static thread_local double cCoeff[1024], cSig[1024], c0[1024];
  static thread_local double flagCost[64];
  static thread_local uint8_t sigCG[64];
  for (int i = 0; i < num; i++) absOut[i] = 0;
  for (int i = 0; i < (num + 15) >> 4; i++) sigCG[i] = 0;
  double blockUncoded = 0.0;
  for (int sp = 0; sp < num; sp++) {
    double d = (double)levelDbl[sp];
    c0[sp] = d * d * B->err_scale;
    cCoeff[sp] = c0[sp];
    cSig[sp] = 0.0;
    blockUncoded += c0[sp];
    deltaU[B->scan[sp]] = 0;
  }

  double totalCost = 0.0;   // chosen cost over coded region incl CG flags
  for (int sp = num - 1; sp > lastScanPos; sp--)
    totalCost += c0[sp];    // above the last candidate: uncoded either way
  int prev_c1 = 1;
  static thread_local RdqState st[17][RDQ_BEAM];
  static thread_local int nst[17];

  for (int cg = lastCG; cg >= 0; cg--) {
    const int cg_blk = B->scan_cg[cg];
    const int cg_y = cg_blk / wg, cg_x = cg_blk % wg;
    const int right = (cg_x < wg - 1) ? (sigCG[cg_y * wg + cg_x + 1] != 0) : 0;
    const int lower = (cg_y < hg - 1) ? (sigCG[(cg_y + 1) * wg + cg_x] != 0) : 0;
    const int pattern = right + 2 * lower;
    const int cg_ctx = (right || lower) ? 1 : 0;
    const int ctxSet =
        ((B->chan == 0 && cg > 0) ? 2 : 0) + (prev_c1 == 0 ? 1 : 0);
    const int top = (cg == lastCG) ? (lastScanPos & 15) : 15;
    const int infer_pos0 = (cg > 0 && cg < lastCG);

    // run the trellis over positions top..0 (coding order)
    nst[top + 1] = 1;
    st[top + 1][0] = RdqState{1, 0, 0, 0, 0, -1, 0.0};
    for (int k = top; k >= 0; k--) {
      const int sp = (cg << 4) + k;
      const int bp = B->scan[sp];
      const int isLast = (sp == lastScanPos);
      const int64_t ld = levelDbl[sp];
      int maxAbs = (int)((ld + ((int64_t)1 << (qbits - 1))) >> qbits);
      if (maxAbs > 32767) maxAbs = 32767;
      const int sigIdx = rd_sig_ctx(pattern, bp, log2n, B->chan,
                                    B->first_sig_ctx, B->single_ctx);
      const double sig0 = lam * B->sig_bits[2 * sigIdx + 0];
      const double sig1 = lam * B->sig_bits[2 * sigIdx + 1];
      int cands[3], ncand = 0;
      if (!isLast && maxAbs < 3) cands[ncand++] = 0;
      if (maxAbs >= 1) {
        cands[ncand++] = maxAbs;
        if (maxAbs > 1) cands[ncand++] = maxAbs - 1;
      }
      int m = 0;
      RdqState out[RDQ_BEAM * 3];
      for (int si = 0; si < nst[k + 1]; si++) {
        const RdqState &s = st[k + 1][si];
        for (int ci = 0; ci < ncand; ci++) {
          const int lvl = cands[ci];
          double dErr = (double)(ld - ((int64_t)lvl << qbits));
          double cost = s.cost + dErr * dErr * B->err_scale;
          if (!isLast) {
            // sig flag; inferred for pos 0 of an interior coded CG whose
            // other 15 positions are all zero
            if (!(k == 0 && infer_pos0 && s.nco == 0))
              cost += lvl ? sig1 : sig0;
          }
          if (lvl)
            cost += lam * rd_level_bits(B, lvl, s.rice, s.nco, s.ngt1,
                                        4 * ctxSet + s.c1, ctxSet);
          RdqState t;
          t.c1 = s.c1;
          t.nco = s.nco;
          t.ngt1 = s.ngt1;
          t.rice = s.rice;
          if (lvl >= 1 && t.nco < 8) t.nco++;
          if (lvl > 1) {
            t.c1 = 0;
            if (t.ngt1 < 1) t.ngt1++;
          } else if (t.c1 > 0 && t.c1 < 3 && lvl == 1) {
            t.c1++;
          }
          if (lvl >= (3 << s.rice) && t.rice < 4) t.rice++;
          t.cost = cost;
          t.lvl = (int16_t)lvl;
          t.prev = (int16_t)si;
          // merge with an identical rate state, else append
          int found = -1;
          for (int oi = 0; oi < m; oi++)
            if (out[oi].c1 == t.c1 && out[oi].nco == t.nco &&
                out[oi].ngt1 == t.ngt1 && out[oi].rice == t.rice) {
              found = oi;
              break;
            }
          if (found >= 0) {
            if (t.cost < out[found].cost) out[found] = t;
          } else {
            out[m++] = t;
          }
        }
      }
      // beam-prune to the RDQ_BEAM cheapest states
      int keep = m < RDQ_BEAM ? m : RDQ_BEAM;
      for (int a = 0; a < keep; a++) {
        int best = a;
        for (int b = a + 1; b < m; b++)
          if (out[b].cost < out[best].cost) best = b;
        RdqState tmp = out[a];
        out[a] = out[best];
        out[best] = tmp;
      }
      nst[k] = keep;
      for (int a = 0; a < keep; a++) st[k][a] = out[a];
    }

    // best path -> levels + per-position decomposition (recompute each
    // step's components while backtracking)
    int si = 0;
    int lvls[16];
    for (int k = 0; k <= top; k++) {
      lvls[k] = st[k][si].lvl;
      si = st[k][si].prev;
    }
    double cgCoded = 0.0;
    int nco_run = 0;
    {
      // forward re-walk (coding order top..0) to split costs per position
      RdqState s{1, 0, 0, 0, 0, -1, 0.0};
      for (int k = top; k >= 0; k--) {
        const int sp = (cg << 4) + k;
        const int bp = B->scan[sp];
        const int isLast = (sp == lastScanPos);
        const int64_t ld = levelDbl[sp];
        const int lvl = lvls[k];
        const int sigIdx = rd_sig_ctx(pattern, bp, log2n, B->chan,
                                      B->first_sig_ctx, B->single_ctx);
        double dErr = (double)(ld - ((int64_t)lvl << qbits));
        double dcost = dErr * dErr * B->err_scale;
        double scost = 0.0, lcost = 0.0;
        if (!isLast && !(k == 0 && infer_pos0 && s.nco == 0))
          scost = lam * B->sig_bits[2 * sigIdx + (lvl ? 1 : 0)];
        if (lvl)
          lcost = lam * rd_level_bits(B, lvl, s.rice, s.nco, s.ngt1,
                                      4 * ctxSet + s.c1, ctxSet);
        absOut[sp] = lvl;
        deltaU[bp] = (ld - ((int64_t)lvl << qbits)) >> (qbits - 8);
        cCoeff[sp] = dcost + scost + lcost;
        cSig[sp] = scost;
        cgCoded += cCoeff[sp];
        if (lvl) {
          sigCG[cg_blk] = 1;
          if (k != 0) nco_run++;
        }
        if (lvl >= 1 && s.nco < 8) s.nco++;
        if (lvl > 1) {
          s.c1 = 0;
          if (s.ngt1 < 1) s.ngt1++;
        } else if (s.c1 > 0 && s.c1 < 3 && lvl == 1) {
          s.c1++;
        }
        if (lvl >= (3 << s.rice) && s.rice < 4) s.rice++;
        if (k == 0) prev_c1 = s.c1;
      }
    }

    // CG flag + zeroing decision (interior CGs only; the last CG's flag
    // and CG0's are inferred)
    flagCost[cg] = 0.0;
    if (cg > 0 && cg < lastCG) {
      double zeroCG = lam * B->cg_bits[2 * cg_ctx + 0];
      for (int k = 0; k <= top; k++) zeroCG += c0[(cg << 4) + k];
      double codedCG = cgCoded + lam * B->cg_bits[2 * cg_ctx + 1];
      if (!sigCG[cg_blk] || zeroCG < codedCG) {
        sigCG[cg_blk] = 0;
        flagCost[cg] = lam * B->cg_bits[2 * cg_ctx + 0];
        for (int k = 0; k <= top; k++) {
          const int sp = (cg << 4) + k;
          absOut[sp] = 0;
          cCoeff[sp] = c0[sp];
          cSig[sp] = 0.0;
        }
        totalCost += zeroCG;
      } else {
        flagCost[cg] = lam * B->cg_bits[2 * cg_ctx + 1];
        totalCost += codedCG;
      }
    } else {
      if (cg == 0) sigCG[cg_blk] = 1;
      totalCost += cgCoded;
    }
  }

  // cbf + truncation point: walk candidate last positions in coding
  // order, peeling each position's cost off the running total
  double bestCost = blockUncoded + lam * B->cbf_bits0;
  if (!B->has_cbf) bestCost = 1e300;
  double run = totalCost + lam * B->cbf_bits1;
  int bestLastP1 = 0;
  bool stop = false;
  for (int cg = lastCG; cg >= 0 && !stop; cg--) {
    if (!sigCG[B->scan_cg[cg]]) {
      run -= flagCost[cg];
      // the peeled positions already cost c0 in `run`
      continue;
    }
    const int top = (cg == lastCG) ? (lastScanPos & 15) : 15;
    for (int k = top; k >= 0; k--) {
      const int sp = (cg << 4) + k;
      const int bp = B->scan[sp];
      if (absOut[sp]) {
        const int py = bp >> log2n, px = bp - (py << log2n);
        double total = run + lam * rd_last_bits(B, n, px, py) - cSig[sp];
        if (total < bestCost) {
          bestCost = total;
          bestLastP1 = sp + 1;
        }
        if (absOut[sp] > 1) {
          stop = true;
          break;
        }
        run += c0[sp] - cCoeff[sp];
      } else {
        run -= cSig[sp];
      }
    }
  }

  int cbf = 0;
  for (int sp = 0; sp < bestLastP1; sp++) {
    int bp = B->scan[sp];
    int32_t lvl = absOut[sp];
    if (!lvl) continue;
    cbf = 1;
    levels[(bp >> log2n) * lvl_stride + (bp & (n - 1))] =
        coef[bp] < 0 ? -lvl : lvl;
  }
  return cbf;
}

extern "C" int code_tu(const int32_t *orig, int64_t orig_stride,
                       const int32_t *pred, int64_t pred_stride, int n,
                       int log2n, int bit_depth, int qp, int use_dst,
                       int is_intra, int32_t *levels, int64_t lvl_stride,
                       int32_t *rec, int64_t rec_stride,
                       const int32_t *sbh_scan, const void *rdoq_blob) {
  if (log2n < 2 || log2n > 5) return -1;
  const int32_t *t = (use_dst && n == 4) ? g_dst4 : g_dct[log2n];
  if (!t) return -1;
  int64_t buf_r[32 * 32], buf_1[32 * 32], buf_2[32 * 32];

  // residual
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++)
      buf_r[i * n + j] =
          (int64_t)orig[i * orig_stride + j] - pred[i * pred_stride + j];

  // forward: stage1 horizontal r @ T^T, shift s1; stage2 vertical T @ ., s2
  int s1 = log2n - 1 + bit_depth - 8;
  int s2 = log2n + 6;
  matmul_abt(buf_r, t, n, buf_1);
  if (s1 > 0) {
    int64_t add = (int64_t)1 << (s1 - 1);
    for (int i = 0; i < n * n; i++) buf_1[i] = (buf_1[i] + add) >> s1;
  } else if (s1 < 0) {
    for (int i = 0; i < n * n; i++) buf_1[i] <<= -s1;
  }
  matmul_ta(t, buf_1, n, buf_2);
  {
    int64_t add = (int64_t)1 << (s2 - 1);
    for (int i = 0; i < n * n; i++) buf_2[i] = (buf_2[i] + add) >> s2;
  }

  // quant (flat): q_bits = 14 + per + tshift
  int per = qp / 6, rem = qp % 6;
  int tshift = 15 - bit_depth - log2n;
  int q_bits = 14 + per + tshift;
  int64_t scale = g_qscale[rem];
  int64_t qadd = (int64_t)(is_intra ? 171 : 85) << (q_bits - 9);
  int cbf = 0;
  int64_t deltaU[32 * 32];
  if (rdoq_blob) {
    const RdoqBlob *B = (const RdoqBlob *)rdoq_blob;
    cbf = rdoq_trellis(B, buf_2, n, log2n, qp, bit_depth, levels,
                       lvl_stride, deltaU);
    if (cbf && B->sbh) {
      sbh_adjust(levels, lvl_stride, buf_2, deltaU, n, B->scan);
      cbf = 0;
      for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++)
          if (levels[i * lvl_stride + j]) cbf = 1;
    }
  } else {
    for (int i = 0; i < n; i++)
      for (int j = 0; j < n; j++) {
        int64_t c = buf_2[i * n + j];
        int64_t mag = (c < 0 ? -c : c);
        int64_t tmp = mag * scale;
        int64_t lvl = (tmp + qadd) >> q_bits;
        lvl = clip64(lvl, 0, 32767);
        deltaU[i * n + j] = (tmp - (lvl << q_bits)) >> (q_bits - 8);
        if (c < 0) lvl = -lvl;
        levels[i * lvl_stride + j] = (int32_t)lvl;
        if (lvl) cbf = 1;
      }
    if (cbf && sbh_scan) {
      sbh_adjust(levels, lvl_stride, buf_2, deltaU, n, sbh_scan);
      cbf = 0;
      for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++)
          if (levels[i * lvl_stride + j]) cbf = 1;
    }
  }
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++) buf_r[i * n + j] = levels[i * lvl_stride + j];

  int64_t maxv = ((int64_t)1 << bit_depth) - 1;
  if (!cbf) {
    for (int i = 0; i < n; i++)
      for (int j = 0; j < n; j++) {
        int64_t v = pred[i * pred_stride + j];
        rec[i * rec_stride + j] = (int32_t)clip64(v, 0, maxv);
      }
    return 0;
  }

  // dequant (flat): right_shift = 6 - (tshift + per)
  {
    int right_shift = 6 - (tshift + per);
    int64_t iscale = g_iqscale[rem];
    int target_bd = 16 < (64 + right_shift - 7) ? 16 : (64 + right_shift - 7);
    int64_t imin = -((int64_t)1 << (target_bd - 1));
    int64_t imax = ((int64_t)1 << (target_bd - 1)) - 1;
    for (int i = 0; i < n * n; i++) {
      int64_t cq = clip64(buf_r[i], imin, imax);
      int64_t out;
      if (right_shift > 0)
        out = (cq * iscale + ((int64_t)1 << (right_shift - 1))) >> right_shift;
      else
        out = (cq * iscale) << (-right_shift);
      buf_r[i] = clip64(out, -32768, 32767);
    }
  }

  // inverse: stage1 vertical T^T(left) with clip to dynamic range, stage2
  // horizontal @ T with int16 clip
  {
    int is1 = 6 + 1;
    int is2 = (6 + 15 - 1) - bit_depth;
    matmul_tta(t, buf_r, n, buf_1);
    int64_t add1 = (int64_t)1 << (is1 - 1);
    for (int i = 0; i < n * n; i++)
      buf_1[i] = clip64((buf_1[i] + add1) >> is1, -32768, 32767);
    matmul_at(buf_1, t, n, buf_2);
    int64_t add2 = (int64_t)1 << (is2 - 1);
    for (int i = 0; i < n; i++)
      for (int j = 0; j < n; j++) {
        int64_t res =
            clip64((buf_2[i * n + j] + add2) >> is2, -32768, 32767);
        int64_t v = pred[i * pred_stride + j] + res;
        rec[i * rec_stride + j] = (int32_t)clip64(v, 0, maxv);
      }
  }
  return 1;
}

// ---------------------------------------------------------------------------
// Native plan-commit engine: walks a CTU's planned intra quadtree
// (hm16_2_tpu/encode/intra_rd.IntraPlan) entirely in C++ — candidate
// refinement on true reconstructed references, TU coding via
// intra_code_tu (prediction + transform + RDOQ + SBH + reconstruction),
// and all per-part bookkeeping.  Mirrors CtuSearch._commit_plan_tree /
// _commit_cu / _commit_nxn / _refine_mode bit-exactly (same candidate
// order, same cost model), eliminating the per-TU Python dispatch.
// ---------------------------------------------------------------------------

extern "C" int intra_code_tu(
    const int32_t *rec_plane, int64_t rec_stride, int plane_w, int plane_h,
    const uint8_t *coded, int64_t coded_stride, int pic_w, int pic_h, int sx,
    int sy, int x0, int y0, int size, int mode, int bit_depth, int is_luma,
    int strong_smoothing, int smoothing_disabled, int chroma_fmt,
    const int32_t *orig, int64_t orig_stride, int qp, int use_dst,
    int is_intra, int32_t *levels, int64_t lvl_stride, int32_t *rec_out,
    int64_t rec_out_stride, const int32_t *sbh_scan, const void *rdoq_blob);

struct CommitCtx {
  int32_t pic_w, pic_h;       // coded luma dims
  int32_t parts_w;            // picture part-grid row stride (elements)
  int32_t plan_w;             // plan-array row stride (unpadded part grid)
  int32_t ctb_log2;
  int32_t num_comps, chroma_fmt;
  int32_t slice_qp;
  int32_t strong_smoothing, smoothing_disabled;
  int32_t mode_intra, size_2nx2n, size_nxn, dm_chroma_idx;
  int32_t bd[3], qp_comp[3];
  int32_t pad_;
  double lam;
  // component planes (int32, contiguous: stride == width); the original
  // planes are unpadded (own stride), rec/coeff are CTU-padded
  const int32_t *orig_p[3];
  int32_t *rec_p[3];
  int32_t *coeff_p[3];
  int64_t orig_stride[3];
  int64_t plane_stride[3];
  int64_t plane_h[3];
  // part-grid arrays, row stride parts_w
  uint8_t *coded;
  int8_t *depth;
  int8_t *part_size;
  int8_t *pred_mode;
  int16_t *intra_luma;
  int16_t *intra_chroma;
  int16_t *qp_arr;
  int32_t *slice_id;
  int8_t *tr_idx;
  uint8_t *cbf[3];
  // plan arrays, row stride parts_w (cands: parts_w*3)
  const int8_t *plan_depth;
  const uint8_t *plan_nxn;
  const int8_t *plan_mode;
  const uint8_t *plan_tusplit;
  const int8_t *plan_cmode;
  const int8_t *plan_cands;
  // RDOQ blobs indexed [chan][log2n][scan_type] (log2n 2..5); null = none
  const RdoqBlob *blobs[2][6][3];
  // exact TU bit-counting kit (resenc == 0 => regression estimate):
  // counts the real residual_coding syntax through cabac_core's counting
  // encoder with fresh slice-init contexts per TU
  const void *resenc;            // cabac_core encode_residual
  const uint8_t *bits_ctx_init;  // context states for slice type/QP
  int64_t bits_ctx_n;
  const void *bits_params[24];   // ResParams: chan*12 + (log2w-2)*3 + scan
  const void *bits_scan[12];
  const void *bits_scan_cg[12];
};

static inline int cc_mdcs_scan(int size, int comp, int mode) {
  int max_mdcs = comp == 0 ? 8 : 4;
  if (mode >= 0 && size <= max_mdcs) {
    int dv = mode - 26 < 0 ? 26 - mode : mode - 26;
    if (dv <= 4) return 1;
    int dh = mode - 10 < 0 ? 10 - mode : mode - 10;
    if (dh <= 4) return 2;
  }
  return 0;
}

// numpy twin of CtuSearch._res_bits_est (levels stride == n)
static double cc_res_bits(const int32_t *lvl, int n) {
  int nnz = 0, gt1 = 0, lx = -1, ly = -1;
  double esc_bits = 0.0;
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) {
      int a = lvl[y * n + x];
      if (a < 0) a = -a;
      if (a > 0) {
        nnz++;
        if (x > lx) lx = x;
        if (y > ly) ly = y;
        if (a > 1) {
          gt1++;
          esc_bits += 2.0 * ceil(log2((double)(a - 1) + 1.0)) + 1.0;
        }
      }
    }
  if (nnz == 0) return 0.8;
  int nzc = (lx + 1) * (ly + 1) - nnz;
  if (nzc < 0) nzc = 0;
  double lastpos = 2.0 * (log2(lx + 1.5) + log2(ly + 1.5)) + 2.0;
  int ncg = (lx / 4 + 1) * (ly / 4 + 1) - 1;
  double bits = -0.089 * nzc + 3.798 * nnz - 0.648 * gt1 +
                0.616 * esc_bits + 2.275 * lastpos + 1.173 * ncg - 12.817 +
                1.0;
  return bits > 2.0 ? bits : 2.0;
}


// ---- exact TU bit counting through cabac_core's counting encoder ----
// layout mirror of cabac_core EncState (keep in sync)
struct CntEncState {
  uint8_t *out; int64_t n; uint32_t low; int32_t range_; int32_t bits_left;
  int32_t num_buffered; int32_t buffered_byte; int32_t counting;
  int32_t _pad; int64_t frac_bits; int64_t bins;
};
typedef int (*resenc_fn_t)(void *, uint8_t *, const void *, const int32_t *,
                           const int32_t *, const int32_t *, int64_t *);

static double exact_tu_bits_raw(const void *resenc, const uint8_t *ctx_init,
                                int64_t ctx_n, const void *params,
                                const void *scan, const void *scan_cg,
                                const int32_t *lvl, int64_t stride, int n) {
  if (!resenc || !params || !scan || !ctx_init) return -1.0;
  static thread_local uint8_t ctx[1024];
  static thread_local int32_t buf[32 * 32];
  int64_t rice[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (ctx_n > (int64_t)sizeof(ctx)) return -1.0;
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) buf[y * n + x] = lvl[y * stride + x];
  memcpy(ctx, ctx_init, (size_t)ctx_n);
  CntEncState es; memset(&es, 0, sizeof es); es.counting = 1;
  int r = ((resenc_fn_t)resenc)(&es, ctx, params, (const int32_t *)scan,
                                (const int32_t *)scan_cg, buf, rice);
  if (r < 0) return 0.0;                        // all-zero TU
  return (double)es.frac_bits / 32768.0;
}

static double cc_tu_bits(const CommitCtx *C, const int32_t *lvl,
                         int64_t stride, int n, int chan, int scan_type) {
  int log2w = 31 - __builtin_clz((unsigned)n);
  int ti = (log2w - 2) * 3 + scan_type;
  double b = exact_tu_bits_raw(C->resenc, C->bits_ctx_init, C->bits_ctx_n,
                               C->bits_params[chan * 12 + ti],
                               C->bits_scan[ti], C->bits_scan_cg[ti],
                               lvl, stride, n);
  if (b < 0.0) {
    static thread_local int32_t tmp[32 * 32];
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++) tmp[y * n + x] = lvl[y * stride + x];
    return cc_res_bits(tmp, n);
  }
  return b > 0.0 ? b : 0.8;
}

// getIntraDirPredictor (decode/ctu_dec._intra_mpm), single-slice fast path
static void cc_mpm(const CommitCtx *C, int px, int py, int out[3]) {
  const int DC = 1, PLANAR = 0, VER = 26;
  int left = DC, above = DC;
  if (px > 0 && (px - 1) * 4 < C->pic_w && py * 4 < C->pic_h &&
      C->coded[py * C->parts_w + px - 1] &&
      C->pred_mode[py * C->parts_w + px - 1] == C->mode_intra)
    left = C->intra_luma[py * C->parts_w + px - 1];
  int parts = 1 << (C->ctb_log2 - 2);
  if (py % parts != 0 && py > 0 && px * 4 < C->pic_w &&
      (py - 1) * 4 < C->pic_h && C->coded[(py - 1) * C->parts_w + px] &&
      C->pred_mode[(py - 1) * C->parts_w + px] == C->mode_intra)
    above = C->intra_luma[(py - 1) * C->parts_w + px];
  if (left == above) {
    if (left > 1) {
      out[0] = left;
      out[1] = ((left + 29) % 32) + 2;
      out[2] = ((left - 1) % 32) + 2;
    } else {
      out[0] = PLANAR;
      out[1] = DC;
      out[2] = VER;
    }
  } else {
    out[0] = left;
    out[1] = above;
    out[2] = (left && above) ? PLANAR : (left + above < 2 ? VER : DC);
  }
}

// code one intra TU into the picture planes (or scratch when out set)
static int cc_code_tu(const CommitCtx *C, int px, int py, int log2, int comp,
                      int mode, int32_t *scratch_lvl, int32_t *scratch_rec) {
  int sx = comp ? (C->chroma_fmt == 1 || C->chroma_fmt == 2 ? 1 : 0) : 0;
  int sy = comp ? (C->chroma_fmt == 1 ? 1 : 0) : 0;
  int size = (1 << log2) >> sx;
  int x0 = (px * 4) >> sx, y0 = (py * 4) >> sy;
  int bd = C->bd[comp];
  int qp = C->qp_comp[comp];
  int use_dst = (comp == 0 && size == 4) ? 1 : 0;
  int log2n = 0;
  for (int t = size; t > 1; t >>= 1) log2n++;
  int chan = comp == 0 ? 0 : 1;
  const RdoqBlob *blob =
      C->blobs[chan][log2n][cc_mdcs_scan(size, comp, mode)];
  int64_t st = C->plane_stride[comp];
  int32_t *lvl_out, *rec_out;
  int64_t lvl_stride, rec_out_stride;
  if (scratch_lvl) {
    lvl_out = scratch_lvl;
    rec_out = scratch_rec;
    lvl_stride = rec_out_stride = size;
  } else {
    lvl_out = C->coeff_p[comp] + y0 * st + x0;
    rec_out = C->rec_p[comp] + y0 * st + x0;
    lvl_stride = rec_out_stride = st;
  }
  int64_t ost = C->orig_stride[comp];
  return intra_code_tu(
      C->rec_p[comp], st, (int)st, (int)C->plane_h[comp], C->coded,
      C->parts_w, C->pic_w, C->pic_h, sx, sy, x0, y0, size, mode, bd,
      comp == 0 ? 1 : 0, C->strong_smoothing, C->smoothing_disabled,
      C->chroma_fmt, C->orig_p[comp] + y0 * ost + x0, ost, qp, use_dst, 1,
      lvl_out, lvl_stride, rec_out, rec_out_stride, 0, blob);
}

// CtuSearch._refine_mode: re-rank plan candidates + MPMs on true refs;
// codes the winner's luma TU into the planes, returns (mode<<1)|cbf or -1
static int cc_refine(const CommitCtx *C, int px, int py, int log2,
                     int planned) {
  int cands[5], ncand = 0;
  const int8_t *pc = C->plan_cands + (py * C->plan_w + px) * 3;
  for (int i = 0; i < 3; i++) {
    int m = pc[i];
    if (m < 0) continue;
    bool dup = false;
    for (int j = 0; j < ncand; j++)
      if (cands[j] == m) dup = true;
    if (!dup) cands[ncand++] = m;
  }
  bool has_planned = false;
  for (int j = 0; j < ncand; j++)
    if (cands[j] == planned) has_planned = true;
  if (!has_planned) {
    for (int j = ncand; j > 0; j--) cands[j] = cands[j - 1];
    cands[0] = planned;
    ncand++;
  }
  int mpm[3];
  cc_mpm(C, px, py, mpm);
  for (int i = 0; i < 3 && ncand < 5; i++) {
    bool dup = false;
    for (int j = 0; j < ncand; j++)
      if (cands[j] == mpm[i]) dup = true;
    if (!dup) cands[ncand++] = mpm[i];
  }
  int size = 1 << log2;
  int best_mode = planned;
  if (ncand > 1) {
    int32_t lvl_s[32 * 32], rec_s[32 * 32];
    const int32_t *orig =
        C->orig_p[0] + (py * 4) * C->orig_stride[0] + px * 4;
    double best_cost = 0.0;
    bool first = true;
    for (int ci = 0; ci < ncand; ci++) {
      int mode = cands[ci];
      int cbf = cc_code_tu(C, px, py, log2, 0, mode, lvl_s, rec_s);
      if (cbf < 0) return -1;
      double dist = 0.0;
      for (int y = 0; y < size; y++)
        for (int x = 0; x < size; x++) {
          double d = (double)(orig[y * C->orig_stride[0] + x] -
                              rec_s[y * size + x]);
          dist += d * d;
        }
      double mb = 6.0;
      if (mode == mpm[0]) mb = 2.0;
      else if (mode == mpm[1] || mode == mpm[2]) mb = 3.0;
      double bits = (cbf ? cc_tu_bits(C, lvl_s, size, size, 0,
                                      cc_mdcs_scan(size, 0, mode))
                         : 0.8) + mb;
      double cost = dist + C->lam * bits;
      if (first || cost < best_cost) {
        first = false;
        best_cost = cost;
        best_mode = mode;
      }
    }
  }
  int cbf = cc_code_tu(C, px, py, log2, 0, best_mode, 0, 0);
  if (cbf < 0) return -1;
  return (best_mode << 1) | cbf;
}

static void cc_fill(const CommitCtx *C, int px, int py, int n, int8_t *arr,
                    int8_t v) {
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) arr[(py + y) * C->parts_w + px + x] = v;
}

static void cc_mark_cu(const CommitCtx *C, int px, int py, int log2,
                       int part_size) {
  int n = (1 << log2) >> 2;
  cc_fill(C, px, py, n, C->depth, (int8_t)(C->ctb_log2 - log2));
  cc_fill(C, px, py, n, C->pred_mode, (int8_t)C->mode_intra);
  cc_fill(C, px, py, n, C->part_size, (int8_t)part_size);
  cc_fill(C, px, py, n, C->tr_idx, 0);
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) {
      C->qp_arr[(py + y) * C->parts_w + px + x] = (int16_t)C->slice_qp;
      C->slice_id[(py + y) * C->parts_w + px + x] = 0;
    }
}

// CtuSearch._plan_chroma: resolve the planned chroma candidate index
static void cc_chroma_mode(const CommitCtx *C, int px, int py, int luma_mode,
                           int *stored, int *actual) {
  int ci = C->plan_cmode[py * C->plan_w + px];
  if (ci == 4 || ci < 0) {
    *stored = C->dm_chroma_idx;
    *actual = luma_mode;
    return;
  }
  static const int base[4] = {0, 26, 10, 1};
  int b = base[ci];
  *stored = (b == luma_mode) ? 34 : b;
  *actual = *stored;
}


// strided copy of cc_res_bits for the commit-time RQT trial
static double cc_res_bits_strided(const int32_t *lvl, int64_t stride, int n) {
  static thread_local int32_t tmp[32 * 32];
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) tmp[y * n + x] = lvl[y * stride + x];
  return cc_res_bits(tmp, n);
}

static int cc_commit_cu(const CommitCtx *C, int px, int py, int log2,
                        int mode, int tusplit) {
  int n = (1 << log2) >> 2;
  cc_mark_cu(C, px, py, log2, C->size_2nx2n);
  int W = C->parts_w;
  if (!tusplit) {
    int r = cc_refine(C, px, py, log2, mode);
    if (r < 0) return -1;
    mode = r >> 1;
    int cbf_y = r & 1;
    // Commit-time one-level intra RQT (TEncSearch.cpp:1364
    // xRecurIntraCodingQT): trial-split the luma TU with the winning
    // mode on the TRUE reconstructed references this walk maintains;
    // adopt the split when SSE + estimated bits wins, then fall into
    // the shared-mode split commit below for fields and chroma.
    int size = 1 << log2;
    int min_rqt = getenv("HM16_RQT8") ? 8 : 16;
    if (size >= min_rqt && size <= 32 && !getenv("HM16_NO_INTRA_RQT")) {
      static thread_local int32_t srec[32 * 32], scoef[32 * 32];
      int64_t st = C->plane_stride[0];
      int64_t ost = C->orig_stride[0];
      int x0 = px * 4, y0 = py * 4;
      const int32_t *orig = C->orig_p[0] + (int64_t)y0 * ost + x0;
      int32_t *rec = C->rec_p[0] + (int64_t)y0 * st + x0;
      int32_t *coef = C->coeff_p[0] + (int64_t)y0 * st + x0;
      for (int y = 0; y < size; y++)
        for (int x = 0; x < size; x++) {
          srec[y * size + x] = rec[y * st + x];
          scoef[y * size + x] = coef[y * st + x];
        }
      double dist_w = 0.0;
      for (int y = 0; y < size; y++)
        for (int x = 0; x < size; x++) {
          double d = (double)(orig[y * ost + x] - rec[y * st + x]);
          dist_w += d * d;
        }
      double bits_w = cbf_y ? cc_tu_bits(C, coef, st, size, 0,
                                         cc_mdcs_scan(size, 0, mode))
                            : 0.8;
      double cost_w = dist_w + C->lam * (bits_w + 1.0);
      int hn = n / 2 > 0 ? n / 2 : 1;
      int hs = size / 2;
      int kids[4];
      int ok = 1;
      double bits_s = 1.0;                       // split_transform_flag
      for (int sub = 0; sub < 4 && ok; sub++) {
        int cx = px + (sub & 1) * hn;
        int cy = py + (sub >> 1) * hn;
        int k = cc_code_tu(C, cx, cy, log2 - 1, 0, mode, 0, 0);
        if (k < 0) { ok = 0; break; }
        kids[sub] = k;
        bits_s += 1.0;                           // per-sub luma cbf bin
        if (k)
          bits_s += cc_tu_bits(
              C, C->coeff_p[0] + (int64_t)(cy * 4) * st + cx * 4, st, hs,
              0, cc_mdcs_scan(hs, 0, mode));
        // mark the quadrant coded so the next quadrant's prediction
        // references its fresh reconstruction (TU-split semantics)
        for (int y = 0; y < hn; y++)
          for (int x = 0; x < hn; x++)
            C->coded[(cy + y) * W + cx + x] = 1;
      }
      int adopt = 0;
      if (ok) {
        double dist_s = 0.0;
        for (int y = 0; y < size; y++)
          for (int x = 0; x < size; x++) {
            double d = (double)(orig[y * ost + x] - rec[y * st + x]);
            dist_s += d * d;
          }
        if (dist_s + C->lam * bits_s < cost_w) adopt = 1;
      }
      if (!adopt) {
        for (int y = 0; y < size; y++)
          for (int x = 0; x < size; x++) {
            rec[y * st + x] = srec[y * size + x];
            coef[y * st + x] = scoef[y * size + x];
          }
      } else {
        // fields + chroma handled by the shared-mode split path below
        // (the luma sub-TUs recode deterministically to the same result)
        tusplit = 1;
      }
      (void)kids;
    }
    if (!tusplit) {
    int stored, cmode;
    cc_chroma_mode(C, px, py, mode, &stored, &cmode);
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++) {
        C->intra_luma[(py + y) * W + px + x] = (int16_t)mode;
        C->intra_chroma[(py + y) * W + px + x] = (int16_t)stored;
        C->coded[(py + y) * W + px + x] = 1;
        C->cbf[0][(py + y) * W + px + x] = (uint8_t)cbf_y;
      }
    if (C->num_comps > 1) {
      int cb = cc_code_tu(C, px, py, log2, 1, cmode, 0, 0);
      int cr = cc_code_tu(C, px, py, log2, 2, cmode, 0, 0);
      if (cb < 0 || cr < 0) return -1;
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          C->cbf[1][(py + y) * W + px + x] = (uint8_t)cb;
          C->cbf[2][(py + y) * W + px + x] = (uint8_t)cr;
        }
    }
    return 0;
    }
  }
  // shared-mode one-level TU split
  int stored, cmode;
  cc_chroma_mode(C, px, py, mode, &stored, &cmode);
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) {
      C->intra_luma[(py + y) * W + px + x] = (int16_t)mode;
      C->intra_chroma[(py + y) * W + px + x] = (int16_t)stored;
      C->tr_idx[(py + y) * W + px + x] = 1;
      C->coded[(py + y) * W + px + x] = 0;
    }
  int half = n / 2 > 0 ? n / 2 : 1;
  for (int sub = 0; sub < 4; sub++) {
    int cx = px + (sub & 1) * half;
    int cy = py + (sub >> 1) * half;
    int cbf = cc_code_tu(C, cx, cy, log2 - 1, 0, mode, 0, 0);
    if (cbf < 0) return -1;
    int cb = -2, cr = -2;
    if (C->num_comps > 1 && log2 > 3) {
      cb = cc_code_tu(C, cx, cy, log2 - 1, 1, cmode, 0, 0);
      cr = cc_code_tu(C, cx, cy, log2 - 1, 2, cmode, 0, 0);
      if (cb < 0 || cr < 0) return -1;
    }
    for (int y = 0; y < half; y++)
      for (int x = 0; x < half; x++) {
        int idx = (cy + y) * W + cx + x;
        C->cbf[0][idx] = (uint8_t)(cbf << 1);
        if (cb >= 0) {
          C->cbf[1][idx] = (uint8_t)(cb << 1);
          C->cbf[2][idx] = (uint8_t)(cr << 1);
        }
        C->coded[idx] = 1;
      }
  }
  if (C->num_comps > 1) {
    if (log2 == 3) {
      int cb = cc_code_tu(C, px, py, 3, 1, cmode, 0, 0);
      int cr = cc_code_tu(C, px, py, 3, 2, cmode, 0, 0);
      if (cb < 0 || cr < 0) return -1;
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          C->cbf[1][(py + y) * W + px + x] = (uint8_t)cb;
          C->cbf[2][(py + y) * W + px + x] = (uint8_t)cr;
        }
    } else {
      for (int comp = 1; comp < 3; comp++) {
        int root = 0;
        for (int y = 0; y < n && !root; y++)
          for (int x = 0; x < n; x++)
            if (C->cbf[comp][(py + y) * W + px + x] & 2) {
              root = 1;
              break;
            }
        if (root)
          for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++)
              C->cbf[comp][(py + y) * W + px + x] |= 1;
      }
    }
  }
  return 0;
}

static int cc_commit_nxn(const CommitCtx *C, int px, int py) {
  int W = C->parts_w;
  cc_mark_cu(C, px, py, 3, C->size_nxn);
  for (int y = 0; y < 2; y++)
    for (int x = 0; x < 2; x++) {
      C->tr_idx[(py + y) * W + px + x] = 1;
      C->coded[(py + y) * W + px + x] = 0;
    }
  for (int oy = 0; oy < 2; oy++)
    for (int ox = 0; ox < 2; ox++) {
      int planned = C->plan_mode[(py + oy) * C->plan_w + px + ox];
      int r = cc_refine(C, px + ox, py + oy, 2, planned);
      if (r < 0) return -1;
      C->intra_luma[(py + oy) * W + px + ox] = (int16_t)(r >> 1);
      C->cbf[0][(py + oy) * W + px + ox] = (uint8_t)((r & 1) << 1);
      C->coded[(py + oy) * W + px + ox] = 1;
    }
  int stored, cmode;
  cc_chroma_mode(C, px, py, C->intra_luma[py * W + px], &stored, &cmode);
  for (int y = 0; y < 2; y++)
    for (int x = 0; x < 2; x++)
      C->intra_chroma[(py + y) * W + px + x] = (int16_t)stored;
  if (C->num_comps > 1) {
    int cb = cc_code_tu(C, px, py, 3, 1, cmode, 0, 0);
    int cr = cc_code_tu(C, px, py, 3, 2, cmode, 0, 0);
    if (cb < 0 || cr < 0) return -1;
    for (int y = 0; y < 2; y++)
      for (int x = 0; x < 2; x++) {
        C->cbf[1][(py + y) * W + px + x] = (uint8_t)cb;
        C->cbf[2][(py + y) * W + px + x] = (uint8_t)cr;
      }
  }
  return 0;
}

static int cc_walk(const CommitCtx *C, int px, int py, int log2) {
  int x0 = px * 4, y0 = py * 4, size = 1 << log2;
  if (x0 >= C->pic_w || y0 >= C->pic_h) return 0;  // outside: z-scan skip
  bool inside = (x0 + size <= C->pic_w) && (y0 + size <= C->pic_h);
  if (!inside) {
    // picture-boundary CU: implicit split (HEVC 7.4.9.4), children with
    // origin outside the picture are skipped above
    if (log2 <= 3) return -1;  // non-8-multiple picture: host fallback
    int half = 1 << (log2 - 3);
    for (int sub = 0; sub < 4; sub++)
      if (cc_walk(C, px + (sub & 1) * half, py + (sub >> 1) * half,
                  log2 - 1) < 0)
        return -1;
    return 0;
  }
  int depth = C->ctb_log2 - log2;
  int pd = C->plan_depth[py * C->plan_w + px];
  if (pd == depth) {
    if (log2 == 3 && C->plan_nxn[py * C->plan_w + px])
      return cc_commit_nxn(C, px, py);
    return cc_commit_cu(C, px, py, log2, C->plan_mode[py * C->plan_w + px],
                        C->plan_tusplit[py * C->plan_w + px]);
  }
  if (pd < depth || log2 <= 3) {
    return -1;   // plan inconsistency / uncovered area: host fallback
  }
  int half = 1 << (log2 - 3);
  for (int sub = 0; sub < 4; sub++)
    if (cc_walk(C, px + (sub & 1) * half, py + (sub >> 1) * half, log2 - 1) <
        0)
      return -1;
  return 0;
}

extern "C" int commit_plan_ctu(const CommitCtx *C, int cx, int cy) {
  int parts = 1 << (C->ctb_log2 - 2);
  return cc_walk(C, cx * parts, cy * parts, C->ctb_log2);
}

// whole-frame pass 1: every CTU in raster order through the native walk.
// Returns 0, or 1 + the raster index of the first CTU the native engine
// could not commit (the host re-runs that CTU and the rest in Python).
extern "C" int commit_plan_frame(const CommitCtx *C) {
  int parts = 1 << (C->ctb_log2 - 2);
  int wc = (C->pic_w + (1 << C->ctb_log2) - 1) >> C->ctb_log2;
  int hc = (C->pic_h + (1 << C->ctb_log2) - 1) >> C->ctb_log2;
  for (int cy = 0; cy < hc; cy++)
    for (int cx = 0; cx < wc; cx++)
      if (cc_walk(C, cx * parts, cy * parts, C->ctb_log2) < 0)
        return 1 + cy * wc + cx;
  return 0;
}

// ---------------------------------------------------------------------------
// Fused intra TU coding: availability scan + reference assembly (with
// substitution), [1 2 1]/strong smoothing, 35-mode prediction, then the
// same transform/quant/recon as code_tu.  Semantics mirror
// hm16_2_tpu/ops/intra_ref.py (HM TComPattern.cpp:309-556,
// TComPrediction.cpp:120-440) — verified by the bit-exact self/reference
// decode tests.
// ---------------------------------------------------------------------------

static const int32_t *g_ang_table = 0;
static const int32_t *g_inv_ang_table = 0;

extern "C" void set_intra_tables(const void *ang, const void *inv_ang) {
  g_ang_table = (const int32_t *)ang;
  g_inv_ang_table = (const int32_t *)inv_ang;
}

static const int kFilterThreshold[5] = {10, 7, 1, 0, 10};

extern "C" int intra_code_tu(
    const int32_t *rec_plane, int64_t rec_stride, int plane_w, int plane_h,
    const uint8_t *coded, int64_t coded_stride, int pic_w, int pic_h,
    int sx, int sy, int x0, int y0, int size, int mode, int bit_depth,
    int is_luma, int strong_smoothing, int smoothing_disabled,
    int chroma_fmt, const int32_t *orig, int64_t orig_stride, int qp,
    int use_dst, int is_intra, int32_t *levels, int64_t lvl_stride,
    int32_t *rec_out, int64_t rec_out_stride, const int32_t *sbh_scan,
    const void *rdoq_blob) {
  if (!g_ang_table || size > 32) return -1;
  const int s = size;
  const int unit_w = 4 >> sx, unit_h = 4 >> sy;
  const int n_left = (2 * s) / unit_h, n_above = (2 * s) / unit_w;
  const int total_units = n_left + n_above + 1;
  const int64_t dc_fill = (int64_t)1 << (bit_depth - 1);

  // availability per unit (fast path: committed-part lookup)
  bool flags[130];
  int num_avail = 0;
  {
    // avail(ux,uy): comp-plane sample -> 4x4 luma part
    auto avail = [&](int ux, int uy) -> bool {
      if (ux < 0 || uy < 0) return false;
      int ppx = (ux << sx) >> 2, ppy = (uy << sy) >> 2;
      if (ppx * 4 >= pic_w || ppy * 4 >= pic_h) return false;
      return coded[ppy * coded_stride + ppx] != 0;
    };
    for (int j = 0; j < n_left; j++) {
      int uy = y0 + (n_left - 1 - j) * unit_h;
      flags[j] = avail(x0 - 1, uy);
    }
    flags[n_left] = avail(x0 - 1, y0 - 1);
    for (int j = 0; j < n_above; j++)
      flags[n_left + 1 + j] = avail(x0 + j * unit_w, y0 - 1);
    for (int u = 0; u < total_units; u++) num_avail += flags[u];
  }

  int64_t top[65], left[65];
  for (int i = 0; i <= 2 * s; i++) top[i] = left[i] = dc_fill;
  auto sample = [&](int x, int y) -> int64_t {
    if (x > plane_w - 1) x = plane_w - 1;
    if (y > plane_h - 1) y = plane_h - 1;
    return rec_plane[(int64_t)y * rec_stride + x];
  };
  if (num_avail == total_units) {
    for (int i = 0; i <= 2 * s; i++) top[i] = sample(x0 - 1 + i, y0 - 1);
    for (int i = 1; i <= 2 * s; i++) left[i] = sample(x0 - 1, y0 - 1 + i);
    left[0] = top[0];
  } else if (num_avail > 0) {
    // line buffer bottom-left -> top-right in units
    int total_samples = n_left * unit_h + (n_above + 1) * unit_w;
    int64_t line[200];
    for (int i = 0; i < total_samples; i++) line[i] = dc_fill;
    for (int j = 0; j < n_left; j++)
      if (flags[j]) {
        int uy = y0 + (n_left - 1 - j) * unit_h;
        for (int i = 0; i < unit_h; i++)
          line[j * unit_h + i] = sample(x0 - 1, uy + unit_h - 1 - i);
      }
    int corner_base = n_left * unit_h;
    if (flags[n_left])
      for (int i = 0; i < unit_w; i++)
        line[corner_base + i] = sample(x0 - 1, y0 - 1);
    for (int j = 0; j < n_above; j++)
      if (flags[n_left + 1 + j]) {
        int base = corner_base + unit_w + j * unit_w;
        for (int i = 0; i < unit_w; i++)
          line[base + i] = sample(x0 + j * unit_w + i, y0 - 1);
      }
    auto unit_base = [&](int u) {
      return u < n_left ? u * unit_h : corner_base + (u - n_left) * unit_w;
    };
    auto unit_len = [&](int u) { return u < n_left ? unit_h : unit_w; };
    int start = 0;
    if (!flags[0]) {
      int nxt = 1;
      while (nxt < total_units && !flags[nxt]) nxt++;
      int64_t ref_sample = line[unit_base(nxt)];
      for (int u = 0; u < nxt; u++) {
        int b = unit_base(u);
        for (int i = 0; i < unit_len(u); i++) line[b + i] = ref_sample;
      }
      start = nxt;
    }
    for (int u = start; u < total_units; u++)
      if (!flags[u]) {
        int b = unit_base(u);
        for (int i = 0; i < unit_len(u); i++) line[b + i] = line[b - 1];
      }
    int off = (2 * s + 1) + unit_w - 2;
    for (int i = 0; i <= 2 * s; i++) top[i] = line[off + i];
    off = (2 * s + 1) - 1;
    for (int i = 1; i <= 2 * s; i++) left[i] = line[off - i];
    left[0] = top[0];
  }

  // filtering decision (filteringIntraReferenceSamples)
  bool do_filter = false;
  if (!smoothing_disabled && (is_luma || chroma_fmt == 3) && mode != 1) {
    int size_idx = 0, t = s;
    while (t > 4) { t >>= 1; size_idx++; }
    int d1 = mode - 10 < 0 ? 10 - mode : mode - 10;
    int d2 = mode - 26 < 0 ? 26 - mode : mode - 26;
    int diff = d1 < d2 ? d1 : d2;
    do_filter = diff > kFilterThreshold[size_idx];
  }
  if (do_filter) {
    int64_t tf[65], lf[65];
    bool strong = false;
    if (strong_smoothing && s == 32) {
      int64_t thr = (int64_t)1 << (bit_depth - 5);
      int64_t bl = left[2 * s], tl = top[0], tr = top[2 * s];
      int64_t dl = bl + tl - 2 * left[s];
      int64_t da = tl + tr - 2 * top[s];
      strong = (dl < 0 ? -dl : dl) < thr && (da < 0 ? -da : da) < thr;
    }
    if (strong) {
      int log2s = 0;
      for (int t = s; t > 1; t >>= 1) log2s++;
      int shift = log2s + 1;
      int64_t bl = left[2 * s], tl = top[0], tr = top[2 * s];
      tf[0] = tl; lf[0] = tl;
      tf[2 * s] = tr; lf[2 * s] = bl;
      for (int i = 1; i < 2 * s; i++) {
        lf[i] = ((2 * s - i) * tl + i * bl + s) >> shift;
        tf[i] = ((2 * s - i) * tl + i * tr + s) >> shift;
      }
    } else {
      tf[2 * s] = top[2 * s]; lf[2 * s] = left[2 * s];
      for (int i = 1; i < 2 * s; i++) {
        lf[i] = (left[i + 1] + 2 * left[i] + left[i - 1] + 2) >> 2;
        tf[i] = (top[i + 1] + 2 * top[i] + top[i - 1] + 2) >> 2;
      }
      int64_t corner = (left[1] + 2 * top[0] + top[1] + 2) >> 2;
      tf[0] = corner; lf[0] = corner;
    }
    for (int i = 0; i <= 2 * s; i++) { top[i] = tf[i]; left[i] = lf[i]; }
  }

  // prediction
  int32_t pred[32 * 32];
  const int64_t maxv = ((int64_t)1 << bit_depth) - 1;
  if (mode == 0) {                                   // planar
    int64_t bl = left[s + 1], tr = top[s + 1];
    int log2s = 0;
    for (int t = s; t > 1; t >>= 1) log2s++;
    for (int y = 0; y < s; y++)
      for (int x = 0; x < s; x++) {
        int64_t hor = (s - 1 - x) * left[y + 1] + (x + 1) * tr;
        int64_t ver = (s - 1 - y) * top[x + 1] + (y + 1) * bl;
        pred[y * s + x] = (int32_t)((hor + ver + s) >> (log2s + 1));
      }
  } else if (mode == 1) {                            // DC
    int64_t sum = 0;
    for (int i = 1; i <= s; i++) sum += top[i] + left[i];
    int log2s = 0;
    for (int t = s; t > 1; t >>= 1) log2s++;
    int64_t dcval = (sum + s) >> (log2s + 1);
    for (int i = 0; i < s * s; i++) pred[i] = (int32_t)dcval;
    if (is_luma && s <= 16) {
      pred[0] = (int32_t)((top[1] + left[1] + 2 * dcval + 2) >> 2);
      for (int x = 1; x < s; x++)
        pred[x] = (int32_t)((top[x + 1] + 3 * dcval + 2) >> 2);
      for (int y = 1; y < s; y++)
        pred[y * s] = (int32_t)((left[y + 1] + 3 * dcval + 2) >> 2);
    }
  } else {                                           // angular
    bool is_ver = mode >= 18;
    int ang_mode = is_ver ? mode - 26 : -(mode - 10);
    int aam = ang_mode < 0 ? -ang_mode : ang_mode;
    int abs_ang = g_ang_table[aam];
    int inv_angle = g_inv_ang_table[aam];
    int angle = ang_mode < 0 ? -abs_ang : abs_ang;
    int64_t ref_main[4 * 32 + 2];
    const int base = s;
    const int64_t *main_src = is_ver ? top : left;
    const int64_t *side_src = is_ver ? left : top;
    if (angle < 0) {
      for (int x = 0; x <= s; x++) ref_main[base + x] = main_src[x];
      int inv_sum = 128;
      for (int k = -1; k > (s * angle) >> 5; k--) {
        inv_sum += inv_angle;
        ref_main[base + k] = side_src[inv_sum >> 8];
      }
    } else {
      for (int x = 0; x <= 2 * s; x++) ref_main[base + x] = main_src[x];
    }
    int64_t tmp[32 * 32];
    if (angle == 0) {
      for (int y = 0; y < s; y++)
        for (int x = 0; x < s; x++) tmp[y * s + x] = ref_main[base + 1 + x];
      if (is_luma && s <= 16) {
        int64_t ref0 = side_src[0];
        for (int y = 0; y < s; y++) {
          int64_t v = tmp[y * s] + ((side_src[y + 1] - ref0) >> 1);
          tmp[y * s] = clip64(v, 0, maxv);
        }
      }
    } else {
      for (int y = 0; y < s; y++) {
        int delta = (y + 1) * angle;
        int i_int = delta >> 5;
        int frac = delta & 31;
        for (int x = 0; x < s; x++) {
          int idx = base + 1 + i_int + x;
          tmp[y * s + x] = frac
              ? ((32 - frac) * ref_main[idx] + frac * ref_main[idx + 1] + 16)
                    >> 5
              : ref_main[idx];
        }
      }
    }
    if (is_ver) {
      for (int i = 0; i < s * s; i++) pred[i] = (int32_t)tmp[i];
    } else {
      for (int y = 0; y < s; y++)
        for (int x = 0; x < s; x++) pred[y * s + x] = (int32_t)tmp[x * s + y];
    }
  }

  int log2n = 0;
  for (int t = s; t > 1; t >>= 1) log2n++;
  return code_tu(orig, orig_stride, pred, s, s, log2n, bit_depth, qp,
                 use_dst, is_intra, levels, lvl_stride, rec_out,
                 rec_out_stride, sbh_scan, rdoq_blob);
}

// ---------------------------------------------------------------------------
// SAO: whole-frame statistics (encoder estimate) and per-CTU apply.
// Twins of encode/sao_enc._frame_stats and ops/sao_ref._sao_ctu_comp /
// _eo_classify (HM TEncSampleAdaptiveOffset.cpp:910 getBlkStats,
// TComSampleAdaptiveOffset.cpp:309 offsetBlock).  Sums are integers, so
// the double accumulators match numpy's float64 block sums exactly.
// ---------------------------------------------------------------------------

extern "C" {

static const int kEoD[4][2][2] = {   // [type][neighbor][dy,dx]
    {{0, -1}, {0, 1}},    // EO_0
    {{-1, 0}, {1, 0}},    // EO_90
    {{-1, -1}, {1, 1}},   // EO_135
    {{-1, 1}, {1, -1}},   // EO_45
};
static const int kEdgeSlot[5] = {0, 1, -1, 2, 3};  // et -> offsets slot

void sao_frame_stats(const int32_t *rec, int64_t rstride, int ph, int pw,
                     const int32_t *org, int64_t ostride, int w, int h,
                     int cb_w, int cb_h, int w_ctbs, int bd,
                     double *S_eo, int64_t *N_eo, double *S_bo,
                     int64_t *N_bo) {
  int shift = bd - 5;
  for (int y = 0; y < h; y++) {
    const int32_t *rrow = rec + (int64_t)y * rstride;
    const int32_t *orow = org + (int64_t)y * ostride;
    int ctu_row = (y / cb_h) * w_ctbs;
    for (int x = 0; x < w; x++) {
      int c = rrow[x];
      int64_t diff = (int64_t)orow[x] - c;
      int ctu = ctu_row + x / cb_w;
      // BO
      int band = c >> shift;
      S_bo[ctu * 32 + band] += (double)diff;
      N_bo[ctu * 32 + band] += 1;
      // EO types: neighbor range limits over the PADDED plane, exactly
      // like the numpy fast path (valid-area border pixels may read the
      // zero-initialised padding — identical semantics, not a bug swap)
      for (int t = 0; t < 4; t++) {
        int d1y = kEoD[t][0][0], d1x = kEoD[t][0][1];
        int d2y = kEoD[t][1][0], d2x = kEoD[t][1][1];
        int y1 = y + d1y, x1 = x + d1x, y2 = y + d2y, x2 = x + d2x;
        if (y1 < 0 || y1 >= ph || x1 < 0 || x1 >= pw || y2 < 0 ||
            y2 >= ph || x2 < 0 || x2 >= pw)
          continue;
        int v1 = rec[(int64_t)y1 * rstride + x1];
        int v2 = rec[(int64_t)y2 * rstride + x2];
        int et = (c > v1) - (c < v1) + (c > v2) - (c < v2) + 2;
        int slot = kEdgeSlot[et];
        if (slot < 0) continue;
        int idx = (ctu * 4 + t) * 4 + slot;
        S_eo[idx] += (double)diff;
        N_eo[idx] += 1;
      }
    }
  }
}

// avail_mask bits: 0 left, 1 right, 2 above, 3 below, 4 above-left,
// 5 above-right, 6 below-left, 7 below-right
void sao_apply_ctu(const int32_t *src, int64_t sstride, int64_t splane_h,
                   int64_t splane_w, int32_t *rec, int64_t rstride, int x0,
                   int y0, int w, int h, int bd, int type_idx,
                   const int32_t *offs4, int band, int avail_mask) {
  int max_val = (1 << bd) - 1;
  if (type_idx == 4) {           // BO
    int64_t table[32];
    for (int i = 0; i < 32; i++) table[i] = 0;
    for (int i = 0; i < 4; i++) table[(band + i) & 31] = offs4[i];
    int shift = bd - 5;
    for (int y = 0; y < h; y++) {
      const int32_t *srow = src + (int64_t)(y0 + y) * sstride + x0;
      int32_t *rrow = rec + (int64_t)(y0 + y) * rstride + x0;
      for (int x = 0; x < w; x++) {
        int v = srow[x] + (int)table[srow[x] >> shift];
        rrow[x] = v < 0 ? 0 : (v > max_val ? max_val : v);
      }
    }
    return;
  }
  int left = (avail_mask >> 0) & 1, right = (avail_mask >> 1) & 1;
  int above = (avail_mask >> 2) & 1, below = (avail_mask >> 3) & 1;
  int al = (avail_mask >> 4) & 1, ar = (avail_mask >> 5) & 1;
  int bl = (avail_mask >> 6) & 1, br = (avail_mask >> 7) & 1;
  int d1y = kEoD[type_idx][0][0], d1x = kEoD[type_idx][0][1];
  int d2y = kEoD[type_idx][1][0], d2x = kEoD[type_idx][1][1];
  int64_t offsets5[5] = {offs4[0], offs4[1], 0, offs4[2], offs4[3]};
  for (int y = 0; y < h; y++) {
    // per-row processable column range(s), mirroring _eo_classify
    int xs = 0, xe = w;     // [xs, xe)
    if (type_idx == 0) {
      if (!left) xs = 1;
      if (!right) xe = w - 1;
    } else if (type_idx == 1) {
      if ((y == 0 && !above) || (y == h - 1 && !below)) continue;
    } else if (type_idx == 2) {
      if (y == 0) {
        xs = al ? 0 : 1;
        xe = above ? (right ? w : w - 1) : 1;
      } else if (y == h - 1) {
        xs = below ? (left ? 0 : 1) : w - 1;
        xe = br ? w : w - 1;
      } else {
        if (!left) xs = 1;
        if (!right) xe = w - 1;
      }
    } else {
      if (y == 0) {
        xs = above ? (left ? 0 : 1) : w - 1;
        xe = ar ? w : w - 1;
      } else if (y == h - 1) {
        xs = bl ? 0 : 1;
        xe = below ? (right ? w : w - 1) : 1;
      } else {
        if (!left) xs = 1;
        if (!right) xe = w - 1;
      }
    }
    if (xe > w) xe = w;
    if (xs < 0) xs = 0;
    const int32_t *srow = src + (int64_t)(y0 + y) * sstride;
    int32_t *rrow = rec + (int64_t)(y0 + y) * rstride;
    for (int x = xs; x < xe; x++) {
      int gx = x0 + x, gy = y0 + y;
      int n1y = gy + d1y, n1x = gx + d1x, n2y = gy + d2y, n2x = gx + d2x;
      if (n1y < 0 || n1y >= splane_h || n1x < 0 || n1x >= splane_w ||
          n2y < 0 || n2y >= splane_h || n2x < 0 || n2x >= splane_w)
        continue;
      int c = srow[gx];
      int v1 = src[(int64_t)n1y * sstride + n1x];
      int v2 = src[(int64_t)n2y * sstride + n2x];
      int et = (c > v1) - (c < v1) + (c > v2) - (c < v2) + 2;
      int v = c + (int)offsets5[et];
      rrow[gx] = v < 0 ? 0 : (v > max_val ? max_val : v);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Deblocking per-edge pixel kernels: scalar twins of the vectorized
// ops/deblock_ref._filter_luma_vec / _filter_chroma_vec inner loops (HM
// TComLoopFilter xEdgeFilterLuma/Chroma, TComLoopFilter.cpp:540,656).
// Edge selection, boundary strengths and tc/beta derivation stay in the
// (cheap) vectorized Python layer; these do the 4-line sample filtering.
// ---------------------------------------------------------------------------

extern "C" {

void deblock_luma_edges(int32_t *rec, int64_t stride, int n,
                        const int32_t *y0s, const int32_t *x0s,
                        const int64_t *tcs, const int64_t *betas,
                        const uint8_t *no_p, const uint8_t *no_q,
                        int direction, int bd) {
  const int max_val = (1 << bd) - 1;
  for (int e = 0; e < n; e++) {
    int y0 = y0s[e], x0 = x0s[e];
    long tc = tcs[e], beta = betas[e];
    int64_t m[4][8];
    int32_t *ptr[4][8];
    for (int line = 0; line < 4; line++)
      for (int k = 0; k < 8; k++) {
        int64_t off;
        if (direction == 0)   // EDGE_VER
          off = (int64_t)(y0 + line) * stride + (x0 + k - 4);
        else
          off = (int64_t)(y0 + k - 4) * stride + (x0 + line);
        ptr[line][k] = rec + off;
        m[line][k] = rec[off];
      }
    long dp0 = labs((long)(m[0][1] - 2 * m[0][2] + m[0][3]));
    long dq0 = labs((long)(m[0][4] - 2 * m[0][5] + m[0][6]));
    long dp3 = labs((long)(m[3][1] - 2 * m[3][2] + m[3][3]));
    long dq3 = labs((long)(m[3][4] - 2 * m[3][5] + m[3][6]));
    long d0 = dp0 + dq0, d3 = dp3 + dq3;
    long d = d0 + d3;
    int act = d < beta;
    long side_thresh = (beta + (beta >> 1)) >> 3;
    int filter_p = (dp0 + dp3) < side_thresh;
    int filter_q = (dq0 + dq3) < side_thresh;
    auto strong_line = [&](int line, long dd) -> int {
      return (labs((long)(m[line][0] - m[line][3])) +
                  labs((long)(m[line][7] - m[line][4])) <
              (beta >> 3)) &&
             (dd < (beta >> 2)) &&
             (labs((long)(m[line][3] - m[line][4])) < ((tc * 5 + 1) >> 1));
    };
    int sw = strong_line(0, 2 * d0) && strong_line(3, 2 * d3);
    for (int line = 0; line < 4; line++) {
      const int64_t *mm = m[line];
      int64_t out[8];
      for (int k = 0; k < 8; k++) out[k] = mm[k];
      if (sw) {
        auto cl2 = [&](int64_t v, int64_t ref) {
          int64_t lo = ref - 2 * tc, hi = ref + 2 * tc;
          return v < lo ? lo : (v > hi ? hi : v);
        };
        out[3] = cl2((mm[1] + 2 * mm[2] + 2 * mm[3] + 2 * mm[4] + mm[5] + 4)
                         >> 3, mm[3]);
        out[4] = cl2((mm[2] + 2 * mm[3] + 2 * mm[4] + 2 * mm[5] + mm[6] + 4)
                         >> 3, mm[4]);
        out[2] = cl2((mm[1] + mm[2] + mm[3] + mm[4] + 2) >> 2, mm[2]);
        out[5] = cl2((mm[3] + mm[4] + mm[5] + mm[6] + 2) >> 2, mm[5]);
        out[1] = cl2((2 * mm[0] + 3 * mm[1] + mm[2] + mm[3] + mm[4] + 4)
                         >> 3, mm[1]);
        out[6] = cl2((mm[3] + mm[4] + mm[5] + 3 * mm[6] + 2 * mm[7] + 4)
                         >> 3, mm[6]);
      } else {
        int64_t delta = (9 * (mm[4] - mm[3]) - 3 * (mm[5] - mm[2]) + 8) >> 4;
        if (labs((long)delta) < tc * 10) {
          int64_t dclip = delta < -tc ? -tc : (delta > tc ? tc : delta);
          int64_t v3 = mm[3] + dclip;
          out[3] = v3 < 0 ? 0 : (v3 > max_val ? max_val : v3);
          int64_t v4 = mm[4] - dclip;
          out[4] = v4 < 0 ? 0 : (v4 > max_val ? max_val : v4);
          int64_t tc2 = tc >> 1;
          if (filter_p) {
            int64_t d1 = (((mm[1] + mm[3] + 1) >> 1) - mm[2] + dclip) >> 1;
            d1 = d1 < -tc2 ? -tc2 : (d1 > tc2 ? tc2 : d1);
            int64_t v2 = mm[2] + d1;
            out[2] = v2 < 0 ? 0 : (v2 > max_val ? max_val : v2);
          }
          if (filter_q) {
            int64_t d2 = (((mm[6] + mm[4] + 1) >> 1) - mm[5] - dclip) >> 1;
            d2 = d2 < -tc2 ? -tc2 : (d2 > tc2 ? tc2 : d2);
            int64_t v5 = mm[5] + d2;
            out[5] = v5 < 0 ? 0 : (v5 > max_val ? max_val : v5);
          }
        }
      }
      if (!act) continue;
      for (int k = 1; k < 7; k++) {
        if (k < 4 && no_p[e]) continue;
        if (k >= 4 && no_q[e]) continue;
        *ptr[line][k] = (int32_t)out[k];
      }
    }
  }
}

void deblock_chroma_edges(int32_t *rec, int64_t stride, int n,
                          const int32_t *cy0, const int32_t *cx0,
                          const int64_t *tcs, const uint8_t *no_p,
                          const uint8_t *no_q, int n_lines, int direction,
                          int bd) {
  const int max_val = (1 << bd) - 1;
  for (int e = 0; e < n; e++) {
    long tc = tcs[e];
    for (int line = 0; line < n_lines; line++) {
      int64_t off[4];
      for (int k = 0; k < 4; k++) {
        if (direction == 0)
          off[k] = (int64_t)(cy0[e] + line) * stride + (cx0[e] + k - 2);
        else
          off[k] = (int64_t)(cy0[e] + k - 2) * stride + (cx0[e] + line);
      }
      int64_t m2 = rec[off[0]], m3 = rec[off[1]];
      int64_t m4 = rec[off[2]], m5 = rec[off[3]];
      int64_t delta = (((m4 - m3) * 4) + m2 - m5 + 4) >> 3;
      delta = delta < -tc ? -tc : (delta > tc ? tc : delta);
      if (!no_p[e]) {
        int64_t v = m3 + delta;
        rec[off[1]] = (int32_t)(v < 0 ? 0 : (v > max_val ? max_val : v));
      }
      if (!no_q[e]) {
        int64_t v = m4 - delta;
        rec[off[2]] = (int32_t)(v < 0 ? 0 : (v > max_val ? max_val : v));
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Motion-compensation interpolation (ops/interp_ref.mc_block twin; spec
// 8.5.4.2.2, HM TComInterpolationFilter.cpp:94-383).  Border replication
// equals the reference's extended picture margins.  Single block, both
// separable stages, exact shift/offset/clip semantics of _filter_1d /
// _copy_stage (IF_INTERNAL_PREC=14, IF_FILTER_PREC=6).
// ---------------------------------------------------------------------------

namespace {

static const int kLumaTaps[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};
static const int kChromaTaps[8][4] = {
    {0, 64, 0, 0},  {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

static inline int mc_clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace


extern "C" int mc_block_native(const int32_t *ref, int64_t stride, int ph,
                               int pw, int x0, int y0, int w, int h,
                               int mv_x, int mv_y, int frac_bits_x,
                               int frac_bits_y, int is_luma, int bd,
                               int keep_precision, int32_t *out) {
  const int n = is_luma ? 8 : 4;
  const int half = n / 2 - 1;
  const int ix = x0 + (mv_x >> frac_bits_x);
  const int iy = y0 + (mv_y >> frac_bits_y);
  const int fx = mv_x & ((1 << frac_bits_x) - 1);
  const int fy = mv_y & ((1 << frac_bits_y) - 1);
  const int tx = is_luma ? fx : fx << (3 - frac_bits_x);
  const int ty = is_luma ? fy : fy << (3 - frac_bits_y);
  const int *tapx = is_luma ? kLumaTaps[tx] : kChromaTaps[tx];
  const int *tapy = is_luma ? kLumaTaps[ty] : kChromaTaps[ty];
  const int hr = (14 - bd) > 2 ? (14 - bd) : 2;
  const int OFFS = 1 << 13;
  const int maxv = (1 << bd) - 1;
  const bool last = !keep_precision;

  // clamped source fetch
  auto src = [&](int r, int c) -> int64_t {
    int rr = mc_clampi(r, 0, ph - 1);
    int cc = mc_clampi(c, 0, pw - 1);
    return ref[(int64_t)rr * stride + cc];
  };

  if (fy == 0 && fx == 0) {
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        int64_t v = src(iy + r, ix + c);
        out[r * w + c] =
            last ? (int32_t)v : (int32_t)((v << hr) - OFFS);
      }
    return 0;
  }
  if (fy == 0) {  // horizontal only: is_first, is_last=last
    int shift = last ? 6 : 6 - hr;
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        int64_t acc = 0;
        for (int k = 0; k < n; k++)
          acc += (int64_t)tapx[k] * src(iy + r, ix + c - half + k);
        int64_t off = last ? (int64_t)1 << (shift - 1)
                           : -((int64_t)OFFS << shift);
        int64_t v = (acc + off) >> shift;
        if (last) v = mc_clampi((int)v, 0, maxv);
        out[r * w + c] = (int32_t)v;
      }
    return 0;
  }
  if (fx == 0) {  // vertical only: is_first, is_last=last
    int shift = last ? 6 : 6 - hr;
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        int64_t acc = 0;
        for (int k = 0; k < n; k++)
          acc += (int64_t)tapy[k] * src(iy + r - half + k, ix + c);
        int64_t off = last ? (int64_t)1 << (shift - 1)
                           : -((int64_t)OFFS << shift);
        int64_t v = (acc + off) >> shift;
        if (last) v = mc_clampi((int)v, 0, maxv);
        out[r * w + c] = (int32_t)v;
      }
    return 0;
  }
  // two-stage: horizontal (is_first, not last) into tmp, then vertical
  // (not first, is_last=last)
  const int rows = h + n - 1;
  const int sh1 = 6 - hr;
  static thread_local int64_t tmp_buf[(64 + 8) * 64];
  int64_t *tmp = tmp_buf;
  bool heap = (int64_t)rows * w > (int64_t)(64 + 8) * 64;
  if (heap) tmp = new int64_t[(size_t)rows * w];
  for (int r = 0; r < rows; r++)
    for (int c = 0; c < w; c++) {
      int64_t acc = 0;
      for (int k = 0; k < n; k++)
        acc += (int64_t)tapx[k] * src(iy + r - half, ix + c - half + k);
      tmp[r * w + c] = (acc - ((int64_t)OFFS << sh1)) >> sh1;
    }
  int shift = last ? 6 + hr : 6;
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++) {
      int64_t acc = 0;
      for (int k = 0; k < n; k++)
        acc += (int64_t)tapy[k] * tmp[(r + k) * w + c];
      int64_t v;
      if (last) {
        v = (acc + ((int64_t)1 << (shift - 1)) + ((int64_t)OFFS << 6))
            >> shift;
        v = mc_clampi((int)v, 0, maxv);
      } else {
        v = acc >> shift;
      }
      out[r * w + c] = (int32_t)v;
    }
  if (heap) delete[] tmp;
  return 0;
}

// ---------------------------------------------------------------------------
// Native inter CU commit (CtuSearch._inter_residual_commit twin): MC from
// the committed motion fields (incl. bi averaging and the identical-motion
// collapse), residual coding per component via code_tu (RDOQ), the
// zero-residual (skip / root-cbf-0) RD decision, and the one-level TU
// split trial.  Reference semantics: TEncSearch::encodeResAndCalcRdInterCU
// (TEncSearch.cpp:4435) and xEstimateResidualQT (:4680), re-expressed as
// a plan-driven single pass (no recursive trials).
// Python keeps merge/AMVP signalling and the field writes; weighted
// prediction and non-4:2:0 chroma fall back to the Python path.
// ---------------------------------------------------------------------------

struct InterCtx {
  int32_t pic_w, pic_h;
  int32_t parts_w;
  int32_t num_comps, chroma_fmt;
  int32_t max_tb_log2;
  int32_t try_tusplit;
  int32_t allow_collapse;      // B-slice && !weighted_bipred
  int32_t bd[3], qp_comp[3];
  double lam, chroma_weight;
  // planes
  const int32_t *orig_p[3];
  int32_t *rec_p[3];
  int32_t *coeff_p[3];
  int64_t orig_stride[3];
  int64_t plane_stride[3];
  // part-grid arrays (row stride parts_w)
  const int32_t *mv;           // (2, PH, PW, 2) int32
  int64_t mv_list_stride;      // elements between lists
  const int8_t *ref_idx;       // (2, PH, PW)
  int64_t ri_list_stride;
  const int8_t *inter_dir;
  int8_t *skip;
  const int8_t *merge_flag;
  int8_t *tr_idx;
  uint8_t *cbf[3];
  // reference planes [lx][ridx][comp]
  const int32_t *ref_pix[2][8][3];
  int64_t ref_stride[2][8][3];
  int32_t ref_w[2][8][3], ref_h[2][8][3];
  int32_t ref_poc[2][8];
  int32_t n_ref[2];
  // RDOQ blobs per [chan][log2n] (scan 0; inter has no MDCS)
  const RdoqBlob *blobs[2][6];
  // exact TU bit-counting kit (see CommitCtx)
  const void *resenc;
  const uint8_t *bits_ctx_init;
  int64_t bits_ctx_n;
  const void *bits_params[24];
  const void *bits_scan[12];
  const void *bits_scan_cg[12];
};

extern "C" int mc_block_native(const int32_t *, int64_t, int, int, int, int,
                               int, int, int, int, int, int, int, int, int,
                               int32_t *);

namespace {

// one PU's prediction into out (strided); motion read from the PU's
// top-left part (ppx, ppy).  Identical-motion collapse is per PU
// (TComPrediction::xCheckIdenticalMotion).
static int ic_pred_pu(const InterCtx *I, int x0, int y0, int pw, int ph,
                      int ppx, int ppy, int comp, int32_t *out,
                      int out_stride) {
  int sx = comp ? 1 : 0, sy = comp ? 1 : 0;   // chroma_fmt 1 only
  int part = ppy * I->parts_w + ppx;
  int dir = I->inter_dir[part];
  if (dir < 1 || dir > 3) return -1;
  int bi = dir == 3;
  int r[2] = {-1, -1};
  const int32_t *mvp[2] = {nullptr, nullptr};
  for (int lx = 0; lx < 2; lx++) {
    if (!((dir >> lx) & 1)) continue;
    r[lx] = I->ref_idx[lx * I->ri_list_stride + part];
    if (r[lx] < 0 || r[lx] >= I->n_ref[lx]) return -1;
    mvp[lx] = I->mv + (lx * I->mv_list_stride + part * 2);
  }
  if (bi && I->allow_collapse) {
    if (I->ref_poc[0][r[0]] == I->ref_poc[1][r[1]] &&
        mvp[0][0] == mvp[1][0] && mvp[0][1] == mvp[1][1]) {
      bi = 0;
      dir = 1;
    }
  }
  static thread_local int32_t part_buf[2][64 * 64];
  static thread_local int32_t uni_buf[64 * 64];
  int cw = pw >> sx, ch = ph >> sy;
  int bd = I->bd[comp];
  int done = 0;
  for (int lx = 0; lx < 2; lx++) {
    if (!((dir >> lx) & 1)) continue;
    const int32_t *rp = I->ref_pix[lx][r[lx]][comp];
    if (!rp) return -1;
    int32_t *dst = bi ? part_buf[lx] : uni_buf;
    mc_block_native(rp, I->ref_stride[lx][r[lx]][comp],
                    I->ref_h[lx][r[lx]][comp], I->ref_w[lx][r[lx]][comp],
                    x0 >> sx, y0 >> sy, cw, ch, mvp[lx][0], mvp[lx][1],
                    2 + sx, 2 + sy, comp == 0, bd, bi ? 1 : 0, dst);
    done = 1;
    if (!bi) break;
  }
  if (!done) return -1;
  if (bi) {
    int shift = 14 + 1 - bd;
    int off = (1 << (shift - 1)) + 2 * (1 << 13);
    int maxv = (1 << bd) - 1;
    for (int i = 0; i < cw * ch; i++) {
      int v = (part_buf[0][i] + part_buf[1][i] + off) >> shift;
      uni_buf[i] = v < 0 ? 0 : (v > maxv ? maxv : v);
    }
  }
  for (int yy = 0; yy < ch; yy++)
    for (int xx = 0; xx < cw; xx++)
      out[yy * out_stride + xx] = uni_buf[yy * cw + xx];
  return 0;
}

// one component of the CU prediction into out (size_c x size_c); psize
// 0 = 2Nx2N, 1 = 2NxN, 2 = Nx2N (per-PU motion from each PU's origin)
static int ic_pred_comp(const InterCtx *I, int px, int py, int log2,
                        int comp, int psize, int32_t *out) {
  int sx = comp ? 1 : 0, sy = comp ? 1 : 0;
  int w = 1 << log2, h = 1 << log2;
  int cs = w >> sx;
  int x0 = px * 4, y0 = py * 4;
  int n = w / 4;
  if (psize == 0)
    return ic_pred_pu(I, x0, y0, w, h, px, py, comp, out, cs);
  if (psize == 1) {                                     // 2NxN
    if (ic_pred_pu(I, x0, y0, w, h / 2, px, py, comp, out, cs) < 0)
      return -1;
    return ic_pred_pu(I, x0, y0 + h / 2, w, h / 2, px, py + n / 2, comp,
                      out + (size_t)((h / 2) >> sy) * cs, cs);
  }
  if (psize == 2) {                                     // Nx2N
    if (ic_pred_pu(I, x0, y0, w / 2, h, px, py, comp, out, cs) < 0)
      return -1;
    return ic_pred_pu(I, x0 + w / 2, y0, w / 2, h, px + n / 2, py, comp,
                      out + ((w / 2) >> sx), cs);
  }
  return -1;
}

static double ic_sse(const int32_t *a, int64_t astride, const int32_t *b,
                     int64_t bstride, int n) {
  double s = 0.0;
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) {
      double d = (double)(a[y * astride + x] - b[y * bstride + x]);
      s += d * d;
    }
  return s;
}

static bool ic_any(const int32_t *a, int64_t stride, int n) {
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++)
      if (a[y * stride + x]) return true;
  return false;
}

static void ic_fill_u8(uint8_t *arr, int parts_w, int px, int py, int n,
                       uint8_t v) {
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) arr[(py + y) * parts_w + px + x] = v;
}

static void ic_or_u8(uint8_t *arr, int parts_w, int px, int py, int n,
                     uint8_t v) {
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) arr[(py + y) * parts_w + px + x] |= v;
}

static void ic_fill_i8(int8_t *arr, int parts_w, int px, int py, int n,
                       int8_t v) {
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) arr[(py + y) * parts_w + px + x] = v;
}

static double ic_tu_bits(const InterCtx *I, const int32_t *lvl,
                         int64_t stride, int n, int chan) {
  if (n > 32 || (chan == 1 && n > 16)) {
    // region spans four coded TUs (implicit split): sum the quadrants
    int h = n / 2;
    return ic_tu_bits(I, lvl, stride, h, chan) +
           ic_tu_bits(I, lvl + h, stride, h, chan) +
           ic_tu_bits(I, lvl + h * stride, stride, h, chan) +
           ic_tu_bits(I, lvl + h * stride + h, stride, h, chan);
  }
  int log2w = 31 - __builtin_clz((unsigned)n);
  int ti = (log2w - 2) * 3;                    // inter residuals scan diag
  double b = exact_tu_bits_raw(I->resenc, I->bits_ctx_init, I->bits_ctx_n,
                               I->bits_params[chan * 12 + ti],
                               I->bits_scan[ti], I->bits_scan_cg[ti],
                               lvl, stride, n);
  if (b >= 0.0) return b > 0.0 ? b : 0.8;
  static thread_local int32_t tmp[32 * 32];
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) tmp[y * n + x] = lvl[y * stride + x];
  return cc_res_bits(tmp, n);
}

// copy of cc_res_bits on strided levels
static double ic_res_bits(const int32_t *lvl, int64_t stride, int n) {
  static thread_local int32_t tmp[64 * 64];
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) tmp[y * n + x] = lvl[y * stride + x];
  return cc_res_bits(tmp, n);
}

static int ic_code_tu(const InterCtx *I, int comp, int cx0, int cy0, int cs,
                      const int32_t *pred, int64_t pred_stride) {
  int bd = I->bd[comp];
  int qp = I->qp_comp[comp];
  int log2n = 0;
  for (int t = cs; t > 1; t >>= 1) log2n++;
  int chan = comp == 0 ? 0 : 1;
  const RdoqBlob *blob = I->blobs[chan][log2n];
  int64_t st = I->plane_stride[comp];
  int64_t ost = I->orig_stride[comp];
  return code_tu(I->orig_p[comp] + cy0 * ost + cx0, ost, pred, pred_stride,
                 cs, log2n, bd, qp, 0, 0,
                 I->coeff_p[comp] + cy0 * st + cx0, st,
                 I->rec_p[comp] + cy0 * st + cx0, st, nullptr, blob);
}

}  // namespace

// weighted multi-component SSE of the CURRENT part-array motion's
// prediction vs the original over one PU rect — the host writes a
// candidate's (dir, ref, mv) into the PU-origin part, calls this, and
// restores; replaces the per-candidate numpy MC in the merge/AMVP
// rerank (TEncCu::xCheckRDCostMerge2Nx2N pricing).  -1 = not
// compensable with this context.
extern "C" double ic_cand_sse(const InterCtx *I, int x0, int y0, int pw,
                              int ph, int ppx, int ppy) {
  if (I->chroma_fmt != 1 && I->num_comps != 1) return -1.0;
  static thread_local int32_t buf[64 * 64];
  double tot = 0.0;
  for (int comp = 0; comp < I->num_comps; comp++) {
    int sx = comp ? 1 : 0;
    int cw = pw >> sx, ch = ph >> sx;
    if (ic_pred_pu(I, x0, y0, pw, ph, ppx, ppy, comp, buf, cw) < 0)
      return -1.0;
    const int32_t *o = I->orig_p[comp]
        + (int64_t)(y0 >> sx) * I->orig_stride[comp] + (x0 >> sx);
    double w = comp ? I->chroma_weight : 1.0;
    double s = 0.0;
    for (int yy = 0; yy < ch; yy++) {
      const int32_t *orow = o + (int64_t)yy * I->orig_stride[comp];
      const int32_t *prow = buf + yy * cw;
      for (int xx = 0; xx < cw; xx++) {
        double d = (double)(orow[xx] - prow[xx]);
        s += d * d;
      }
    }
    tot += w * s;
  }
  return tot;
}

// batched ic_cand_sse: candidates as int32 rows [dir, r0, mvx0, mvy0,
// r1, mvx1, mvy1, pad]; writes each into the PU-origin part (the part
// arrays are writable numpy buffers — const in the struct only because
// the commit engine reads them), prices, restores the original motion.
// out[i] = weighted SSE or -1 (not compensable).
extern "C" int ic_cand_sse_batch(const InterCtx *I, int x0, int y0,
                                 int pw, int ph, int ppx, int ppy,
                                 const int32_t *cands, int n,
                                 double *out) {
  if (I->chroma_fmt != 1 && I->num_comps != 1) return -1;
  int part = ppy * I->parts_w + ppx;
  int32_t *mv0 = const_cast<int32_t *>(I->mv) + part * 2;
  int32_t *mv1 = const_cast<int32_t *>(I->mv) + I->mv_list_stride + part * 2;
  int8_t *ri0 = const_cast<int8_t *>(I->ref_idx) + part;
  int8_t *ri1 = const_cast<int8_t *>(I->ref_idx) + I->ri_list_stride + part;
  int8_t *dirp = const_cast<int8_t *>(I->inter_dir) + part;
  int32_t smv0[2] = {mv0[0], mv0[1]}, smv1[2] = {mv1[0], mv1[1]};
  int8_t sri0 = *ri0, sri1 = *ri1, sdir = *dirp;
  for (int i = 0; i < n; i++) {
    const int32_t *c = cands + i * 8;
    *dirp = (int8_t)c[0];
    *ri0 = (c[0] & 1) ? (int8_t)c[1] : -1;
    mv0[0] = c[2]; mv0[1] = c[3];
    *ri1 = (c[0] & 2) ? (int8_t)c[4] : -1;
    mv1[0] = c[5]; mv1[1] = c[6];
    out[i] = ic_cand_sse(I, x0, y0, pw, ph, ppx, ppy);
  }
  mv0[0] = smv0[0]; mv0[1] = smv0[1];
  mv1[0] = smv1[0]; mv1[1] = smv1[1];
  *ri0 = sri0; *ri1 = sri1; *dirp = sdir;
  return 0;
}

extern "C" int inter_commit_cu(const InterCtx *I, int px, int py, int log2,
                               int skip_hint, int is_merge, int psize) {
  if (I->chroma_fmt != 1 && I->num_comps != 1) return -1;
  if (psize < 0 || psize > 2) return -1;
  int size = 1 << log2;
  int n = size >> 2;
  int x0 = px * 4, y0 = py * 4;
  static thread_local int32_t pred[3][64 * 64];
  for (int comp = 0; comp < I->num_comps; comp++)
    if (ic_pred_comp(I, px, py, log2, comp, psize, pred[comp]) < 0)
      return -1;

  // skip_hint is intentionally NOT trusted for the coding decision: the
  // plan priced it with luma-only SSE and estimated bits, and merge
  // repair may have committed a different MV than the plan evaluated.
  // Always code the residual and let the true zero-vs-coded RD choice at
  // the end of this function decide (TEncSearch.cpp:4680
  // xEstimateResidualQT's zero-cost comparison).
  (void)skip_hint;

  int any_cbf = 0;
  int max_tb = 1 << I->max_tb_log2;
  for (int comp = 0; comp < I->num_comps; comp++) {
    int sx = comp ? 1 : 0;
    int cs = size >> sx;
    int cx0 = x0 >> sx, cy0 = y0 >> sx;
    if (size > max_tb) {
      // implicit TU split: four max-TB TUs per component
      int hs = cs / 2, hn = n / 2;
      int kids[4];
      for (int q = 0; q < 4; q++) {
        int ty = (q >> 1) * hs, tx = (q & 1) * hs;
        int k = ic_code_tu(I, comp, cx0 + tx, cy0 + ty, hs,
                           pred[comp] + ty * cs + tx, cs);
        if (k < 0) return -1;
        kids[q] = k;
      }
      int cbf = 0;
      for (int q = 0; q < 4; q++) {
        int ty = (q >> 1) * hn, tx = (q & 1) * hn;
        uint8_t v = (uint8_t)(kids[q] << 1);
        if (comp == 0) v |= (uint8_t)kids[q];
        ic_fill_u8(I->cbf[comp], I->parts_w, px + tx, py + ty, hn, v);
        cbf |= kids[q];
      }
      if (comp)
        ic_or_u8(I->cbf[comp], I->parts_w, px, py, n, (uint8_t)cbf);
      else if (cbf)
        ic_or_u8(I->cbf[0], I->parts_w, px, py, n, 1);
      ic_fill_i8(I->tr_idx, I->parts_w, px, py, n, 1);
      any_cbf |= cbf;
      continue;
    }
    int cbf = ic_code_tu(I, comp, cx0, cy0, cs, pred[comp], cs);
    if (cbf < 0) return -1;
    ic_fill_u8(I->cbf[comp], I->parts_w, px, py, n, (uint8_t)cbf);
    any_cbf |= cbf;
  }

  // one-level TU split trial (_try_inter_tusplit)
  if (any_cbf && I->try_tusplit && log2 >= 4 && size <= max_tb) {
    static thread_local int32_t snap_rec[3][64 * 64], snap_lvl[3][64 * 64];
    double tot_w = 0.0;
    for (int comp = 0; comp < I->num_comps; comp++) {
      int sx = comp ? 1 : 0;
      int cs = size >> sx;
      int cx0 = x0 >> sx, cy0 = y0 >> sx;
      int64_t st = I->plane_stride[comp];
      int64_t ost = I->orig_stride[comp];
      double w = comp == 0 ? 1.0 : I->chroma_weight;
      for (int y = 0; y < cs; y++)
        for (int x = 0; x < cs; x++) {
          snap_rec[comp][y * cs + x] =
              I->rec_p[comp][(cy0 + y) * st + cx0 + x];
          snap_lvl[comp][y * cs + x] =
              I->coeff_p[comp][(cy0 + y) * st + cx0 + x];
        }
      tot_w += w * ic_sse(I->orig_p[comp] + cy0 * ost + cx0, ost,
                          snap_rec[comp], cs, cs);
      if (ic_any(snap_lvl[comp], cs, cs))
        tot_w += I->lam * ic_tu_bits(I, snap_lvl[comp], cs, cs,
                                     comp ? 1 : 0);
    }
    double tot_s = I->lam * 1.0;
    int child[3][4] = {{0}};
    int hn = n / 2;
    bool ok = true;
    for (int comp = 0; comp < I->num_comps && ok; comp++) {
      int sx = comp ? 1 : 0;
      int cs = size >> sx;
      int hs = cs / 2;
      int cx0 = x0 >> sx, cy0 = y0 >> sx;
      int64_t st = I->plane_stride[comp];
      int64_t ost = I->orig_stride[comp];
      double w = comp == 0 ? 1.0 : I->chroma_weight;
      for (int q = 0; q < 4; q++) {
        int ty = (q >> 1) * hs, tx = (q & 1) * hs;
        int k = ic_code_tu(I, comp, cx0 + tx, cy0 + ty, hs,
                           pred[comp] + ty * cs + tx, cs);
        if (k < 0) { ok = false; break; }
        child[comp][q] = k;
        tot_s += I->lam * 1.0;
        if (k)
          tot_s += I->lam * ic_tu_bits(
              I, I->coeff_p[comp] + (cy0 + ty) * st + cx0 + tx, st, hs,
              comp ? 1 : 0);
      }
      if (ok)
        tot_s += w * ic_sse(I->orig_p[comp] + cy0 * ost + cx0, ost,
                            I->rec_p[comp] + cy0 * st + cx0, st, cs);
    }
    if (ok && tot_s < tot_w) {
      ic_fill_i8(I->tr_idx, I->parts_w, px, py, n, 1);
      any_cbf = 0;
      for (int comp = 0; comp < I->num_comps; comp++) {
        int cany = 0;
        for (int q = 0; q < 4; q++) {
          int ty = (q >> 1) * hn, tx = (q & 1) * hn;
          uint8_t v = (uint8_t)(child[comp][q] << 1);
          if (comp == 0) v |= (uint8_t)child[comp][q];
          ic_fill_u8(I->cbf[comp], I->parts_w, px + tx, py + ty, hn, v);
          cany |= child[comp][q];
        }
        if (comp && cany)
          ic_or_u8(I->cbf[comp], I->parts_w, px, py, n, 1);
        any_cbf |= cany;
      }
      if (child[0][0] | child[0][1] | child[0][2] | child[0][3])
        ic_or_u8(I->cbf[0], I->parts_w, px, py, n, 1);
    } else {
      // keep whole-TU coding: restore planes
      for (int comp = 0; comp < I->num_comps; comp++) {
        int sx = comp ? 1 : 0;
        int cs = size >> sx;
        int cx0 = x0 >> sx, cy0 = y0 >> sx;
        int64_t st = I->plane_stride[comp];
        for (int y = 0; y < cs; y++)
          for (int x = 0; x < cs; x++) {
            I->rec_p[comp][(cy0 + y) * st + cx0 + x] =
                snap_rec[comp][y * cs + x];
            I->coeff_p[comp][(cy0 + y) * st + cx0 + x] =
                snap_lvl[comp][y * cs + x];
          }
      }
    }
  }

  // zero-residual RD alternative (skip / rqt_root_cbf = 0)
  if (any_cbf) {
    double dist_c = 0.0, dist_z = 0.0, bits_c = 1.0;
    for (int comp = 0; comp < I->num_comps; comp++) {
      int sx = comp ? 1 : 0;
      int cs = size >> sx;
      int cx0 = x0 >> sx, cy0 = y0 >> sx;
      int64_t st = I->plane_stride[comp];
      int64_t ost = I->orig_stride[comp];
      double w = comp == 0 ? 1.0 : I->chroma_weight;
      dist_c += w * ic_sse(I->orig_p[comp] + cy0 * ost + cx0, ost,
                           I->rec_p[comp] + cy0 * st + cx0, st, cs);
      dist_z += w * ic_sse(I->orig_p[comp] + cy0 * ost + cx0, ost,
                           pred[comp], cs, cs);
      if (ic_any(I->coeff_p[comp] + cy0 * st + cx0, st, cs))
        bits_c += ic_tu_bits(I, I->coeff_p[comp] + cy0 * st + cx0, st, cs,
                             comp ? 1 : 0);
    }
    if (dist_z + I->lam * 1.0 < dist_c + I->lam * bits_c) {
      for (int comp = 0; comp < I->num_comps; comp++) {
        int sx = comp ? 1 : 0;
        int cs = size >> sx;
        int cx0 = x0 >> sx, cy0 = y0 >> sx;
        int64_t st = I->plane_stride[comp];
        for (int y = 0; y < cs; y++)
          for (int x = 0; x < cs; x++) {
            I->coeff_p[comp][(cy0 + y) * st + cx0 + x] = 0;
            I->rec_p[comp][(cy0 + y) * st + cx0 + x] =
                pred[comp][y * cs + x];
          }
        ic_fill_u8(I->cbf[comp], I->parts_w, px, py, n, 0);
      }
      ic_fill_i8(I->tr_idx, I->parts_w, px, py, n, 0);
      any_cbf = 0;
    }
  }
  ic_fill_i8(I->skip, I->parts_w, px, py, n,
             (is_merge && !any_cbf) ? 1 : 0);
  return 0;
}

extern "C" void dsp_struct_probe(int64_t *out) {
  out[0] = (int64_t)sizeof(InterCtx);
  out[1] = (int64_t)__builtin_offsetof(InterCtx, resenc);
  out[2] = (int64_t)sizeof(CommitCtx);
  out[3] = (int64_t)__builtin_offsetof(CommitCtx, resenc);
}

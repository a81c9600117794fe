// Native walk of one CTU of an inter frame plan (encode/inter_plan.py):
// the twin of CtuSearch._commit_plan_tree -> _commit_planned_inter /
// _commit_planned_rect -> MvPredictor (decode/mvpred.py) for every CU the
// plan decided as inter.  Per CU, in z-order: the exact merge list and
// AMVP lists from the committed neighbours (spec 8.5.3.2; HM
// TComDataCU::getInterMergeCandidates, fillMvpCand, xGetColMVP), the SSE
// rerank of every merge candidate against the planned motion signalled as
// AMVP (priced in float64 with the host's operation order), the CU's and
// PUs' field writes, then dsp_core's inter_commit_cu for the residual.
// The candidate SSE and the residual are dsp_core's own functions, called
// through pointers on the InterCtx the host built.  A planned intra CU is
// committed by the host (CtuSearch._commit_cu / _commit_nxn) through a
// callback, in its z-order place.
//
// A CTU the walk cannot take (an uncovered area, a reference index out of
// range, a CU without a compensable candidate, a lookup the host would
// raise on, a host commit that failed) is handed back untouched: the CTU's
// part arrays and planes are restored from a snapshot taken before the
// walk.
//
// iw_wave_ctu is the walk of one CTU as native/intra_wave.cpp's wavefront
// calls it, on several threads at once.  What makes that safe: a CTU reads
// only its left, above-left, above and above-right neighbours (motion
// fields, `coded` flags, reconstructed samples, each through available(),
// which checks `coded`), the colocated picture and the reference planes,
// all complete before it starts; cand_sse's temporary motion goes into the
// PU-origin part of the CTU's own CU; the snapshot and dsp_core's scratch
// (ic_cand_sse, inter_commit_cu, the RDOQ and bit-count helpers, whose
// counts start from the fixed slice-init contexts) are thread_local; the
// context's fields are only read, and of ctu_cus and ctu_host_cus a CTU
// writes its own entries.  The host's commit of a planned intra CU runs
// Python on shared state (the search's scratch, the tracer's stack), so
// host_cu calls are serialised; the other threads go on walking meanwhile.
//
// Build: g++ -O3 -march=native -ffp-contract=off -pthread -shared -fPIC
// (the flags of dsp_core.cpp, so float64 rounds the same way).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

const int kModeInter = 0;
const int kMaxRefs = 16;
const int32_t kNoPoc = -1000000000;   // -(10 ** 9): no reference

typedef double (*cand_sse_fn)(const void *, int, int, int, int, int, int);
typedef int (*commit_cu_fn)(const void *, int, int, int, int, int, int);
typedef int (*host_cu_fn)(int, int, int);

}  // namespace

extern "C" {

struct WalkCtx {
  // geometry
  int32_t pic_w, pic_h;        // coded luma size
  int32_t parts_w, parts_h;    // padded part grid
  int32_t log2_ctb, w_ctbs;
  int32_t min_cb_log2;
  int32_t plan_w, plan_h;      // plan grid (pic_w / 4, pic_h / 4)
  // slice
  int32_t is_b;
  int32_t max_merge;           // max_num_merge_cand
  int32_t plevel;              // log2_parallel_merge_level
  int32_t tmvp;                // temporal MVP on and a colocated picture
  int32_t ldc;                 // no reference after the current picture
  int32_t col_from_l0;
  int32_t cur_poc;
  int32_t num_ref_idx[2];      // the slice's active counts
  int32_t n_list[2];           // the reference lists' lengths
  int32_t ref_poc[2][kMaxRefs];
  int32_t ref_lt[2][kMaxRefs];
  // colocated picture (part grid col_ph x col_pw)
  int32_t col_poc, col_pw, col_ph;
  const int8_t *col_pred_mode;
  const int8_t *col_ref_idx;   // (2, col_ph, col_pw)
  const int32_t *col_ref_poc;  // (2, col_ph, col_pw)
  const int32_t *col_mv;       // (2, col_ph, col_pw, 2)
  // availability
  const int32_t *slice_id;     // part grid
  const int32_t *tile_of_ctu;  // (h_ctbs, w_ctbs)
  const int64_t *ctu_rs_to_ts;
  // the picture's part arrays (row stride parts_w)
  uint8_t *coded;
  int8_t *depth, *part_size, *pred_mode, *tr_idx, *merge_flag, *skip;
  int8_t *inter_dir;
  int16_t *qp, *intra_luma;
  uint8_t *cbf[3];
  // written by the host's intra commit only (kept in the snapshot)
  int16_t *intra_chroma;
  int8_t *ipcm;
  int8_t *tskip[3];
  int8_t *ref_idx;             // (2, ph, pw)
  int8_t *mvp_idx;             // (2, ph, pw)
  int32_t *mv, *mvd;           // (2, ph, pw, 2)
  int32_t *ref_poc_arr;        // (2, ph, pw)
  // planes (CTU-padded; chroma 4:2:0)
  int32_t num_comps;
  int32_t *rec_p[3];
  int32_t *coeff_p[3];
  int64_t plane_stride[3];
  // the plan (row stride plan_w)
  const uint8_t *p_cov, *p_pred_inter, *p_skip_hint;
  const int8_t *p_depth, *p_part, *p_dir;
  const int32_t *p_mv;         // (2, plan_h, plan_w, 2)
  const int8_t *p_ref;         // (2, plan_h, plan_w)
  const int32_t *p_pu;         // (2, 4, plan_h, plan_w): dir, mvy, mvx, ref
  // dsp_core: its InterCtx, ic_cand_sse and inter_commit_cu
  const void *ictx;
  const void *cand_sse;
  const void *commit_cu;
  // the host's commit of a planned intra CU (px, py, log2): 0, or -1
  const void *host_cu;
  // the rerank's lambda and the CUs' QP for iw_wave_ctu
  double lam;
  int32_t cu_qp;
  // per CTU in raster order, written by its walk when it is not handed
  // back (null: not kept): the inter CUs it committed, and the planned
  // intra CUs host_cu committed in it
  int32_t *ctu_cus;
  int32_t *ctu_host_cus;
};

}  // extern "C"

namespace {

struct Cand {
  int dir;
  int r[2];
  int mv[2][2];
};

struct Walk {
  const WalkCtx *C;
  double lam;
  int qp;
  int cus;        // inter CUs committed
  int host_cus;   // planned intra CUs host_cu committed
};

std::mutex host_mu;   // one host_cu call at a time

inline int64_t part_at(const WalkCtx *C, int px, int py) {
  return (int64_t)py * C->parts_w + px;
}

inline int64_t list_plane(const WalkCtx *C) {
  return (int64_t)C->parts_h * C->parts_w;
}

inline int64_t clip64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

inline int64_t iabs(int64_t v) { return v < 0 ? -v : v; }

// ---- availability (PictureState.part_available, no constrained intra) ----

int part_z(const WalkCtx *C, int px, int py) {
  int parts = 1 << (C->log2_ctb - 2);
  int cx = px / parts, cy = py / parts;
  int64_t ts = C->ctu_rs_to_ts[cy * C->w_ctbs + cx];
  int x = px % parts, y = py % parts, z = 0;
  for (int i = 0; (1 << i) < parts; i++)
    z |= ((x >> i) & 1) << (2 * i) | ((y >> i) & 1) << (2 * i + 1);
  return (int)(ts * parts * parts + z);
}

int tile_of(const WalkCtx *C, int px, int py) {
  int parts = 1 << (C->log2_ctb - 2);
  return C->tile_of_ctu[(py / parts) * C->w_ctbs + px / parts];
}

bool available(const WalkCtx *C, int px, int py, int cur_px, int cur_py,
               int bw, int bh) {
  if (px < 0 || py < 0 || px >= C->parts_w || py >= C->parts_h) return false;
  if (px * 4 >= C->pic_w || py * 4 >= C->pic_h) return false;
  if (!C->coded[part_at(C, px, py)]) return false;
  if (C->slice_id[part_at(C, px, py)] !=
      C->slice_id[part_at(C, cur_px, cur_py)])
    return false;
  if (tile_of(C, px, py) != tile_of(C, cur_px, cur_py)) return false;
  int ax = px > cur_px ? px : cur_px;
  if (ax > cur_px + bw - 1) ax = cur_px + bw - 1;
  int ay = py > cur_py ? py : cur_py;
  if (ay > cur_py + bh - 1) ay = cur_py + bh - 1;
  return part_z(C, px, py) < part_z(C, ax, ay);
}

// an available inter neighbour part, or false
bool fetch(const WalkCtx *C, int px, int py, int cur_px, int cur_py, int bw,
           int bh) {
  return available(C, px, py, cur_px, cur_py, bw, bh) &&
         C->pred_mode[part_at(C, px, py)] == kModeInter;
}

void motion_of(const WalkCtx *C, int px, int py, Cand *c) {
  int64_t p = part_at(C, px, py), L = list_plane(C);
  c->dir = C->inter_dir[p];
  for (int lx = 0; lx < 2; lx++) {
    c->r[lx] = C->ref_idx[lx * L + p];
    c->mv[lx][0] = C->mv[(lx * L + p) * 2];
    c->mv[lx][1] = C->mv[(lx * L + p) * 2 + 1];
  }
}

bool same(const Cand &a, const Cand &b) {
  return a.dir == b.dir && a.r[0] == b.r[0] && a.r[1] == b.r[1] &&
         a.mv[0][0] == b.mv[0][0] && a.mv[0][1] == b.mv[0][1] &&
         a.mv[1][0] == b.mv[1][0] && a.mv[1][1] == b.mv[1][1];
}

// a reference index the host could look up (ref_lists[lx][ri])
bool ref_ok(const WalkCtx *C, int lx, int ri) {
  return ri >= 0 && ri < C->n_list[lx];
}

// ---- scaling (dist_scale_factor, scale_mv) ----

// 0 = ok; -1 = the host would divide by zero
int dist_scale(int64_t cur_poc, int64_t cur_ref_poc, int64_t col_poc,
               int64_t col_ref_poc, int *out) {
  int64_t db = cur_poc - cur_ref_poc;
  int64_t dd = col_poc - col_ref_poc;
  if (dd == db) {
    *out = 4096;
    return 0;
  }
  int64_t tdb = clip64(db, -128, 127);
  int64_t tdd = clip64(dd, -128, 127);
  if (tdd == 0) return -1;
  // C division truncates toward zero, as mvpred._trunc_div
  int64_t x = (0x4000 + iabs(tdd / 2)) / tdd;
  *out = (int)clip64((tdb * x + 32) >> 6, -4096, 4095);
  return 0;
}

int scale_comp(int64_t scale, int64_t v) {
  int64_t p = scale * v;
  return (int)clip64((p + 127 + (p < 0 ? 1 : 0)) >> 8, -32768, 32767);
}

void scale_mv(int scale, const int in[2], int out[2]) {
  out[0] = scale_comp(scale, in[0]);
  out[1] = scale_comp(scale, in[1]);
}

// ---- TMVP (MvPredictor._tmvp, _col_mv) ----

// 1 = found (mv), 0 = none, -1 = the host would raise
int col_mv(const WalkCtx *C, int sx, int sy, int lx, int ref_idx, int mv[2]) {
  int px = ((sx >> 4) << 4) >> 2;
  int py = ((sy >> 4) << 4) >> 2;
  if (px >= C->col_pw || py >= C->col_ph) return 0;
  int64_t p = (int64_t)py * C->col_pw + px;
  int64_t L = (int64_t)C->col_ph * C->col_pw;
  if (C->col_pred_mode[p] != kModeInter) return 0;
  int col_list = C->ldc ? lx : C->col_from_l0;
  int col_ref = C->col_ref_idx[col_list * L + p];
  if (col_ref < 0) {
    col_list = 1 - col_list;
    col_ref = C->col_ref_idx[col_list * L + p];
    if (col_ref < 0) return 0;
  }
  int64_t col_ref_poc = C->col_ref_poc[col_list * L + p];
  int cmv[2] = {C->col_mv[(col_list * L + p) * 2],
                C->col_mv[(col_list * L + p) * 2 + 1]};
  if (!ref_ok(C, lx, ref_idx)) return -1;
  if (C->ref_lt[lx][ref_idx]) return 0;   // the colocated ref: short-term
  int scale;
  if (dist_scale(C->cur_poc, C->ref_poc[lx][ref_idx], C->col_poc,
                 col_ref_poc, &scale) < 0)
    return -1;
  if (scale == 4096) {
    mv[0] = cmv[0];
    mv[1] = cmv[1];
  } else {
    scale_mv(scale, cmv, mv);
  }
  return 1;
}

int tmvp(const WalkCtx *C, int x, int y, int w, int h, int lx, int ref_idx,
         int mv[2]) {
  int hx = x + w, hy = y + h;
  int got = 0;
  if (hx < C->pic_w && hy < C->pic_h &&
      (hy >> C->log2_ctb) == ((y + h - 1) >> C->log2_ctb)) {
    got = col_mv(C, hx, hy, lx, ref_idx, mv);
    if (got < 0) return -1;
  }
  if (!got) got = col_mv(C, x + w / 2, y + h / 2, lx, ref_idx, mv);
  return got;
}

// ---- merge list (MvPredictor.merge_candidates) ----

// candidates into out[] (at most max_merge), or -1 where the host raises
int merge_list(const WalkCtx *C, int x, int y, int w, int h, int pu_idx,
               int part_size, Cand *out) {
  const int max_cand = C->max_merge;
  const int pl = C->plevel;
  int n = 0;
  int cx = x >> 2, cy = y >> 2;
  int bw = w >> 2 > 1 ? w >> 2 : 1, bh = h >> 2 > 1 ? h >> 2 : 1;
  auto diff_mer = [&](int xn, int yn) {
    return (xn >> pl) != (x >> pl) || (yn >> pl) != (y >> pl);
  };
  auto get = [&](int px, int py, Cand *c) {
    if (!fetch(C, px, py, cx, cy, bw, bh)) return false;
    motion_of(C, px, py, c);
    return true;
  };
  if (max_cand <= 0) return 0;
  Cand a1, b1, b0, a0, b2;
  bool has_a1 = false, has_b1 = false;
  // A1 left (x-1, y+h-1)
  if (!(pu_idx == 1 && (part_size == 2 || part_size == 6 ||
                        part_size == 7)) &&
      diff_mer(x - 1, y + h - 1))
    has_a1 = get((x - 1) >> 2, (y + h - 4) >> 2, &a1);
  if (has_a1) out[n++] = a1;
  if (n == max_cand) return n;
  // B1 above (x+w-1, y-1)
  if (!(pu_idx == 1 && (part_size == 1 || part_size == 4 ||
                        part_size == 5)) &&
      diff_mer(x + w - 1, y - 1))
    has_b1 = get((x + w - 4) >> 2, (y - 4) >> 2, &b1);
  if (has_b1 && !(has_a1 && same(a1, b1))) out[n++] = b1;
  if (n == max_cand) return n;
  // B0 above-right (x+w, y-1)
  if (diff_mer(x + w, y - 1) && get((x + w) >> 2, (y - 4) >> 2, &b0) &&
      !(has_b1 && same(b1, b0)))
    out[n++] = b0;
  if (n == max_cand) return n;
  // A0 below-left (x-1, y+h)
  if (diff_mer(x - 1, y + h) && get((x - 4) >> 2, (y + h) >> 2, &a0) &&
      !(has_a1 && same(a1, a0)))
    out[n++] = a0;
  if (n == max_cand) return n;
  // B2 above-left (x-1, y-1), only while fewer than 4
  if (n < 4 && diff_mer(x - 1, y - 1) &&
      get((x - 4) >> 2, (y - 4) >> 2, &b2) && !(has_a1 && same(a1, b2)) &&
      !(has_b1 && same(b1, b2)))
    out[n++] = b2;
  if (n == max_cand) return n;
  // temporal
  if (C->tmvp) {
    Cand t;
    t.dir = 0;
    for (int lx = 0; lx < 2; lx++) {
      t.r[lx] = -1;
      t.mv[lx][0] = t.mv[lx][1] = 0;
    }
    for (int lx = 0; lx < (C->is_b ? 2 : 1); lx++) {
      int mv[2];
      int got = tmvp(C, x, y, w, h, lx, 0, mv);
      if (got < 0) return -1;
      if (got) {
        t.dir |= 1 << lx;
        t.r[lx] = 0;
        t.mv[lx][0] = mv[0];
        t.mv[lx][1] = mv[1];
      }
    }
    if (t.dir) out[n++] = t;
  }
  if (n == max_cand) return n;
  // combined bi-predictive candidates
  if (C->is_b) {
    static const int pr0[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
    static const int pr1[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
    int cutoff = n;
    for (int idx = 0; idx < cutoff * (cutoff - 1); idx++) {
      if (n == max_cand) break;
      if (idx >= 12) return -1;
      const Cand &ci = out[pr0[idx]], &cj = out[pr1[idx]];
      if ((ci.dir & 1) && (cj.dir & 2)) {
        if (!ref_ok(C, 0, ci.r[0]) || !ref_ok(C, 1, cj.r[1])) return -1;
        if (C->ref_poc[0][ci.r[0]] == C->ref_poc[1][cj.r[1]] &&
            ci.mv[0][0] == cj.mv[1][0] && ci.mv[0][1] == cj.mv[1][1])
          continue;
        Cand c;
        c.dir = 3;
        c.r[0] = ci.r[0];
        c.mv[0][0] = ci.mv[0][0];
        c.mv[0][1] = ci.mv[0][1];
        c.r[1] = cj.r[1];
        c.mv[1][0] = cj.mv[1][0];
        c.mv[1][1] = cj.mv[1][1];
        out[n++] = c;
      }
    }
  }
  // zero candidates
  int n_ref = C->is_b ? (C->num_ref_idx[0] < C->num_ref_idx[1]
                             ? C->num_ref_idx[0] : C->num_ref_idx[1])
                      : C->num_ref_idx[0];
  int r = 0, refcnt = 0;
  while (n < max_cand) {
    Cand c;
    c.dir = C->is_b ? 3 : 1;
    c.r[0] = r;
    c.r[1] = C->is_b ? r : -1;
    c.mv[0][0] = c.mv[0][1] = c.mv[1][0] = c.mv[1][1] = 0;
    out[n++] = c;
    if (refcnt == n_ref - 1) {
      r = 0;
    } else {
      r++;
      refcnt++;
    }
  }
  return n;
}

// ---- AMVP (MvPredictor.amvp_candidates) ----

// 1 = found, 0 = none, -1 = the host would raise
int try_cand(const WalkCtx *C, bool avail, int px, int py, int lx,
             int ref_idx, int mv[2]) {
  if (!avail) return 0;
  Cand m;
  motion_of(C, px, py, &m);
  int cur_ref_poc = C->ref_poc[lx][ref_idx];
  int ri = m.r[lx];
  if (ri >= 0) {
    if (ri >= C->n_list[lx]) return -1;
    if (C->ref_poc[lx][ri] == cur_ref_poc) {
      mv[0] = m.mv[lx][0];
      mv[1] = m.mv[lx][1];
      return 1;
    }
  }
  int ri2 = m.r[1 - lx];
  if (ri2 >= 0 && C->n_list[1 - lx] > ri2 &&
      C->ref_poc[1 - lx][ri2] == cur_ref_poc) {
    mv[0] = m.mv[1 - lx][0];
    mv[1] = m.mv[1 - lx][1];
    return 1;
  }
  return 0;
}

int try_scaled(const WalkCtx *C, bool avail, int px, int py, int lx,
               int ref_idx, int mv[2]) {
  if (!avail) return 0;
  Cand m;
  motion_of(C, px, py, &m);
  int cur_ref_poc = C->ref_poc[lx][ref_idx];
  int cur_lt = C->ref_lt[lx][ref_idx];
  for (int k = 0; k < 2; k++) {
    int ll = k ? 1 - lx : lx;
    int ri = m.r[ll];
    if (ri < 0 || ri >= C->n_list[ll]) continue;
    int neib_lt = C->ref_lt[ll][ri];
    if (cur_lt != neib_lt) continue;
    if (cur_lt) {
      mv[0] = m.mv[ll][0];
      mv[1] = m.mv[ll][1];
      return 1;
    }
    int scale;
    if (dist_scale(C->cur_poc, cur_ref_poc, C->cur_poc, C->ref_poc[ll][ri],
                   &scale) < 0)
      return -1;
    if (scale == 4096) {
      mv[0] = m.mv[ll][0];
      mv[1] = m.mv[ll][1];
    } else {
      scale_mv(scale, m.mv[ll], mv);
    }
    return 1;
  }
  return 0;
}

// the two predictors into out[2][2]; 0, or -1 where the host raises
int amvp_list(const WalkCtx *C, int x, int y, int w, int h, int lx,
              int ref_idx, int out[2][2]) {
  if (!ref_ok(C, lx, ref_idx)) return -1;
  int cx = x >> 2, cy = y >> 2;
  int bw = w >> 2 > 1 ? w >> 2 : 1, bh = h >> 2 > 1 ? h >> 2 : 1;
  const int lb[2] = {(x - 4) >> 2, (y + h) >> 2};
  const int left[2] = {(x - 4) >> 2, (y + h - 4) >> 2};
  const int rt[2] = {(x + w) >> 2, (y - 4) >> 2};
  const int ab[2] = {(x + w - 4) >> 2, (y - 4) >> 2};
  const int al[2] = {(x - 4) >> 2, (y - 4) >> 2};
  bool a0 = fetch(C, lb[0], lb[1], cx, cy, bw, bh);
  bool a1 = fetch(C, left[0], left[1], cx, cy, bw, bh);
  bool smvp = a0 || a1;
  int cands[3][2];
  int n = 0;
  int mv[2];
  int got = try_cand(C, a0, lb[0], lb[1], lx, ref_idx, mv);
  if (!got) got = try_cand(C, a1, left[0], left[1], lx, ref_idx, mv);
  if (!got) {
    got = try_scaled(C, a0, lb[0], lb[1], lx, ref_idx, mv);
    if (!got) got = try_scaled(C, a1, left[0], left[1], lx, ref_idx, mv);
  }
  if (got < 0) return -1;
  if (got) {
    cands[n][0] = mv[0];
    cands[n++][1] = mv[1];
  }
  bool b0 = fetch(C, rt[0], rt[1], cx, cy, bw, bh);
  bool b1 = fetch(C, ab[0], ab[1], cx, cy, bw, bh);
  bool b2 = fetch(C, al[0], al[1], cx, cy, bw, bh);
  got = try_cand(C, b0, rt[0], rt[1], lx, ref_idx, mv);
  if (!got) got = try_cand(C, b1, ab[0], ab[1], lx, ref_idx, mv);
  if (!got) got = try_cand(C, b2, al[0], al[1], lx, ref_idx, mv);
  if (got < 0) return -1;
  if (got) {
    cands[n][0] = mv[0];
    cands[n++][1] = mv[1];
  }
  if (!smvp) {
    got = try_scaled(C, b0, rt[0], rt[1], lx, ref_idx, mv);
    if (!got) got = try_scaled(C, b1, ab[0], ab[1], lx, ref_idx, mv);
    if (!got) got = try_scaled(C, b2, al[0], al[1], lx, ref_idx, mv);
    if (got < 0) return -1;
    if (got) {
      cands[n][0] = mv[0];
      cands[n++][1] = mv[1];
    }
  }
  if (n == 2 && cands[0][0] == cands[1][0] && cands[0][1] == cands[1][1])
    n = 1;
  if (C->tmvp) {
    got = tmvp(C, x, y, w, h, lx, ref_idx, mv);
    if (got < 0) return -1;
    if (got && n < 2) {
      cands[n][0] = mv[0];
      cands[n++][1] = mv[1];
    }
  }
  while (n < 2) {
    cands[n][0] = 0;
    cands[n++][1] = 0;
  }
  for (int k = 0; k < 2; k++) {
    out[k][0] = cands[k][0];
    out[k][1] = cands[k][1];
  }
  return 0;
}

// ---- pricing ----

// exact bins of one MVD component (CtuSearch._mvd_comp_bits)
int mvd_comp_bits(int64_t d) {
  if (d == 0) return 1;
  int64_t a = iabs(d);
  int bits = 3;
  if (a >= 2) {
    int64_t sym = a - 2;
    int count = 1;
    while (sym >= ((int64_t)1 << count)) {
      sym -= (int64_t)1 << count;
      count++;
      bits++;
    }
    bits += 1 + count;
  }
  return bits;
}

int mvd_bits(int dx, int dy) {
  return mvd_comp_bits(dx) + mvd_comp_bits(dy);
}

// the predictor of the fewest MVD bins (ties: the first) and its bins
int best_mvp(const int mv[2], const int amvp[2][2], int *bits) {
  int b0 = mvd_bits(mv[0] - amvp[0][0], mv[1] - amvp[0][1]);
  int b1 = mvd_bits(mv[0] - amvp[1][0], mv[1] - amvp[1][1]);
  *bits = b1 < b0 ? b1 : b0;
  return b1 < b0 ? 1 : 0;
}

// weighted SSE of a candidate's prediction over a PU (CtuSearch._cand_sse):
// its motion goes into the PU-origin part for ic_cand_sse, then back.
// Negative: not compensable.
double cand_sse(const WalkCtx *C, int x, int y, int w, int h,
                const Cand &c) {
  int64_t p = part_at(C, x >> 2, y >> 2), L = list_plane(C);
  int8_t sdir = C->inter_dir[p];
  int8_t sr[2] = {C->ref_idx[p], C->ref_idx[L + p]};
  int32_t smv[2][2] = {{C->mv[p * 2], C->mv[p * 2 + 1]},
                       {C->mv[(L + p) * 2], C->mv[(L + p) * 2 + 1]}};
  C->inter_dir[p] = (int8_t)c.dir;
  for (int lx = 0; lx < 2; lx++) {
    if ((c.dir >> lx) & 1) {
      C->ref_idx[lx * L + p] = (int8_t)c.r[lx];
      C->mv[(lx * L + p) * 2] = c.mv[lx][0];
      C->mv[(lx * L + p) * 2 + 1] = c.mv[lx][1];
    } else {
      C->ref_idx[lx * L + p] = -1;
    }
  }
  double v = ((cand_sse_fn)C->cand_sse)(C->ictx, x, y, w, h, x >> 2, y >> 2);
  C->inter_dir[p] = sdir;
  for (int lx = 0; lx < 2; lx++) {
    C->ref_idx[lx * L + p] = sr[lx];
    C->mv[(lx * L + p) * 2] = smv[lx][0];
    C->mv[(lx * L + p) * 2 + 1] = smv[lx][1];
  }
  return v;
}

double merge_bits(int i, int nmerge) {
  return 1.0 + (double)(i < nmerge - 1 ? i + 1
                                       : (nmerge - 1 > 1 ? nmerge - 1 : 1));
}

// ---- field writes ----

template <typename T>
void fill(T *arr, const WalkCtx *C, int px, int py, int w, int h, T v) {
  for (int y = 0; y < h; y++) {
    T *row = arr + part_at(C, px, py + y);
    for (int x = 0; x < w; x++) row[x] = v;
  }
}

void fill_mv(int32_t *arr, const WalkCtx *C, int px, int py, int w, int h,
             int vx, int vy) {
  for (int y = 0; y < h; y++) {
    int32_t *row = arr + part_at(C, px, py + y) * 2;
    for (int x = 0; x < w; x++) {
      row[2 * x] = vx;
      row[2 * x + 1] = vy;
    }
  }
}

// ref_idx -1, mv 0, mvd 0, ref_poc "none" in both lists
void reset_motion(const WalkCtx *C, int px, int py, int w, int h) {
  int64_t L = list_plane(C);
  for (int lx = 0; lx < 2; lx++) {
    fill<int8_t>(C->ref_idx + lx * L, C, px, py, w, h, -1);
    fill_mv(C->mv + lx * L * 2, C, px, py, w, h, 0, 0);
    fill_mv(C->mvd + lx * L * 2, C, px, py, w, h, 0, 0);
    fill<int32_t>(C->ref_poc_arr + lx * L, C, px, py, w, h, kNoPoc);
  }
}

// the CU's fields before its lists are derived (_commit_planned_inter's
// first writes)
void cu_fields(const Walk &W, int px, int py, int log2, int psize) {
  const WalkCtx *C = W.C;
  int n = 1 << (log2 - 2);
  fill<int8_t>(C->depth, C, px, py, n, n, (int8_t)(C->log2_ctb - log2));
  fill<int8_t>(C->part_size, C, px, py, n, n, (int8_t)psize);
  fill<int8_t>(C->pred_mode, C, px, py, n, n, kModeInter);
  fill<int16_t>(C->qp, C, px, py, n, n, (int16_t)W.qp);
  fill<uint8_t>(C->coded, C, px, py, n, n, 1);
  fill<int8_t>(C->tr_idx, C, px, py, n, n, 0);
  fill<int8_t>(C->merge_flag, C, px, py, n, n, 0);
  fill<int16_t>(C->intra_luma, C, px, py, n, n, 0);
  reset_motion(C, px, py, n, n);
}

// one list's motion over a rect: ref_idx, mv, ref_poc
void set_list(const WalkCtx *C, int px, int py, int w, int h, int lx, int r,
              const int mv[2]) {
  int64_t L = list_plane(C);
  fill<int8_t>(C->ref_idx + lx * L, C, px, py, w, h, (int8_t)r);
  fill_mv(C->mv + lx * L * 2, C, px, py, w, h, mv[0], mv[1]);
  fill<int32_t>(C->ref_poc_arr + lx * L, C, px, py, w, h, C->ref_poc[lx][r]);
}

void set_amvp(const WalkCtx *C, int px, int py, int w, int h, int lx, int r,
              const int mv[2], const int amvp[2][2], int k) {
  int64_t L = list_plane(C);
  set_list(C, px, py, w, h, lx, r, mv);
  fill_mv(C->mvd + lx * L * 2, C, px, py, w, h, mv[0] - amvp[k][0],
          mv[1] - amvp[k][1]);
  fill<int8_t>(C->mvp_idx + lx * L, C, px, py, w, h, (int8_t)k);
}

// ---- planned CUs ----

inline int64_t plan_at(const WalkCtx *C, int px, int py) {
  return (int64_t)py * C->plan_w + px;
}

int plan_pu(const WalkCtx *C, int pu, int f, int px, int py) {
  return C->p_pu[((int64_t)(pu * 4 + f) * C->plan_h + py) * C->plan_w + px];
}

int plan_ref(const WalkCtx *C, int lx, int px, int py) {
  return C->p_ref[(int64_t)lx * C->plan_h * C->plan_w + plan_at(C, px, py)];
}

int active_refs(const WalkCtx *C, int lx) {
  return C->num_ref_idx[lx] < C->n_list[lx] ? C->num_ref_idx[lx]
                                             : C->n_list[lx];
}

int commit_residual(const Walk &W, int px, int py, int log2, int skip_hint,
                    int is_merge, int psize) {
  const WalkCtx *C = W.C;
  return ((commit_cu_fn)C->commit_cu)(C->ictx, px, py, log2, skip_hint,
                                      is_merge, psize);
}

// 2Nx2N (_commit_planned_inter)
int commit_square(Walk &W, int px, int py, int log2) {
  const WalkCtx *C = W.C;
  int size = 1 << log2, n = size >> 2;
  int x0 = px * 4, y0 = py * 4;
  int64_t pi = plan_at(C, px, py);
  int dirv = C->p_dir[pi];
  int skip_hint = C->p_skip_hint[pi] ? 1 : 0;
  Cand plan;
  plan.dir = dirv;
  for (int lx = 0; lx < 2; lx++) {
    int64_t m = ((int64_t)lx * C->plan_h * C->plan_w + pi) * 2;
    plan.mv[lx][0] = C->p_mv[m];
    plan.mv[lx][1] = C->p_mv[m + 1];
    plan.r[lx] = -1;
    if (!((dirv >> lx) & 1)) continue;
    plan.r[lx] = plan_ref(C, lx, px, py);
    if (plan.r[lx] < 0 || plan.r[lx] >= active_refs(C, lx)) return -1;
  }
  cu_fields(W, px, py, log2, 0);

  Cand cands[8];
  int nc = merge_list(C, x0, y0, size, size, 0, 0, cands);
  if (nc < 0) return -1;
  if (nc > C->max_merge) nc = C->max_merge;
  int nmerge = nc > 1 ? nc : 1;
  bool have = false;
  double best = 0.0;
  int sel = -1;                  // merge index, or -1: the planned AMVP
  int match = -1;
  for (int i = 0; i < nc; i++) {
    const Cand &c = cands[i];
    if (match < 0 && c.dir == dirv) {
      bool ok = true;
      for (int lx = 0; lx < 2 && ok; lx++)
        if ((dirv >> lx) & 1)
          ok = c.r[lx] == plan.r[lx] && c.mv[lx][0] == plan.mv[lx][0] &&
               c.mv[lx][1] == plan.mv[lx][1];
      if (ok) match = i;
    }
  }
  for (int i = 0; i < nc; i++) {
    double sse = cand_sse(C, x0, y0, size, size, cands[i]);
    if (sse < 0) continue;
    double cost = sse + W.lam * merge_bits(i, nmerge);
    if (!have || cost < best) {
      have = true;
      best = cost;
      sel = i;
    }
  }
  int amvp[2][2][2];
  if (match < 0) {
    double sse = cand_sse(C, x0, y0, size, size, plan);
    if (sse >= 0) {
      double bits = 3.0;
      for (int lx = 0; lx < 2; lx++) {
        if (!((dirv >> lx) & 1)) continue;
        if (amvp_list(C, x0, y0, size, size, lx, plan.r[lx], amvp[lx]) < 0)
          return -1;
        int b;
        best_mvp(plan.mv[lx], amvp[lx], &b);
        bits += (double)(1 + b);
        int n_refs = active_refs(C, lx);
        if (n_refs > 1)
          bits += (double)(plan.r[lx] + 1 < n_refs - 1 ? plan.r[lx] + 1
                                                       : n_refs - 1);
      }
      double cost = sse + W.lam * bits;
      if (!have || cost < best) {
        have = true;
        best = cost;
        sel = -1;
      }
    }
  }
  if (!have) return -1;

  if (sel >= 0) {               // commit_choice(m_idx)
    const Cand &c = cands[sel];
    fill<int8_t>(C->merge_flag, C, px, py, n, n, 1);
    fill<int8_t>(C->mvp_idx, C, px, py, n, n, (int8_t)sel);
    fill<int8_t>(C->inter_dir, C, px, py, n, n, (int8_t)c.dir);
    reset_motion(C, px, py, n, n);
    for (int lx = 0; lx < 2; lx++) {
      if (!((c.dir >> lx) & 1)) continue;
      if (!ref_ok(C, lx, c.r[lx])) return -1;
      set_list(C, px, py, n, n, lx, c.r[lx], c.mv[lx]);
    }
    return commit_residual(W, px, py, log2, skip_hint, 1, 0);
  }
  fill<int8_t>(C->merge_flag, C, px, py, n, n, 0);   // commit_choice(None)
  fill<int8_t>(C->inter_dir, C, px, py, n, n, (int8_t)dirv);
  for (int lx = 0; lx < 2; lx++) {
    if (!((dirv >> lx) & 1)) continue;
    int b;
    int k = best_mvp(plan.mv[lx], amvp[lx], &b);
    set_amvp(C, px, py, n, n, lx, plan.r[lx], plan.mv[lx], amvp[lx], k);
  }
  return commit_residual(W, px, py, log2, skip_hint, 0, 0);
}

// 2NxN / Nx2N (_commit_planned_rect, _map_pu_motion, _commit_pu_fields)
int commit_rect(Walk &W, int px, int py, int log2, int part) {
  const WalkCtx *C = W.C;
  int size = 1 << log2;
  int x0 = px * 4, y0 = py * 4;
  int psize = part == 1 ? 1 : 2;
  int plx[2], pr[2], pmv[2][2];
  for (int pu = 0; pu < 2; pu++) {
    plx[pu] = plan_pu(C, pu, 0, px, py) - 1;
    pr[pu] = plan_pu(C, pu, 3, px, py);
    pmv[pu][0] = plan_pu(C, pu, 2, px, py);
    pmv[pu][1] = plan_pu(C, pu, 1, px, py);
    if (plx[pu] < 0 || plx[pu] > 1 || pr[pu] < 0 ||
        pr[pu] >= active_refs(C, plx[pu]))
      return -1;
  }
  cu_fields(W, px, py, log2, psize);
  for (int pu = 0; pu < 2; pu++) {
    int x = x0, y = y0, w = size, h = size;
    if (psize == 1) {
      h = size / 2;
      y += pu * h;
    } else {
      w = size / 2;
      x += pu * w;
    }
    int lx = plx[pu], r = pr[pu];
    const int *mvq = pmv[pu];
    Cand cands[8];
    int nc = merge_list(C, x, y, w, h, pu, psize, cands);
    if (nc < 0) return -1;
    if (nc > C->max_merge) nc = C->max_merge;
    int nmerge = nc > 1 ? nc : 1;
    bool have = false, matched = false;
    double best = 0.0;
    int sel = -1;
    for (int i = 0; i < nc; i++) {
      const Cand &c = cands[i];
      double sse = cand_sse(C, x, y, w, h, c);
      if (sse < 0) continue;
      if (c.dir == (1 << lx) && c.r[lx] == r && c.mv[lx][0] == mvq[0] &&
          c.mv[lx][1] == mvq[1])
        matched = true;
      double cost = sse + W.lam * merge_bits(i, nmerge);
      if (!have || cost < best) {
        have = true;
        best = cost;
        sel = i;
      }
    }
    int amvp[2][2], k = 0;
    if (!matched) {
      Cand uni;
      uni.dir = 1 << lx;
      uni.r[0] = uni.r[1] = 0;
      uni.mv[0][0] = uni.mv[0][1] = uni.mv[1][0] = uni.mv[1][1] = 0;
      uni.r[lx] = r;
      uni.mv[lx][0] = mvq[0];
      uni.mv[lx][1] = mvq[1];
      double sse = cand_sse(C, x, y, w, h, uni);
      if (sse >= 0) {
        if (amvp_list(C, x, y, w, h, lx, r, amvp) < 0) return -1;
        int b;
        k = best_mvp(mvq, amvp, &b);
        double bits = (double)b + 4.0;
        int n_refs = active_refs(C, lx);
        if (n_refs > 1) bits += (double)(r + 1 < n_refs - 1 ? r + 1
                                                             : n_refs - 1);
        double cost = sse + W.lam * bits;
        if (!have || cost < best) {
          have = true;
          best = cost;
          sel = -1;
        }
      }
    }
    if (!have) return -1;
    int ppx = x >> 2, ppy = y >> 2;
    int pw = w >> 2 > 1 ? w >> 2 : 1, ph = h >> 2 > 1 ? h >> 2 : 1;
    fill<int8_t>(C->pred_mode, C, ppx, ppy, pw, ph, kModeInter);
    fill<uint8_t>(C->coded, C, ppx, ppy, pw, ph, 1);
    reset_motion(C, ppx, ppy, pw, ph);
    int dir;
    if (sel >= 0) {
      const Cand &c = cands[sel];
      fill<int8_t>(C->merge_flag, C, ppx, ppy, pw, ph, 1);
      fill<int8_t>(C->mvp_idx, C, ppx, ppy, pw, ph, (int8_t)sel);
      for (int l = 0; l < 2; l++) {
        if (!((c.dir >> l) & 1)) continue;
        if (!ref_ok(C, l, c.r[l])) return -1;
        set_list(C, ppx, ppy, pw, ph, l, c.r[l], c.mv[l]);
      }
      dir = c.dir;
    } else {
      fill<int8_t>(C->merge_flag, C, ppx, ppy, pw, ph, 0);
      set_amvp(C, ppx, ppy, pw, ph, lx, r, mvq, amvp, k);
      dir = 1 << lx;
    }
    fill<int8_t>(C->inter_dir, C, ppx, ppy, pw, ph, (int8_t)dir);
  }
  return commit_residual(W, px, py, log2, 0, 0, psize);
}

// ---- the CTU (_commit_plan_tree) ----

// 0 = done, -1 = hand the CTU back
int walk(Walk &W, int px, int py, int log2) {
  const WalkCtx *C = W.C;
  int size = 1 << log2;
  int x0 = px * 4, y0 = py * 4;
  if (x0 >= C->pic_w || y0 >= C->pic_h) return 0;
  bool inside = x0 + size <= C->pic_w && y0 + size <= C->pic_h;
  int depth = C->log2_ctb - log2;
  bool covered = inside && C->p_cov[plan_at(C, px, py)];
  if (covered && C->p_depth[plan_at(C, px, py)] == depth) {
    if (!C->p_pred_inter[plan_at(C, px, py)]) {
      // a planned intra CU: the host commits it, in its z-order place
      if (!C->host_cu) return -1;
      std::lock_guard<std::mutex> lock(host_mu);
      if (((host_cu_fn)C->host_cu)(px, py, log2) != 0) return -1;
      W.host_cus++;
      return 0;
    }
    int part = C->p_part[plan_at(C, px, py)];
    int rc = part == 1 || part == 2 ? commit_rect(W, px, py, log2, part)
                                    : commit_square(W, px, py, log2);
    if (rc != 0) return -1;
    W.cus++;
    return 0;
  }
  if (inside && !covered) return -1;       // the host's local search
  if (log2 <= C->min_cb_log2) return -1;   // the host's 8x8 search
  int half = 1 << (log2 - 3);
  for (int sub = 0; sub < 4; sub++)
    if (walk(W, px + (sub & 1) * half, py + (sub >> 1) * half, log2 - 1) <
        0)
      return -1;
  return 0;
}

// the CTU's part arrays and planes, copied out and back
struct Region {
  uint8_t *base;
  int64_t stride;     // bytes between rows
  int64_t width;      // bytes of a row
  int rows;
};

int regions(const WalkCtx *C, int cx, int cy, Region *out) {
  int parts = 1 << (C->log2_ctb - 2);
  int px = cx * parts, py = cy * parts;
  int64_t L = list_plane(C);
  int n = 0;
  auto part_arr = [&](void *arr, int elem) {
    out[n++] = {(uint8_t *)arr + part_at(C, px, py) * elem,
                (int64_t)C->parts_w * elem, (int64_t)parts * elem, parts};
  };
  part_arr(C->coded, 1);
  part_arr(C->depth, 1);
  part_arr(C->part_size, 1);
  part_arr(C->pred_mode, 1);
  part_arr(C->tr_idx, 1);
  part_arr(C->merge_flag, 1);
  part_arr(C->skip, 1);
  part_arr(C->inter_dir, 1);
  part_arr(C->qp, 2);
  part_arr(C->intra_luma, 2);
  part_arr(C->intra_chroma, 2);
  part_arr(C->ipcm, 1);
  for (int c = 0; c < 3; c++) {
    part_arr(C->cbf[c], 1);
    part_arr(C->tskip[c], 1);
  }
  for (int lx = 0; lx < 2; lx++) {
    part_arr(C->ref_idx + lx * L, 1);
    part_arr(C->mvp_idx + lx * L, 1);
    part_arr(C->ref_poc_arr + lx * L, 4);
    part_arr(C->mv + lx * L * 2, 8);
    part_arr(C->mvd + lx * L * 2, 8);
  }
  for (int c = 0; c < C->num_comps; c++) {
    int s = c ? 1 : 0;
    int side = (parts * 4) >> s;
    int64_t x = (int64_t)(px * 4) >> s, y = (int64_t)(py * 4) >> s;
    for (int32_t *plane : {C->rec_p[c], C->coeff_p[c]})
      out[n++] = {(uint8_t *)(plane + y * C->plane_stride[c] + x),
                  C->plane_stride[c] * 4, (int64_t)side * 4, side};
  }
  return n;
}

void save(const Region *r, int n, std::vector<uint8_t> &buf) {
  size_t total = 0;
  for (int i = 0; i < n; i++) total += (size_t)(r[i].width * r[i].rows);
  buf.resize(total);
  uint8_t *dst = buf.data();
  for (int i = 0; i < n; i++)
    for (int y = 0; y < r[i].rows; y++, dst += r[i].width)
      std::memcpy(dst, r[i].base + y * r[i].stride, (size_t)r[i].width);
}

void load(const Region *r, int n, const std::vector<uint8_t> &buf) {
  const uint8_t *src = buf.data();
  for (int i = 0; i < n; i++)
    for (int y = 0; y < r[i].rows; y++, src += r[i].width)
      std::memcpy(r[i].base + y * r[i].stride, src, (size_t)r[i].width);
}

}  // namespace

extern "C" {

// Commits CTU (cx, cy) of the plan: the inter CUs it committed (a planned
// intra CU goes to host_cu), or -1 when the CTU is handed back as it was
// found.  lam: the rerank's lambda; qp: the CUs' QP (CtuSearch.lam,
// .cur_qp).
int iw_commit_ctu(const WalkCtx *C, int cx, int cy, double lam, int qp) {
  if (!C->p_cov || !C->ictx || !C->cand_sse || !C->commit_cu) return -1;
  Walk W{C, lam, qp, 0, 0};
  int parts = 1 << (C->log2_ctb - 2);
  static thread_local std::vector<uint8_t> snap;
  Region r[48];
  int n = regions(C, cx, cy, r);
  save(r, n, snap);
  if (walk(W, cx * parts, cy * parts, C->log2_ctb) < 0) {
    load(r, n, snap);
    return -1;
  }
  int64_t idx = (int64_t)cy * C->w_ctbs + cx;
  if (C->ctu_cus) C->ctu_cus[idx] = W.cus;
  if (C->ctu_host_cus) C->ctu_host_cus[idx] = W.host_cus;
  return W.cus;
}

// CTU (cx, cy) as native/intra_wave.cpp's intra_wave_commit calls it
// (ctx: a WalkCtx): iw_commit_ctu with the context's lam and cu_qp; 0, or -1
// when the CTU was handed back as it was found.
int iw_wave_ctu(const void *ctx, int cx, int cy) {
  const WalkCtx *C = (const WalkCtx *)ctx;
  return iw_commit_ctu(C, cx, cy, C->lam, C->cu_qp) < 0 ? -1 : 0;
}

// MvPredictor.merge_candidates(x, y, w, h, pu_idx, part_size, ...)
// truncated to max_num_merge_cand, as rows [dir, r0, mvx0, mvy0, r1, mvx1,
// mvy1] into out (room for 8): the count, or -1 where the host raises.
int iw_merge_list(const WalkCtx *C, int x, int y, int w, int h, int pu_idx,
                  int part_size, int32_t *out) {
  Cand cands[8];
  int n = merge_list(C, x, y, w, h, pu_idx, part_size, cands);
  if (n < 0) return -1;
  if (n > C->max_merge) n = C->max_merge;
  for (int i = 0; i < n; i++) {
    const Cand &c = cands[i];
    int32_t *o = out + i * 7;
    o[0] = c.dir;
    for (int lx = 0; lx < 2; lx++) {
      o[1 + 3 * lx] = c.r[lx];
      o[2 + 3 * lx] = c.mv[lx][0];
      o[3 + 3 * lx] = c.mv[lx][1];
    }
  }
  return n;
}

// MvPredictor.amvp_candidates(x, y, w, h, lx, ref_idx) as [mvx0, mvy0,
// mvx1, mvy1] into out: 0, or -1 where the host raises.
int iw_amvp_list(const WalkCtx *C, int x, int y, int w, int h, int lx,
                 int ref_idx, int32_t *out) {
  int a[2][2];
  if (amvp_list(C, x, y, w, h, lx, ref_idx, a) < 0) return -1;
  out[0] = a[0][0];
  out[1] = a[0][1];
  out[2] = a[1][0];
  out[3] = a[1][1];
  return 0;
}

int64_t iw_sizeof_ctx() { return (int64_t)sizeof(WalkCtx); }

}  // extern "C"

"""Motion vector prediction: merge candidates, AMVP, temporal MVP
(spec 8.5.3.2; HM TComDataCU.cpp getInterMergeCandidates :2309,
fillMvpCand :2752, xGetColMVP :2543, xGetDistScaleFactor, TComMv::scaleMv).

Operates on the dense picture arrays; a PU is (x, y, w, h) in luma pixels.
"""

from __future__ import annotations

import numpy as np

from hevcref.decode.picture import MODE_INTER, PictureState

NOT_VALID = -1


class RefCtx:
    """Per-slice reference context needed by MV prediction."""

    def __init__(self, sh, ref_lists, dpb_col=None):
        self.sh = sh
        self.ref_lists = ref_lists          # [list0, list1] of RefPicture
        self.ldc = all(p.poc <= sh.poc for lst in ref_lists for p in lst)
        # colocated picture (TMVP)
        self.col_pic = None
        if sh.temporal_mvp_enabled:
            lx = (1 - sh.collocated_from_l0) if sh.slice_type == 0 else 0
            lst = ref_lists[lx] if lx < len(ref_lists) else []
            if sh.collocated_ref_idx < len(lst):
                self.col_pic = lst[sh.collocated_ref_idx]

    def ref_poc(self, lx, ref_idx):
        return self.ref_lists[lx][ref_idx].poc

    def ref_is_lt(self, lx, ref_idx):
        return self.ref_lists[lx][ref_idx].is_long_term


def scale_mv(mv, scale):
    def comp(v):
        return int(np.clip((scale * v + 127 + (scale * v < 0)) >> 8,
                           -32768, 32767))
    return (comp(int(mv[0])), comp(int(mv[1])))


def _trunc_div(a, b):
    """C integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def dist_scale_factor(cur_poc, cur_ref_poc, col_poc, col_ref_poc):
    db = cur_poc - cur_ref_poc
    dd = col_poc - col_ref_poc
    if dd == db:
        return 4096
    tdb = int(np.clip(db, -128, 127))
    tdd = int(np.clip(dd, -128, 127))
    x = _trunc_div(0x4000 + abs(_trunc_div(tdd, 2)), tdd)
    return int(np.clip((tdb * x + 32) >> 6, -4096, 4095))


class MvPredictor:
    def __init__(self, pic: PictureState, rc: RefCtx, slice_idx: int):
        self.pic = pic
        self.rc = rc
        self.slice_idx = slice_idx

    # ---- neighbor access ----

    def _part_at(self, px, py, cur_px, cur_py, bw=1, bh=1):
        """Return part coords if available for MV prediction, else None.
        (bw, bh): current PU span in parts — the decode-order anchor is the
        PU corner nearest the neighbor."""
        pic = self.pic
        if not pic.part_available(px, py, cur_px, cur_py, False, bw, bh):
            return None
        return (px, py)

    def _is_inter(self, p):
        return p is not None and self.pic.pred_mode[p[1], p[0]] == MODE_INTER

    def _motion(self, p, lx):
        py, px = p[1], p[0]
        return (int(self.pic.ref_idx[lx, py, px]),
                (int(self.pic.mv[lx, py, px, 0]), int(self.pic.mv[lx, py, px, 1])))

    def _inter_dir(self, p):
        return int(self.pic.inter_dir[p[1], p[0]])

    # ---- merge (spec 8.5.3.2.3) ----

    def merge_candidates(self, x, y, w, h, pu_idx, part_size, cu_x, cu_y,
                         merge_idx=-1):
        """Returns list of (inter_dir, mvf0, mvf1) with mvf = (ref_idx, mv)."""
        sh = self.rc.sh
        pic = self.pic
        is_b = sh.slice_type == 0
        max_cand = sh.max_num_merge_cand
        cands = []
        cur = (x // 4, y // 4)
        plevel = sh.pps.log2_parallel_merge_level

        def diff_mer(xn, yn):
            return (xn >> plevel) != (x >> plevel) or (yn >> plevel) != (y >> plevel)

        bw, bh = max(w // 4, 1), max(h // 4, 1)

        def fetch(px, py):
            p = self._part_at(px, py, cur[0], cur[1], bw, bh)
            return p if self._is_inter(p) else None

        def motion_of(p):
            d = self._inter_dir(p)
            m0 = self._motion(p, 0) if True else None
            m1 = self._motion(p, 1)
            return (d, m0, m1)

        def same_motion(a, b):
            return a == b

        # A1 left (x-1, y+h-1)
        a1 = None
        if not (pu_idx == 1 and part_size in (2, 6, 7)):
            if diff_mer(x - 1, y + h - 1):
                a1 = fetch((x - 1) // 4, (y + h - 4) // 4)
        if a1:
            cands.append(motion_of(a1))
            if merge_idx == len(cands) - 1:
                return cands
        if len(cands) == max_cand:
            return cands
        # B1 above (x+w-1, y-1)
        b1 = None
        if not (pu_idx == 1 and part_size in (1, 4, 5)):
            if diff_mer(x + w - 1, y - 1):
                b1 = fetch((x + w - 4) // 4, (y - 4) // 4)
        if b1 and not (a1 and same_motion(motion_of(a1), motion_of(b1))):
            cands.append(motion_of(b1))
            if merge_idx == len(cands) - 1:
                return cands
        if len(cands) == max_cand:
            return cands
        # B0 above-right (x+w, y-1)
        b0 = fetch((x + w) // 4, (y - 4) // 4) if diff_mer(x + w, y - 1) else None
        if b0 and not (b1 and same_motion(motion_of(b1), motion_of(b0))):
            cands.append(motion_of(b0))
            if merge_idx == len(cands) - 1:
                return cands
        if len(cands) == max_cand:
            return cands
        # A0 below-left (x-1, y+h)
        a0 = fetch((x - 4) // 4, (y + h) // 4) if diff_mer(x - 1, y + h) else None
        if a0 and not (a1 and same_motion(motion_of(a1), motion_of(a0))):
            cands.append(motion_of(a0))
            if merge_idx == len(cands) - 1:
                return cands
        if len(cands) == max_cand:
            return cands
        # B2 above-left (x-1, y-1), only if fewer than 4 so far
        if len(cands) < 4:
            b2 = fetch((x - 4) // 4, (y - 4) // 4) if diff_mer(x - 1, y - 1) else None
            if b2 and not (a1 and same_motion(motion_of(a1), motion_of(b2))) \
                    and not (b1 and same_motion(motion_of(b1), motion_of(b2))):
                cands.append(motion_of(b2))
                if merge_idx == len(cands) - 1:
                    return cands
        if len(cands) == max_cand:
            return cands

        # temporal (TMVP)
        if sh.temporal_mvp_enabled and self.rc.col_pic is not None:
            dir_flags = 0
            mvf = [ (NOT_VALID, (0, 0)), (NOT_VALID, (0, 0)) ]
            for lx in range(2 if is_b else 1):
                got = self._tmvp(x, y, w, h, lx, 0)
                if got is not None:
                    dir_flags |= (1 << lx)
                    mvf[lx] = (0, got)
            if dir_flags:
                cands.append((dir_flags, mvf[0], mvf[1]))
                if merge_idx == len(cands) - 1:
                    return cands
        if len(cands) == max_cand:
            return cands

        # combined bi-pred candidates (B slices)
        if is_b:
            pr0 = [0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3]
            pr1 = [1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2]
            cutoff = len(cands)
            for idx in range(cutoff * (cutoff - 1)):
                if len(cands) == max_cand:
                    break
                i, j = pr0[idx], pr1[idx]
                di, m0i, m1i = cands[i]
                dj, m0j, m1j = cands[j]
                if (di & 1) and (dj & 2):
                    ref0, mv0 = m0i
                    ref1, mv1 = m1j
                    if self.rc.ref_poc(0, ref0) == self.rc.ref_poc(1, ref1) \
                            and mv0 == mv1:
                        continue
                    cands.append((3, (ref0, mv0), (ref1, mv1)))
        # zero candidates
        n_ref = min(self.rc.sh.num_ref_idx[0],
                    self.rc.sh.num_ref_idx[1]) if is_b else self.rc.sh.num_ref_idx[0]
        r = 0
        refcnt = 0
        while len(cands) < max_cand:
            if is_b:
                cands.append((3, (r, (0, 0)), (r, (0, 0))))
            else:
                cands.append((1, (r, (0, 0)), (NOT_VALID, (0, 0))))
            if refcnt == n_ref - 1:
                r = 0
            else:
                r += 1
                refcnt += 1
        return cands

    # ---- TMVP (spec 8.5.3.2.8) ----

    def _tmvp(self, x, y, w, h, lx, ref_idx):
        pic = self.pic
        col = self.rc.col_pic
        # H position: bottom-right + (1,1), constrained to same CTU row
        hx, hy = x + w, y + h
        mv = None
        if hx < pic.w and hy < pic.h and \
                (hy >> pic.log2_ctb) == (y + h - 1) >> pic.log2_ctb:
            mv = self._col_mv(col, hx, hy, lx, ref_idx)
        if mv is None:
            cx = x + w // 2
            cy = y + h // 2
            mv = self._col_mv(col, cx, cy, lx, ref_idx)
        return mv

    def _col_mv(self, col, sx, sy, lx, ref_idx):
        """Colocated MV at sample (sx, sy), 16x16-compressed sampling."""
        px = ((sx >> 4) << 4) // 4
        py = ((sy >> 4) << 4) // 4
        if px >= col.pred_mode.shape[1] or py >= col.pred_mode.shape[0]:
            return None
        if col.pred_mode[py, px] != MODE_INTER:
            return None
        col_list = lx if self.rc.ldc else self.rc.sh.collocated_from_l0
        col_ref = int(col.ref_idx[col_list, py, px])
        if col_ref < 0:
            col_list = 1 - col_list
            col_ref = int(col.ref_idx[col_list, py, px])
            if col_ref < 0:
                return None
        col_ref_poc = int(col.ref_poc[col_list, py, px])
        cmv = (int(col.mv[col_list, py, px, 0]), int(col.mv[col_list, py, px, 1]))
        cur_ref_lt = self.rc.ref_is_lt(lx, ref_idx)
        # long-term tracking per part not stored; short-term assumed
        col_ref_lt = False
        if cur_ref_lt != col_ref_lt:
            return None
        if cur_ref_lt:
            return cmv
        scale = dist_scale_factor(self.rc.sh.poc, self.rc.ref_poc(lx, ref_idx),
                                  col.poc, col_ref_poc)
        return cmv if scale == 4096 else scale_mv(cmv, scale)

    # ---- AMVP (spec 8.5.3.2.5) ----

    def amvp_candidates(self, x, y, w, h, lx, ref_idx):
        pic = self.pic
        sh = self.rc.sh
        cur = (x // 4, y // 4)
        cands = []

        bw, bh = max(w // 4, 1), max(h // 4, 1)

        def fetch(px, py):
            p = self._part_at(px, py, cur[0], cur[1], bw, bh)
            return p if self._is_inter(p) else None

        lb = ((x - 4) // 4, (y + h) // 4)         # A0 below-left
        left = ((x - 4) // 4, (y + h - 4) // 4)   # A1 left
        rt_ar = ((x + w) // 4, (y - 4) // 4)      # B0 above-right
        above = ((x + w - 4) // 4, (y - 4) // 4)  # B1
        al = ((x - 4) // 4, (y - 4) // 4)         # B2

        a0 = fetch(*lb)
        a1 = fetch(*left)
        # bAddedSmvp: a left-side inter neighbor exists -> skip above-scaled
        smvp = (a0 is not None) or (a1 is not None)

        def try_cand(p):
            """xAddMVPCand (exact-POC, then cross-list same POC); optionally
            scaled versions (xAddMVPCandOrder)."""
            if p is None:
                return None
            cur_ref_poc = self.rc.ref_poc(lx, ref_idx)
            ri, mv = self._motion(p, lx)
            if ri >= 0 and self.rc.ref_poc(lx, ri) == cur_ref_poc:
                return mv
            ri2, mv2 = self._motion(p, 1 - lx)
            if ri2 >= 0 and len(self.rc.ref_lists[1 - lx]) > ri2 and \
                    self.rc.ref_poc(1 - lx, ri2) == cur_ref_poc:
                return mv2
            return None

        def try_cand_scaled(p):
            if p is None:
                return None
            cur_poc = sh.poc
            cur_ref_poc = self.rc.ref_poc(lx, ref_idx)
            cur_lt = self.rc.ref_is_lt(lx, ref_idx)
            for ll in (lx, 1 - lx):
                if ll == 1 - lx and len(self.rc.ref_lists) <= ll:
                    continue
                ri, mv = self._motion(p, ll)
                if ri < 0 or ri >= len(self.rc.ref_lists[ll]):
                    continue
                neib_ref_poc = self.rc.ref_poc(ll, ri)
                neib_lt = self.rc.ref_is_lt(ll, ri)
                if cur_lt != neib_lt:
                    continue
                if cur_lt:
                    return mv
                scale = dist_scale_factor(cur_poc, cur_ref_poc, cur_poc,
                                          neib_ref_poc)
                return mv if scale == 4096 else scale_mv(mv, scale)
            return None

        # left predictor: A0 then A1 unscaled; if none, A0 then A1 scaled
        got = try_cand(a0)
        if got is None:
            got = try_cand(a1)
        if got is None:
            got = try_cand_scaled(a0)
            if got is None:
                got = try_cand_scaled(a1)
        if got is not None:
            cands.append(got)

        # above predictor: B0, B1, B2 unscaled; scaled only when no left-side
        # inter neighbor exists (fillMvpCand's bAddedSmvp gate)
        b0 = fetch(*rt_ar)
        b1 = fetch(*above)
        b2 = fetch(*al)
        got = try_cand(b0)
        if got is None:
            got = try_cand(b1)
        if got is None:
            got = try_cand(b2)
        if got is not None:
            cands.append(got)
        if not smvp:
            # scaled above search runs regardless of the unscaled outcome
            # when no left-side inter neighbor exists (fillMvpCand)
            got = try_cand_scaled(b0)
            if got is None:
                got = try_cand_scaled(b1)
            if got is None:
                got = try_cand_scaled(b2)
            if got is not None:
                cands.append(got)

        if len(cands) == 2 and cands[0] == cands[1]:
            cands = cands[:1]

        if sh.temporal_mvp_enabled and self.rc.col_pic is not None:
            t = self._tmvp(x, y, w, h, lx, ref_idx)
            if t is not None:
                cands.append(t)
        while len(cands) < 2:
            cands.append((0, 0))
        return cands[:2]

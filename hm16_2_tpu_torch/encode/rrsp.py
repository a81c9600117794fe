"""RRSP — Reduced Region Similarity Partitioning (fork's encoder-only fast
CU-depth algorithm, the sibling of SBD).

Reference behavior: TEncCu.cpp:2671-3634 (evaluateGroupA64x64 /
evaluateGroupB64x64 / getNumOf32x32CUsInA / buildRRSPAlphaGroup /
buildRRSPBetaGroup / getRRSPSimLevel / setReducedRangeDepths /
performRRSPLow|Medium|HighSim), gates in xCompressCU at
TEncCu.cpp:477-536 (depth-0 64x64 voting), :598 (bRRSP mode gate),
:937-971 (bRRSPSplit), :992-1002 (per-quadrant mask build), with types in
TypeDef.h:823-862.

Where the reference walks hard-coded Z-order part-index tables per 32x32
quadrant (w/x/y/z), this implementation samples the dense per-4x4-part
depth planes at 8x8-CU granularity over the equivalent pixel rectangles —
the depth history of the current picture, the colocated reference ("father")
and the colocated reference's own colocated reference ("grandfather").
The masks it produces shrink the CU-depth candidate set; on the TPU batch
path that is a batch-size reduction, here it prunes the quadtree recursion.
Normatively transparent: the bitstream stays standard HEVC.
"""

from __future__ import annotations

import numpy as np

# reference constants (TypeDef.h:824-830)
N32_PER_CTU = 4          # NUM_OF_32X32_CTUS_IN_64X64_CTU
N8_PER_32 = 16           # NUM_OF_8X8_CTUS_IN_32X32_CTU
PAIRS = 2                # CU_8X8_IS_ADOPTED_IN_PAIRS
FOURSOMES = 4            # CU_32X32_IS_ADOPTED_IN_FOURSOMES

# quadrant (RRSP32x32CU w/x/y/z, TypeDef.h:856-862) pixel offsets in the CTU
QUAD_OFF = [(0, 0), (32, 0), (0, 32), (32, 32)]


def _hist_region(out, arr, px, py, w, h):
    """Accumulate the weighted reduced-depth histogram of one pixel
    rectangle sampled at 8x8-CU granularity (the R=8 strips of
    buildRRSPAlphaGroup / buildRRSPBetaGroup).  depth==0 counts twice at
    reduced depth 0; depth d>0 counts once at reduced depth d-1."""
    if arr is None or px < 0 or py < 0:
        return False
    ph, pw = arr.shape                       # 4x4-part units
    if px + w > pw * 4 or py + h > ph * 4:
        return False
    d = arr[py // 4:(py + h) // 4:2, px // 4:(px + w) // 4:2].ravel()
    if d.size == 0 or np.any(d < 0):
        return False
    red = np.where(d == 0, 0, np.minimum(d, 3) - 1)
    out += np.bincount(red, weights=np.where(d == 0, 2, 1),
                       minlength=3).astype(np.int64)
    return True


def _single(out, arr, px, py):
    """One 8x8 sample with multiplier 1 (the above-left / above-right CU
    contributions)."""
    if arr is None or px < 0 or py < 0:
        return False
    ph, pw = arr.shape
    if px >= pw * 4 or py >= ph * 4:
        return False
    d = int(arr[py // 4, px // 4])
    if d < 0:
        return False
    out[0 if d == 0 else min(d, 3) - 1] += 1
    return True


def _depth_at(arr, px, py):
    if arr is None or px < 0 or py < 0:
        return None
    ph, pw = arr.shape
    if px >= pw * 4 or py >= ph * 4:
        return None
    d = int(arr[py // 4, px // 4])
    return d if d >= 0 else None


class RRSP:
    """Per-picture RRSP state.

    cur_depth: current picture's per-part depth plane (filled in coding
    order by the search); col: the list-0/idx-0 reference picture carrying
    its own depth plane, the slice type it was coded with, and the depth
    plane of *its* colocated reference (the grandfather frame).
    """

    def __init__(self, cur_depth, col, qp, pic_w, pic_h):
        self.cur = cur_depth
        self.col = col.depth if col is not None else None
        self.grand = getattr(col, "col_depth", None) if col is not None \
            else None
        self.col_is_intra = bool(getattr(col, "is_intra", False)) \
            if col is not None else False
        self.qp = qp
        self.w, self.h = pic_w, pic_h

    # ---- depth-0 (64x64) voting, TEncCu.cpp:483-536 ------------------

    def ctu_state(self, ctu_x, ctu_y):
        """Returns (check64, only_depth0) for the CTU with top-left pixel
        (ctu_x, ctu_y)."""
        cx, cy = ctu_x, ctu_y
        # group A 64x64 votes: left/above/above-left CTUs + colocated
        a_votes, a_n = 0, 0
        for arr, px, py in ((self.cur, cx - 64, cy), (self.cur, cx, cy - 64),
                            (self.cur, cx - 64, cy - 64),
                            (self.col, cx, cy)):
            d = _depth_at(arr, px, py)
            if d is not None:
                a_n += 1
                a_votes += (d == 0)

        def b_votes():
            v, n = 0, 0
            for arr, px, py in ((self.cur, cx + 64, cy - 64),
                                (self.col, cx, cy - 64),
                                (self.col, cx - 64, cy),
                                (self.col, cx, cy + 64),
                                (self.col, cx + 64, cy)):
                d = _depth_at(arr, px, py)
                if d is not None:
                    n += 1
                    v += (d == 0)
            return v, n

        only0 = False
        if a_votes == a_n:
            bv, bn = b_votes()
            if bv == bn:
                gd = _depth_at(self.grand, cx, cy)
                if self.qp > 35 or gd is None or gd == 0:
                    only0 = True

        check64 = a_votes > 0 or (self.col_is_intra and cy < 32)
        if not check64:
            bv, _ = b_votes()
            check64 = bv > 0
        if not check64:
            n32 = self._num_32x32_in_a(cx, cy)
            check64 = n32 >= (a_n * N32_PER_CTU) // 2
        return check64, only0

    def _num_32x32_in_a(self, cx, cy):
        """getNumOf32x32CUsInA (TEncCu.cpp:2763): count depth-1 quadrants
        over group-A CTUs; at QP>35 a fully-32x32 CTU short-circuits with a
        foursome bonus."""
        total = 0
        for arr, px, py in ((self.cur, cx - 64, cy), (self.cur, cx, cy - 64),
                            (self.cur, cx - 64, cy - 64),
                            (self.col, cx, cy)):
            if _depth_at(arr, px, py) is None:
                continue
            n = sum(_depth_at(arr, px + qx, py + qy) == 1
                    for qx, qy in QUAD_OFF)
            total += n
            if self.qp > 35 and n == N32_PER_CTU:
                return total + N32_PER_CTU
        return total

    # ---- per-32x32-quadrant reduced-range masks ----------------------

    def _alpha(self, qx, qy, cur, col):
        """buildRRSPAlphaGroup over pixel-space regions: left 8x32 strip,
        above-left 8x8, above 32x8 strip (current frame), colocated 32x32."""
        out = np.zeros(3, dtype=np.int64)
        any_hit = False
        any_hit |= _hist_region(out, cur, qx - 8, qy, 8, 32)
        any_hit |= _single(out, cur, qx - 8, qy - 8)
        any_hit |= _hist_region(out, cur, qx, qy - 8, 32, 8)
        any_hit |= _hist_region(out, col, qx, qy, 32, 32)
        return out, any_hit

    def _beta(self, qx, qy, cur, col):
        """buildRRSPBetaGroup: above-right 8x8 (current) + colocated ring
        strips (above/left/bottom/right)."""
        out = np.zeros(3, dtype=np.int64)
        _single(out, cur, qx + 32, qy - 8)
        _hist_region(out, col, qx, qy - 8, 32, 8)
        _hist_region(out, col, qx - 8, qy, 8, 32)
        _hist_region(out, col, qx, qy + 32, 32, 8)
        _hist_region(out, col, qx + 32, qy, 8, 32)
        return out

    def quadrant_mask(self, ctu_x, ctu_y, quad):
        """Reduced depth mask (bool[3]; index d-1 allows CU depth d) for one
        32x32 quadrant — setReducedRangeDepths(getRRSPSimLevel())
        (TEncCu.cpp:3367-3634) plus the I-predecessor top-row escape
        (:996-1001)."""
        qx = ctu_x + QUAD_OFF[quad][0]
        qy = ctu_y + QUAD_OFF[quad][1]
        mask = self._mask_for(qx, qy, self.cur, self.col, self.grand)
        if self.col_is_intra and ctu_y < 32:
            mask[0] = True
        return mask

    def _mask_for(self, qx, qy, cur, col, grand, depth_recursed=False):
        alpha, any_hit = self._alpha(qx, qy, cur, col)
        mask = np.zeros(3, dtype=bool)
        if not any_hit:
            mask[:] = True
            return mask
        sim = int(np.count_nonzero(alpha == 0))   # getRRSPSimLevel
        if sim == 0:
            self._low_sim(mask, alpha, qx, qy, cur, col)
        elif sim == 1:
            self._medium_sim(mask, alpha, qx, qy, cur, col)
        elif sim == 2:
            self._high_sim(mask, alpha, qx, qy, cur, col, grand,
                           depth_recursed)
        else:
            mask[:] = True                        # alpha empty: no pruning
        return mask

    def _low_sim(self, mask, alpha, qx, qy, cur, col):
        """performRRSPLowSim (TEncCu.cpp:3422): all three depth classes
        adopted — try to drop the one with lowest support."""
        mask[:] = True
        if alpha[0] > N8_PER_32 + FOURSOMES:
            mask[2] = False
        elif alpha[2] > N8_PER_32 + 2 * PAIRS:
            mask[0] = False
        elif alpha[2] <= PAIRS:
            if alpha[2] == 1:                     # adopted only by CU c
                mask[2] = False
            else:
                beta = self._beta(qx, qy, cur, col)
                if beta[2] <= PAIRS:
                    mask[2] = False
        elif alpha[0] < FOURSOMES:
            beta = self._beta(qx, qy, cur, col)
            if beta[0] == 0:
                mask[0] = False

    def _medium_sim(self, mask, alpha, qx, qy, cur, col):
        """performRRSPMediumSim (TEncCu.cpp:3478)."""
        beta = self._beta(qx, qy, cur, col)
        beta_more, extra, by_c = False, None, -1
        for i in range(3):
            mask[i] = alpha[i] > 0
            if alpha[i] == 1:
                by_c = i
            if alpha[i] == 0:
                extra = i
                beta_more = beta[i] > 0
        if alpha[0] > 1 and alpha[2] >= N8_PER_32:
            mask[1] = True
            return
        if beta_more:
            need = FOURSOMES if extra == 0 else PAIRS
            if beta[extra] > need:
                mask[extra] = True
        elif by_c != -1 and beta[by_c] == 0:
            mask[by_c] = False

    def _high_sim(self, mask, alpha, qx, qy, cur, col, grand, recursed):
        """performRRSPHighSim (TEncCu.cpp:3556): single adopted depth;
        widen by the beta group or by re-running the decision on the
        colocated CU in the grandfather frame (used once, :3590-3615)."""
        beta = self._beta(qx, qy, cur, col)
        d_a, beta_more = 0, False
        for i in range(3):
            mask[i] = alpha[i] > 0
            if alpha[i] > 0:
                d_a = i
            elif beta[i] > 0:
                beta_more = True
        if beta_more:
            if d_a < 2:
                mask[d_a + 1] = True
            else:
                mask[d_a - 1] = True
            return
        if self.qp <= 35:
            if grand is not None and not recursed:
                gmask = self._mask_for(qx, qy, col, grand, None,
                                       depth_recursed=True)
                mask[:] = gmask
                if d_a > 0:
                    mask[d_a - 1] = True
            elif grand is None and not recursed and d_a > 0:
                mask[d_a - 1] = True
        elif d_a > 0:
            mask[d_a - 1] = True

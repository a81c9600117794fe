"""Reference picture management: DPB, RPS application, reference list
construction (spec 8.3.2-8.3.4; HM TComSlice.cpp setRefPicList /
applyReferencePictureSet, TDecTop DPB handling).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class RefPicture:
    """A decoded picture retained for reference / colocated MVs."""
    poc: int
    rec: list                       # per-component planes (padded, CTU-aligned)
    mv: np.ndarray | None = None    # (2, ph, pw, 2)
    ref_idx: np.ndarray | None = None
    ref_poc: np.ndarray | None = None   # (2, ph, pw) POC referenced per part
    pred_mode: np.ndarray | None = None
    depth: np.ndarray | None = None     # (ph, pw) CU depth (encoder SBD/RRSP)
    col_depth: np.ndarray | None = None  # depth plane of THIS picture's own
    #                                      colocated ref (RRSP "grandfather")
    is_intra: bool = False               # coded as an I slice (RRSP escapes)
    is_long_term: bool = False
    is_b_slice: bool = False


class DPB:
    def __init__(self):
        self.pics: dict[int, RefPicture] = {}

    def add(self, pic: RefPicture):
        self.pics[pic.poc] = pic

    def get(self, poc: int) -> RefPicture | None:
        return self.pics.get(poc)

    def clear(self):
        self.pics.clear()


def conceal_lost_picture(dpb: DPB, poc: int) -> RefPicture:
    """Lost-reference concealment (TDecTop::xCreateLostPicture,
    TDecTop.cpp:229-278): clone the DPB picture closest in POC and
    re-badge it with the missing POC (zeroed motion)."""
    assert dpb.pics, "cannot conceal with an empty DPB"
    closest = min(dpb.pics.values(), key=lambda p: abs(p.poc - poc))
    sub = RefPicture(
        poc=poc, rec=[pl.copy() for pl in closest.rec],
        mv=None if closest.mv is None else np.zeros_like(closest.mv),
        ref_idx=None if closest.ref_idx is None
        else np.full_like(closest.ref_idx, -1),
        ref_poc=None if closest.ref_poc is None
        else np.full_like(closest.ref_poc, -(10 ** 9)),
        pred_mode=None if closest.pred_mode is None
        else closest.pred_mode.copy(),
        is_intra=closest.is_intra, is_b_slice=closest.is_b_slice)
    dpb.add(sub)
    return sub


def build_ref_lists(sh, dpb: DPB, conceal: bool = True):
    """RefPicList0/1 as lists of RefPicture (spec 8.3.4).

    Short-term before (POC < cur, descending) then after (ascending), from
    the slice RPS 'used' pictures; wrap-around fill to num_ref_idx.
    Missing references are concealed (cloned nearest picture) when
    `conceal`, matching the reference decoder's robustness path.
    """
    cur = sh.poc
    rps = sh.rps
    before, after = [], []
    if rps is not None:
        for d, used in zip(rps.delta_poc, rps.used):
            if not used:
                continue
            p = dpb.get(cur + d)
            if p is None:
                if not conceal or not dpb.pics:
                    raise KeyError(f"missing reference POC {cur + d}")
                p = conceal_lost_picture(dpb, cur + d)
            (before if d < 0 else after).append((d, p))
    before.sort(key=lambda x: -x[0])    # closest (least negative) first
    after.sort(key=lambda x: x[0])
    st_before = [p for _, p in before]
    st_after = [p for _, p in after]
    # long-term entries are re-badged so MV prediction applies the
    # no-scaling / exclusion rules for LT references (TComSlice
    # setRefPicList; mvpred ref_is_lt consumers)
    from dataclasses import replace as _replace
    lt = [_replace(dpb.get(p), is_long_term=True)
          for p, u in zip(sh.lt_poc, sh.lt_used) if u and dpb.get(p)]

    temp0 = st_before + st_after + lt
    temp1 = st_after + st_before + lt
    lists = []
    for lx, temp in ((0, temp0), (1, temp1)):
        n = sh.num_ref_idx[lx]
        if n == 0 or not temp:
            lists.append([])
            continue
        mod = sh.ref_pic_list_modification[lx]
        if mod is not None:
            lists.append([temp[i] for i in mod[:n]])
        else:
            lists.append([temp[i % len(temp)] for i in range(n)])
    return lists


def check_ldc(ref_lists, cur_poc: int) -> bool:
    """True when every reference has POC <= current (low-delay check)."""
    for lst in ref_lists:
        for p in lst:
            if p.poc > cur_poc:
                return False
    return True

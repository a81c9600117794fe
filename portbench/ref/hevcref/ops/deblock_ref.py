"""HEVC deblocking filter, decode side (spec 8.7.2; HM TComLoopFilter.cpp).

Restructured picture-wide: edge masks and boundary strengths are derived
from the dense per-part syntax arrays (no CU recursion), then the normative
per-edge filters are applied — vertical edges over the whole picture first,
then horizontal (matching loopFilterPic's two passes).
"""

from __future__ import annotations

import numpy as np

from hevcref.common.tables import CHROMA_QP_SCALE
from hevcref.decode.picture import MODE_INTRA, PictureState

TC_TABLE = np.array(
    [0]*18 + [1]*9 + [2]*4 + [3]*4 + [4]*3 + [5, 5, 6, 6, 7, 8, 9, 10, 11,
     13, 14, 16, 18, 20, 22, 24], dtype=np.int64)
BETA_TABLE = np.array(
    [0]*16 + list(range(6, 19)) + list(range(20, 66, 2)), dtype=np.int64)

EDGE_VER, EDGE_HOR = 0, 1



def _cl(v, lo, hi):
    """Scalar clip (min/max beats np.clip on Python ints in the hot loop)."""
    return lo if v < lo else (hi if v > hi else v)

def _slice_flags(pic: PictureState):
    """Per-slice (disable, beta, tc, lf_cross_slices) lookup arrays."""
    n = len(pic.slices)
    dis = np.zeros(n + 1, dtype=bool)
    beta = np.zeros(n + 1, dtype=np.int64)
    tc = np.zeros(n + 1, dtype=np.int64)
    cross = np.ones(n + 1, dtype=bool)
    for i, sh in enumerate(pic.slices):
        dis[i] = bool(sh.deblocking_filter_disabled)
        beta[i] = sh.beta_offset_div2
        tc[i] = sh.tc_offset_div2
        cross[i] = bool(sh.loop_filter_across_slices)
    return dis, beta, tc, cross


def build_edge_masks(pic: PictureState, direction: int):
    """edge_filter + TU pre-marker masks over the part grid.

    Mirrors xSetEdgefilterTU/PU + xSetLoopfilterParam (TComLoopFilter.cpp:
    269-410): TU edges and PU edges inside a CU use the internal-edge value;
    CU left/top edges use availability across slice/tile boundaries.
    """
    ph, pw = pic.depth.shape
    edge = np.zeros((ph, pw), dtype=bool)
    marker = np.zeros((ph, pw), dtype=bool)
    dis, _, _, cross = _slice_flags(pic)
    lf_cross_tiles = bool(pic.pps.loop_filter_across_tiles)

    valid_h = pic.h // 4
    valid_w = pic.w // 4
    for py in range(valid_h):
        for px in range(valid_w):
            sl = pic.slice_id[py, px]
            if sl < 0:
                continue
            internal = not dis[sl]
            depth = int(pic.depth[py, px])
            cu_n = 1 << (pic.log2_ctb - 2 - depth)
            tu_n = cu_n >> int(pic.tr_idx[py, px])
            if direction == EDGE_VER:
                on_tu_edge = (px % tu_n) == 0
                on_cu_edge = (px % cu_n) == 0
                nx, ny = px - 1, py
            else:
                on_tu_edge = (py % tu_n) == 0
                on_cu_edge = (py % cu_n) == 0
                nx, ny = px, py - 1
            if on_cu_edge:
                # CU boundary: xSetLoopfilterParam's bLeftEdge/bTopEdge
                val = internal
                if (direction == EDGE_VER and px == 0) or \
                        (direction == EDGE_HOR and py == 0):
                    val = False
                elif nx < 0 or ny < 0:
                    val = False
                else:
                    nsl = pic.slice_id[ny, nx]
                    if nsl < 0:
                        val = False
                    elif nsl != sl and not cross[sl]:
                        val = False
                    elif not lf_cross_tiles and \
                            pic.tile_of_part(nx, ny) != pic.tile_of_part(px, py):
                        val = False
                edge[py, px] = val
                marker[py, px] = val
            elif on_tu_edge:
                edge[py, px] = internal
                marker[py, px] = internal
            else:
                # internal PU edges per partition mode (xSetEdgefilterPU)
                ps = int(pic.part_size[py, px])
                q = cu_n >> 2
                rel = (px % cu_n) if direction == EDGE_VER else (py % cu_n)
                offs = ()
                if direction == EDGE_VER:
                    if ps in (2, 3):          # Nx2N, NxN
                        offs = (2 * q,)
                    elif ps == 6:             # nLx2N
                        offs = (q,)
                    elif ps == 7:             # nRx2N
                        offs = (3 * q,)
                else:
                    if ps in (1, 3):          # 2NxN, NxN
                        offs = (2 * q,)
                    elif ps == 4:             # 2NxnU
                        offs = (q,)
                    elif ps == 5:             # 2NxnD
                        offs = (3 * q,)
                if rel in offs:
                    edge[py, px] = internal
    return edge, marker


def compute_bs(pic: PictureState, direction: int, edge, marker):
    """Boundary strength per part (xGetBoundaryStrengthSingle)."""
    ph, pw = edge.shape
    bs = np.zeros((ph, pw), dtype=np.int8)
    for py in range(ph):
        for px in range(pw):
            if not edge[py, px]:
                continue
            nx, ny = (px - 1, py) if direction == EDGE_VER else (px, py - 1)
            p_intra = pic.pred_mode[ny, nx] == MODE_INTRA
            q_intra = pic.pred_mode[py, px] == MODE_INTRA
            if p_intra or q_intra:
                bs[py, px] = 2
                continue
            # inter: cbf rule on TU boundaries
            if marker[py, px]:
                cbf_q = (int(pic.cbf[0][py, px]) >> int(pic.tr_idx[py, px])) & 1
                cbf_p = (int(pic.cbf[0][ny, nx]) >> int(pic.tr_idx[ny, nx])) & 1
                if cbf_q or cbf_p:
                    bs[py, px] = 1
                    continue
            bs[py, px] = _bs_mv(pic, px, py, nx, ny)
    return bs


def _bs_mv(pic: PictureState, px, py, nx, ny):
    """MV-difference boundary strength (inter-inter edges)."""
    def refs(pt_x, pt_y):
        return [int(pic.ref_poc[lx, pt_y, pt_x])
                if pic.ref_idx[lx, pt_y, pt_x] >= 0 else None
                for lx in range(2)]
    refp = refs(nx, ny)
    refq = refs(px, py)
    mvp = [pic.mv[lx, ny, nx] if refp[lx] is not None else np.zeros(2, np.int32)
           for lx in range(2)]
    mvq = [pic.mv[lx, py, px] if refq[lx] is not None else np.zeros(2, np.int32)
           for lx in range(2)]

    def mv_far(a, b):
        return abs(int(a[0]) - int(b[0])) >= 4 or abs(int(a[1]) - int(b[1])) >= 4

    if (refp[0] == refq[0] and refp[1] == refq[1]) or \
            (refp[0] == refq[1] and refp[1] == refq[0]):
        if refp[0] != refp[1]:
            if refp[0] == refq[0]:
                return 1 if (mv_far(mvq[0], mvp[0]) or mv_far(mvq[1], mvp[1])) else 0
            return 1 if (mv_far(mvq[1], mvp[0]) or mv_far(mvq[0], mvp[1])) else 0
        same = mv_far(mvq[0], mvp[0]) or mv_far(mvq[1], mvp[1])
        crossed = mv_far(mvq[1], mvp[0]) or mv_far(mvq[0], mvp[1])
        return 1 if (same and crossed) else 0
    return 1


def _no_filter_flags(pic, px, py):
    if pic.sps.pcm_enabled and pic.sps.pcm_loop_filter_disabled and \
            pic.ipcm[py, px]:
        return True
    if pic.pps.transquant_bypass_enabled and pic.tqb[py, px]:
        return True
    return False


def build_edge_masks_vec(pic: PictureState, direction: int):
    """Vectorized dual of build_edge_masks."""
    ph, pw = pic.depth.shape
    edge = np.zeros((ph, pw), dtype=bool)
    marker = np.zeros((ph, pw), dtype=bool)
    dis, _, _, cross = _slice_flags(pic)
    lf_cross_tiles = bool(pic.pps.loop_filter_across_tiles)
    vh, vw = pic.h // 4, pic.w // 4

    sl = pic.slice_id[:vh, :vw].astype(np.int64)
    ok = sl >= 0
    internal = ok & ~dis[np.clip(sl, 0, len(dis) - 1)]
    depth = pic.depth[:vh, :vw].astype(np.int64)
    cu_n = (1 << (pic.log2_ctb - 2 - depth)).astype(np.int64)
    tu_n = np.maximum(cu_n >> pic.tr_idx[:vh, :vw].astype(np.int64), 1)
    PY, PX = np.mgrid[0:vh, 0:vw]
    along = PX if direction == EDGE_VER else PY
    on_tu = (along % tu_n) == 0
    on_cu = (along % cu_n) == 0

    # CU boundary value with slice/tile crossing rules
    if direction == EDGE_VER:
        NY, NX = PY, PX - 1
        at_pic_edge = PX == 0
    else:
        NY, NX = PY - 1, PX
        at_pic_edge = PY == 0
    NYc, NXc = np.clip(NY, 0, vh - 1), np.clip(NX, 0, vw - 1)
    nsl = pic.slice_id[NYc, NXc].astype(np.int64)
    val = internal & ~at_pic_edge & (nsl >= 0)
    diff_slice = nsl != sl
    val &= ~diff_slice | cross[np.clip(sl, 0, len(cross) - 1)]
    if not lf_cross_tiles:
        ctb_sh = pic.log2_ctb - 2
        tile = pic.tiles.tile_of_ctu
        t_cur = tile[PY >> ctb_sh, PX >> ctb_sh]
        t_n = tile[NYc >> ctb_sh, NXc >> ctb_sh]
        val &= t_cur == t_n

    edge[:vh, :vw] = np.where(on_cu, val, internal & on_tu)
    marker[:vh, :vw] = np.where(on_cu, val, internal & on_tu)

    # internal PU edges (xSetEdgefilterPU) on non-TU-edge parts
    ps = pic.part_size[:vh, :vw].astype(np.int64)
    q = cu_n >> 2
    rel = along % cu_n
    if direction == EDGE_VER:
        pu = (np.isin(ps, (2, 3)) & (rel == 2 * q)) | \
             ((ps == 6) & (rel == q)) | ((ps == 7) & (rel == 3 * q))
    else:
        pu = (np.isin(ps, (1, 3)) & (rel == 2 * q)) | \
             ((ps == 4) & (rel == q)) | ((ps == 5) & (rel == 3 * q))
    edge[:vh, :vw] |= internal & ~on_tu & ~on_cu & pu
    return edge, marker


def compute_bs_vec(pic: PictureState, direction: int, edge, marker):
    """Vectorized dual of compute_bs."""
    ph, pw = edge.shape
    bs = np.zeros((ph, pw), dtype=np.int8)
    eys, exs = np.nonzero(edge)
    if len(eys) == 0:
        return bs
    if direction == EDGE_VER:
        nys, nxs = eys, exs - 1
    else:
        nys, nxs = eys - 1, exs
    p_intra = pic.pred_mode[nys, nxs] == MODE_INTRA
    q_intra = pic.pred_mode[eys, exs] == MODE_INTRA
    out = np.zeros(len(eys), dtype=np.int8)
    intra = p_intra | q_intra
    out[intra] = 2

    rem = ~intra
    if rem.any():
        mk = marker[eys, exs] & rem
        cbf_q = (pic.cbf[0][eys, exs].astype(np.int64)
                 >> pic.tr_idx[eys, exs]) & 1
        cbf_p = (pic.cbf[0][nys, nxs].astype(np.int64)
                 >> pic.tr_idx[nys, nxs]) & 1
        one = mk & ((cbf_q | cbf_p) > 0)
        out[one] = 1
        mv_rem = rem & ~one
        if mv_rem.any():
            i = np.nonzero(mv_rem)[0]
            NONE = -(10 ** 9) - 7
            def refs(ys, xs):
                r = np.stack([np.where(pic.ref_idx[lx, ys, xs] >= 0,
                                       pic.ref_poc[lx, ys, xs], NONE)
                              for lx in range(2)])
                return r
            rp = refs(nys[i], nxs[i])
            rq = refs(eys[i], exs[i])
            mvp = np.stack([np.where((pic.ref_idx[lx, nys[i], nxs[i]] >= 0)[:, None],
                                     pic.mv[lx, nys[i], nxs[i]], 0)
                            for lx in range(2)]).astype(np.int64)
            mvq = np.stack([np.where((pic.ref_idx[lx, eys[i], exs[i]] >= 0)[:, None],
                                     pic.mv[lx, eys[i], exs[i]], 0)
                            for lx in range(2)]).astype(np.int64)

            def far(a, b):
                return (np.abs(a[..., 0] - b[..., 0]) >= 4) | \
                       (np.abs(a[..., 1] - b[..., 1]) >= 4)
            same_sets = ((rp[0] == rq[0]) & (rp[1] == rq[1])) | \
                        ((rp[0] == rq[1]) & (rp[1] == rq[0]))
            distinct = rp[0] != rp[1]
            straight = rp[0] == rq[0]
            f00 = far(mvq[0], mvp[0]); f11 = far(mvq[1], mvp[1])
            f10 = far(mvq[1], mvp[0]); f01 = far(mvq[0], mvp[1])
            v_distinct = np.where(straight, f00 | f11, f10 | f01)
            v_same = (f00 | f11) & (f10 | f01)
            v = np.where(same_sets,
                         np.where(distinct, v_distinct, v_same), True)
            out[i] = v.astype(np.int8)
    bs[eys, exs] = out
    return bs


def deblock_picture(pic: PictureState):
    dis, beta_off, tc_off, _ = _slice_flags(pic)
    for direction in (EDGE_VER, EDGE_HOR):
        edge, marker = build_edge_masks_vec(pic, direction)
        bs = compute_bs_vec(pic, direction, edge, marker)
        _filter_luma_vec(pic, direction, bs, beta_off, tc_off)
        if pic.num_comps > 1:
            _filter_chroma_vec(pic, direction, bs, tc_off)


def _edge_nofilter(pic, pys, pxs):
    """Vectorized _no_filter_flags over part coordinate arrays."""
    out = np.zeros(len(pys), dtype=bool)
    if pic.sps.pcm_enabled and pic.sps.pcm_loop_filter_disabled:
        out |= pic.ipcm[pys, pxs].astype(bool)
    if pic.pps.transquant_bypass_enabled:
        out |= pic.tqb[pys, pxs].astype(bool)
    return out


def _filter_luma_vec(pic: PictureState, direction, bs, beta_off, tc_off):
    """Vectorized luma deblock: all 4-line edge segments of one direction
    filtered at once (numpy).  Bit-exact dual of _filter_luma; edges on the
    8-px grid never overlap within a pass, so scatter writes are safe."""
    rec = pic.rec[0]
    bd = pic.sps.bit_depth_luma
    bd_scale = 1 << (bd - 8)
    max_val = (1 << bd) - 1
    valid_h, valid_w = pic.h // 4, pic.w // 4
    b = bs[:valid_h, :valid_w].astype(np.int64)
    sel = b > 0
    if direction == EDGE_VER:
        sel[:, 1::2] = False
        sel[:, 0] = False
    else:
        sel[1::2, :] = False
        sel[0, :] = False
    pys, pxs = np.nonzero(sel)
    if len(pys) == 0:
        return
    bval = b[pys, pxs]
    sl = pic.slice_id[pys, pxs]
    if direction == EDGE_VER:
        nys, nxs = pys, pxs - 1
    else:
        nys, nxs = pys - 1, pxs
    qp = (pic.qp[nys, nxs].astype(np.int64) + pic.qp[pys, pxs] + 1) >> 1
    idx_tc = np.clip(qp + 2 * (bval - 1) + (tc_off[sl] << 1), 0, 53)
    idx_b = np.clip(qp + (beta_off[sl] << 1), 0, 51)
    tc = TC_TABLE[idx_tc] * bd_scale
    beta = BETA_TABLE[idx_b] * bd_scale
    keep = ~((beta == 0) & (tc == 0))
    pys, pxs, nys, nxs = pys[keep], pxs[keep], nys[keep], nxs[keep]
    tc, beta, sl = tc[keep], beta[keep], sl[keep]
    if len(pys) == 0:
        return
    no_p = _edge_nofilter(pic, nys, nxs)
    no_q = _edge_nofilter(pic, pys, pxs)
    from hevcref import native
    lib = native.get_dsp()
    if lib is not None and hasattr(lib, "deblock_luma_edges") and \
            rec.dtype == np.int32 and rec.flags.c_contiguous:
        # keep the marshalled arrays referenced through the call
        a_y = np.ascontiguousarray(pys * 4, dtype=np.int32)
        a_x = np.ascontiguousarray(pxs * 4, dtype=np.int32)
        a_tc = np.ascontiguousarray(tc, dtype=np.int64)
        a_b = np.ascontiguousarray(beta, dtype=np.int64)
        a_np = np.ascontiguousarray(no_p, dtype=np.uint8)
        a_nq = np.ascontiguousarray(no_q, dtype=np.uint8)
        lib.deblock_luma_edges(
            rec.ctypes.data, rec.shape[1], len(pys),
            a_y.ctypes.data, a_x.ctypes.data, a_tc.ctypes.data,
            a_b.ctypes.data, a_np.ctypes.data, a_nq.ctypes.data,
            0 if direction == EDGE_VER else 1, bd)
        return
    e = len(pys)
    y0, x0 = pys * 4, pxs * 4
    # patch[e, line, k] = sample at distance k-4 from the edge on `line`
    lines = np.arange(4)
    ks = np.arange(-4, 4)
    if direction == EDGE_VER:
        ri = y0[:, None, None] + lines[None, :, None]
        ci = x0[:, None, None] + ks[None, None, :]
    else:
        # [e, line, k] = rec[y0 + k - 4, x0 + line]
        ri = y0[:, None, None] + ks[None, None, :]
        ci = x0[:, None, None] + lines[None, :, None]
    patch = rec[ri, ci].astype(np.int64)
    m = [patch[:, :, i] for i in range(8)]        # m0..m7 per (e, line)

    dp_ = np.abs(patch[:, :, 1] - 2 * patch[:, :, 2] + patch[:, :, 3])
    dq_ = np.abs(patch[:, :, 4] - 2 * patch[:, :, 5] + patch[:, :, 6])
    dp0, dp3 = dp_[:, 0], dp_[:, 3]
    dq0, dq3 = dq_[:, 0], dq_[:, 3]
    d0, d3 = dp0 + dq0, dp3 + dq3
    d = d0 + d3
    act = d < beta
    no_p = _edge_nofilter(pic, nys, nxs)
    no_q = _edge_nofilter(pic, pys, pxs)
    side_thresh = (beta + (beta >> 1)) >> 3
    filter_p = (dp0 + dp3) < side_thresh
    filter_q = (dq0 + dq3) < side_thresh

    def strong_line(line, dd):
        return ((np.abs(patch[:, line, 0] - patch[:, line, 3])
                 + np.abs(patch[:, line, 7] - patch[:, line, 4]))
                < (beta >> 3)) & (dd < (beta >> 2)) & \
            (np.abs(patch[:, line, 3] - patch[:, line, 4])
             < ((tc * 5 + 1) >> 1))
    sw = strong_line(0, 2 * d0) & strong_line(3, 2 * d3)

    tcl = tc[:, None]
    out = patch.copy()
    # strong filter (6 outputs)
    sres = {
        3: np.clip((m[1] + 2*m[2] + 2*m[3] + 2*m[4] + m[5] + 4) >> 3,
                   m[3] - 2*tcl, m[3] + 2*tcl),
        4: np.clip((m[2] + 2*m[3] + 2*m[4] + 2*m[5] + m[6] + 4) >> 3,
                   m[4] - 2*tcl, m[4] + 2*tcl),
        2: np.clip((m[1] + m[2] + m[3] + m[4] + 2) >> 2,
                   m[2] - 2*tcl, m[2] + 2*tcl),
        5: np.clip((m[3] + m[4] + m[5] + m[6] + 2) >> 2,
                   m[5] - 2*tcl, m[5] + 2*tcl),
        1: np.clip((2*m[0] + 3*m[1] + m[2] + m[3] + m[4] + 4) >> 3,
                   m[1] - 2*tcl, m[1] + 2*tcl),
        6: np.clip((m[3] + m[4] + m[5] + 3*m[6] + 2*m[7] + 4) >> 3,
                   m[6] - 2*tcl, m[6] + 2*tcl),
    }
    # weak filter
    delta = (9 * (m[4] - m[3]) - 3 * (m[5] - m[2]) + 8) >> 4
    wact = np.abs(delta) < (tcl * 10)
    dclip = np.clip(delta, -tcl, tcl)
    w3 = np.clip(m[3] + dclip, 0, max_val)
    w4 = np.clip(m[4] - dclip, 0, max_val)
    tc2 = tcl >> 1
    d1 = np.clip((((m[1] + m[3] + 1) >> 1) - m[2] + dclip) >> 1, -tc2, tc2)
    w2 = np.clip(m[2] + d1, 0, max_val)
    d2 = np.clip((((m[6] + m[4] + 1) >> 1) - m[5] - dclip) >> 1, -tc2, tc2)
    w5 = np.clip(m[5] + d2, 0, max_val)

    swl = sw[:, None]
    actl = act[:, None]
    fpl = filter_p[:, None]
    fql = filter_q[:, None]
    for k in range(1, 7):
        strong_v = sres[k]
        if k == 3:
            weak_v = np.where(wact, w3, m[3])
        elif k == 4:
            weak_v = np.where(wact, w4, m[4])
        elif k == 2:
            weak_v = np.where(wact & fpl, w2, m[2])
        elif k == 5:
            weak_v = np.where(wact & fql, w5, m[5])
        else:
            weak_v = m[k]
        v = np.where(swl, strong_v, weak_v)
        v = np.where(actl, v, m[k])
        if k < 4:
            v = np.where(no_p[:, None], m[k], v)
        else:
            v = np.where(no_q[:, None], m[k], v)
        out[:, :, k] = v
    rec[ri, ci] = out


def _filter_chroma_vec(pic: PictureState, direction, bs, tc_off):
    """Vectorized chroma deblock (dual of _filter_chroma)."""
    sx, sy = pic.comp_shift[1]
    bd = pic.sps.bit_depth_chroma
    bd_scale = 1 << (bd - 8)
    max_val = (1 << bd) - 1
    fmt = pic.sps.chroma_format_idc
    valid_h, valid_w = pic.h // 4, pic.w // 4
    b = bs[:valid_h, :valid_w].astype(np.int64)
    align = (8 << (sx if direction == EDGE_VER else sy)) // 4
    sel = b > 1
    if direction == EDGE_VER:
        mask = np.zeros(valid_w, dtype=bool)
        mask[0::align] = True
        mask[0] = False
        sel &= mask[None, :]
    else:
        mask = np.zeros(valid_h, dtype=bool)
        mask[0::align] = True
        mask[0] = False
        sel &= mask[:, None]
    pys, pxs = np.nonzero(sel)
    if len(pys) == 0:
        return
    bval = b[pys, pxs]
    sl = pic.slice_id[pys, pxs]
    if direction == EDGE_VER:
        nys, nxs = pys, pxs - 1
    else:
        nys, nxs = pys - 1, pxs
    qp_p = pic.qp[nys, nxs].astype(np.int64)
    qp_q = pic.qp[pys, pxs].astype(np.int64)
    no_p = _edge_nofilter(pic, nys, nxs)
    no_q = _edge_nofilter(pic, pys, pxs)
    n_lines = (4 >> sy) if direction == EDGE_VER else (4 >> sx)
    lines = np.arange(n_lines)
    ks = np.arange(-2, 2)
    for comp in (1, 2):
        rec = pic.rec[comp]
        off = pic.pps.cb_qp_offset if comp == 1 else pic.pps.cr_qp_offset
        qp = ((qp_p + qp_q + 1) >> 1) + off
        qpc = qp.copy()
        hi = qp >= 58
        qpc[hi] = (qp[hi] - 6) if fmt == 1 else np.minimum(qp[hi], 51)
        mid = (~hi) & (qp >= 0)
        qpc[mid] = CHROMA_QP_SCALE[fmt][qp[mid]]
        idx_tc = np.clip(qpc + 2 * (bval - 1) + (tc_off[sl] << 1), 0, 53)
        tc = TC_TABLE[idx_tc] * bd_scale
        keep = tc != 0
        if not keep.any():
            continue
        kp_pys, kp_pxs = pys[keep], pxs[keep]
        ktc = tc[keep][:, None]
        knp = no_p[keep][:, None]
        knq = no_q[keep][:, None]
        cx0 = (kp_pxs * 4) >> sx
        cy0 = (kp_pys * 4) >> sy
        from hevcref import native
        lib = native.get_dsp()
        if lib is not None and hasattr(lib, "deblock_chroma_edges") and \
                rec.dtype == np.int32 and rec.flags.c_contiguous:
            a_y = np.ascontiguousarray(cy0, dtype=np.int32)
            a_x = np.ascontiguousarray(cx0, dtype=np.int32)
            a_tc = np.ascontiguousarray(tc[keep], dtype=np.int64)
            a_np = np.ascontiguousarray(no_p[keep], np.uint8)
            a_nq = np.ascontiguousarray(no_q[keep], np.uint8)
            lib.deblock_chroma_edges(
                rec.ctypes.data, rec.shape[1], len(kp_pys),
                a_y.ctypes.data, a_x.ctypes.data, a_tc.ctypes.data,
                a_np.ctypes.data, a_nq.ctypes.data,
                int(n_lines), 0 if direction == EDGE_VER else 1, bd)
            continue
        if direction == EDGE_VER:
            ri = cy0[:, None, None] + lines[None, :, None]
            ci = cx0[:, None, None] + ks[None, None, :]
        else:
            ri = cy0[:, None, None] + ks[None, None, :]
            ci = cx0[:, None, None] + lines[None, :, None]
        patch = rec[ri, ci].astype(np.int64)
        m2, m3 = patch[:, :, 0], patch[:, :, 1]
        m4, m5 = patch[:, :, 2], patch[:, :, 3]
        delta = np.clip((((m4 - m3) << 2) + m2 - m5 + 4) >> 3, -ktc, ktc)
        new_p = np.where(knp, m3, np.clip(m3 + delta, 0, max_val))
        new_q = np.where(knq, m4, np.clip(m4 - delta, 0, max_val))
        out = patch.copy()
        out[:, :, 1] = new_p
        out[:, :, 2] = new_q
        rec[ri, ci] = out


def _filter_luma(pic: PictureState, direction, bs, beta_off, tc_off):
    rec = pic.rec[0]
    bd = pic.sps.bit_depth_luma
    bd_scale = 1 << (bd - 8)
    max_val = (1 << bd) - 1
    ph, pw = bs.shape
    valid_h, valid_w = pic.h // 4, pic.w // 4
    # 8-aligned edges only
    for py in range(valid_h):
        for px in range(valid_w):
            if direction == EDGE_VER and (px % 2): continue
            if direction == EDGE_HOR and (py % 2): continue
            b = int(bs[py, px])
            if b == 0:
                continue
            sl = pic.slice_id[py, px]
            nx, ny = (px - 1, py) if direction == EDGE_VER else (px, py - 1)
            qp_q = int(pic.qp[py, px])
            qp_p = int(pic.qp[ny, nx])
            qp = (qp_p + qp_q + 1) >> 1
            idx_tc = _cl(qp + 2 * (b - 1) + (int(tc_off[sl]) << 1), 0, 53)
            idx_b = int(np.clip(qp + (int(beta_off[sl]) << 1), 0, 51))
            tc = int(TC_TABLE[idx_tc]) * bd_scale
            beta = int(BETA_TABLE[idx_b]) * bd_scale
            if beta == 0 and tc == 0:
                continue
            side_thresh = (beta + (beta >> 1)) >> 3
            thr_cut = tc * 10

            x0, y0 = px * 4, py * 4
            def get(line, k):
                # sample at distance k from edge (negative = P side)
                if direction == EDGE_VER:
                    return int(rec[y0 + line, x0 + k])
                return int(rec[y0 + k, x0 + line])
            def put(line, k, v):
                if direction == EDGE_VER:
                    rec[y0 + line, x0 + k] = v
                else:
                    rec[y0 + k, x0 + line] = v

            def dp(line):
                return abs(get(line, -3) - 2 * get(line, -2) + get(line, -1))
            def dq(line):
                return abs(get(line, 0) - 2 * get(line, 1) + get(line, 2))

            dp0, dq0, dp3, dq3 = dp(0), dq(0), dp(3), dq(3)
            d0, d3 = dp0 + dq0, dp3 + dq3
            d = d0 + d3
            if d >= beta:
                continue
            no_p = _no_filter_flags(pic, nx, ny)
            no_q = _no_filter_flags(pic, px, py)
            filter_p = (dp0 + dp3) < side_thresh
            filter_q = (dq0 + dq3) < side_thresh

            def strong(line, dd):
                return (abs(get(line, -4) - get(line, -1)) +
                        abs(get(line, 3) - get(line, 0))) < (beta >> 3) and \
                    dd < (beta >> 2) and \
                    abs(get(line, -1) - get(line, 0)) < ((tc * 5 + 1) >> 1)
            sw = strong(0, 2 * d0) and strong(3, 2 * d3)

            for line in range(4):
                m = [get(line, k) for k in range(-4, 4)]  # m[0..7] = m0..m7
                if sw:
                    res = {
                        -1: np.clip((m[1] + 2*m[2] + 2*m[3] + 2*m[4] + m[5] + 4) >> 3, m[3]-2*tc, m[3]+2*tc),
                        0: np.clip((m[2] + 2*m[3] + 2*m[4] + 2*m[5] + m[6] + 4) >> 3, m[4]-2*tc, m[4]+2*tc),
                        -2: np.clip((m[1] + m[2] + m[3] + m[4] + 2) >> 2, m[2]-2*tc, m[2]+2*tc),
                        1: np.clip((m[3] + m[4] + m[5] + m[6] + 2) >> 2, m[5]-2*tc, m[5]+2*tc),
                        -3: np.clip((2*m[0] + 3*m[1] + m[2] + m[3] + m[4] + 4) >> 3, m[1]-2*tc, m[1]+2*tc),
                        2: np.clip((m[3] + m[4] + m[5] + 3*m[6] + 2*m[7] + 4) >> 3, m[6]-2*tc, m[6]+2*tc),
                    }
                    for k, v in res.items():
                        put(line, k, int(v))
                else:
                    delta = (9 * (m[4] - m[3]) - 3 * (m[5] - m[2]) + 8) >> 4
                    if abs(delta) < thr_cut:
                        delta = _cl(delta, -tc, tc)
                        put(line, -1, _cl(m[3] + delta, 0, max_val))
                        put(line, 0, _cl(m[4] - delta, 0, max_val))
                        tc2 = tc >> 1
                        if filter_p:
                            d1 = _cl((((m[1] + m[3] + 1) >> 1) - m[2] + delta) >> 1, -tc2, tc2)
                            put(line, -2, _cl(m[2] + d1, 0, max_val))
                        if filter_q:
                            d2 = _cl((((m[6] + m[4] + 1) >> 1) - m[5] - delta) >> 1, -tc2, tc2)
                            put(line, 1, _cl(m[5] + d2, 0, max_val))
                if no_p:
                    for k in (-1, -2, -3):
                        put(line, k, m[4 + k])
                if no_q:
                    for k in (0, 1, 2):
                        put(line, k, m[4 + k])


def _filter_chroma(pic: PictureState, direction, bs, tc_off):
    sx, sy = pic.comp_shift[1]
    bd = pic.sps.bit_depth_chroma
    bd_scale = 1 << (bd - 8)
    max_val = (1 << bd) - 1
    fmt = pic.sps.chroma_format_idc
    ph, pw = bs.shape
    valid_h, valid_w = pic.h // 4, pic.w // 4
    # part grid alignment for chroma (8 chroma px): 420 -> every 4 parts
    align = (8 << (sx if direction == EDGE_VER else sy)) // 4
    pels_h = 4 >> sx   # chroma pels per part horizontally
    pels_v = 4 >> sy
    for py in range(valid_h):
        for px in range(valid_w):
            if direction == EDGE_VER:
                if px % align: continue
            else:
                if py % align: continue
            b = int(bs[py, px])
            if b <= 1:
                continue
            sl = pic.slice_id[py, px]
            nx, ny = (px - 1, py) if direction == EDGE_VER else (px, py - 1)
            qp_q = int(pic.qp[py, px])
            qp_p = int(pic.qp[ny, nx])
            no_p = _no_filter_flags(pic, nx, ny)
            no_q = _no_filter_flags(pic, px, py)
            for comp in (1, 2):
                rec = pic.rec[comp]
                off = pic.pps.cb_qp_offset if comp == 1 else pic.pps.cr_qp_offset
                qp = ((qp_p + qp_q + 1) >> 1) + off
                if qp >= 58:
                    qp = qp - 6 if fmt == 1 else min(qp, 51)
                elif qp >= 0:
                    qp = int(CHROMA_QP_SCALE[fmt][qp])
                idx_tc = _cl(qp + 2 * (b - 1) + (int(tc_off[sl]) << 1), 0, 53)
                tc = int(TC_TABLE[idx_tc]) * bd_scale
                if tc == 0:
                    continue
                cx0 = (px * 4) >> sx
                cy0 = (py * 4) >> sy
                n_lines = pels_v if direction == EDGE_VER else pels_h
                for line in range(n_lines):
                    if direction == EDGE_VER:
                        yy, xx = cy0 + line, cx0
                        m2, m3 = int(rec[yy, xx-2]), int(rec[yy, xx-1])
                        m4, m5 = int(rec[yy, xx]), int(rec[yy, xx+1])
                    else:
                        yy, xx = cy0, cx0 + line
                        m2, m3 = int(rec[yy-2, xx]), int(rec[yy-1, xx])
                        m4, m5 = int(rec[yy, xx]), int(rec[yy+1, xx])
                    delta = _cl((((m4 - m3) << 2) + m2 - m5 + 4) >> 3, -tc, tc)
                    new_p = _cl(m3 + delta, 0, max_val)
                    new_q = _cl(m4 - delta, 0, max_val)
                    if no_p:
                        new_p = m3
                    if no_q:
                        new_q = m4
                    if direction == EDGE_VER:
                        rec[yy, xx-1] = new_p
                        rec[yy, xx] = new_q
                    else:
                        rec[yy-1, xx] = new_p
                        rec[yy, xx] = new_q

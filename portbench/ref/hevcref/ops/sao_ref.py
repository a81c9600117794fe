"""SAO application, decode side (spec 8.7.3; HM TComSampleAdaptiveOffset.cpp
offsetBlock :309 / offsetCTU :542).

The per-pixel edge classification is expressed with vectorized numpy over
each CTU block, reading from a snapshot of the deblocked picture (SAO input
must not see SAO output).
"""

from __future__ import annotations

import numpy as np

from hevcref.decode.picture import PictureState

SAO_EO_0, SAO_EO_90, SAO_EO_135, SAO_EO_45, SAO_BO = 0, 1, 2, 3, 4

# neighbor deltas for each EO class
_EO_NEIGHBORS = {
    SAO_EO_0: ((0, -1), (0, 1)),
    SAO_EO_90: ((-1, 0), (1, 0)),
    SAO_EO_135: ((-1, -1), (1, 1)),
    SAO_EO_45: ((-1, 1), (1, -1)),
}


def _ctu_avail(pic: PictureState, cx, cy, dx, dy):
    nx, ny = cx + dx, cy + dy
    if nx < 0 or ny < 0 or nx >= pic.w_ctbs or ny >= pic.h_ctbs:
        return False
    parts = pic.ctb // 4
    sl_a = pic.slice_id[cy * parts, cx * parts]
    sl_b = pic.slice_id[ny * parts, nx * parts]
    if sl_b < 0:
        return False
    if sl_a != sl_b:
        sh_a = pic.slices[sl_a]
        sh_b = pic.slices[sl_b]
        if not (sh_a.loop_filter_across_slices and sh_b.loop_filter_across_slices):
            return False
    if not pic.pps.loop_filter_across_tiles and \
            pic.tiles.tile_of_ctu[cy, cx] != pic.tiles.tile_of_ctu[ny, nx]:
        return False
    return True


def sao_picture(pic: PictureState):
    src = [p.copy() for p in pic.rec]
    from hevcref import native
    lib = native.get_dsp()
    native_ok = lib is not None and hasattr(lib, "sao_apply_ctu")
    for cy in range(pic.h_ctbs):
        for cx in range(pic.w_ctbs):
            ctu_rs = cy * pic.w_ctbs + cx
            avail = {(dy, dx): _ctu_avail(pic, cx, cy, dx, dy)
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)}
            for comp in range(pic.num_comps):
                mode = int(pic.sao_mode[ctu_rs, comp])
                if mode == 0:
                    continue
                if native_ok and _sao_ctu_native(pic, src, ctu_rs, cx, cy,
                                                 comp, avail, lib):
                    continue
                _sao_ctu_comp(pic, src, ctu_rs, cx, cy, comp, avail)


def _sao_ctu_native(pic, src, ctu_rs, cx, cy, comp, avail, lib) -> bool:
    """dsp_core.sao_apply_ctu fast path (bit-exact twin of
    _sao_ctu_comp; 1x1 regions keep the numpy path — the row-rule
    precedence differs there)."""
    sx, sy = pic.comp_shift[comp]
    x0 = (cx * pic.ctb) >> sx
    y0 = (cy * pic.ctb) >> sy
    w = min(pic.ctb >> sx, (pic.w >> sx) - x0)
    h = min(pic.ctb >> sy, (pic.h >> sy) - y0)
    if w <= 1 or h <= 1:
        return False
    s = src[comp]
    r = pic.rec[comp]
    if s.dtype != np.int32 or r.dtype != np.int32 or \
            not s.flags.c_contiguous or not r.flags.c_contiguous:
        return False
    bd = pic.sps.bit_depth_luma if comp == 0 else pic.sps.bit_depth_chroma
    offs4 = np.ascontiguousarray(pic.sao_offsets[ctu_rs, comp],
                                 dtype=np.int32)
    mask = (int(avail[(0, -1)]) | (int(avail[(0, 1)]) << 1)
            | (int(avail[(-1, 0)]) << 2) | (int(avail[(1, 0)]) << 3)
            | (int(avail[(-1, -1)]) << 4) | (int(avail[(-1, 1)]) << 5)
            | (int(avail[(1, -1)]) << 6) | (int(avail[(1, 1)]) << 7))
    lib.sao_apply_ctu(
        s.ctypes.data, s.shape[1], s.shape[0], s.shape[1],
        r.ctypes.data, r.shape[1], x0, y0, w, h, bd,
        int(pic.sao_type[ctu_rs, comp]), offs4.ctypes.data,
        int(pic.sao_band[ctu_rs, comp]), mask)
    return True


def _sao_ctu_comp(pic, src, ctu_rs, cx, cy, comp, avail):
    sx, sy = pic.comp_shift[comp]
    bd = pic.sps.bit_depth_luma if comp == 0 else pic.sps.bit_depth_chroma
    max_val = (1 << bd) - 1
    x0 = (cx * pic.ctb) >> sx
    y0 = (cy * pic.ctb) >> sy
    w = min(pic.ctb >> sx, (pic.w >> sx) - x0)
    h = min(pic.ctb >> sy, (pic.h >> sy) - y0)
    if w <= 0 or h <= 0:
        return
    s = src[comp]
    r = pic.rec[comp]
    type_idx = int(pic.sao_type[ctu_rs, comp])
    offs4 = pic.sao_offsets[ctu_rs, comp]

    if type_idx == SAO_BO or type_idx == 4:
        band = int(pic.sao_band[ctu_rs, comp])
        table = np.zeros(32, dtype=np.int64)
        for i in range(4):
            table[(band + i) % 32] = offs4[i]
        shift = bd - 5
        blk = s[y0:y0 + h, x0:x0 + w]
        r[y0:y0 + h, x0:x0 + w] = np.clip(blk + table[blk >> shift], 0, max_val)
        return

    # EO
    offsets5 = np.array([offs4[0], offs4[1], 0, offs4[2], offs4[3]],
                        dtype=np.int64)
    y0, x0, h, w, proc, edge_type, cur = _eo_classify(
        pic, s, cx, cy, comp, type_idx, avail)
    out = np.clip(cur + offsets5[edge_type], 0, max_val)
    blk = r[y0:y0 + h, x0:x0 + w]
    blk[proc] = out[proc]


def _eo_classify(pic, s, cx, cy, comp, type_idx, avail):
    """Edge-offset classification for one CTU component: returns region
    origin/size, the processable-pixel mask (CTU/picture-boundary rules)
    and the per-pixel edge type (0..4).  Shared by the decode-side apply
    and the encoder's statistics collection."""
    sx, sy = pic.comp_shift[comp]
    x0 = (cx * pic.ctb) >> sx
    y0 = (cy * pic.ctb) >> sy
    w = min(pic.ctb >> sx, (pic.w >> sx) - x0)
    h = min(pic.ctb >> sy, (pic.h >> sy) - y0)
    (d1y, d1x), (d2y, d2x) = _EO_NEIGHBORS[type_idx]
    plane_h, plane_w = s.shape
    # processable region limits based on neighbor availability
    x_lo, x_hi = 0, w       # [x_lo, x_hi)
    y_lo, y_hi = 0, h
    left = avail[(0, -1)]; right = avail[(0, 1)]
    above = avail[(-1, 0)]; below = avail[(1, 0)]
    al = avail[(-1, -1)]; ar = avail[(-1, 1)]
    bl = avail[(1, -1)]; br = avail[(1, 1)]

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    proc = np.ones((h, w), dtype=bool)
    if type_idx == SAO_EO_0:
        if not left: proc[:, 0] = False
        if not right: proc[:, w - 1:] = False
    elif type_idx == SAO_EO_90:
        if not above: proc[0, :] = False
        if not below: proc[h - 1:, :] = False
    elif type_idx == SAO_EO_135:
        if not left: proc[1:h - 1, 0] = False
        if not right: proc[1:h - 1, w - 1:] = False
        # first row
        proc[0, :] = False
        fs = 0 if al else 1
        fe = (w if right else w - 1) if above else 1
        proc[0, fs:fe] = True
        # last row
        proc[h - 1, :] = False
        ls = (0 if left else 1) if below else w - 1
        le = w if br else w - 1
        proc[h - 1, ls:le] = True
    else:  # EO_45
        if not left: proc[1:h - 1, 0] = False
        if not right: proc[1:h - 1, w - 1:] = False
        proc[0, :] = False
        fs = (0 if left else 1) if above else w - 1
        fe = w if ar else w - 1
        proc[0, fs:fe] = True
        proc[h - 1, :] = False
        ls = 0 if bl else 1
        le = (w if right else w - 1) if below else 1
        proc[h - 1, ls:le] = True

    gy, gx = ys + y0, xs + x0
    n1y, n1x = gy + d1y, gx + d1x
    n2y, n2x = gy + d2y, gx + d2x
    inb = (n1y >= 0) & (n1y < plane_h) & (n1x >= 0) & (n1x < plane_w) & \
          (n2y >= 0) & (n2y < plane_h) & (n2x >= 0) & (n2x < plane_w)
    proc &= inb
    cur = s[gy, gx].astype(np.int64)
    v1 = s[np.clip(n1y, 0, plane_h - 1), np.clip(n1x, 0, plane_w - 1)].astype(np.int64)
    v2 = s[np.clip(n2y, 0, plane_h - 1), np.clip(n2x, 0, plane_w - 1)].astype(np.int64)
    edge_type = np.sign(cur - v1) + np.sign(cur - v2) + 2
    return y0, x0, h, w, proc, edge_type, cur

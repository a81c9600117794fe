"""Reference-exact intra prediction (spec 8.4.4.2; HM TComPattern.cpp:107-530,
TComPrediction.cpp:120-440,746-835).

Operates on numpy int arrays.  The batched TPU path in hevcref.ops.intra
reuses the same per-mode math on dense candidate tensors; this module is the
scalar oracle and the decoder's recon path.

Reference line layout: ref[0] = top-left, ref[1..2W] = top row (left->right),
left column stored separately as left[1..2H] (top->bottom).
"""

from __future__ import annotations

import numpy as np

from hevcref.common.tables import ANG_TABLE, INV_ANG_TABLE

PLANAR_IDX, DC_IDX, HOR_IDX, VER_IDX, DM_CHROMA_IDX = 0, 1, 10, 26, 36

# [1 2 1] smoothing thresholds per log2(size)-2 (TComPrediction.cpp:49-63)
INTRA_FILTER_THRESHOLD = [10, 7, 1, 0, 10]


def fill_reference_samples(rec: np.ndarray, x0: int, y0: int, tu_size: int,
                           unit_w: int, unit_h: int,
                           avail_fn, bit_depth: int):
    """Assemble the (2*size+1) top and left reference arrays with
    unavailable-sample substitution (fillReferenceSamples TComPattern.cpp:309).

    rec: full reconstructed plane (this component's sampling grid)
    x0, y0: TU origin in this plane; tu_size: square TU size
    avail_fn(ux, uy) -> bool: availability of the 4x4-unit containing plane
      sample (ux, uy) (already accounts for picture bounds, coding order,
      slice/tile, constrained intra)
    Returns (top, left): top[0..2S] with top[0]=corner; left[1..2S].
    """
    s = tu_size
    dc = 1 << (bit_depth - 1)
    n_left_units = (2 * s) // unit_h
    n_above_units = (2 * s) // unit_w
    total_units = n_left_units + n_above_units + 1

    # availability per unit, ordered: below-left(bottom)..left(top), corner,
    # above(left)..above-right(right)  (bNeighborFlags layout)
    flags = np.zeros(total_units, dtype=bool)
    # left/below-left units: index 0 = bottom-most
    for j in range(n_left_units):
        uy = y0 + (n_left_units - 1 - j) * unit_h
        flags[j] = avail_fn(x0 - 1, uy)
    flags[n_left_units] = avail_fn(x0 - 1, y0 - 1)
    for j in range(n_above_units):
        ux = x0 + j * unit_w
        flags[n_left_units + 1 + j] = avail_fn(ux, y0 - 1)

    num_avail = int(flags.sum())
    top = np.full(2 * s + 1, dc, dtype=np.int64)
    left = np.full(2 * s + 1, dc, dtype=np.int64)
    h_plane, w_plane = rec.shape

    def sample(x, y):
        return int(rec[y, x])

    if num_avail == 0:
        return top, left
    if num_avail == total_units:
        for i in range(2 * s + 1):
            top[i] = sample(min(x0 - 1 + i, w_plane - 1), y0 - 1)
        for i in range(1, 2 * s + 1):
            left[i] = sample(x0 - 1, min(y0 - 1 + i, h_plane - 1))
        left[0] = top[0]
        return top, left

    # partial: line buffer bottom-left -> top-right in units
    total_samples = n_left_units * unit_h + (n_above_units + 1) * unit_w
    line = np.full(total_samples, dc, dtype=np.int64)
    # copy available samples
    # left/below-left: line index grows upward from bottom
    for j in range(n_left_units):
        if flags[j]:
            uy = y0 + (n_left_units - 1 - j) * unit_h
            for i in range(unit_h):
                yy = uy + unit_h - 1 - i
                line[j * unit_h + i] = sample(x0 - 1, min(yy, h_plane - 1))
    corner_base = n_left_units * unit_h
    if flags[n_left_units]:
        line[corner_base:corner_base + unit_w] = sample(x0 - 1, y0 - 1)
    for j in range(n_above_units):
        if flags[n_left_units + 1 + j]:
            base = corner_base + unit_w + j * unit_w
            for i in range(unit_w):
                xx = x0 + j * unit_w + i
                line[base + i] = sample(min(xx, w_plane - 1), y0 - 1)

    # pad: first find first available unit if unit 0 missing
    def unit_base(u):
        return u * unit_h if u < n_left_units else \
            corner_base + (u - n_left_units) * unit_w

    def unit_len(u):
        return unit_h if u < n_left_units else unit_w

    if not flags[0]:
        nxt = 1
        while nxt < total_units and not flags[nxt]:
            nxt += 1
        ref_sample = line[unit_base(nxt)]
        for u in range(nxt):
            b = unit_base(u)
            line[b:b + unit_len(u)] = ref_sample
        start = nxt
    else:
        start = 0
    for u in range(start, total_units):
        if not flags[u]:
            b = unit_base(u)
            line[b:b + unit_len(u)] = line[b - 1]

    # unpack: top[i] = line[2S + unit_w - 1 + i]? HM: piAdiLineTemp =
    # piAdiLine + uiHeight + unitWidth - 2 with uiHeight = 2S+1
    off = (2 * s + 1) + unit_w - 2
    for i in range(2 * s + 1):
        top[i] = line[off + i]
    off = (2 * s + 1) - 1
    for i in range(1, 2 * s + 1):
        left[i] = line[off - i]
    left[0] = top[0]
    return top, left


def filter_reference_samples(top: np.ndarray, left: np.ndarray, tu_size: int,
                             bit_depth: int, strong_enabled: bool):
    """[1 2 1] smoothing, or strong bilinear interpolation for 32x32
    (TComPattern.cpp:344-460)."""
    s = tu_size
    top_f = top.copy()
    left_f = left.copy()
    bottom_left = int(left[2 * s])
    top_left = int(top[0])
    top_right = int(top[2 * s])
    strong = False
    if strong_enabled and s == 32:
        threshold = 1 << (bit_depth - 5)
        bilinear_left = abs((bottom_left + top_left) - 2 * int(left[s])) < threshold
        bilinear_above = abs((top_left + top_right) - 2 * int(top[s])) < threshold
        strong = bilinear_left and bilinear_above
    if strong:
        shift = (s.bit_length() - 1) + 1   # log2(2s)
        i = np.arange(1, 2 * s)
        left_f[1:2 * s] = ((2 * s - i) * top_left + i * bottom_left + s) >> shift
        top_f[1:2 * s] = ((2 * s - i) * top_left + i * top_right + s) >> shift
        # ends unfiltered; top-left stays
    else:
        left_f[1:2 * s] = (left[2:] + 2 * left[1:2 * s] + left[:2 * s - 1] + 2) >> 2
        top_f[1:2 * s] = (top[2:] + 2 * top[1:2 * s] + top[:2 * s - 1] + 2) >> 2
        corner = (left[1] + 2 * top[0] + top[1] + 2) >> 2
        top_f[0] = corner
        left_f[0] = corner
    return top_f, left_f


def should_filter(mode: int, tu_size: int, is_luma: bool,
                  chroma_format_idc: int = 1,
                  smoothing_disabled: bool = False) -> bool:
    """filteringIntraReferenceSamples (TComPattern.cpp:530-556)."""
    if smoothing_disabled:
        return False
    if not is_luma and chroma_format_idc != 3:
        return False
    if mode == DC_IDX:
        return False
    size_idx = tu_size.bit_length() - 3   # log2-2
    diff = min(abs(mode - HOR_IDX), abs(mode - VER_IDX))
    return diff > INTRA_FILTER_THRESHOLD[size_idx]


def predict_intra(mode: int, top: np.ndarray, left: np.ndarray, size: int,
                  bit_depth: int, is_luma: bool,
                  enable_edge_filters: bool = True) -> np.ndarray:
    """Produce the (size, size) prediction block for one of the 35 modes."""
    s = size
    if mode == PLANAR_IDX:
        return _pred_planar(top, left, s)
    if mode == DC_IDX:
        return _pred_dc(top, left, s, bit_depth, is_luma, enable_edge_filters)
    return _pred_angular(mode, top, left, s, bit_depth, is_luma,
                         enable_edge_filters)


def _pred_planar(top, left, s):
    t = top[1:s + 1].astype(np.int64)
    l = left[1:s + 1].astype(np.int64)
    bottom_left = int(left[s + 1]) if s + 1 <= 2 * s else int(left[s])
    bottom_left = int(left[s + 1])
    top_right = int(top[s + 1])
    shift = s.bit_length() - 1   # log2(s)
    x = np.arange(s, dtype=np.int64)
    y = np.arange(s, dtype=np.int64)
    xx, yy = np.meshgrid(x, y)
    hor = (s - 1 - xx) * l[yy] + (xx + 1) * top_right
    ver = (s - 1 - yy) * t[xx] + (yy + 1) * bottom_left
    return (hor + ver + s) >> (shift + 1)


def _pred_dc(top, left, s, bit_depth, is_luma, edge_filters):
    dcval = (int(top[1:s + 1].sum()) + int(left[1:s + 1].sum()) + s) >> \
        ((s.bit_length() - 1) + 1)
    pred = np.full((s, s), dcval, dtype=np.int64)
    if is_luma and s <= 16:
        # DC filtering (xDCPredFiltering) — applied when above+left available;
        # after substitution both are treated available (HM passes true/true)
        pred[0, 0] = (int(top[1]) + int(left[1]) + 2 * dcval + 2) >> 2
        pred[0, 1:] = (top[2:s + 1] + 3 * dcval + 2) >> 2
        pred[1:, 0] = (left[2:s + 1] + 3 * dcval + 2) >> 2
    return pred


def _pred_angular(mode, top, left, s, bit_depth, is_luma, edge_filters):
    is_ver = mode >= 18
    ang_mode = (mode - VER_IDX) if is_ver else -(mode - HOR_IDX)
    abs_ang = int(ANG_TABLE[abs(ang_mode)])
    inv_angle = int(INV_ANG_TABLE[abs(ang_mode)])
    sign = -1 if ang_mode < 0 else 1
    angle = sign * abs_ang

    # build refMain/refSide arrays indexed -s..2s
    n = 4 * s + 2
    ref_main = np.zeros(n, dtype=np.int64)   # index offset s
    base = s
    if angle < 0:
        # main = above row (ver) or left col (hor), extended to the left
        main_src = top if is_ver else left
        side_src = left if is_ver else top
        for x in range(s + 1):
            ref_main[base + x] = main_src[x]
        inv_sum = 128
        k = -1
        while k > (s * angle) >> 5:
            inv_sum += inv_angle
            ref_main[base + k] = side_src[inv_sum >> 8]
            k -= 1
    else:
        main_src = top if is_ver else left
        for x in range(2 * s + 1):
            ref_main[base + x] = main_src[x]

    pred = np.zeros((s, s), dtype=np.int64)
    edge = edge_filters and is_luma and s <= 16
    if angle == 0:
        row = ref_main[base + 1: base + 1 + s]
        pred[:] = row[np.newaxis, :]
        if edge:
            side_src = left if is_ver else top
            ref0 = int(side_src[0])
            col = pred[:, 0] + ((side_src[1:s + 1] - ref0) >> 1)
            pred[:, 0] = np.clip(col, 0, (1 << bit_depth) - 1)
    else:
        for y in range(s):
            delta = (y + 1) * angle
            i_int = delta >> 5
            frac = delta & 31
            idx = base + 1 + i_int + np.arange(s)
            if frac:
                pred[y] = ((32 - frac) * ref_main[idx] + frac * ref_main[idx + 1]
                           + 16) >> 5
            else:
                pred[y] = ref_main[idx]
    if not is_ver:
        pred = pred.T.copy()
    # mode 2/34 do not have edge filtering in HEVC v1 (only 10/26 via angle==0)
    return pred

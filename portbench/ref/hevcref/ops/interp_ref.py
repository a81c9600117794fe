"""Motion-compensation interpolation (spec 8.5.4.2.2; HM
TComInterpolationFilter.cpp:94-383), numpy reference-exact.

IF_INTERNAL_PREC = 14, IF_FILTER_PREC = 6; intermediate (non-last) stages
keep 14-bit headroom with the internal offset subtracted.
"""

from __future__ import annotations

import numpy as np

from hevcref.common.tables import CHROMA_FILTER, LUMA_FILTER

IF_INTERNAL_PREC = 14
IF_FILTER_PREC = 6
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)


def _filter_1d(src, taps, axis, bit_depth, is_first, is_last):
    """Apply an FIR along axis; src already includes the (N/2-1)/(N/2) margin
    on that axis."""
    n = len(taps)
    head_room = max(2, IF_INTERNAL_PREC - bit_depth)
    shift = IF_FILTER_PREC
    if is_last:
        shift += 0 if is_first else head_room
        offset = 1 << (shift - 1)
        offset += 0 if is_first else (IF_INTERNAL_OFFS << IF_FILTER_PREC)
    else:
        shift -= head_room if is_first else 0
        offset = (-IF_INTERNAL_OFFS << shift) if is_first else 0
    src = src.astype(np.int64)
    out = np.zeros([s - n + 1 if a == axis else s
                    for a, s in enumerate(src.shape)], dtype=np.int64)
    for k in range(n):
        sl = [slice(None)] * src.ndim
        sl[axis] = slice(k, k + out.shape[axis])
        out += int(taps[k]) * src[tuple(sl)]
    out = (out + offset) >> shift
    if is_last:
        out = np.clip(out, 0, (1 << bit_depth) - 1)
    return out


def _copy_stage(src, bit_depth, is_first, is_last):
    if is_first == is_last:
        return src.astype(np.int64)
    shift = max(2, IF_INTERNAL_PREC - bit_depth)
    if is_first:
        return (src.astype(np.int64) << shift) - IF_INTERNAL_OFFS
    val = (src.astype(np.int64) + IF_INTERNAL_OFFS + (1 << (shift - 1))) >> shift
    return np.clip(val, 0, (1 << bit_depth) - 1)


def mc_block(ref_plane: np.ndarray, x0: int, y0: int, w: int, h: int,
             mv_x: int, mv_y: int, frac_bits_x: int, frac_bits_y: int,
             is_luma: bool, bit_depth: int, keep_precision: bool) -> np.ndarray:
    """Motion-compensated (w, h) block from ref_plane at (x0, y0) + mv.

    frac_bits: 2 for luma quarter-pel; 2 + chroma shift per axis for chroma.
    keep_precision: True for the bi-pred intermediate (14-bit internal).
    Out-of-picture reference samples use border replication (equivalent to
    the reference's picture-margin extension).

    Dispatches to the native twin (dsp_core mc_block_native) when the
    library is available; the numpy path below is the reference
    implementation and the fallback.
    """
    from hevcref import native
    lib = native.get_dsp()
    if lib is not None and ref_plane.dtype == np.int32 and \
            ref_plane.flags.c_contiguous:
        import ctypes
        out = np.empty((h, w), dtype=np.int32)
        lib.mc_block_native(
            ref_plane.ctypes.data_as(ctypes.c_void_p),
            ref_plane.strides[0] // 4, ref_plane.shape[0],
            ref_plane.shape[1], x0, y0, w, h, mv_x, mv_y,
            frac_bits_x, frac_bits_y, int(is_luma), bit_depth,
            int(keep_precision),
            out.ctypes.data_as(ctypes.c_void_p))
        return out.astype(np.int64)
    taps = LUMA_FILTER if is_luma else CHROMA_FILTER
    n = taps.shape[1]
    ix = x0 + (mv_x >> frac_bits_x)
    iy = y0 + (mv_y >> frac_bits_y)
    fx = mv_x & ((1 << frac_bits_x) - 1)
    fy = mv_y & ((1 << frac_bits_y) - 1)
    # chroma fraction index into the 1/8-pel table: scale 422's vertical
    # quarter fractions by 2 (HM xPredInterBlk yFrac scaling)
    tx = fx << (3 - frac_bits_x) if not is_luma else fx
    ty = fy << (3 - frac_bits_y) if not is_luma else fy

    ph, pw = ref_plane.shape
    half = n // 2 - 1
    ys = np.clip(np.arange(iy - half, iy + h + n - 1 - half), 0, ph - 1)
    xs = np.clip(np.arange(ix - half, ix + w + n - 1 - half), 0, pw - 1)
    win = ref_plane[np.ix_(ys, xs)]

    last = not keep_precision
    if fy == 0 and fx == 0:
        blk = win[half:half + h, half:half + w]
        return _copy_stage(blk, bit_depth, True, last)
    if fy == 0:
        rows = win[half:half + h, :]
        return _filter_1d(rows, taps[tx], 1, bit_depth, True, last)
    if fx == 0:
        cols = win[:, half:half + w]
        return _filter_1d(cols, taps[ty], 0, bit_depth, True, last)
    tmp = _filter_1d(win, taps[tx], 1, bit_depth, True, False)
    return _filter_1d(tmp, taps[ty], 0, bit_depth, False, last)


def bi_average(a: np.ndarray, b: np.ndarray, bit_depth: int) -> np.ndarray:
    """xWeightedAverage for default (non-WP) bi-prediction."""
    shift = IF_INTERNAL_PREC + 1 - bit_depth
    offset = (1 << (shift - 1)) + 2 * IF_INTERNAL_OFFS
    return np.clip((a + b + offset) >> shift, 0, (1 << bit_depth) - 1)

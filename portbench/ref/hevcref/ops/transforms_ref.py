"""Reference-exact (numpy int) transform + quantization kernels.

These are the scalar-golden implementations used to validate the batched
JAX/Pallas kernels in hevcref.ops.transforms.  Semantics follow the
normative inverse-transform path (spec 8.6.3-8.6.5; HM TComTrQuant.cpp:
xITrMxN :894, partialButterflyInverse* :468-835, xDeQuant :1203).

All stages operate on int64 arrays (no overflow possible at these widths);
results equal the reference's 32-bit int arithmetic exactly.
"""

from __future__ import annotations

import numpy as np

from hevcref.common.tables import DCT, DST4, INV_QUANT_SCALES, QUANT_SCALES

TRANSFORM_MATRIX_SHIFT = 6     # 6-bit matrices (default build)


def transform_shift(bit_depth: int, log2_tr_size: int,
                    max_tr_dynamic_range: int = 15) -> int:
    return max_tr_dynamic_range - bit_depth - log2_tr_size


def _clip(x, lo, hi):
    return np.clip(x, lo, hi)


def inverse_transform(coeffs: np.ndarray, bit_depth: int, use_dst: bool,
                      max_tr_dynamic_range: int = 15) -> np.ndarray:
    """2-D inverse transform of an (H, W) coefficient block -> residual.

    Stage 1 (vertical) result is clipped to the transform dynamic range,
    stage 2 (horizontal) to int16 (Pel protection), matching xITrMxN.
    """
    h, w = coeffs.shape
    c = coeffs.astype(np.int64)
    t_v = (DST4 if (use_dst and h == 4) else DCT[h])
    t_h = (DST4 if (use_dst and w == 4) else DCT[w])
    s1 = TRANSFORM_MATRIX_SHIFT + 1
    s2 = (TRANSFORM_MATRIX_SHIFT + max_tr_dynamic_range - 1) - bit_depth
    clip_min, clip_max = -(1 << max_tr_dynamic_range), (1 << max_tr_dynamic_range) - 1
    stage1 = _clip((t_v.T @ c + (1 << (s1 - 1))) >> s1, clip_min, clip_max)
    out = _clip((stage1 @ t_h + (1 << (s2 - 1))) >> s2, -32768, 32767)
    return out


def forward_transform(residual: np.ndarray, bit_depth: int, use_dst: bool,
                      max_tr_dynamic_range: int = 15) -> np.ndarray:
    """2-D forward transform (HM xTrMxN :836): horizontal then vertical."""
    h, w = residual.shape
    r = residual.astype(np.int64)
    t_v = (DST4 if (use_dst and h == 4) else DCT[h])
    t_h = (DST4 if (use_dst and w == 4) else DCT[w])
    log2w = w.bit_length() - 1
    log2h = h.bit_length() - 1
    # forward shifts (TComTrQuant.cpp:836-893): stage1 horizontal
    s1 = log2w - 1 + bit_depth - 8
    s2 = log2h + 6
    stage1 = (r @ t_h.T + ((1 << (s1 - 1)) if s1 > 0 else 0)) >> s1 if s1 > 0 \
        else (r @ t_h.T) << -s1
    out = (t_v @ stage1 + (1 << (s2 - 1))) >> s2
    return out


def dequant(qcoeffs: np.ndarray, qp: int, bit_depth: int, log2_tr_size: int,
            scaling_list_coeffs: np.ndarray | None = None,
            transform_skip: bool = False,
            max_tr_dynamic_range: int = 15) -> np.ndarray:
    """Dequantize an (H, W) level block (HM xDeQuant TComTrQuant.cpp:1203).

    scaling_list_coeffs: flat per-coefficient scales (already upsampled to
    this block size) or None for flat default.
    """
    per, rem = qp // 6, qp % 6
    tmin = -(1 << max_tr_dynamic_range)
    tmax = (1 << max_tr_dynamic_range) - 1
    iquant_shift = 6
    tshift = transform_shift(bit_depth, log2_tr_size, max_tr_dynamic_range)
    q = qcoeffs.astype(np.int64)

    if scaling_list_coeffs is None:
        right_shift = iquant_shift - (tshift + per)
        scale = int(INV_QUANT_SCALES[rem])
        scale_bits = iquant_shift + 1 + 1   # (IQUANT_SHIFT + 1) +1 sign
        target_bd = min(max_tr_dynamic_range + 1, 64 + right_shift - (iquant_shift + 1))
        imin, imax = -(1 << (target_bd - 1)), (1 << (target_bd - 1)) - 1
        cq = _clip(q, imin, imax)
        if right_shift > 0:
            out = (cq * scale + (1 << (right_shift - 1))) >> right_shift
        else:
            out = (cq * scale) << (-right_shift)
    else:
        right_shift = iquant_shift - (tshift + per) + 4   # LOG2_SCALING_LIST_NEUTRAL_VALUE
        dequant_coef_bits = 1 + iquant_shift + 8          # SCALING_LIST_BITS = 8
        target_bd = min(max_tr_dynamic_range + 1, 64 + right_shift - dequant_coef_bits)
        imin, imax = -(1 << (target_bd - 1)), (1 << (target_bd - 1)) - 1
        # per is accounted for in right_shift (xDeQuant); the dequant matrix
        # is scalingList * invQuantScale only
        dq = (scaling_list_coeffs.reshape(qcoeffs.shape).astype(np.int64)
              * int(INV_QUANT_SCALES[rem]))
        cq = _clip(q, imin, imax)
        if right_shift > 0:
            out = (cq * dq + (1 << (right_shift - 1))) >> right_shift
        else:
            out = (cq * dq) << (-right_shift)
    return _clip(out, tmin, tmax)


def inverse_transform_skip(coeffs: np.ndarray, bit_depth: int,
                           max_tr_dynamic_range: int = 15) -> np.ndarray:
    """Inverse transform-skip scaling (HM xITransformSkip :1920)."""
    h, w = coeffs.shape
    log2_tr = w.bit_length() - 1
    tshift = transform_shift(bit_depth, log2_tr, max_tr_dynamic_range)
    c = coeffs.astype(np.int64)
    if tshift > 0:
        offset = 1 << (tshift - 1)
        out = (c + offset) >> tshift
    else:
        out = c << (-tshift)
    return _clip(out, -32768, 32767)


def quant(coeffs: np.ndarray, qp: int, bit_depth: int, log2_tr_size: int,
          is_intra: bool, max_tr_dynamic_range: int = 15,
          lambda_scale: int | None = None,
          scaling_list_coeffs: np.ndarray | None = None) -> np.ndarray:
    """Plain (non-RDOQ) quantization (HM xQuant :1087).

    Rounding offset: 171/512 intra, 85/512 inter (HM default f).
    scaling_list_coeffs: flat per-coefficient scales (upsampled to this
    block size, DC substituted) or None for the flat default.  The
    per-coefficient quantiser is (quantScales << 4) / w, same q_bits
    (xSetScalingListEnc / processScalingListEnc, TComTrQuant.cpp:3062).
    """
    per, rem = qp // 6, qp % 6
    tshift = transform_shift(bit_depth, log2_tr_size, max_tr_dynamic_range)
    q_bits = 14 + per + tshift   # QUANT_SHIFT=14
    scale = int(QUANT_SCALES[rem])
    if scaling_list_coeffs is not None:
        scale = (scale << 4) // scaling_list_coeffs.reshape(
            coeffs.shape).astype(np.int64)
    add = (171 if is_intra else 85) << (q_bits - 9)
    c = coeffs.astype(np.int64)
    sign = np.where(c < 0, -1, 1)
    level = (np.abs(c) * scale + add) >> q_bits
    entropy_max = (1 << 15) - 1
    return _clip(sign * level, -32768, entropy_max)


SBH_THRESHOLD = 4


def sign_bit_hiding(levels: np.ndarray, coeffs: np.ndarray, qp: int,
                    bit_depth: int, log2_tr_size: int, scan: np.ndarray,
                    is_intra: bool = True) -> np.ndarray:
    """Encoder sign-data-hiding adjustment (signBitHidingHDQ,
    TComTrQuant.cpp:952-1086).  levels: quantized block (modified copy
    returned); coeffs: pre-quant transform coefficients; scan: raster
    positions in coding-scan order."""
    n = levels.shape[0]
    per, rem = qp // 6, qp % 6
    tshift = 15 - bit_depth - log2_tr_size
    q_bits = 14 + per + tshift
    scale = int(QUANT_SCALES[rem])
    lv = levels.ravel().copy()
    cf = coeffs.ravel()
    mag = np.abs(cf.astype(np.int64)) * scale
    deltaU = (mag - (np.abs(lv.astype(np.int64)) << q_bits)) >> (q_bits - 8)
    last_cg = -1
    for sub in range((n * n - 1) >> 4, -1, -1):
        pos = scan[sub * 16: sub * 16 + 16]
        vals = lv[pos]
        nz = np.nonzero(vals)[0]
        if len(nz) == 0:
            continue
        first_nz, last_nz = int(nz[0]), int(nz[-1])
        if last_cg == -1:
            last_cg = 1
        if last_nz - first_nz >= SBH_THRESHOLD:
            abs_sum = int(vals[first_nz:last_nz + 1].sum())
            signbit = 0 if vals[first_nz] > 0 else 1
            if signbit != (abs_sum & 1):
                best_cost, best_pos, best_chg = None, -1, 0
                rng = range(last_nz if last_cg == 1 else 15, -1, -1)
                for k in rng:
                    bp = int(pos[k])
                    q = int(lv[bp])
                    if q != 0:
                        if deltaU[bp] > 0:
                            cost, chg = -int(deltaU[bp]), 1
                        elif k == first_nz and abs(q) == 1:
                            cost, chg = None, 0
                        else:
                            cost, chg = int(deltaU[bp]), -1
                    elif k < first_nz:
                        if (0 if cf.ravel()[bp] >= 0 else 1) != signbit:
                            cost, chg = None, 0
                        else:
                            cost, chg = -int(deltaU[bp]), 1
                    else:
                        cost, chg = -int(deltaU[bp]), 1
                    if cost is not None and                             (best_cost is None or cost < best_cost):
                        best_cost, best_pos, best_chg = cost, bp, chg
                if best_pos >= 0:
                    if lv[best_pos] in (32767, -32768):
                        best_chg = -1
                    if cf[best_pos] >= 0:
                        lv[best_pos] += best_chg
                    else:
                        lv[best_pos] -= best_chg
        if last_cg == 1:
            last_cg = 0
    return lv.reshape(n, n)

"""Adaptive-QP preanalysis (TEncPreanalyzer.cpp:64-141, TM5 step 3).

Per-CTU spatial activity from the minimum of the four quadrant variances
(xPreanalyze computes per-AQ-unit 2x2 sub-block variances and takes
1 + min), then a logarithmic QP offset against the picture-average
activity, clipped to the adaptation range.  Vectorized over the whole
plane instead of the reference's per-sample loops.
"""

from __future__ import annotations

import numpy as np


def aq_offsets(y, ctb: int, pic_h: int, pic_w: int, strength: float = 1.0,
               qp_range: int = 6) -> np.ndarray:
    """(h_ctbs, w_ctbs) int QP offsets for one picture."""
    h_ctbs = (pic_h + ctb - 1) // ctb
    w_ctbs = (pic_w + ctb - 1) // ctb
    half = ctb // 2
    ph, pw = h_ctbs * ctb, w_ctbs * ctb
    yp = np.zeros((ph, pw), dtype=np.float64)
    yp[:pic_h, :pic_w] = y[:pic_h, :pic_w]
    # edge-replicate the padding so border CTUs don't see zeros
    yp[pic_h:, :pic_w] = yp[pic_h - 1: pic_h, :pic_w]
    yp[:, pic_w:] = yp[:, pic_w - 1: pic_w]
    # per half-CTU-block mean and variance
    b = yp.reshape(ph // half, half, pw // half, half)
    mean = b.mean(axis=(1, 3))
    var = (b * b).mean(axis=(1, 3)) - mean * mean
    # 1 + min of the four quadrant variances per CTU
    v = var.reshape(h_ctbs, 2, w_ctbs, 2).min(axis=(1, 3))
    act = 1.0 + v
    avg = float(act.mean())
    if avg <= 0:
        return np.zeros((h_ctbs, w_ctbs), dtype=np.int32)
    off = strength * (np.log2(act) - np.log2(avg))
    return np.clip(np.rint(off), -qp_range, qp_range).astype(np.int32)

"""Slice-level weighted-prediction parameter estimation.

DC/AC statistics of the current picture vs each reference, an LMS-style
weight/offset fit, and a SAD-based on/off check — the WHAT of HM's
WeightPredAnalysis.cpp (xCalcACDCParamSlice, xEstimateWPParamSlice,
xCheckWPEnable), computed with whole-plane numpy reductions instead of
the reference's per-sample loops.  Weights are an encoder choice
(non-normative); the shared decoder MC path applies them bit-exactly.
"""

from __future__ import annotations

import numpy as np

from hm16_2_tpu_torch.headers.params import B_SLICE, P_SLICE
from hm16_2_tpu_torch.headers.parse import PredWeight

LOG2_DENOM = 6


def _plane_dc_ac(p):
    n = p.size
    dc = int(p.sum())
    avg = dc // n
    ac = int(np.abs(p.astype(np.int64) - avg).sum())
    return dc, ac, n


def estimate_wp(sh, planes, ref_lists, sps, pps):
    """Fill sh.pred_weights / log2 denoms; returns True when any ref got
    an explicit weight (WP engaged)."""
    ncomp = 1 if sps.chroma_format_idc == 0 else 3
    sh.luma_log2_weight_denom = LOG2_DENOM
    sh.chroma_log2_weight_denom = LOG2_DENOM
    n_lists = 2 if sh.slice_type == B_SLICE else 1
    engaged = False
    cur_stats = [_plane_dc_ac(np.asarray(planes[c])) for c in range(ncomp)]
    for lx in range(n_lists):
        for r in range(min(sh.num_ref_idx[lx], len(ref_lists[lx]))):
            ref = ref_lists[lx][r]
            use_ref = False
            ws = {}
            for comp in range(ncomp):
                cur = np.asarray(planes[comp])
                rp = np.asarray(ref.rec[comp])[: cur.shape[0],
                                               : cur.shape[1]]
                dc_c, ac_c, num = cur_stats[comp]
                dc_r, ac_r, _ = _plane_dc_ac(rp)
                denom = 1 << LOG2_DENOM
                if ac_r <= 0:
                    w = denom
                else:
                    w = int(np.clip(round(ac_c * denom / ac_r), -128, 127))
                off = int(np.clip(round((dc_c - (w * dc_r) / denom) / num),
                                  -128, 127))
                default = (w == denom and off == 0)
                ws[comp] = (w, off, not default)
                if comp == 0 and not default:
                    # SAD check on the luma plane (xCheckWPEnable)
                    pred_w = ((w * rp.astype(np.int64)
                               + (denom >> 1)) >> LOG2_DENOM) + off
                    sad_w = int(np.abs(cur.astype(np.int64)
                                       - pred_w).sum())
                    sad_p = int(np.abs(cur.astype(np.int64)
                                       - rp.astype(np.int64)).sum())
                    use_ref = sad_w * 100 < sad_p * 99
            luma_on = use_ref
            chroma_on = use_ref and ncomp > 1 and \
                (ws[1][2] or ws[2][2])
            for comp in range(ncomp):
                w, off, _ = ws[comp]
                present = luma_on if comp == 0 else chroma_on
                if not present:
                    w, off = 1 << LOG2_DENOM, 0
                sh.pred_weights[(lx, r, comp)] = PredWeight(
                    present=present, log2_denom=LOG2_DENOM, weight=w,
                    offset=off)
            engaged = engaged or luma_on
    return engaged

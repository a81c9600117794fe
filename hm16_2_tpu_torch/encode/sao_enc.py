"""SAO parameter estimation (TEncSampleAdaptiveOffset analogue).

Per-CTU, per-component statistics on (original - deblocked reconstruction)
for every candidate type (EO classes 0-3 via the shared edge classifier,
BO over 32 bands), then an RD decision across OFF / NEW / MERGE-left /
MERGE-up using the closed-form distortion delta of adding offset o to a
category with pixel count N and diff sum S:  dD = N*o^2 - 2*o*S
(getBlkStats TEncSampleAdaptiveOffset.cpp:910, deriveModeNewRDO :583,
deriveModeMergeRDO :726).
"""

from __future__ import annotations

import numpy as np

from hm16_2_tpu_torch.ops.sao_ref import _EO_NEIGHBORS, _ctu_avail, _eo_classify

# edge_type value -> offsets4 slot (value 2 is category 0: no offset)
_EDGE_TO_SLOT = {0: 0, 1: 1, 3: 2, 4: 3}


def _best_offsets_vec(S, N, lo, hi, lam):
    """Vectorized _best_offset over category arrays: evaluates every
    offset between 0 and the rounded estimate (inclusive) and keeps the
    cheapest — identical to the scalar search path."""
    S = np.asarray(S, dtype=np.float64)
    N = np.asarray(N, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        est = np.where(N > 0, np.round(S / np.maximum(N, 1)), 0.0)
    est = np.clip(est, lo, hi).astype(np.int64)
    max_abs = max(abs(lo), abs(hi))
    os_ = np.arange(-max_abs, max_abs + 1)                 # (M,)
    cost = (N[..., None] * os_ * os_ - 2.0 * os_ * S[..., None]
            + lam * (np.abs(os_) + 2))
    cost = np.where(os_ == 0, 0.0, cost)                   # o=0 costs 0
    # valid offsets lie between 0 and est (inclusive), same sign as est
    valid = ((os_ >= np.minimum(est, 0)[..., None])
             & (os_ <= np.maximum(est, 0)[..., None]))
    cost = np.where(valid, cost, np.inf)
    k = np.argmin(cost, axis=-1)
    best_o = os_[k]
    best_c = np.take_along_axis(cost, k[..., None], axis=-1)[..., 0]
    best_c = np.where(np.isfinite(best_c), best_c, 0.0)
    return best_o, best_c


def _best_offset(s, n, lo, hi, lam):
    """Offset minimizing N*o^2 - 2*o*S + lam*rate(|o|), searched from the
    rounded estimate toward zero (xGetBestOffset-style)."""
    if n == 0:
        return 0, 0.0
    est = int(np.clip(round(s / n), lo, hi))
    best_o, best_c = 0, 0.0
    o = est
    while True:
        cost = n * o * o - 2.0 * o * s + lam * (abs(o) + 2)
        if cost < best_c:
            best_o, best_c = o, cost
        if o == 0:
            break
        o += 1 if o < 0 else -1
    return best_o, best_c


def _collect_stats(pic, orig, src, cx, cy, comp, avail):
    """Per-type stats for one CTU comp: dict type -> (S[..], N[..])."""
    sx, sy = pic.comp_shift[comp]
    x0 = (cx * pic.ctb) >> sx
    y0 = (cy * pic.ctb) >> sy
    w = min(pic.ctb >> sx, (pic.w >> sx) - x0)
    h = min(pic.ctb >> sy, (pic.h >> sy) - y0)
    if w <= 0 or h <= 0:
        return None
    o_blk = orig[comp][y0:y0 + h, x0:x0 + w].astype(np.int64)
    stats = {}
    for t in range(4):                      # EO classes
        ty0, tx0, th, tw, proc, edge_type, cur = _eo_classify(
            pic, src[comp], cx, cy, comp, t, avail)
        diff = o_blk - cur
        S = np.zeros(4)
        N = np.zeros(4, dtype=np.int64)
        for et, slot in _EDGE_TO_SLOT.items():
            m = proc & (edge_type == et)
            S[slot] = float(diff[m].sum())
            N[slot] = int(m.sum())
        stats[t] = (S, N)
    # BO: 32 bands
    bd = pic.sps.bit_depth_luma if comp == 0 else pic.sps.bit_depth_chroma
    rec_blk = src[comp][y0:y0 + h, x0:x0 + w].astype(np.int64)
    bands = rec_blk >> (bd - 5)
    diff = o_blk - rec_blk
    S = np.zeros(32)
    N = np.zeros(32, dtype=np.int64)
    np.add.at(S, bands.ravel(), diff.ravel().astype(np.float64))
    np.add.at(N, bands.ravel(), 1)
    stats[4] = (S, N)
    return stats


def _delta_for_params(stats, type_idx, offs4, band):
    """Distortion delta of applying the given (already signed) offsets."""
    S, N = stats[4] if type_idx == 4 else stats[type_idx]
    d = 0.0
    for i in range(4):
        o = int(offs4[i])
        idx = (band + i) % 32 if type_idx == 4 else i
        d += N[idx] * o * o - 2.0 * o * S[idx]
    return d


def _frame_stats(pic, orig, comp):
    """Whole-plane vectorized statistics for one component: returns
    (S_eo (n_ctu,4,4), N_eo, S_bo (n_ctu,32), N_bo).  Valid when every
    CTU neighbor is available (single slice+tile): the per-pixel edge
    classification then only depends on plane boundaries, so the per-CTU
    loop collapses to one classification + block-sum per EO class."""
    nat = _frame_stats_native(pic, orig, comp)
    if nat is not None:
        return nat
    return _frame_stats_np(pic, orig, comp)


def _frame_stats_native(pic, orig, comp):
    """dsp_core.sao_frame_stats: one C++ pass over the plane (sums are
    integers, so the double accumulators equal numpy's float64 exactly)."""
    from hm16_2_tpu_torch import native
    lib = native.get_dsp()
    if lib is None or not hasattr(lib, "sao_frame_stats"):
        return None
    import ctypes
    sx, sy = pic.comp_shift[comp]
    P = pic.rec[comp]
    o = orig[comp]
    if P.dtype != np.int32 or not P.flags.c_contiguous:
        return None
    if o.dtype != np.int32 or not o.flags.c_contiguous:
        o = np.ascontiguousarray(o, dtype=np.int32)
    ph, pw = P.shape
    cb_h, cb_w = pic.ctb >> sy, pic.ctb >> sx
    w, h = pic.w >> sx, pic.h >> sy
    n_ctu = pic.w_ctbs * pic.h_ctbs
    bd = pic.sps.bit_depth_luma if comp == 0 else pic.sps.bit_depth_chroma
    S_eo = np.zeros((n_ctu, 4, 4))
    N_eo = np.zeros((n_ctu, 4, 4), dtype=np.int64)
    S_bo = np.zeros((n_ctu, 32))
    N_bo = np.zeros((n_ctu, 32), dtype=np.int64)
    lib.sao_frame_stats(
        P.ctypes.data, P.shape[1], ph, pw, o.ctypes.data, o.shape[1],
        w, h, cb_w, cb_h, pic.w_ctbs, bd,
        S_eo.ctypes.data, N_eo.ctypes.data, S_bo.ctypes.data,
        N_bo.ctypes.data)
    return S_eo, N_eo, S_bo, N_bo


def _frame_stats_np(pic, orig, comp):
    sx, sy = pic.comp_shift[comp]
    P = pic.rec[comp]
    ph, pw = P.shape
    cb_h, cb_w = pic.ctb >> sy, pic.ctb >> sx
    w, h = pic.w >> sx, pic.h >> sy
    n_ctu = pic.w_ctbs * pic.h_ctbs
    Pl = P.astype(np.int64)
    diffp = np.zeros((ph, pw), dtype=np.float64)
    diffp[:h, :w] = orig[comp][:h, :w].astype(np.float64) - Pl[:h, :w]
    inside = np.zeros((ph, pw), dtype=bool)
    inside[:h, :w] = True

    def block_sum(a):
        return a.reshape(ph // cb_h, cb_h, pw // cb_w, cb_w) \
            .sum(axis=(1, 3)).ravel()

    S_eo = np.zeros((n_ctu, 4, 4))
    N_eo = np.zeros((n_ctu, 4, 4), dtype=np.int64)
    for t, ((d1y, d1x), (d2y, d2x)) in _EO_NEIGHBORS.items():
        et = np.full((ph, pw), -1, dtype=np.int8)
        y0v, y1v = max(d1y, d2y, 0), ph + min(d1y, d2y, 0)
        x0v, x1v = max(d1x, d2x, 0), pw + min(d1x, d2x, 0)
        c = Pl[y0v:y1v, x0v:x1v]
        v1 = Pl[y0v + d1y:y1v + d1y, x0v + d1x:x1v + d1x]
        v2 = Pl[y0v + d2y:y1v + d2y, x0v + d2x:x1v + d2x]
        et[y0v:y1v, x0v:x1v] = (np.sign(c - v1) + np.sign(c - v2) + 2) \
            .astype(np.int8)
        et[~inside] = -1
        for ev, slot in _EDGE_TO_SLOT.items():
            m = et == ev
            S_eo[:, t, slot] = block_sum(diffp * m)
            N_eo[:, t, slot] = block_sum(m.astype(np.int64))

    bd = pic.sps.bit_depth_luma if comp == 0 else pic.sps.bit_depth_chroma
    ctu_id = (np.arange(ph)[:, None] // cb_h) * pic.w_ctbs + \
        (np.arange(pw)[None, :] // cb_w)
    bins = (ctu_id * 32 + (P >> (bd - 5)))[inside].ravel()
    S_bo = np.bincount(bins, weights=diffp[inside].ravel(),
                       minlength=n_ctu * 32).reshape(n_ctu, 32)
    N_bo = np.bincount(bins, minlength=n_ctu * 32).reshape(n_ctu, 32)
    return S_eo, N_eo, S_bo, N_bo


def estimate_sao_fast(pic, orig, lam, luma=True, chroma=True):
    """Vectorized estimate_sao for the every-neighbor-available case.
    luma/chroma=False skips the channel (picture-level SAO disable,
    decidePicParams): its sao_mode stays 0 and nothing is applied."""
    n_ctu = pic.w_ctbs * pic.h_ctbs
    pic.sao_merge = np.zeros(n_ctu, dtype=np.int8)
    bd_max = [(1 << (min((pic.sps.bit_depth_luma if c == 0 else
                          pic.sps.bit_depth_chroma), 10) - 5)) - 1
              for c in range(3)]
    stats = [_frame_stats(pic, orig, c) for c in range(pic.num_comps)]

    # per-channel NEW-mode decision across all CTUs at once
    nc = pic.num_comps
    chan_comps = ([(0, [0])] if luma else []) + \
        ([(1, [1, 2])] if (nc > 1 and chroma) else [])
    best_cost = {}
    best_type = {}
    best_offs = {}
    best_band = {}
    for chan, comps in chan_comps:
        costs = np.full((n_ctu, 5), np.inf)
        offs = np.zeros((n_ctu, 5, len(comps), 4), dtype=np.int64)
        bands = np.zeros((n_ctu, 5, len(comps)), dtype=np.int64)
        for t in range(5):
            tot = np.full(n_ctu, lam * 4.0)
            for ci, c in enumerate(comps):
                S_eo, N_eo, S_bo, N_bo = stats[c]
                mx = bd_max[c]
                if t == 4:
                    ob, cb = _best_offsets_vec(S_bo, N_bo, -mx, mx, lam)
                    win = cb + np.roll(cb, -1, 1) + np.roll(cb, -2, 1) \
                        + np.roll(cb, -3, 1)
                    bb = np.argmin(win, axis=1)
                    tot += np.take_along_axis(win, bb[:, None], 1)[:, 0] \
                        + lam * 5
                    idx = (bb[:, None] + np.arange(4)[None, :]) % 32
                    offs[:, t, ci] = np.take_along_axis(ob, idx, 1)
                    bands[:, t, ci] = bb
                else:
                    o_pos, c_pos = _best_offsets_vec(
                        S_eo[:, t, :2], N_eo[:, t, :2], 0, mx, lam)
                    o_neg, c_neg = _best_offsets_vec(
                        S_eo[:, t, 2:], N_eo[:, t, 2:], -mx, 0, lam)
                    tot += c_pos.sum(1) + c_neg.sum(1)
                    offs[:, t, ci, :2] = o_pos
                    offs[:, t, ci, 2:] = o_neg
            costs[:, t] = tot
        bt = np.argmin(costs, axis=1)
        bc = np.take_along_axis(costs, bt[:, None], 1)[:, 0]
        off_cost = lam * 1.0
        best_cost[chan] = np.where(bc < off_cost, bc, off_cost)
        best_type[chan] = np.where(bc < off_cost, bt, 0)
        best_offs[chan] = offs[np.arange(n_ctu), bt]
        best_band[chan] = bands[np.arange(n_ctu), bt]
        best_type[chan] = np.where(bc < off_cost, bt, -1)   # -1 = OFF

    def delta_for(c, rs, type_idx, offs4, band):
        S_eo, N_eo, S_bo, N_bo = stats[c]
        d = 0.0
        for i in range(4):
            o = int(offs4[i])
            if type_idx == 4:
                idx = (band + i) % 32
                d += N_bo[rs, idx] * o * o - 2.0 * o * S_bo[rs, idx]
            else:
                d += N_eo[rs, type_idx, i] * o * o \
                    - 2.0 * o * S_eo[rs, type_idx, i]
        return d

    for cy in range(pic.h_ctbs):
        for cx in range(pic.w_ctbs):
            rs = cy * pic.w_ctbs + cx

            def merge_cost(src_rs):
                tot = 0.0
                for c in range(nc):
                    if pic.sao_mode[src_rs, c] == 0:
                        continue
                    tot += delta_for(c, rs, int(pic.sao_type[src_rs, c]),
                                     pic.sao_offsets[src_rs, c],
                                     int(pic.sao_band[src_rs, c]))
                return tot + lam * 1.0

            new_cost = sum(best_cost[ch][rs] for ch, _ in chan_comps)
            best_merge, best_merge_cost = 0, None
            if cx > 0:
                cml = merge_cost(rs - 1)
                if best_merge_cost is None or cml < best_merge_cost:
                    best_merge, best_merge_cost = 1, cml
            if cy > 0:
                cmu = merge_cost(rs - pic.w_ctbs)
                if best_merge_cost is None or cmu < best_merge_cost:
                    best_merge, best_merge_cost = 2, cmu
            if best_merge_cost is not None and best_merge_cost < new_cost:
                src_rs = rs - 1 if best_merge == 1 else rs - pic.w_ctbs
                pic.sao_merge[rs] = best_merge
                pic.sao_mode[rs] = pic.sao_mode[src_rs]
                pic.sao_type[rs] = pic.sao_type[src_rs]
                pic.sao_offsets[rs] = pic.sao_offsets[src_rs]
                pic.sao_band[rs] = pic.sao_band[src_rs]
                continue
            for chan, comps in chan_comps:
                t = int(best_type[chan][rs])
                for ci, c in enumerate(comps):
                    if t < 0:
                        pic.sao_mode[rs, c] = 0
                        pic.sao_type[rs, c] = 0
                    else:
                        pic.sao_mode[rs, c] = 1
                        pic.sao_type[rs, c] = t
                        pic.sao_offsets[rs, c] = best_offs[chan][rs, ci]
                        pic.sao_band[rs, c] = best_band[chan][rs, ci]


def estimate_sao(pic, orig, lam, luma=True, chroma=True):
    """Fill pic.sao_mode/type/offsets/band (+ pic.sao_merge) for all CTUs.
    luma/chroma=False: picture-level component disable (no stats, no
    decisions, no application for the channel)."""
    # fast full-frame path: one slice, one tile, loop filter across
    # boundaries on -> every CTU neighbor is available everywhere
    if len(pic.slices) == 1 and \
            pic.slices[0].loop_filter_across_slices and \
            len(pic.tiles.col_bounds) == 2 and \
            len(pic.tiles.row_bounds) == 2 and \
            pic.rec[0].shape[0] % pic.ctb == 0 and \
            pic.rec[0].shape[1] % pic.ctb == 0:
        return estimate_sao_fast(pic, orig, lam, luma, chroma)
    if not (luma or (chroma and pic.num_comps > 1)):
        return
    src = [p.copy() for p in pic.rec]        # deblocked, pre-SAO
    n_ctu = pic.w_ctbs * pic.h_ctbs
    pic.sao_merge = np.zeros(n_ctu, dtype=np.int8)
    bd_max = [(1 << (min((pic.sps.bit_depth_luma if c == 0 else
                          pic.sps.bit_depth_chroma), 10) - 5)) - 1
              for c in range(3)]

    for cy in range(pic.h_ctbs):
        for cx in range(pic.w_ctbs):
            rs = cy * pic.w_ctbs + cx
            avail = {(dy, dx): _ctu_avail(pic, cx, cy, dx, dy)
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)}
            stats = [_collect_stats(pic, orig, src, cx, cy, c, avail)
                     for c in range(pic.num_comps)]

            # ---- NEW mode decision ----
            # luma: best of OFF / EO0-3 / BO
            choices = []       # per channel: (cost, mode, type, offs, band)
            chan_list = ([(0, [0])] if luma else []) + \
                ([(1, [1, 2])] if chroma else [])
            for chan, comps in chan_list:
                if comps[0] >= pic.num_comps or stats[comps[0]] is None:
                    break
                best = (lam * 1.0, 0, 0, {c: [0, 0, 0, 0] for c in comps},
                        {c: 0 for c in comps})
                for t in range(5):
                    cost = lam * 4.0     # type/class signalling ballpark
                    offs = {}
                    bands = {}
                    ok = True
                    for c in comps:
                        st = stats[c]
                        if st is None:
                            ok = False
                            break
                        mx = bd_max[c]
                        if t == 4:
                            S, N = st[4]
                            ob, cb = _best_offsets_vec(S, N, -mx, mx, lam)
                            win = cb + np.roll(cb, -1) + np.roll(cb, -2) \
                                + np.roll(cb, -3)
                            best_band = int(np.argmin(win))
                            cost += float(win[best_band]) + lam * 5
                            offs[c] = [int(ob[(best_band + i) % 32])
                                       for i in range(4)]
                            bands[c] = best_band
                        else:
                            S, N = st[t]
                            o_pos, c_pos = _best_offsets_vec(
                                S[:2], N[:2], 0, mx, lam)
                            o_neg, c_neg = _best_offsets_vec(
                                S[2:], N[2:], -mx, 0, lam)
                            cost += float(c_pos.sum() + c_neg.sum())
                            offs[c] = [int(o_pos[0]), int(o_pos[1]),
                                       int(o_neg[0]), int(o_neg[1])]
                            bands[c] = 0
                    if ok and cost < best[0]:
                        best = (cost, 1, t, offs, bands)
                choices.append(best)

            new_cost = sum(c[0] for c in choices)

            # ---- MERGE candidates ----
            def merge_cost(src_rs):
                tot = 0.0
                for c in range(pic.num_comps):
                    if stats[c] is None:
                        continue
                    if pic.sao_mode[src_rs, c] == 0:
                        continue
                    tot += _delta_for_params(
                        stats[c], int(pic.sao_type[src_rs, c]),
                        pic.sao_offsets[src_rs, c],
                        int(pic.sao_band[src_rs, c]))
                return tot + lam * 1.0

            # merge is SYNTAX prediction: allowed only within the same
            # slice AND tile (unlike the loop-filter availability above,
            # which the across-slices/tiles flags can widen)
            def syn_avail(dx, dy):
                nx, ny = cx + dx, cy + dy
                if nx < 0 or ny < 0:
                    return False
                parts = pic.ctb // 4
                if pic.slice_id[cy * parts, cx * parts] != \
                        pic.slice_id[ny * parts, nx * parts]:
                    return False
                return pic.tiles.tile_of_ctu[cy, cx] == \
                    pic.tiles.tile_of_ctu[ny, nx]

            best_merge, best_merge_cost = 0, None
            if syn_avail(-1, 0):
                cml = merge_cost(rs - 1)
                if best_merge_cost is None or cml < best_merge_cost:
                    best_merge, best_merge_cost = 1, cml
            if syn_avail(0, -1):
                cmu = merge_cost(rs - pic.w_ctbs)
                if best_merge_cost is None or cmu < best_merge_cost:
                    best_merge, best_merge_cost = 2, cmu

            if best_merge_cost is not None and best_merge_cost < new_cost:
                src_rs = rs - 1 if best_merge == 1 else rs - pic.w_ctbs
                pic.sao_merge[rs] = best_merge
                for c in range(pic.num_comps):
                    pic.sao_mode[rs, c] = pic.sao_mode[src_rs, c]
                    pic.sao_type[rs, c] = pic.sao_type[src_rs, c]
                    pic.sao_offsets[rs, c] = pic.sao_offsets[src_rs, c]
                    pic.sao_band[rs, c] = pic.sao_band[src_rs, c]
                continue

            for (chan, comps), (cost, mode, t, offs, bands) in \
                    zip(chan_list, choices):
                for c in comps:
                    if c >= pic.num_comps:
                        continue
                    pic.sao_mode[rs, c] = mode
                    pic.sao_type[rs, c] = t
                    if mode:
                        pic.sao_offsets[rs, c] = offs[c]
                        pic.sao_band[rs, c] = bands[c]

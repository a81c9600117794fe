"""Frame-level fused inter plan in PyTorch: the P- and B-picture paths.

Counterpart of `hm16_2_tpu/encode/inter_plan.py`, which describes the
algorithm; both its branches (`is_b` False and True, rect partitions on,
integer ME inside the plan) are ported.  Each stage is a wrapper that runs
a hand-written CUDA kernel (`hm16_2_tpu_torch.kernels`) on a CUDA tensor
and the plain PyTorch version beside it on a CPU tensor:

    int_me          K5  4x-downsampled SSD grids, coarse argmin with MVD
                        pricing, +-3 full-pel SSE refinement, per CU shape
    subpel_planes   K6  16-phase quarter-pel planes per reference
    frac_refine     K7  49 quarter-pel SATDs around the integer MV, argmin
    uni_select_all  K7  each list's best reference per block, for every
                        (CU size, shape, list) of a picture in one launch
    frac_refine_any K7  one pass of the B plan's bi refinement (a reference
                        per block, the bi target 2*orig - other prediction)
    cu_rd           K8  P: merge set, kind, residual trial, skip, 2NxN /
                        Nx2N, intra comparison: one cost and record per CU
    cu_rd_b         K8  the same for B: six bi merge candidates, uni-L0,
                        uni-L1, bi and refined bi, rect PUs from either list
    intra_rd.size_rd K2 the intra alternative (inter rounding offset)
    emit            K4  quadtree DP and the packed (24, h/4, w/4) plan

Only the live unique references are computed.  The reference pads the
reference stack to MAXREF_PLAN so that XLA compiles one program; the
padded entries are never selected (their list entries are masked), so
leaving them out changes nothing in the plan.

Float32 parity.  The plan is integer maths ranked by float32 costs.  The
reference's P and B programs (`_plan_device` with is_b False / True, two
HLO modules) run under XLA:CPU, whose LLVM backend fuses a multiply into
the add that consumes it when both sit in one basic block and the product
has no other use.  Read from each program's optimised HLO and object code,
these steps are fused multiply-adds (`intra_rd._fma32` here, `__fmaf_rn`
in the kernels):

    coarse ME   g + lamf*mvb                     (reference :150)
    refine      sse + lamf*bits                  (:192)
    q-pel       satd + lams*bits                 (:394, B pass :429)
    list pick   satd + lams*bits                 (:523, :843)
    bi (B)      satd + lams*bits, refined too    (:668, :692)
    trial       sse + lamf*(bits + ...)          (:789, :793, :898, :899)
    intra RD    dist + lamf*bits                 (:967, inside K2)

and these add a separately rounded scalar product: the merge cost
`satd + lams*bits` (:627), the intra extra `icost + lamf*3` (:928) and the
split cost `quad + lamf*3` (:989-1003).  XLA computes `log2` as
`ln * 1.44269502`, which puts floor(log2(8192)) at 12; `_mvd_bits` keeps
that exception.
"""

from __future__ import annotations

import os
import weakref

import numpy as np
import torch

from hm16_2_tpu_torch.common.tables import LUMA_FILTER
from hm16_2_tpu_torch.headers.params import B_SLICE
from hm16_2_tpu_torch import kernels
from hm16_2_tpu_torch import trace as _trace
from hm16_2_tpu_torch.encode import intra_rd
from hm16_2_tpu_torch.encode.intra_rd import _bit_length, _f32, _fma32, \
    _on_cuda, _pad_to, _quad, _up
from hm16_2_tpu_torch.ops import analysis

# constants copied from the reference (a test asserts equality)
COARSE_R = 16          # coarse-offset radius (x4 = full-pel +-64)
REFINE_R = 3           # full-res int refinement radius
MAXREF_PLAN = 4        # list length of the plan's reference maps
MARGIN = 80            # subpel-plane padding (covers +-67 int + filter)
MERGE_FLAG_BITS = 1.0
SKIP_EXTRA_BITS = 1.0
UNI_BASE_BITS = 4.0
BI_BASE_BITS = 6.0
SPLIT_BITS = 3.0
INTRA_EXTRA_BITS = 3.0
RECT_PART_BITS = 1.5
RECT_SIZES = (16, 32, 64)
SIZES = (8, 16, 32, 64)
KIND_MERGE, KIND_UNI0, KIND_UNI1, KIND_BI = 0, 1, 2, 3
_QOFFS = [(dy, dx) for dy in range(-3, 4) for dx in range(-3, 4)]

# fields of the per-CU record K8 writes and the emission reads
REC_FIELDS = ("kind", "msrc", "dir", "skip", "intra", "imode", "mv0y", "mv0x",
              "mv1y", "mv1x", "ref0", "ref1", "c0", "c1", "c2", "part",
              "p0dir", "p0mvy", "p0mvx", "p0ref", "p1dir", "p1mvy", "p1mvx",
              "p1ref")
NREC = len(REC_FIELDS)
PLAN_CHANNELS = 24


# ---------------------------------------------------------------------------
# exact helpers
# ---------------------------------------------------------------------------

def _mvd_comp_bits(d):
    """Bins of one quarter-pel MVD component: greater0, greater1, sign + EG1
    remainder.  The EG1 prefix is 2 * floor(log2(max(|d| >> 1, 1))), taken
    from the integer bit length; XLA's float log2 gives 12 at 8192, which
    is kept."""
    a = d.abs()
    h = torch.clamp(a >> 1, min=1)
    e = _bit_length(h) - 1 - (h == 8192).to(torch.int32)
    eg1 = (5 + 2 * e).to(torch.float32)
    return torch.where(a == 0, 1.0, torch.where(a == 1, 3.0, eg1)) \
        .to(torch.float32)


def _mvd_bits(dx, dy):
    return _mvd_comp_bits(dx) + _mvd_comp_bits(dy)


def _quant_t(coeffs, qp: int, bit_depth: int, log2_tr: int):
    """Flat quant with the inter rounding offset (85)."""
    return analysis.batched_quant(coeffs, qp, bit_depth, log2_tr, False)


def _dequant_t(levels, qp: int, bit_depth: int, log2_tr: int):
    return intra_rd.batched_dequant(levels, qp, bit_depth, log2_tr)


def _offsets(r, device):
    a = torch.arange(-r, r + 1, device=device, dtype=torch.int32)
    return torch.stack(torch.meshgrid(a, a, indexing="ij"), -1).reshape(-1, 2)


def _grid_blocks(plane, bh, bw, ny, nx):
    """(ny*nx, bh, bw) raster blocks of a plane."""
    return plane[:ny * bh, :nx * bw].reshape(ny, bh, nx, bw).transpose(1, 2) \
        .reshape(ny * nx, bh, bw).to(torch.int32)


def _grid_origins(bh, bw, ny, nx, device):
    ys = (torch.arange(ny, device=device, dtype=torch.int32) * bh) \
        .repeat_interleave(nx)
    xs = (torch.arange(nx, device=device, dtype=torch.int32) * bw).repeat(ny)
    return ys, xs


def _clamped_windows(plane, ys, xs, hh, ww):
    """(N, hh, ww) windows at (ys, xs) of a plane, edge-extended."""
    ph, pw = plane.shape[-2:]
    dev = plane.device
    iy = torch.clamp(ys[:, None] + torch.arange(hh, device=dev), 0, ph - 1)
    ix = torch.clamp(xs[:, None] + torch.arange(ww, device=dev), 0, pw - 1)
    return plane[iy[:, :, None].long(), ix[:, None, :].long()]


def _mvp_full(mvn16, dists):
    """Per-reference full-pel prior (R, h/8, w/8, 2): rint(mvn16 * d / 64),
    half to even, clipped inside the subpel margin."""
    cap = MARGIN - REFINE_R - 8
    v = mvn16[None].to(torch.float32) * \
        dists[:, None, None, None].to(torch.float32) / 64.0
    return torch.clamp(torch.round(v).to(torch.int32), -cap, cap)


# ---------------------------------------------------------------------------
# K5: dense integer ME (plain version)
# ---------------------------------------------------------------------------

def _coarse_grid8(cur, refs, h, w, row0=0):
    """(R, 1089, h/8, w/8) float32 coarse SSD of every 8x8 block (2x2
    samples of the 4x box-downsampled planes) at each of 33x33 offsets.
    cur: (h, w), the rows row0.. of the picture (a band when row0 > 0 or
    refs are taller); refs: (R, full_h, w) whole references."""
    R = refs.shape[0]
    hc, wc = h // 4, w // 4
    fhc = refs.shape[1] // 4
    n8y, n8x = h // 8, w // 8
    dev = cur.device
    cd = cur[:hc * 4, :wc * 4].reshape(hc, 4, wc, 4) \
        .sum((1, 3), dtype=torch.int32) // 16
    rd = refs[:, :fhc * 4, :wc * 4].reshape(R, fhc, 4, wc, 4) \
        .sum((2, 4), dtype=torch.int32) // 16
    cr = COARSE_R
    rc0 = row0 // 4
    iy = torch.clamp(torch.arange(rc0 - cr, rc0 + hc + cr, device=dev), 0,
                     fhc - 1)
    ix = torch.clamp(torch.arange(-cr, wc + cr, device=dev), 0, wc - 1)
    rdp = rd[:, iy][:, :, ix]
    n = 2 * cr + 1
    out = torch.empty((R, n, n, n8y, n8x), dtype=torch.float32, device=dev)
    for oy in range(n):
        win = rdp[:, oy:oy + hc].unfold(2, wc, 1)      # (R, hc, 33, wc)
        d = cd[None, :, None, :] - win
        sq = (d * d)[:, :n8y * 2, :, :n8x * 2]
        g = sq.reshape(R, n8y, 2, n, n8x, 2).sum((2, 5), dtype=torch.int32)
        out[:, oy] = g.permute(0, 2, 1, 3).to(torch.float32)
    return out.reshape(R, n * n, n8y, n8x)


def _quad4(p, ny, nx):
    """Sum of 2x2 grid cells in the reference's order."""
    q = p[..., :ny * 2, :nx * 2]
    return ((q[..., 0::2, 0::2] + q[..., 0::2, 1::2]) + q[..., 1::2, 0::2]) \
        + q[..., 1::2, 1::2]


def _me_shape_plain(cur, refs, grid, mvp, lamf, bh, bw,
                    comp_bits=_mvd_comp_bits, row0=0):
    """Best full-pel MV (R, Ny, Nx, 2) of one block shape from its coarse
    grid (R, 1089, Ny, Nx) and its per-reference prior (R, Ny, Nx, 2), and
    its cost (R, Ny*Nx) float32.  comp_bits: the bits of one MV delta
    component (the plan's MVD bins; inter_me's log model); row0: the
    picture row of cur's first row (refs are the whole pictures)."""
    R, O, Ny, Nx = grid.shape
    N = Ny * Nx
    dev = cur.device
    roffs = _offsets(REFINE_R, dev)
    g = grid.reshape(R, O, N)
    mvp = mvp.reshape(R, N, 2)
    # the two components' bits are separable: (R, 33, N) each, summed
    a = torch.arange(-COARSE_R, COARSE_R + 1, device=dev, dtype=torch.int32)
    by = comp_bits(4 * (a[None, :, None] - mvp[:, None, :, 0]))
    bx = comp_bits(4 * (a[None, :, None] - mvp[:, None, :, 1]))
    mvb = (bx[:, None, :, :] + by[:, :, None, :]).reshape(R, O, N)
    lam = _f32(lamf, g)
    offs = _offsets(COARSE_R, dev)
    best_o = torch.argmin(_fma32(lam.expand_as(mvb), mvb, g), dim=1)
    coarse = 4 * offs[best_o]                              # (R, N, 2)
    ys, xs = _grid_origins(bh, bw, Ny, Nx, dev)
    blocks = _grid_blocks(cur, bh, bw, Ny, Nx)
    ys = ys + row0
    rr = REFINE_R
    out = torch.empty((R, N, 2), dtype=torch.int32, device=dev)
    out_cost = torch.empty((R, N), dtype=torch.float32, device=dev)
    for r in range(R):
        cands = []
        for centers in (coarse[r], torch.zeros_like(coarse[r])):
            wins = _clamped_windows(refs[r], ys + centers[:, 0] - rr,
                                    xs + centers[:, 1] - rr, bh + 2 * rr,
                                    bw + 2 * rr)
            cols = []
            for dy in range(2 * rr + 1):
                for dx in range(2 * rr + 1):
                    dd = blocks - wins[:, dy:dy + bh, dx:dx + bw]
                    sq = dd * dd
                    if bh * bw >= 4096:
                        sq = sq >> 2
                    cols.append(sq.sum((1, 2), dtype=torch.int32)
                                .to(torch.float32))
            sse = torch.stack(cols, 1)                     # (N, 49)
            mv_cand = centers[:, None, :] + roffs[None]
            bits = comp_bits(4 * (mv_cand[:, :, 1] - mvp[r][:, None, 1])) + \
                comp_bits(4 * (mv_cand[:, :, 0] - mvp[r][:, None, 0]))
            cost = _fma32(lam.expand_as(bits), bits, sse)
            k = torch.argmin(cost, dim=1)
            cands.append((mv_cand[torch.arange(N, device=dev), k],
                          cost[torch.arange(N, device=dev), k]))
        better = cands[0][1] <= cands[1][1]
        out[r] = torch.where(better[:, None], cands[0][0], cands[1][0])
        out_cost[r] = torch.where(better, cands[0][1], cands[1][1])
    return out.reshape(R, Ny, Nx, 2), out_cost


def _me_mvp(mvp8, s, part):
    """The prior of the CU shape (s, part) sampled from the 8x8 prior."""
    if part == 0:
        return mvp8[:, ::s // 8, ::s // 8]
    if part == 1:
        return mvp8[:, ::s // 16, ::s // 8]
    return mvp8[:, ::s // 8, ::s // 16]


def _shapes(h, w, parts):
    """(s, part, bh, bw, Ny, Nx) of every CU shape the plan prices: the
    squares 8..64 (part 0), then 2NxN (1) and Nx2N (2) of RECT_SIZES."""
    out = []
    for s in SIZES:
        ny, nx = h // s, w // s
        if ny and nx:
            out.append((s, 0, s, s, ny, nx))
    if parts:
        for s in RECT_SIZES:
            ny, nx = h // s, w // s
            if ny and nx:
                out.append((s, 1, s // 2, s, 2 * ny, nx))
                out.append((s, 2, s, s // 2, ny, 2 * nx))
    return out


def _int_me_plain(cur, refs, mvp8, lamf, h, w, parts, row0=0):
    grids = {8: _coarse_grid8(cur, refs, h, w, row0)}
    for s in (16, 32, 64):
        grids[s] = _quad4(grids[s // 2], h // s, w // s)
    out = {}
    for s, part, bh, bw, Ny, Nx in _shapes(h, w, parts):
        if part == 0:
            g = grids[s]
        else:
            half = grids[s // 2][:, :, :2 * (h // s), :2 * (w // s)]
            g = half[..., 0::2] + half[..., 1::2] if part == 1 else \
                half[:, :, 0::2] + half[:, :, 1::2]
        mvp = _me_mvp(mvp8, s, part)[:, :Ny, :Nx]
        out[(s, part)] = _me_shape_plain(cur, refs, g.contiguous(), mvp,
                                         lamf, bh, bw, row0=row0)[0]
    return out


def int_me(cur, refs, mvp8, lams: float, h: int, w: int, parts: bool,
           row0: int = 0, full_h: int | None = None):
    """Best full-pel MV (R, Ny, Nx, 2) int32 (dy, dx) per reference and
    block for every CU shape of `_shapes`, keyed (s, part) (K5); MVD bins
    are priced at lams, the square root of the frame lambda.
    cur: (h, w) int32; refs: (R, full_h, w) int32; mvp8: (R, h/8, w/8, 2)
    int32 per-reference full-pel prior.  Band mode (K5's `inter_me_band`):
    cur is the band of rows row0.. (a multiple of 4; of 64 for grids equal
    to the whole picture's) of a full_h-row picture, refs are the whole
    references (full_h defaults to h)."""
    full_h = h if full_h is None else full_h
    if tuple(refs.shape[1:]) != (full_h, w):
        raise ValueError(f"int_me: references {tuple(refs.shape)} are not "
                         f"{full_h}x{w}")
    if _on_cuda(cur):
        return kernels.inter_me(cur, refs, mvp8, lams, h, w, parts, row0,
                                full_h)
    return _int_me_plain(cur, refs, mvp8, lams, h, w, parts, row0)


# ---------------------------------------------------------------------------
# K6: 16-phase quarter-pel planes (plain version)
# ---------------------------------------------------------------------------

def _subpel_planes_plain(refs, bd, h, w):
    M = MARGIN
    R = refs.shape[0]
    dev = refs.device
    taps = np.asarray(LUMA_FILTER, dtype=np.int64)
    hr = max(2, 14 - bd)
    sh1 = 6 - hr
    offs = 1 << 13
    Hp, Wp = h + 2 * M + 1, w + 2 * M + 1
    iy = torch.clamp(torch.arange(-(M + 4), h + M + 5, device=dev), 0, h - 1)
    ix = torch.clamp(torch.arange(-(M + 4), w + M + 5, device=dev), 0, w - 1)
    rp = refs[:, iy][:, :, ix].to(torch.int32)

    def hfilt(fx):
        if fx == 0:
            return (rp[:, :, 4:4 + Wp] << hr) - offs
        acc = torch.zeros((R, rp.shape[1], Wp), dtype=torch.int32, device=dev)
        for k in range(8):
            acc = acc + int(taps[fx][k]) * rp[:, :, 1 + k:1 + k + Wp]
        if sh1 >= 0:
            return (acc - (offs << sh1)) >> sh1
        return (acc << (-sh1)) - offs

    hcache = [hfilt(fx) for fx in range(4)]
    out = torch.empty((R, 16, Hp, Wp), dtype=torch.int16, device=dev)
    for fy in range(4):
        for fx in range(4):
            hh = hcache[fx]
            if fy == 0:
                v = (hh[:, 4:4 + Hp] + offs + (1 << (hr - 1))) >> hr
            else:
                acc = torch.zeros((R, Hp, Wp), dtype=torch.int32, device=dev)
                for k in range(8):
                    acc = acc + int(taps[fy][k]) * hh[:, 1 + k:1 + k + Hp]
                sh2 = 6 + hr
                v = (acc + (1 << (sh2 - 1)) + (offs << 6)) >> sh2
            out[:, fy * 4 + fx] = torch.clamp(v, 0, (1 << bd) - 1) \
                .to(torch.int16)
    return out


def subpel_planes(refs, bd: int, h: int, w: int):
    """(R, 16, h+2M+1, w+2M+1) int16 phase planes; plane[fy*4+fx][y, x] is
    the rounded prediction sample at (y - M + fy/4, x - M + fx/4) (K6)."""
    if _on_cuda(refs):
        return kernels.subpel_planes(refs, bd, h, w)
    return _subpel_planes_plain(refs, bd, h, w)


# ---------------------------------------------------------------------------
# K7: quarter-pel refinement and the list's best reference (plain)
# ---------------------------------------------------------------------------

def _phase_windows(sub, plane_idx, ys, xs, hh, ww):
    """(N, hh, ww) int32 windows of phase planes sub (P, Hp, Wp): block n
    reads plane plane_idx[n] at (ys[n], xs[n])."""
    dev = sub.device
    iy = ys[:, None] + torch.arange(hh, device=dev)
    ix = xs[:, None] + torch.arange(ww, device=dev)
    return sub[plane_idx.long()[:, None, None], iy[:, :, None].long(),
               ix[:, None, :].long()].to(torch.int32)


def _gather_pred(suball, ys, xs, mv4, uref, bh, bw):
    """Predicted blocks for per-block quarter MVs on the stacked phase
    planes suball (R*16, Hp, Wp)."""
    ph = uref * 16 + (mv4[:, 0] & 3) * 4 + (mv4[:, 1] & 3)
    return _phase_windows(suball, ph, ys + (mv4[:, 0] >> 2) + MARGIN,
                          xs + (mv4[:, 1] >> 2) + MARGIN, bh, bw)


def _frac_refine_plain(sub, cur, mv_int, pred4, lams, bh, bw):
    R, Ny, Nx = mv_int.shape[:3]
    N = Ny * Nx
    dev = cur.device
    ys, xs = _grid_origins(bh, bw, Ny, Nx, dev)
    blocks = _grid_blocks(cur, bh, bw, Ny, Nx)
    suball = sub.reshape((R * 16,) + tuple(sub.shape[2:]))
    lam = _f32(lams, blocks)
    mv4 = torch.empty((R, N, 2), dtype=torch.int32, device=dev)
    satd_out = torch.empty((R, N), dtype=torch.float32, device=dev)
    ar = torch.arange(N, device=dev)
    for r in range(R):
        mv = mv_int[r].reshape(N, 2)
        p4 = pred4[r].reshape(N, 2)
        sat, bits = [], []
        for qy, qx in _QOFFS:
            m4 = torch.stack([4 * mv[:, 0] + qy, 4 * mv[:, 1] + qx], -1)
            pred = _gather_pred(suball, ys, xs, m4,
                                torch.full((N,), r, device=dev), bh, bw)
            sat.append(analysis.batched_satd(blocks - pred)
                       .to(torch.float32))
            bits.append(_mvd_bits(m4[:, 1] - p4[:, 1], m4[:, 0] - p4[:, 0]))
        satd = torch.stack(sat, 1)
        bits = torch.stack(bits, 1)
        k = torch.argmin(_fma32(lam.expand_as(bits), bits, satd), dim=1)
        q = torch.as_tensor(_QOFFS, dtype=torch.int32, device=dev)
        mv4[r] = 4 * mv + q[k]
        satd_out[r] = satd[ar, k]
    return mv4, satd_out


def frac_refine(sub, cur, mv_int, pred4, lams: float, bh: int, bw: int):
    """Quarter-pel SATD refinement of every (reference, block) of one CU
    shape over the +-3 quarter window around its integer MV (K7).
    sub: (R, 16, Hp, Wp) int16; mv_int: (R, Ny, Nx, 2) full-pel;
    pred4: (R, Ny, Nx, 2) quarter-pel MVD anchor.  Returns (mv4 (R, N, 2)
    int32, satd (R, N) float32)."""
    if _on_cuda(sub):
        return kernels.frac_refine(sub, cur, mv_int, pred4, lams, bh, bw)
    return _frac_refine_plain(sub, cur, mv_int, pred4, lams, bh, bw)


def _frac_refine_any_plain(sub, cur, mv4, uref, anchor4, o_uref, o_mv4, lams,
                           s):
    h, w = cur.shape
    ny, nx = h // s, w // s
    N = ny * nx
    dev = cur.device
    R = sub.shape[0]
    suball = sub.reshape((R * 16,) + tuple(sub.shape[2:]))
    ys, xs = _grid_origins(s, s, ny, nx, dev)
    target = 2 * _grid_blocks(cur, s, s, ny, nx) - \
        _gather_pred(suball, ys, xs, o_mv4, o_uref, s, s)
    mv_int = mv4 >> 2                          # floor toward -inf
    lam = _f32(lams, target)
    sat, bits = [], []
    for qy, qx in _QOFFS:
        m4 = torch.stack([4 * mv_int[:, 0] + qy, 4 * mv_int[:, 1] + qx], -1)
        pred = _gather_pred(suball, ys, xs, m4, uref, s, s)
        sat.append(analysis.batched_satd(target - pred).to(torch.float32))
        bits.append(_mvd_bits(m4[:, 1] - anchor4[:, 1],
                              m4[:, 0] - anchor4[:, 0]))
    satd = torch.stack(sat, 1)
    bits = torch.stack(bits, 1)
    k = torch.argmin(_fma32(lam.expand_as(bits), bits, satd), dim=1)
    q = torch.as_tensor(_QOFFS, dtype=torch.int32, device=dev)
    return 4 * mv_int + q[k], satd[torch.arange(N, device=dev), k]


def frac_refine_any(sub, cur, mv4, uref, anchor4, o_uref, o_mv4, lams: float,
                    s: int):
    """One pass of the bi refinement (K7, per-block reference mode): the
    quarter-pel SATD refinement of each s-block's MV mv4 (N, 2) on its own
    reference uref[n], over the +-3 quarter window around mv4 >> 2, against
    the bi target 2 * orig - pred(o_uref[n], o_mv4[n]) (the other list's
    prediction), MVD bins priced from anchor4 (N, 2).  Returns (mv4 (N, 2)
    int32, satd (N,) float32)."""
    if _on_cuda(sub):
        return kernels.frac_refine_any(sub, cur, mv4, uref, anchor4, o_uref,
                                       o_mv4, lams, s)
    return _frac_refine_any_plain(sub, cur, mv4, uref, anchor4, o_uref,
                                  o_mv4, lams, s)


def _uni_select_plain(mvq, satd, pred4, lmap, nref, lams):
    mr = lmap.shape[0]
    dev = satd.device
    mv_sel, satd_sel, p4 = mvq[lmap], satd[lmap], pred4[lmap]
    mb = _mvd_bits(mv_sel[:, :, 1] - p4[:, :, 1],
                   mv_sel[:, :, 0] - p4[:, :, 0])
    ri = torch.arange(mr, device=dev)
    rb = torch.where(torch.tensor(nref > 1, device=dev),
                     torch.minimum(ri + 1, torch.tensor(nref - 1, device=dev)),
                     0).to(torch.float32)
    bits = mb + rb[:, None] + UNI_BASE_BITS
    lam = _f32(lams, satd)
    costs = _fma32(lam.expand_as(bits), bits, satd_sel)
    costs = torch.where((ri < nref)[:, None], costs, torch.inf)
    k = torch.argmin(costs, dim=0)
    ar = torch.arange(k.shape[0], device=dev)
    return {"ridx": k.to(torch.int32), "uref": lmap[k],
            "mv": mv_sel[k, ar], "satd": satd_sel[k, ar],
            "bits": bits[k, ar], "cost": costs[k, ar], "anchor": p4[k, ar]}


def _uni_select_all_plain(entries, lams):
    return [_uni_select_plain(*e, lams) for e in entries]


def uni_select_all(entries, lams: float):
    """Each entry's list's best reference per block: SATD + lams * (MVD,
    reference and direction bins), entries past nref masked, ties to the
    first (K7's list picks, one launch for all entries).  entries: [(mvq
    (R, N, 2), satd (R, N), pred4 (R, N, 2), lmap (MAXREF,) int32 indices
    into the R references, nref)]; returns one dict per entry."""
    if _on_cuda(entries[0][1]):
        return kernels.uni_select_all(entries, lams)
    return _uni_select_all_plain(entries, lams)


# ---------------------------------------------------------------------------
# K8: CU pricing (plain version)
# ---------------------------------------------------------------------------

def _trial(blocks, pred_b, s, bd, qp):
    """Residual trial of a CU prediction: (sse_rec, bits, sse_zero)."""
    n = blocks.shape[0]
    resi = blocks - pred_b
    if s <= 32:
        log2 = s.bit_length() - 1
        fwd = analysis.batched_fwd_transform(resi, bd, False)
        lvl = _quant_t(fwd, qp, bd, log2)
        br = intra_rd._bits_estimate(lvl)
        rres = intra_rd.batched_inv_transform(_dequant_t(lvl, qp, bd, log2),
                                              bd, False)
    else:
        tu = resi.reshape(n, 2, 32, 2, 32).transpose(2, 3) \
            .reshape(n * 4, 32, 32)
        fwd = analysis.batched_fwd_transform(tu, bd, False)
        lvl = _quant_t(fwd, qp, bd, 5)
        b4 = intra_rd._bits_estimate(lvl).reshape(n, 4)
        br = ((b4[:, 0] + b4[:, 1]) + b4[:, 2]) + b4[:, 3]
        rres = intra_rd.batched_inv_transform(_dequant_t(lvl, qp, bd, 5), bd,
                                              False) \
            .reshape(n, 2, 2, 32, 32).transpose(2, 3).reshape(n, 64, 64)
    maxv = (1 << bd) - 1
    d = blocks - torch.clamp(pred_b + rres, 0, maxv)
    sr = (d * d).sum((1, 2), dtype=torch.int32).to(torch.float32)
    dz = blocks - torch.clamp(pred_b, 0, maxv)
    sz = (dz * dz).sum((1, 2), dtype=torch.int32).to(torch.float32)
    return sr, br, sz


def _roll2(a, ny, nx, dy, dx):
    g = a.reshape((ny, nx) + tuple(a.shape[1:]))
    g = torch.roll(g, shifts=(dy, dx), dims=(0, 1))
    return g.reshape(a.shape)


def _edge_mask(ny, nx, dy, dx, dev):
    """CUs whose rolled (dy, dx) neighbour wrapped around the grid."""
    ii = torch.arange(ny, device=dev).repeat_interleave(nx)
    jj = torch.arange(nx, device=dev).repeat(ny)
    m = torch.zeros((ny * nx,), dtype=torch.bool, device=dev)
    if dy > 0:
        m |= ii == 0
    if dy < 0:
        m |= ii == ny - 1
    if dx > 0:
        m |= jj == 0
    if dx < 0:
        m |= jj == nx - 1
    return m


def _merge_best(blocks, cands, ls, nmerge):
    """The merge candidate of least SATD + lams * bins (a separately rounded
    product; strict <, so ties keep the first).  cands: (prediction,
    invalid) per candidate.  Returns (cost, pred, sel, bits)."""
    m_cost = m_pred = m_sel = m_bits = None
    for m, (pred, invalid) in enumerate(cands):
        satd = analysis.batched_satd(blocks - pred).to(torch.float32)
        bits = float(min(m + 1, nmerge - 1) + 1) + MERGE_FLAG_BITS
        cost = (satd + ls * bits) + torch.where(invalid, torch.inf, 0.0)
        if m == 0:
            m_cost, m_pred = cost, pred
            m_sel = torch.zeros(cost.shape, dtype=torch.int32,
                                device=cost.device)
            m_bits = torch.full(cost.shape, bits, dtype=torch.float32,
                                device=cost.device)
        else:
            better = cost < m_cost
            m_cost = torch.where(better, cost, m_cost)
            m_pred = torch.where(better[:, None, None], pred, m_pred)
            m_sel = torch.where(better, m, m_sel)
            m_bits = torch.where(better, bits, m_bits)
    return m_cost, m_pred, m_sel, m_bits


def _coded_or_skip(blocks, pred_best, bits_motion, is_merge, lf, s, bd, qp):
    """The residual trial of the chosen prediction against its zero-residual
    (skip) alternative: (skip flag, the lesser cost)."""
    sr, br, sz = _trial(blocks, pred_best, s, bd, qp)
    coded_bits = (br + bits_motion) + 2.0
    cost_coded = _fma32(lf.expand_as(coded_bits), coded_bits, sr)
    bits_zero = (bits_motion + torch.where(is_merge, 0.0, 1.0)) - \
        torch.where(is_merge, MERGE_FLAG_BITS - SKIP_EXTRA_BITS, 0.0)
    cost_zero = _fma32(lf.expand_as(bits_zero), bits_zero, sz)
    return cost_zero <= cost_coded, torch.minimum(cost_coded, cost_zero)


def _rect_pu(e0, e1):
    """A rect PU's list: list 1 where strictly cheaper (dir 2), else list
    0 (dir 1); e1 None for a P slice."""
    if e1 is None:
        return dict(e0, dir=torch.ones_like(e0["ridx"]))
    use1 = e1["cost"] < e0["cost"]
    out = {k: torch.where(use1[:, None] if e0[k].dim() == 2 else use1, e1[k],
                          e0[k]) for k in ("mv", "uref", "ridx", "bits")}
    out["dir"] = torch.where(use1, 2, 1).to(torch.int32)
    return out


def _rect_and_intra(blocks, suball, s, ny, nx, rect, intra, inter_cost, lf,
                    bd, qp):
    """The 2NxN / Nx2N shapes (rect: {1: pu, 2: pu} of `_rect_pu`, or None)
    and the intra alternative (size_rd's (mode, cost, top3), or None)
    against inter_cost, on the (ny, nx) grid of CUs.  Returns (part, pu
    (N, 8), intra flag, imode, icands (N, 3), CU cost)."""
    N = blocks.shape[0]
    dev = blocks.device
    i32 = torch.int32
    part_ch = torch.zeros((N,), dtype=i32, device=dev)
    pu = torch.zeros((N, 8), dtype=i32, device=dev)
    if rect is not None:
        shapes = []
        for part in (1, 2):
            e = rect[part]
            bh, bw = (s // 2, s) if part == 1 else (s, s // 2)
            Ny, Nx = (2 * ny, nx) if part == 1 else (ny, 2 * nx)
            pys, pxs = _grid_origins(bh, bw, Ny, Nx, dev)
            pp = _gather_pred(suball, pys, pxs, e["mv"], e["uref"], bh, bw)
            if part == 1:
                A = pp.reshape(ny, 2, nx, bh, bw)
                predc = torch.cat([A[:, 0], A[:, 1]], dim=-2)
            else:
                A = pp.reshape(ny, nx, 2, bh, bw)
                predc = torch.cat([A[:, :, 0], A[:, :, 1]], dim=-1)
            predc = predc.reshape(N, s, s)

            def split(a, _part=part):
                tail = tuple(a.shape[1:])
                if _part == 1:
                    g = a.reshape((ny, 2, nx) + tail)
                    return (g[:, 0].reshape((N,) + tail),
                            g[:, 1].reshape((N,) + tail))
                g = a.reshape((ny, nx, 2) + tail)
                return (g[:, :, 0].reshape((N,) + tail),
                        g[:, :, 1].reshape((N,) + tail))

            b0, b1 = split(e["bits"])
            bits_cu = (b0 + b1) + RECT_PART_BITS
            sr2, br2, sz2 = _trial(blocks, predc, s, bd, qp)
            cb = (br2 + bits_cu) + 2.0
            zb = bits_cu + 1.0
            cost_r = torch.minimum(_fma32(lf.expand_as(cb), cb, sr2),
                                   _fma32(lf.expand_as(zb), zb, sz2))
            d_a, d_b = split(e["dir"])
            mv_a, mv_b = split(e["mv"])
            r_a, r_b = split(e["ridx"])
            shapes.append((cost_r, torch.stack(
                [d_a, mv_a[:, 0], mv_a[:, 1], r_a,
                 d_b, mv_b[:, 0], mv_b[:, 1], r_b], 1)))
        (ca, pa), (cb_, pb) = shapes
        use_b = cb_ < ca
        rect_cost = torch.minimum(ca, cb_)
        part_ch = torch.where(rect_cost < inter_cost,
                              torch.where(use_b, 2, 1), 0).to(i32)
        pu = torch.where(use_b[:, None], pb, pa)
        inter_cost = torch.minimum(inter_cost, rect_cost)

    intra_flag = torch.zeros((N,), dtype=i32, device=dev)
    imode = torch.zeros((N,), dtype=i32, device=dev)
    icands = torch.zeros((N, 3), dtype=i32, device=dev)
    cu_cost = inter_cost
    if intra is not None:
        im, icost, ic3 = intra
        icost = icost + lf * INTRA_EXTRA_BITS
        intra_flag = (icost < inter_cost).to(i32)
        imode, icands = im, ic3
        cu_cost = torch.minimum(inter_cost, icost)
    return part_ch, pu, intra_flag, imode, icands, cu_cost


def _record(kind, msrc, dirv, skip, mv0, mv1, ref0, ref1, tail):
    """The (N, NREC) record of REC_FIELDS."""
    part_ch, pu, intra_flag, imode, icands, _ = tail
    return torch.stack([
        kind, msrc, dirv, skip.to(torch.int32), intra_flag, imode,
        mv0[:, 0], mv0[:, 1], mv1[:, 0], mv1[:, 1], ref0, ref1,
        icands[:, 0], icands[:, 1], icands[:, 2], part_ch,
        *pu.unbind(1)], 1).to(torch.int32)


def _cu_setup(cur, sub, s):
    h, w = cur.shape
    ny, nx = h // s, w // s
    dev = cur.device
    R = sub.shape[0]
    suball = sub.reshape((R * 16,) + tuple(sub.shape[2:]))
    ys, xs = _grid_origins(s, s, ny, nx, dev)
    blocks = _grid_blocks(cur, s, s, ny, nx)

    def pred_of(mv, uref):
        return _gather_pred(suball, ys, xs, mv, uref, s, s)

    return ny, nx, suball, blocks, pred_of


def _cu_rd_plain(cur, sub, s, uni, tmvp4, ref0, rect, intra, lamf, lams, qp,
                 bd, nmerge):
    ny, nx, suball, blocks, pred_of = _cu_setup(cur, sub, s)
    N = ny * nx
    dev = cur.device
    lf, ls = _f32(lamf, blocks), _f32(lams, blocks)
    i32 = torch.int32

    # merge set: left, above, the prior on list 0's first entry, zero
    zero = torch.zeros((N, 2), dtype=i32, device=dev)
    ref0v = torch.full((N,), ref0, dtype=i32, device=dev)
    zi = torch.zeros((N,), dtype=i32, device=dev)
    none = torch.zeros((N,), dtype=torch.bool, device=dev)
    hyps = [(_roll2(uni["mv"], ny, nx, dy, dx),
             _roll2(uni["uref"], ny, nx, dy, dx),
             _roll2(uni["ridx"], ny, nx, dy, dx),
             _edge_mask(ny, nx, dy, dx, dev)) for dy, dx in ((0, 1), (1, 0))]
    hyps += [(tmvp4, ref0v, zi, none), (zero, ref0v, zi, none)]
    m_cost, m_pred, m_sel, m_bits = _merge_best(
        blocks, ((pred_of(mv, ur), inv) for mv, ur, _, inv in hyps), ls,
        nmerge)
    ar = torch.arange(N, device=dev)
    m_mv = torch.stack([c[0] for c in hyps])[m_sel, ar]
    m_ridx = torch.stack([c[2] for c in hyps])[m_sel, ar]

    # kind: merge or uni-L0, ties to merge
    use_uni = uni["cost"] < m_cost
    kind = use_uni.to(i32) * KIND_UNI0
    bits_motion = torch.where(use_uni, uni["bits"], m_bits)
    pred_best = torch.where(use_uni[:, None, None],
                            pred_of(uni["mv"], uni["uref"]), m_pred)
    mv0 = torch.where(use_uni[:, None], uni["mv"], m_mv)
    ref0c = torch.where(use_uni, uni["ridx"], m_ridx)

    skip, inter_cost = _coded_or_skip(blocks, pred_best, bits_motion,
                                      ~use_uni, lf, s, bd, qp)
    rect_pu = None if rect is None else {
        p: _rect_pu(rect[p], None) for p in (1, 2)}
    tail = _rect_and_intra(blocks, suball, s, ny, nx, rect_pu, intra,
                           inter_cost, lf, bd, qp)
    rec = _record(kind, m_sel, torch.ones((N,), dtype=i32, device=dev), skip,
                  mv0, zero, ref0c, torch.full((N,), -1, dtype=i32,
                                               device=dev), tail)
    return rec, tail[-1]


def cu_rd(cur, sub, s: int, uni, tmvp4, ref0: int, rect, intra, lamf: float,
          lams: float, qp: int, bd: int, nmerge: int):
    """Price every CU of size s of a P picture (K8): the approximate merge
    set (left and above neighbours' list winners, the prior, zero), merge
    against uni-prediction, the residual trial and its skip alternative,
    the 2NxN / Nx2N shapes and the intra alternative.  Returns the per-CU
    record (N, NREC) int32 (fields REC_FIELDS) and the CU cost (N,) f32.
    uni: uni_select_all's result for the squares of size s; tmvp4: (N, 2)
    quarter-pel prior on list 0's first entry ref0; rect: {1: ..., 2: ...}
    uni_select_all results of the two rect shapes, or None; intra: size_rd's
    (mode, cost, top3) or None."""
    if _on_cuda(cur):
        return kernels.cu_rd(cur, sub, s, uni, tmvp4, ref0, rect, intra,
                             lamf, lams, qp, bd, nmerge)
    return _cu_rd_plain(cur, sub, s, uni, tmvp4, ref0, rect, intra, lamf,
                        lams, qp, bd, nmerge)


def _rbits(ridx, nref):
    """Reference-index bins of a list entry: min(ridx + 1, nref - 1) when
    the list has more than one live entry, else 0 (float32)."""
    if nref > 1:
        return torch.clamp(ridx + 1, max=nref - 1).to(torch.float32)
    return torch.zeros(ridx.shape, dtype=torch.float32, device=ridx.device)


def _cu_rd_b_plain(cur, sub, s, uni, tmvp4, first, nref, mvb, rect, intra,
                   lamf, lams, qp, bd, nmerge):
    ny, nx, suball, blocks, pred_of = _cu_setup(cur, sub, s)
    N = ny * nx
    dev = cur.device
    lf, ls = _f32(lamf, blocks), _f32(lams, blocks)
    i32 = torch.int32
    zero = torch.zeros((N, 2), dtype=i32, device=dev)
    zi = torch.zeros((N,), dtype=i32, device=dev)
    none = torch.zeros((N,), dtype=torch.bool, device=dev)

    def bi_pred(a, b):
        return (a + b + 1) >> 1

    # merge set of six bi candidates: the A1 / B1 / B0 / A0 neighbours'
    # list winners, the prior on each list's first entry, zero
    hyps = []
    for dy, dx in ((0, 1), (1, 0), (1, -1), (-1, 1)):
        hyps.append(([(_roll2(u["mv"], ny, nx, dy, dx),
                       _roll2(u["uref"], ny, nx, dy, dx),
                       _roll2(u["ridx"], ny, nx, dy, dx)) for u in uni],
                     _edge_mask(ny, nx, dy, dx, dev)))
    for prior in (True, False):
        hyps.append(([(tmvp4[lx] if prior else zero,
                       torch.full((N,), first[lx], dtype=i32, device=dev), zi)
                      for lx in (0, 1)], none))
    m_cost, m_pred, m_sel, m_bits = _merge_best(
        blocks, ((bi_pred(pred_of(*e[0][:2]), pred_of(*e[1][:2])), inv)
                 for e, inv in hyps), ls, nmerge)
    ar = torch.arange(N, device=dev)
    m_mv = [torch.stack([e[lx][0] for e, _ in hyps])[m_sel, ar]
            for lx in (0, 1)]
    m_ridx = [torch.stack([e[lx][2] for e, _ in hyps])[m_sel, ar]
              for lx in (0, 1)]

    # bi: the list winners' average, then the refined pair where cheaper
    pu0 = pred_of(uni[0]["mv"], uni[0]["uref"])
    pu1 = pred_of(uni[1]["mv"], uni[1]["uref"])
    pred_bi = bi_pred(pu0, pu1)
    satd = analysis.batched_satd(blocks - pred_bi).to(torch.float32)
    bits = (uni[0]["bits"] + uni[1]["bits"]) + \
        (BI_BASE_BITS - 2 * UNI_BASE_BITS)
    cost = _fma32(ls.expand_as(bits), bits, satd)
    pred_it = bi_pred(pred_of(mvb[0], uni[0]["uref"]),
                      pred_of(mvb[1], uni[1]["uref"]))
    satd_it = analysis.batched_satd(blocks - pred_it).to(torch.float32)
    a0, a1 = uni[0]["anchor"], uni[1]["anchor"]
    mb_it = _mvd_bits(mvb[0][:, 1] - a0[:, 1], mvb[0][:, 0] - a0[:, 0]) + \
        _mvd_bits(mvb[1][:, 1] - a1[:, 1], mvb[1][:, 0] - a1[:, 0])
    bits_it = ((mb_it + _rbits(uni[0]["ridx"], nref[0])) +
               _rbits(uni[1]["ridx"], nref[1])) + BI_BASE_BITS
    cost_it = _fma32(ls.expand_as(bits_it), bits_it, satd_it)
    it = cost_it < cost
    bi_cost = torch.where(it, cost_it, cost)
    bi_bits = torch.where(it, bits_it, bits)
    bi_pred_b = torch.where(it[:, None, None], pred_it, pred_bi)
    bi_mv = [torch.where(it[:, None], mvb[lx], uni[lx]["mv"])
             for lx in (0, 1)]

    # kind: the first least of merge, uni-L0, uni-L1, bi
    kind = torch.argmin(torch.stack([m_cost, uni[0]["cost"], uni[1]["cost"],
                                     bi_cost]), dim=0).to(i32)
    bits_motion = torch.stack([m_bits, uni[0]["bits"], uni[1]["bits"],
                               bi_bits])[kind, ar]
    pred_best = torch.stack([m_pred, pu0, pu1, bi_pred_b])[kind, ar]

    def pick(merge_v, uni0_v, uni1_v, bi_v):
        k = kind[:, None] if bi_v.dim() == 2 else kind
        out = torch.where(k == KIND_MERGE, merge_v, bi_v)
        out = torch.where(k == KIND_UNI0, uni0_v, out)
        return torch.where(k == KIND_UNI1, uni1_v, out)

    neg = torch.full((N,), -1, dtype=i32, device=dev)
    u0r, u1r = uni[0]["ridx"], uni[1]["ridx"]
    mv0 = pick(m_mv[0], uni[0]["mv"], zero, bi_mv[0])
    mv1 = pick(m_mv[1], zero, uni[1]["mv"], bi_mv[1])
    ref0 = pick(m_ridx[0], u0r, neg, u0r)
    ref1 = pick(m_ridx[1], neg, u1r, u1r)
    dirv = pick(torch.full((N,), 3, dtype=i32, device=dev),
                torch.full((N,), 1, dtype=i32, device=dev),
                torch.full((N,), 2, dtype=i32, device=dev),
                torch.full((N,), 3, dtype=i32, device=dev))

    skip, inter_cost = _coded_or_skip(blocks, pred_best, bits_motion,
                                      kind == KIND_MERGE, lf, s, bd, qp)
    rect_pu = None if rect is None else {
        p: _rect_pu(*rect[p]) for p in (1, 2)}
    tail = _rect_and_intra(blocks, suball, s, ny, nx, rect_pu, intra,
                           inter_cost, lf, bd, qp)
    return _record(kind, m_sel, dirv, skip, mv0, mv1, ref0, ref1, tail), \
        tail[-1]


def cu_rd_b(cur, sub, s: int, uni, tmvp4, first, nref, mvb, rect, intra,
            lamf: float, lams: float, qp: int, bd: int, nmerge: int):
    """Price every CU of size s of a B picture (K8, B mode): the merge set
    of six bi candidates (the A1 / B1 / B0 / A0 neighbours' list winners,
    the prior on each list's first entry, zero), uni-prediction from each
    list, bi-prediction from the two list winners or from the refined pair
    mvb where that is cheaper, the first least of the four kinds, the
    residual trial and its skip alternative, the 2NxN / Nx2N shapes (each
    PU from the cheaper list) and the intra alternative.  Returns the
    record (N, NREC) int32 and the CU cost (N,) f32.
    uni, tmvp4, first, nref, mvb: per list (pair): uni_select_all's result for
    the squares of size s, the (N, 2) quarter-pel prior on the list's first
    entry, that entry's reference index, the live entry count, and the
    (N, 2) bi-refined MV (frac_refine_any); rect: {1: (l0, l1), 2: (l0,
    l1)} uni_select_all results per shape and list, or None; intra: size_rd's
    (mode, cost, top3) or None."""
    if _on_cuda(cur):
        return kernels.cu_rd_b(cur, sub, s, uni, tmvp4, first, nref, mvb,
                               rect, intra, lamf, lams, qp, bd, nmerge)
    return _cu_rd_b_plain(cur, sub, s, uni, tmvp4, first, nref, mvb, rect,
                          intra, lamf, lams, qp, bd, nmerge)


# ---------------------------------------------------------------------------
# K4: quadtree DP and the packed plan (plain version)
# ---------------------------------------------------------------------------

def _emit_plain(recs, costs, lamf, h, w):
    dev = next(c.device for c in costs.values() if c is not None)
    lam = _f32(lamf, torch.zeros((), device=dev))
    h4, w4 = h // 4, w // 4
    shape_s = {s: (h // s, w // s) for s in SIZES}
    cost = {s: (costs[s].reshape(shape_s[s]) if costs[s] is not None
                else torch.zeros(shape_s[s], dtype=torch.float32, device=dev))
            for s in SIZES}
    split = lam * SPLIT_BITS
    zeros = lambda s: torch.zeros(shape_s[s], dtype=torch.bool, device=dev)
    cu16, split16 = cost[16], zeros(16)
    if shape_s[16][0] and cost[8].numel():
        quad = _quad(cost[8])[:shape_s[16][0], :shape_s[16][1]] + split
        split16 = quad < cu16
        cu16 = torch.minimum(cu16, quad)
    cu32, split32 = cost[32], zeros(32)
    if shape_s[32][0] and cu16.numel():
        quad = _quad(cu16)[:shape_s[32][0], :shape_s[32][1]] + split
        split32 = quad < cu32
        cu32 = torch.minimum(cu32, quad)
    split64 = zeros(64)
    if shape_s[64][0] and cu32.numel():
        quad = _quad(cu32)[:shape_s[64][0], :shape_s[64][1]] + split
        split64 = quad < cost[64]

    def border(s):
        ny, nx = shape_s[s]
        py, px = shape_s[2 * s]
        r = torch.arange(ny, device=dev)[:, None]
        c = torch.arange(nx, device=dev)[None, :]
        return (r >= 2 * py) | (c >= 2 * px)

    leaf64, desc64 = ~split64, split64
    active32 = _pad_to(_up(desc64, 2), *shape_s[32], False) | border(32)
    leaf32, desc32 = active32 & ~split32, active32 & split32
    active16 = _pad_to(_up(desc32, 2), *shape_s[16], False) | border(16)
    leaf16, desc16 = active16 & ~split16, active16 & split16
    leaf8 = _pad_to(_up(desc16, 2), *shape_s[8], False) | border(8)
    masks = {64: _pad_to(_up(leaf64, 16), h4, w4, False),
             32: _pad_to(_up(leaf32, 8), h4, w4, False),
             16: _pad_to(_up(leaf16, 4), h4, w4, False),
             8: _pad_to(_up(leaf8, 2), h4, w4, False)}
    neg = torch.full((h4, w4), -1, dtype=torch.int32, device=dev)
    depth = torch.where(masks[64], 0, torch.where(masks[32], 1, torch.where(
        masks[16], 2, torch.where(masks[8], 3, neg))))
    cov = masks[64] | masks[32] | masks[16] | masks[8]
    F = {n: i for i, n in enumerate(REC_FIELDS)}

    def chan(field, default, sizes=(64, 32, 16, 8)):
        out = torch.full((h4, w4), default, dtype=torch.int32, device=dev)
        for s in sizes:
            if recs[s] is None:
                continue
            f = s // 4
            g = recs[s][:, F[field]].reshape(shape_s[s])
            out = torch.where(masks[s], _pad_to(_up(g, f), h4, w4, default),
                              out)
        return out

    intra = torch.where(masks[64], 0, chan("intra", 0))
    cands = [chan(c, -1, (32, 16, 8)) for c in ("c0", "c1", "c2")]
    flags = cov.to(torch.int32) | (intra << 1) | (chan("skip", 0) << 2)
    return torch.stack([
        depth, flags, chan("kind", 0), chan("msrc", 0), chan("dir", 1),
        chan("mv0x", 0), chan("mv0y", 0), chan("mv1x", 0), chan("mv1y", 0),
        chan("ref0", -1), chan("ref1", -1), chan("imode", 0), *cands,
        chan("part", 0),
        *[chan(f, 0) for f in REC_FIELDS[16:]]]).to(torch.int16)


def emit(recs, costs, lamf: float, h: int, w: int):
    """Quadtree DP over the CU costs (split bits SPLIT_BITS, the reference's
    border rules) and the packed (24, h/4, w/4) int16 plan: depth, flags
    (covered | intra << 1 | skip << 2), kind, merge source, direction, the
    two MVs, reference indices, intra mode, three intra candidates, part
    and the two rect PUs (K4).  recs/costs: {s: (N, NREC) / (N,) or
    None}."""
    if _on_cuda(next(c for c in costs.values() if c is not None)):
        return kernels.emit_inter_plan(recs, costs, lamf, h, w)
    return _emit_plain(recs, costs, lamf, h, w)


# ---------------------------------------------------------------------------
# the P- and B-picture frame plan
# ---------------------------------------------------------------------------

def _plan_device(cur, refs, mvn16, dists, lam, lam_sqrt, qp, map0, nref0,
                 map1=None, nref1=0, me=None, *, h: int, w: int, bd: int,
                 nmerge: int, is_b: bool = False, parts: bool = True):
    """The whole P- or B-picture plan on the planes' device.  cur: (h, w)
    int32; refs: (R, h, w) int32, the live unique references; mvn16:
    (h/8, w/8, 2) int32 POC-normalised prior; dists: (R,) int32 signed POC
    distance cur - ref (negative for a future reference, so the prior
    flips); map0 / map1: (MAXREF_PLAN,) int32 list indices into refs,
    nref0 / nref1 live (list 1 only when is_b); me: int_me's grids computed
    elsewhere (the row-banded `parallel.plan_shard.sharded_int_me`, equal
    to int_me's), on the planes' device, or None to run int_me here.
    Returns the packed (24, h/4, w/4) int16 plan."""
    lamf = float(np.float32(lam))
    lams = float(np.float32(lam_sqrt))
    mvp8 = _mvp_full(mvn16, dists)
    mv_int = me if me is not None else \
        int_me(cur, refs, mvp8, lams, h, w, parts)
    sub = subpel_planes(refs, bd, h, w)
    lists = [(map0, nref0), (map1, nref1)] if is_b else [(map0, nref0)]
    first = [int(m[0]) for m, _ in lists]
    # every shape's q-pel refinement, then one launch of the list picks
    qpel = {}                     # (s, part): (mvq, satd, pred4 (R, N, 2))
    for s in SIZES:
        if not (h // s and w // s):
            continue
        for part in ((0, 1, 2) if (s, 1) in mv_int else (0,)):
            bh, bw = {0: (s, s), 1: (s // 2, s), 2: (s, s // 2)}[part]
            mvr = mv_int[(s, part)]
            Ny, Nx = mvr.shape[1:3]
            pp4 = 4 * _me_mvp(mvp8, s, part)[:, :Ny, :Nx]
            mq, sa = frac_refine(sub, cur, mvr, pp4, lams, bh, bw)
            qpel[(s, part)] = (mq, sa, pp4.reshape(pp4.shape[0], -1, 2)
                               .contiguous())
    keys = [(k, lx) for k in qpel for lx in range(len(lists))]
    picks = dict(zip(keys, uni_select_all(
        [qpel[k] + lists[lx] for k, lx in keys], lams)))
    # the intra alternative's K1, every size <= 32 in one launch
    isizes = [s for s in SIZES if s <= 32 and (s, 0) in qpel]
    k1 = dict(zip(isizes, intra_rd.ref_buffers_multi(
        [(cur, s, bd, True, h, w) for s in isizes]))) if isizes else {}
    recs, costs = {}, {}
    for s in SIZES:
        recs[s] = costs[s] = None
        if (s, 0) not in qpel:
            continue
        uni = [picks[((s, 0), lx)] for lx in range(len(lists))]
        rect = None
        if (s, 1) in qpel:
            rect = {part: [picks[((s, part), lx)] for lx in range(len(lists))]
                    for part in (1, 2)}
        intra = None
        if s in k1:
            m, c, c3, _ = intra_rd.size_rd(*k1[s], lamf, s, bd, 3, qp,
                                           True, False, False, inter=True)
            intra = (m, c, c3)
        pred4 = qpel[(s, 0)][2]
        tmvp4 = [pred4[f].contiguous() for f in first]
        if not is_b:
            recs[s], costs[s] = cu_rd(
                cur, sub, s, uni[0], tmvp4[0], first[0],
                None if rect is None else {p: e[0] for p, e in rect.items()},
                intra, lamf, lams, qp, bd, nmerge)
            continue
        # the two-pass bi refinement: list 1 against 2 * orig - pred0,
        # then list 0 against 2 * orig - pred1'
        u0, u1 = uni
        mv1b, _ = frac_refine_any(sub, cur, u1["mv"], u1["uref"],
                                  u1["anchor"], u0["uref"], u0["mv"], lams, s)
        mv0b, _ = frac_refine_any(sub, cur, u0["mv"], u0["uref"],
                                  u0["anchor"], u1["uref"], mv1b, lams, s)
        recs[s], costs[s] = cu_rd_b(
            cur, sub, s, uni, tmvp4, first, [n for _, n in lists],
            [mv0b, mv1b], rect, intra, lamf, lams, qp, bd, nmerge)
    return emit(recs, costs, lamf, h, w)


# ---------------------------------------------------------------------------
# host interface
# ---------------------------------------------------------------------------

class InterPlan:
    """Dense frame plan for a P or B frame.  Field names shared with
    intra_rd.IntraPlan so the intra commit path works unchanged on the
    plan's intra CUs."""

    __slots__ = ("depth", "nxn", "mode", "cov", "tusplit", "cmode",
                 "cands", "h4", "w4", "is_inter_plan", "pred_inter",
                 "skip_hint", "kind", "msrc", "dir", "mv", "ref",
                 "part", "pu")

    def __init__(self, h4, w4):
        self.h4, self.w4 = h4, w4
        self.is_inter_plan = True


class PlanFuture:
    """A submitted plan: the packed host tensor and, on CUDA, the event
    recorded after its device-to-host copy."""

    __slots__ = ("host", "event")

    def __init__(self, host, event):
        self.host, self.event = host, event


def fetch_plan(fut: PlanFuture, h, w):
    """Wait for a submitted plan and unpack the packed (24, h/4, w/4) plan
    into an InterPlan (one wait per frame)."""
    wait = _trace.ON and _trace.wait_open()
    if fut.event is not None:
        fut.event.synchronize()
    wait and _trace.close(wait)
    p = fut.host.numpy().astype(np.int32)
    h4, w4 = h // 4, w // 4
    plan = InterPlan(h4, w4)
    plan.depth = p[0].astype(np.int8)
    flags = p[1]
    plan.cov = (flags & 1) != 0
    plan.pred_inter = ((flags & 2) == 0) & plan.cov
    plan.skip_hint = (flags & 4) != 0
    plan.kind = p[2].astype(np.int8)
    plan.msrc = p[3].astype(np.int8)
    plan.dir = p[4].astype(np.int8)
    plan.mv = np.stack([np.stack([p[5], p[6]], axis=-1),
                        np.stack([p[7], p[8]], axis=-1)]).astype(np.int32)
    plan.ref = np.stack([p[9], p[10]]).astype(np.int8)
    plan.mode = p[11].astype(np.int8)
    plan.cands = np.stack([p[12], p[13], p[14]], axis=-1).astype(np.int8)
    plan.part = p[15].astype(np.int8)
    plan.pu = np.stack([p[16:20], p[20:24]]).astype(np.int32)
    plan.nxn = np.zeros((h4, w4), dtype=bool)
    plan.tusplit = np.zeros((h4, w4), dtype=bool)
    plan.cmode = np.full((h4, w4), 4, dtype=np.int8)
    return plan


_REF_CACHE: dict = {}     # id(plane) -> (weakref(plane), device tensor)


def _device_ref(plane, h, w, device):
    """Device copy of a reference plane, cached across frames: keyed by
    object identity with a weakref guard (a recycled id cannot alias a new
    plane), least recently used evicted beyond 24 entries."""
    key = (id(plane), str(device))
    ent = _REF_CACHE.get(key)
    if ent is not None:
        ref_w, t = ent
        if ref_w() is plane and tuple(t.shape) == (h, w):
            _REF_CACHE[key] = _REF_CACHE.pop(key)
            return t
        del _REF_CACHE[key]
    t = _to_device(plane[:h, :w], device)
    try:
        ref_w = weakref.ref(plane)
    except TypeError:
        return t
    _REF_CACHE[key] = (ref_w, t)
    while len(_REF_CACHE) > 24:
        _REF_CACHE.pop(next(iter(_REF_CACHE)))
    return t


def _to_device(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)) \
        .to(device)


def _plan_inputs(sps, sh, rc):
    """The live unique reference planes (list 0's entries, then list 1's on
    a B slice, deduplicated by identity in that order), the two list maps
    padded to MAXREF_PLAN and their live counts (list 1 empty on a P
    slice), the signed POC distances, and whether the planes were weighted
    (then not cacheable)."""
    bd = sps.bit_depth_luma
    nlists = 2 if sh.slice_type == B_SLICE else 1
    uniq, keymap = [], {}
    for lx in range(nlists):
        for r_idx in range(min(sh.num_ref_idx[lx], len(rc.ref_lists[lx]))):
            ref = rc.ref_lists[lx][r_idx]
            for j, (k2, _, _) in enumerate(uniq):
                if k2 == id(ref):
                    keymap[(lx, r_idx)] = j
                    break
            else:
                keymap[(lx, r_idx)] = len(uniq)
                uniq.append((id(ref), ref.rec[0], ref.poc))
    planes = [p for _, p, _ in uniq]
    weighted = False
    if getattr(sh, "pred_weights", None):
        # WP-aware pricing: fold each reference's explicit luma weight and
        # offset into its plane (the reference's plan_frame, :1227-1248)
        wmap = {}
        for key, j in keymap.items():
            wp = sh.pred_weights.get(key + (0,))
            if wp is not None and wp.present and j not in wmap:
                wmap[j] = wp
        if any(wp.weight != (1 << wp.log2_denom) or wp.offset
               for wp in wmap.values()):
            weighted = True
            maxv = (1 << bd) - 1
            off_scale = 1 << max(bd - 8, 0)
            for j, p in enumerate(planes):
                wp = wmap.get(j)
                if wp is None or (wp.weight == (1 << wp.log2_denom)
                                  and not wp.offset):
                    continue
                rnd = (1 << (wp.log2_denom - 1)) if wp.log2_denom else 0
                q = ((p.astype(np.int64) * wp.weight + rnd)
                     >> wp.log2_denom) + wp.offset * off_scale
                planes[j] = np.clip(q, 0, maxv).astype(np.int32)
    maps, nrefs = [], []
    for lx in range(2):
        m = [j for (l2, _), j in keymap.items() if l2 == lx]
        maps.append((m + [0] * MAXREF_PLAN)[:MAXREF_PLAN])
        nrefs.append(min(len(m), MAXREF_PLAN))
    dists = [sh.poc - poc for _, _, poc in uniq]
    return planes, maps, nrefs, dists, weighted


def submit_plan(orig_y, sps, sh, rc, prev_mv8, lam, lam_sqrt,
                device: torch.device, mesh=None):
    """Enqueue the P- or B-picture plan on `device` without waiting for it:
    the kernels and the copy of the packed plan into pinned host memory are
    queued on the current stream.  With a row mesh (`parallel.frame_shard.
    make_row_mesh`) whose bands the geometry allows
    (`parallel.plan_shard.shardable`), the integer ME runs row-banded over
    it and the plan takes its grids.  Returns None when the slice has no
    reference."""
    h, w = sps.pic_height, sps.pic_width
    planes, maps, nrefs, dists, weighted = _plan_inputs(sps, sh, rc)
    if not planes:
        return None
    parts = not os.environ.get("HM16_NO_PLAN_PARTS")
    mvn16 = (np.zeros((h // 8, w // 8, 2), np.int32) if prev_mv8 is None
             else np.asarray(prev_mv8, np.int32))
    refs = torch.stack([_to_device(p[:h, :w], device) if weighted
                        else _device_ref(p, h, w, device) for p in planes])
    lmaps = [torch.as_tensor(m, dtype=torch.int32, device=device)
             for m in maps]
    cur = _to_device(orig_y[:h, :w], device)
    mvn16 = _to_device(mvn16, device)
    dists = torch.as_tensor(dists, dtype=torch.int32, device=device)
    me = None
    if mesh is not None:
        from hm16_2_tpu_torch.parallel import plan_shard
        if plan_shard.shardable(mesh, h, w, parts):
            me = {k: g.to(device) for k, g in plan_shard.sharded_int_me(
                mesh, cur, refs, mvn16, dists, lam_sqrt, h, w).items()}
    packed = _plan_device(
        cur, refs, mvn16, dists, lam, lam_sqrt,
        sh.qp + 6 * (sps.bit_depth_luma - 8), lmaps[0], nrefs[0], lmaps[1],
        nrefs[1], me, h=h, w=w, bd=sps.bit_depth_luma,
        nmerge=sh.max_num_merge_cand, is_b=sh.slice_type == B_SLICE,
        parts=parts)
    if packed.device.type != "cuda":
        return PlanFuture(packed, None)
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return PlanFuture(host, event)


def plan_frame(orig_y, sps, sh, rc, prev_mv8, lam, lam_sqrt,
               device: torch.device, mesh=None, fetch: bool = True):
    """Plan one P or B picture.  rc: mvpred.RefCtx with the frame's
    reference lists; mesh: a row mesh for the banded integer ME (see
    submit_plan).  fetch=True waits and returns the InterPlan; fetch=False
    returns a function that does.  None when the slice has no reference."""
    fut = submit_plan(orig_y, sps, sh, rc, prev_mv8, lam, lam_sqrt, device,
                      mesh)
    if fut is None:
        return None
    h, w = sps.pic_height, sps.pic_width
    if not fetch:
        return lambda: fetch_plan(fut, h, w)
    return fetch_plan(fut, h, w)

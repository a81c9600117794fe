"""Frame-level batched intra RD plan in PyTorch (the all-intra encode path).

Counterpart of `hm16_2_tpu/encode/intra_rd.py`, which describes the
algorithm.  Each stage is a wrapper that runs a hand-written CUDA kernel
(`hm16_2_tpu_torch.kernels`) on a CUDA tensor and the plain PyTorch version
beside it on a CPU tensor:

    ref_buffers   K1  reference samples + original blocks per size
                      (ref_buffers_multi: every size and plane of a
                      picture in one launch)
    size_rd       K2  35-mode prediction, SATD, top-k, transform RD, top-3
    premodes      K2  the same kernel in SATD-only mode (host fallback)
    cand_rd       K3  dist and bits of given modes (chroma, 64x64 level)
    plan_pre      K4  chroma candidates and 64x64 modes (one launch)
    plan_dp       K4  chroma fold, 64x64 cost, quadtree DP, plan emission
                      (one launch, a CTA per pair of CTUs)

Float32 parity.  The plan is integer maths ranked by float32 costs, and a
1-ulp difference flips an argmin.  The reference runs under XLA:CPU, whose
LLVM backend contracts a multiply feeding an add into one fused
multiply-add where both sit in one fused loop.  The plain versions below
reproduce each such step with `_fma32` (single rounding) and every other
step with separate float32 operations; the kernels use `__fmaf_rn` at the
same places and are compiled with `--fmad=false`.  XLA also computes
`log2(x)` as `ln(x) * 1.44269502`, so the last-position term uses
`LN_LAST`, XLA's own float32 `ln(i + 1.5)` for i in 0..31.
"""

from __future__ import annotations

import numpy as np
import torch

from hm16_2_tpu_torch.common.tables import INV_QUANT_SCALES
from hm16_2_tpu_torch import kernels
from hm16_2_tpu_torch.ops import analysis

TRANSFORM_MATRIX_SHIFT = 6

# plan constants, copied from the reference (a test asserts equality)
BITS_SCALE = 1.0
NXN_OVERHEAD_BITS = 4.0
SPLIT_OVERHEAD_BITS = 3.0
NUM_RD_CANDS = {4: 4, 8: 4, 16: 3, 32: 3}

# float32 ln(i + 1.5), i = 0..31, exactly as XLA:CPU's `log` returns it
# (a test re-derives it from jnp.log); the residual-bits model's
# last-position term indexes it by the last significant row / column
LN_LAST = np.array([float.fromhex(v) for v in (
    "0x1.9f323ep-2", "0x1.d52410p-1", "0x1.40b514p+0", "0x1.810b38p+0",
    "0x1.b46a60p+0", "0x1.df2e6ep+0", "0x1.01e858p+1", "0x1.11edb0p+1",
    "0x1.202a54p+1", "0x1.2cf9dep+1", "0x1.389ed4p+1", "0x1.434b14p+1",
    "0x1.4d24f0p+1", "0x1.564a80p+1", "0x1.5ed3d8p+1", "0x1.66d484p+1",
    "0x1.6e5c9ap+1", "0x1.757982p+1", "0x1.7c368ap+1", "0x1.829d48p+1",
    "0x1.88b5f6p+1", "0x1.8e87acp+1", "0x1.941898p+1", "0x1.996e20p+1",
    "0x1.9e8d04p+1", "0x1.a3797ap+1", "0x1.a83740p+1", "0x1.acc9a8p+1",
    "0x1.b133b4p+1", "0x1.b57812p+1", "0x1.b99932p+1", "0x1.bd9946p+1")],
    dtype=np.float32)
LOG2E = np.float32(1.44269502)       # XLA's 1/ln(2) for log2 = ln * LOG2E
# the bits model's two trailing constants (-12.817 fit, +1.0 cbf), which
# XLA folds into one float32 constant before adding
BITS_CONST = np.float32(np.float32(-12.817) + np.float32(1.0))
BITS_EMPTY = np.float32(0.8)         # a block without coefficients
BITS_FLOOR = np.float32(2.0)         # lower bound of the model
LUMA_MODE_BITS = np.float32(6.0)     # flat luma mode bits in the RD cost
BITS_COEF = {k: np.float32(v) for k, v in (
    ("nzc", -0.089), ("nnz", 3.798), ("gt1", 0.648), ("esc", 0.616),
    ("last", 2.275), ("cgs", 1.173))}


# ---------------------------------------------------------------------------
# float32 helpers
# ---------------------------------------------------------------------------

def _f32(v, like):
    return torch.tensor(np.float32(v), dtype=torch.float32,
                        device=like.device)


def _fma32(a, b, c):
    """float32 a*b + c with a single rounding, as a fused multiply-add.

    a*b is exact in float64; the float64 sum is corrected by its TwoSum
    error where it lands exactly halfway between two float32 values, so the
    result is the correctly rounded float32 of the exact a*b + c."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bp = s - c64
    err = (p - bp) + (c64 - (s - bp))
    r = s.float()
    diff = s - r.double()
    toward = torch.where(diff > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, float("-inf")))
    nb = torch.nextafter(r, toward)
    mid = (diff != 0) & ((r.double() + nb.double()) * 0.5 == s)
    take = mid & (err != 0) & ((err > 0) == (diff > 0))
    return torch.where(take, nb, r)


# ---------------------------------------------------------------------------
# batched integer transform pipeline
# ---------------------------------------------------------------------------

def batched_dequant(levels, qp: int, bit_depth: int, log2_tr: int):
    """Flat-matrix dequant (transforms_ref.dequant, scaling list None)."""
    per, rem = qp // 6, qp % 6
    max_dr = 15
    tshift = max_dr - bit_depth - log2_tr
    right_shift = 6 - (tshift + per)
    scale = int(INV_QUANT_SCALES[rem])
    target_bd = min(max_dr + 1, 32 + right_shift - 7)
    imin, imax = -(1 << (target_bd - 1)), (1 << (target_bd - 1)) - 1
    q = torch.clamp(levels.to(torch.int32), imin, imax)
    if right_shift > 0:
        out = (q * scale + (1 << (right_shift - 1))) >> right_shift
    else:
        out = (q * scale) << (-right_shift)
    return torch.clamp(out, -(1 << max_dr), (1 << max_dr) - 1) \
        .to(torch.int32)


def batched_inv_transform(coeffs, bit_depth: int, use_dst: bool):
    """Inverse 2-D transform with HM's intermediate clamps (xITrMxN)."""
    s = coeffs.shape[-1]
    t = analysis._transform_matrix(s, use_dst, coeffs.device)
    max_dr = 15
    s1 = TRANSFORM_MATRIX_SHIFT + 1
    s2 = (TRANSFORM_MATRIX_SHIFT + max_dr - 1) - bit_depth
    lo, hi = -(1 << max_dr), (1 << max_dr) - 1
    stage1 = torch.clamp(
        (analysis._imatmul(t.T, coeffs) + (1 << (s1 - 1))) >> s1, lo, hi)
    out = torch.clamp(
        (analysis._imatmul(stage1, t) + (1 << (s2 - 1))) >> s2,
        -32768, 32767)
    return out.to(torch.int32)


# ---------------------------------------------------------------------------
# estimated residual bits (context-free CABAC cost model)
# ---------------------------------------------------------------------------

def _bit_length(x):
    """Bits of non-negative int32 values below 2^24 (0 -> 0); equals the
    reference's float32 ceil(log2(x + 1))."""
    return torch.frexp(x.to(torch.float32))[1].to(torch.int32)


def _bits_estimate(lvl):
    """Approximate CABAC bits for (..., s, s) int32 level blocks: the
    reference's regression, with XLA:CPU's float32 rounding steps."""
    a = lvl.abs()
    s = lvl.shape[-1]
    nz = a > 0
    nnz = nz.sum((-1, -2), dtype=torch.int32)
    ys = torch.arange(s, device=lvl.device, dtype=torch.int32)
    last_y = torch.where(nz.any(-1), ys, -1).amax(-1)
    last_x = torch.where(nz.any(-2), ys, -1).amax(-1)
    n_zero_coded = torch.clamp((last_x + 1) * (last_y + 1) - nnz, min=0)
    esc = torch.clamp(a - 1, min=0)
    esc_bits = torch.where(a > 1, 2 * _bit_length(esc) + 1, 0) \
        .sum((-1, -2), dtype=torch.int32)
    gt1 = (a > 1).sum((-1, -2), dtype=torch.int32)
    n_cgs = torch.clamp((torch.div(last_x, 4, rounding_mode="floor") + 1)
                        * (torch.div(last_y, 4, rounding_mode="floor") + 1)
                        - 1, min=0)
    ln = torch.as_tensor(LN_LAST, device=lvl.device)
    lx = ln[last_x.clamp(min=0).long()]
    ly = ln[last_y.clamp(min=0).long()]
    log2e = _f32(LOG2E, lvl)
    lastpos = _fma32(lx, log2e, ly * log2e) * 2.0 + 2.0
    lastpos = torch.where(nnz > 0, lastpos, torch.zeros_like(lastpos))
    k = {n: _f32(v, lvl) for n, v in BITS_COEF.items()}
    f = torch.float32
    bits = _fma32(nnz.to(f), k["nnz"], n_zero_coded.to(f) * k["nzc"])
    bits = _fma32(-gt1.to(f), k["gt1"], bits)
    bits = _fma32(esc_bits.to(f), k["esc"], bits)
    bits = bits + lastpos * k["last"]
    bits = _fma32(n_cgs.to(f), k["cgs"], bits)
    bits = bits + _f32(BITS_CONST, lvl)
    return torch.where(nnz > 0, torch.clamp(bits, min=float(BITS_FLOOR)),
                       _f32(BITS_EMPTY, lvl))


# ---------------------------------------------------------------------------
# per-size candidate evaluation (plain versions of K2 / K3)
# ---------------------------------------------------------------------------

def _topk_argmin(x, k):
    """Indices of the k smallest entries per row, ascending; ties go to the
    lowest index, as in the reference's iterative masked argmin."""
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    idxs = []
    for _ in range(k):
        i = torch.argmin(x, dim=1)
        idxs.append(i)
        x = torch.where(cols == i[:, None], torch.inf, x)
    return torch.stack(idxs, 1)


def _take_modes(preds, modes):
    s = preds.shape[-1]
    return torch.gather(preds, 1, modes[:, :, None, None].long()
                        .expand(-1, -1, s, s))


def _cand_chain(blocks, cand, s, bd, qp, use_dst, inter=False):
    """Transform RD of candidate predictions (N, K, s, s) against
    (N, s, s) originals: int32 SSE as float32, and the level blocks.
    inter: quantise with the inter rounding offset (85, else 171)."""
    resi = blocks[:, None] - cand
    log2 = s.bit_length() - 1
    fwd = analysis.batched_fwd_transform(resi, bd, use_dst)
    lvl = analysis.batched_quant(fwd, qp, bd, log2, not inter)
    deq = batched_dequant(lvl, qp, bd, log2)
    rres = batched_inv_transform(deq, bd, use_dst)
    rec = torch.clamp(cand + rres, 0, (1 << bd) - 1)
    d = blocks[:, None] - rec
    dist = (d * d).sum((-1, -2), dtype=torch.int32).to(torch.float32)
    return dist, lvl


def _size_rd_plain(bufs, blocks, lam, s, bd, k, qp, is_luma, use_dst,
                   want_satd, inter=False):
    preds = analysis.predict_all_modes(bufs, s, is_luma, bd)
    satd = analysis.batched_satd(preds - blocks[:, None])
    topk = _topk_argmin(satd.to(torch.float32), k)
    cand = _take_modes(preds, topk)
    dist, lvl = _cand_chain(blocks, cand, s, bd, qp, use_dst, inter)
    bits = BITS_SCALE * _bits_estimate(lvl) + float(LUMA_MODE_BITS)
    cost = _fma32(_f32(lam, dist).expand_as(bits), bits, dist)
    rd_order = _topk_argmin(cost, 3)
    top3 = torch.gather(topk, 1, rd_order).to(torch.int32)
    best_cost = torch.gather(cost, 1, rd_order[:, :1])[:, 0]
    return top3[:, 0], best_cost, top3, satd if want_satd else None


def _premodes_plain(bufs, blocks, s, bd):
    preds = analysis.predict_all_modes(bufs, s, True, bd)
    satd = analysis.batched_satd(preds - blocks[:, None])
    return torch.argmin(satd, dim=1).to(torch.int32)


def _cand_rd_plain(bufs, blocks, modes, s, bd, qp, is_luma, use_dst):
    preds = analysis.predict_all_modes(bufs, s, is_luma, bd)
    dist, lvl = _cand_chain(blocks, _take_modes(preds, modes), s, bd, qp,
                            use_dst)
    return dist, _bits_estimate(lvl)


def _ref_buffers_plain(plane, s, bd, strong, h, w):
    nby, nbx = h // s, w // s
    ph, pw = plane.shape
    dev = plane.device
    x0s = (torch.arange(nbx, device=dev) * s).repeat(nby)
    y0s = (torch.arange(nby, device=dev) * s).repeat_interleave(nbx)
    rng = torch.arange(-1, 2 * s, device=dev)
    tops = plane[torch.clamp(y0s - 1, min=0)[:, None],
                 torch.clamp(x0s[:, None] + rng[None, :], 0, pw - 1)]
    lrng = torch.arange(-1, 2 * s, device=dev)
    lefts = plane[torch.clamp(y0s[:, None] + lrng[None, :], 0, ph - 1),
                  torch.clamp(x0s - 1, min=0)[:, None]]
    blocks = plane[:nby * s, :nbx * s].reshape(nby, s, nbx, s) \
        .transpose(1, 2).reshape(nby * nbx, s, s).to(torch.int32)
    return _pack_buffers(tops, lefts, s, bd, strong), blocks


def _pack_buffers(tops, lefts, s, bd, strong):
    """(N, 2, 4s+1) [unfiltered, filtered] buffers from the (N, 2s+1)
    top row (corner first) and left column (top-down, its first entry
    unused: the corner comes from the top row), with the [1 2 1] filter and
    at s = 32 the strong smoothing."""
    dev = tops.device
    tops = tops.to(torch.int32)
    lefts = lefts.to(torch.int32)
    buf_u = torch.cat([lefts[:, 1:].flip(1), tops[:, :1], tops[:, 1:]], 1)
    buf_f = buf_u.clone()
    buf_f[:, 1:-1] = (buf_u[:, 2:] + 2 * buf_u[:, 1:-1] + buf_u[:, :-2]
                      + 2) >> 2
    if s == 32 and strong:
        thr = 1 << (bd - 5)
        c0, cs_, c2s = buf_u[:, 2 * s], buf_u[:, 3 * s], buf_u[:, 4 * s]
        l0, ls_, l2s = buf_u[:, 2 * s], buf_u[:, s], buf_u[:, 0]
        use = ((c0 + c2s - 2 * cs_).abs() < thr) & \
              ((l0 + l2s - 2 * ls_).abs() < thr)
        i = torch.arange(1, 2 * s, device=dev, dtype=torch.int32)
        top_bl = ((2 * s - i)[None, :] * c0[:, None]
                  + i[None, :] * c2s[:, None] + s) >> 6
        left_bl = ((2 * s - i)[None, :] * l0[:, None]
                   + i[None, :] * l2s[:, None] + s) >> 6
        sb = buf_u.clone()
        sb[:, 2 * s + 1: 4 * s] = top_bl
        sb[:, 1: 2 * s] = left_bl.flip(1)
        buf_f = torch.where(use[:, None], sb, buf_f)
    return torch.stack([buf_u, buf_f], 1)


# ---------------------------------------------------------------------------
# wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _on_cuda(t):
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def ref_buffers(plane, s: int, bd: int, strong: bool, h: int, w: int):
    """(N, 2, 4s+1) original-pixel reference buffers (unfiltered, filtered)
    and (N, s, s) original blocks for every aligned s-block inside (h, w),
    in raster order (K1)."""
    if _on_cuda(plane):
        return kernels.ref_buffers(plane, s, bd, strong, h, w)
    return _ref_buffers_plain(plane, s, bd, strong, h, w)


def ref_buffers_multi(entries):
    """ref_buffers of each entry (plane, s, bd, strong, h, w), up to
    kernels.MAX_K1 of them, in one K1 launch: a list of (bufs, blocks)."""
    if _on_cuda(entries[0][0]):
        return kernels.ref_buffers_multi(entries)
    return [_ref_buffers_plain(*e) for e in entries]


def size_rd(bufs, blocks, lam: float, s: int, bd: int, k: int, qp: int,
            is_luma: bool = True, use_dst: bool = False,
            want_satd: bool = False, inter: bool = False):
    """Best mode + RD cost for N blocks of one size (K2).  Returns
    (best_mode (N,) i32, cost (N,) f32, top3 (N, 3) i32, satd (N, 35) i32
    or None).  inter: the inter plan's intra alternative, quantised with
    the inter rounding offset."""
    if _on_cuda(bufs):
        return kernels.intra_size_rd(bufs, blocks, lam, s, bd, k, qp,
                                     is_luma, use_dst, want_satd, inter)
    return _size_rd_plain(bufs, blocks, lam, s, bd, k, qp, is_luma,
                          use_dst, want_satd, inter)


def premodes(bufs, blocks, s: int, bd: int):
    """Per-block 35-mode luma SATD argmin, ties to the lowest mode (K2 in
    SATD-only mode)."""
    if _on_cuda(bufs):
        return kernels.intra_premodes(bufs, blocks, s, bd)
    return _premodes_plain(bufs, blocks, s, bd)


def cand_rd(bufs, blocks, modes, s: int, bd: int, qp: int,
            is_luma: bool = False, use_dst: bool = False):
    """(dist, bits) float32 (N, K) for K given modes per block (K3)."""
    if _on_cuda(bufs):
        return kernels.intra_cand_rd(bufs, blocks, modes, s, bd, qp,
                                     is_luma, use_dst)
    return _cand_rd_plain(bufs, blocks, modes, s, bd, qp, is_luma, use_dst)


# ---------------------------------------------------------------------------
# the frame plan: chroma fold, 64x64 level, quadtree DP, emission (K4)
# ---------------------------------------------------------------------------

CHROMA_BASE_MODES = (0, 26, 10, 1)      # planar, ver, hor, DC; then DM
CHROMA_MODE_BITS = (4.0, 4.0, 4.0, 4.0, 1.0)


def _chroma_modes5_plain(dm):
    cols = [torch.where(dm == m, 34, m) for m in CHROMA_BASE_MODES] + [dm]
    return torch.stack(cols, 1).to(torch.int32)


def chroma_modes5(dm):
    """(N, 5) chroma candidates {planar, 26, 10, DC, DM}, 34 replacing a
    base mode equal to DM (K4's first launch, plan_pre)."""
    if _on_cuda(dm):
        return kernels.plan_pre([dm], None, 0, 0)[0][0]
    return _chroma_modes5_plain(dm)


def _chroma_fold_plain(d_cb, b_cb, d_cr, b_cr, cost, lam, cw):
    lamf = _f32(lam, cost)
    cwf = _f32(cw, cost)
    mb = torch.as_tensor(np.asarray(CHROMA_MODE_BITS, np.float32),
                         device=cost.device)
    # XLA contracts every product here except Cb's d * cw, which it rounds
    # before adding it to lam * mode_bits (an exact product)
    tot = (lamf * mb)[None, :] + d_cb * cwf
    tot = _fma32(lamf.expand_as(b_cb), b_cb, tot)
    tot = _fma32(d_cr, cwf.expand_as(d_cr), tot)
    tot = _fma32(lamf.expand_as(b_cr), b_cr, tot)
    best = torch.argmin(tot, dim=1)
    add = torch.gather(tot, 1, best[:, None])[:, 0].reshape(cost.shape)
    return cost + add, add, best.to(torch.int32).reshape(cost.shape)


def chroma_fold(d_cb, b_cb, d_cr, b_cr, cost, lam: float, cw: float):
    """Fold the chroma RD of the five candidates into one luma size's
    cost grid: (cost + best, best chroma cost, best candidate index).  On
    the card the fold runs inside K4's CTU kernel (plan_dp)."""
    if _on_cuda(cost):
        raise ValueError("chroma_fold: on the card the fold runs inside "
                         "plan_dp's kernel")
    return _chroma_fold_plain(d_cb, b_cb, d_cr, b_cr, cost, lam, cw)


def _quad(a):
    """Sum 2x2 neighbourhoods (truncating odd edges), in the reference's
    float32 order."""
    hh, ww = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
    q = a[:hh, :ww]
    return q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]


def _up(a, f):
    return a.repeat_interleave(f, 0).repeat_interleave(f, 1)


def _pad_to(a, hh, ww, fill):
    out = torch.full((hh, ww) + tuple(a.shape[2:]), fill, dtype=a.dtype,
                     device=a.device)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _mode64_plain(satd32, nby64, nbx64):
    ss = satd32[:nby64 * 2, :nbx64 * 2]
    quad_satd = (ss[0::2, 0::2] + ss[0::2, 1::2]
                 + ss[1::2, 0::2] + ss[1::2, 1::2])
    mode64 = torch.argmin(quad_satd, dim=2).to(torch.int32)
    return mode64, _up(mode64, 2).reshape(-1)


def _plan_pre_plain(dms, satd32, nby64, nbx64):
    m64 = (None, None) if satd32 is None else \
        _mode64_plain(satd32, nby64, nbx64)
    return [_chroma_modes5_plain(d) for d in dms], *m64


def plan_pre(dms, satd32, nby64: int, nbx64: int):
    """The chroma candidates (chroma_modes5) of each DM grid of `dms` and,
    with satd32 (nby32, nbx32, 35), the 64x64 CU modes from the quad-summed
    int32 TU32 SATD (argmin, ties to the lowest mode) and that mode for
    each of its four TU32s in raster order of the (2*nby64, 2*nbx64) grid
    (else None, None): K4's first launch."""
    if satd32 is None and not dms:
        return [], None, None
    lead = satd32 if satd32 is not None else dms[0]
    if _on_cuda(lead):
        return kernels.plan_pre(dms, satd32, nby64, nbx64)
    return _plan_pre_plain(dms, satd32, nby64, nbx64)


def _plan_dp_plain(lam, h, w, mode_s, cost_s, cand_s, cmode_s, chroma_add32,
                   d64, b64, mode64_g):
    lamf = _f32(lam, cost_s[4])
    dev = lamf.device
    shape_s = {s: (h // s, w // s) for s in (4, 8, 16, 32, 64)}
    nby64, nbx64 = shape_s[64]
    cost64 = None
    if d64 is not None:
        cc = _fma32(lamf.expand_as(b64), b64, d64) \
            .reshape(2 * nby64, 2 * nbx64)
        cost64 = _quad(cc) + lamf * 8.0
        if chroma_add32 is not None:
            cost64 = cost64 + _quad(chroma_add32[:nby64 * 2, :nbx64 * 2])

    nby8, nbx8 = shape_s[8]
    nby16, nbx16 = shape_s[16]
    nby32, nbx32 = shape_s[32]
    zeros = lambda hh, ww: torch.zeros((hh, ww), dtype=torch.bool,
                                       device=dev)
    cu8 = cost_s[8]
    nxn_g = zeros(nby8, nbx8)
    if nby8 and cost_s[4].numel():
        quad4 = _quad(cost_s[4])[:nby8, :nbx8] + lamf * NXN_OVERHEAD_BITS
        nxn_g = quad4 < cu8
        cu8 = torch.minimum(cu8, quad4)
    split = lamf * SPLIT_OVERHEAD_BITS
    cu16 = cost_s[16]
    split16 = zeros(nby16, nbx16)
    if nby16 and cu8.numel():
        quad = _quad(cu8)[:nby16, :nbx16] + split
        split16 = quad < cu16
        cu16 = torch.minimum(cu16, quad)
    cu32 = cost_s[32]
    split32 = zeros(nby32, nbx32)
    if nby32 and cu16.numel():
        quad = _quad(cu16)[:nby32, :nbx32] + split
        split32 = quad < cu32
        cu32 = torch.minimum(cu32, quad)
    if cost64 is not None:
        c64_chosen = cost64 < (_quad(cu32)[:nby64, :nbx64] + split)
    else:
        c64_chosen = zeros(nby64, nbx64)

    h4, w4 = h // 4, w // 4
    covered64_32 = _pad_to(_up(c64_chosen, 2), nby32, nbx32, False)
    leaf32 = ~covered64_32 & ~split32
    desc32 = ~covered64_32 & split32
    r16 = torch.arange(nby16, device=dev)[:, None]
    c16 = torch.arange(nbx16, device=dev)[None, :]
    border16 = (r16 >= 2 * nby32) | (c16 >= 2 * nbx32)
    active16 = _pad_to(_up(desc32, 2), nby16, nbx16, False) | border16
    leaf16 = active16 & ~split16
    desc16 = active16 & split16
    r8 = torch.arange(nby8, device=dev)[:, None]
    c8 = torch.arange(nbx8, device=dev)[None, :]
    border8 = (r8 >= 2 * nby16) | (c8 >= 2 * nbx16)
    active8 = _pad_to(_up(desc16, 2), nby8, nbx8, False) | border8
    leaf8 = active8 & ~nxn_g
    leafN = active8 & nxn_g

    m64 = _pad_to(_up(c64_chosen, 16), h4, w4, False)
    m32 = _pad_to(_up(leaf32, 8), h4, w4, False)
    m16 = _pad_to(_up(leaf16, 4), h4, w4, False)
    m8 = _pad_to(_up(leaf8, 2), h4, w4, False)
    mN = _pad_to(_up(leafN, 2), h4, w4, False)

    def up_val(grid, f, fill):
        return _pad_to(_up(grid, f), h4, w4, fill)

    neg = torch.full((h4, w4), -1, dtype=torch.int32, device=dev)
    depth = torch.where(m64, 0, torch.where(m32, 1, torch.where(
        m16, 2, torch.where(m8 | mN, 3, neg))))
    mode4p = _pad_to(mode_s[4], h4, w4, -1) if cost_s[4].numel() else neg
    mode = neg
    if cost64 is not None:
        mode = torch.where(m64, up_val(mode64_g, 16, -1), mode)
    mode = torch.where(m32, up_val(mode_s[32], 8, -1), mode)
    mode = torch.where(m16, up_val(mode_s[16], 4, -1), mode)
    mode = torch.where(m8, up_val(mode_s[8], 2, -1), mode)
    mode = torch.where(mN, mode4p, mode)
    cov = m64 | m32 | m16 | m8 | mN
    iy = torch.arange(h4, device=dev)[:, None]
    ix = torch.arange(w4, device=dev)[None, :]

    def origin(f):
        return (iy % f == 0) & (ix % f == 0)

    nxn_plan = mN & origin(2)
    tusplit = m64 & origin(16)
    cands = torch.full((h4, w4, 3), -1, dtype=torch.int32, device=dev)
    for s, m_, f in ((32, m32, 8), (16, m16, 4), (8, m8, 2)):
        if not cost_s[s].numel():
            continue
        c3u = _pad_to(_up(cand_s[s], f), h4, w4, -1)
        cands = torch.where((m_ & origin(f))[:, :, None], c3u, cands)
    if cost_s[4].numel():
        c4u = _pad_to(cand_s[4], h4, w4, -1)
        cands = torch.where(mN[:, :, None], c4u, cands)
    cmode = torch.full((h4, w4), 4, dtype=torch.int32, device=dev)
    for s, m_, f in ((32, m32, 8), (16, m16, 4), (8, m8, 2)):
        if s in cmode_s:
            cmode = torch.where(m_, up_val(cmode_s[s], f, 4), cmode)

    i8 = torch.int8
    flags = nxn_plan.to(i8) | (cov.to(i8) << 1) | (tusplit.to(i8) << 2)
    return torch.stack(
        [depth.to(i8), mode.to(i8), cmode.to(i8), cands[:, :, 0].to(i8),
         cands[:, :, 1].to(i8), cands[:, :, 2].to(i8), flags])


def _plan_ctu_plain(lam, cw, h, w, mode_s, cost_s, cand_s, db_s, d64, b64,
                    mode64_g):
    cost_s, cmode_s, add = dict(cost_s), {}, {}
    for s in (8, 16, 32):
        if s in db_s:
            cost_s[s], add[s], cmode_s[s] = _chroma_fold_plain(
                *db_s[s], cost_s[s], lam, cw)
    return _plan_dp_plain(lam, h, w, mode_s, cost_s, cand_s, cmode_s,
                          add.get(32), d64, b64, mode64_g)


def plan_dp(lam: float, cw: float, h: int, w: int, mode_s, cost_s, cand_s,
            db_s, d64, b64, mode64_g):
    """The chroma fold of each size in db_s ({s: K3's (d_cb, b_cb, d_cr,
    b_cr)}), the 64x64 cost, the bottom-up quadtree DP and the dense
    emission of the packed (7, h/4, w/4) int8 plan (K4's CTU launch)."""
    if _on_cuda(cost_s[4]):
        return kernels.plan_dp(lam, cw, h, w, mode_s, cost_s, cand_s, db_s,
                               d64, b64, mode64_g)
    return _plan_ctu_plain(lam, cw, h, w, mode_s, cost_s, cand_s, db_s, d64,
                           b64, mode64_g)


def _plan_device(y, cb, cr, lam, cweight, stage1=None, *, h: int, w: int,
                 bd: int, cbd: int, strong: bool, qp: int, cqp0: int,
                 cqp1: int, chroma: bool):
    """The whole frame plan on the planes' device: per-size candidate RD,
    chroma mode RD, the 64x64 level, the quadtree DP and the packed plan.
    stage1: the per-size (mode, cost, top3, satd) grids of sizes 4..32
    computed elsewhere (the row-banded `parallel.frame_shard`), on the
    planes' device, in place of K1 + K2 here; None at a size computes it
    here.  One K1 launch gives every luma size computed here (and s = 32
    for the 64x64 level), and Cb and Cr at the chroma sizes.  Every branch
    depends on shapes and options only, never on device values, so nothing
    here waits for the device."""
    dev = y.device
    sizes = (4, 8, 16, 32)
    mode_s, cost_s, cand_s = {}, {}, {}
    shape_s = {s: (h // s, w // s) for s in (4, 8, 16, 32, 64)}
    live = [s for s in sizes if shape_s[s][0] and shape_s[s][1]]
    own = [s for i, s in enumerate(sizes) if s in live and (
        stage1 is None or stage1[i] is None)]
    nby64, nbx64 = shape_s[64]
    has64 = bool(nby64 and nbx64)          # then every size is live
    csizes = [s for s in (8, 16, 32) if chroma and s in live]
    keys = [("y", s) for s in own + ([32] if has64 and 32 not in own
                                     else [])]
    keys += [(c, s // 2) for s in csizes for c in ("cb", "cr")]
    planes = {"y": (y, bd, strong, h, w),
              "cb": (cb, cbd, False, h // 2, w // 2),
              "cr": (cr, cbd, False, h // 2, w // 2)}
    k1 = dict(zip(keys, ref_buffers_multi(
        [(planes[c][0], s) + planes[c][1:] for c, s in keys]))) if keys \
        else {}
    satd32 = None
    for i, s in enumerate(sizes):
        nby, nbx = shape_s[s]
        if s not in live:
            mode_s[s] = torch.zeros((nby, nbx), dtype=torch.int32,
                                    device=dev)
            cost_s[s] = torch.zeros((nby, nbx), dtype=torch.float32,
                                    device=dev)
            cand_s[s] = torch.zeros((nby, nbx, 3), dtype=torch.int32,
                                    device=dev)
            continue
        if s in own:
            m, c, c3, sa = size_rd(*k1[("y", s)], lam, s, bd,
                                   NUM_RD_CANDS[s], qp, True, s == 4,
                                   s == 32)
        else:
            m, c, c3, sa = stage1[i]
        mode_s[s] = m.reshape(nby, nbx)
        cost_s[s] = c.reshape(nby, nbx)
        cand_s[s] = c3.reshape(nby, nbx, 3)
        if s == 32:
            satd32 = sa.reshape(nby, nbx, 35)

    modes5, mode64_g, pm64 = plan_pre(
        [mode_s[s].reshape(-1) for s in csizes],
        satd32 if has64 else None, nby64, nbx64)
    db_s = {}
    for s, m5 in zip(csizes, modes5):
        cs = s // 2
        db_s[s] = [t for c, cqp in (("cb", cqp0), ("cr", cqp1))
                   for t in cand_rd(*k1[(c, cs)], m5, cs, cbd, cqp)]

    d64 = b64 = None
    if has64:
        # the 64x64 level's TU32s: the s = 32 blocks of the rows and
        # columns that whole CTUs cover, a prefix when the columns are
        bufs32, blocks32 = k1[("y", 32)]
        cbx = shape_s[32][1]
        if 2 * nbx64 == cbx:
            n = 4 * nby64 * nbx64
            bufs32, blocks32 = bufs32[:n], blocks32[:n]
        else:
            idx = (torch.arange(2 * nby64, device=dev)[:, None] * cbx
                   + torch.arange(2 * nbx64, device=dev)[None, :]).reshape(-1)
            bufs32, blocks32 = bufs32[idx], blocks32[idx]
        d, b = cand_rd(bufs32, blocks32, pm64[:, None], 32, bd, qp, True,
                       False)
        d64, b64 = d[:, 0], b[:, 0]
    return plan_dp(lam, cweight, h, w, mode_s, cost_s, cand_s, db_s, d64,
                   b64, mode64_g)


# ---------------------------------------------------------------------------
# host interface
# ---------------------------------------------------------------------------

class IntraPlan:
    """Dense frame plan: per-4x4-part depth / NxN flag / luma mode."""

    __slots__ = ("depth", "nxn", "mode", "h4", "w4", "cov", "tusplit",
                 "cmode", "cands")

    def __init__(self, h4, w4):
        self.h4, self.w4 = h4, w4
        self.depth = np.full((h4, w4), -1, dtype=np.int8)
        self.nxn = np.zeros((h4, w4), dtype=bool)      # at 8x8 origins
        self.mode = np.full((h4, w4), -1, dtype=np.int8)
        self.cov = np.zeros((h4, w4), dtype=bool)      # plan covers part
        self.tusplit = np.zeros((h4, w4), dtype=bool)  # at CU origins
        self.cmode = np.full((h4, w4), 4, dtype=np.int8)  # chroma cand idx
        # RD-ranked top-3 luma mode candidates at CU/PU origins, for the
        # commit pass's true-reference re-ranking
        self.cands = np.full((h4, w4, 3), -1, dtype=np.int8)


class PlanFuture:
    """A submitted plan: the packed host tensor and, on CUDA, the event
    recorded after its device-to-host copy."""

    __slots__ = ("host", "event")

    def __init__(self, host, event):
        self.host, self.event = host, event


def submit_plan(orig, sps, qp, lam, chroma_weight, chroma_qps,
                device: torch.device, stage1=None) -> PlanFuture:
    """Enqueue the frame plan on `device` without waiting for it: the
    kernels and the copy of the packed plan into pinned host memory are
    queued on the current stream, so the card plans this frame while the
    host commits the previous one.  stage1: optional per-size (mode, cost,
    top3, satd) grids on `device`, None at a size computed here (see
    _plan_device)."""
    bd = sps.bit_depth_luma
    strong = bool(sps.strong_intra_smoothing)
    h, w = sps.pic_height, sps.pic_width
    chroma = len(orig) > 1 and sps.chroma_format_idc == 1

    def plane(p):
        return torch.from_numpy(np.ascontiguousarray(p, dtype=np.int32)) \
            .to(device)

    y = plane(orig[0])
    if chroma:
        cbp, crp = plane(orig[1]), plane(orig[2])
    else:
        cbp = crp = torch.zeros((1, 1), dtype=torch.int32, device=device)
    packed = _plan_device(
        y, cbp, crp, float(np.float32(lam)),
        float(np.float32(chroma_weight)), stage1, h=h, w=w, bd=bd,
        cbd=sps.bit_depth_chroma, strong=strong, qp=int(qp),
        cqp0=int(chroma_qps[0]), cqp1=int(chroma_qps[1]), chroma=chroma)
    if packed.device.type != "cuda":
        return PlanFuture(packed, None)
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return PlanFuture(host, event)


def fetch_plan(fut: PlanFuture, h, w):
    """Wait for a submitted plan and unpack it (one wait per frame)."""
    if fut.event is not None:
        fut.event.synchronize()
    pi8 = fut.host.numpy()
    plan = IntraPlan(h // 4, w // 4)
    plan.depth[:] = pi8[0]
    plan.mode[:] = pi8[1]
    plan.cmode[:] = pi8[2]
    plan.cands[:] = np.moveaxis(pi8[3:6], 0, -1)
    flags = pi8[6]
    plan.nxn[:] = (flags & 1) != 0
    plan.cov[:] = (flags & 2) != 0
    plan.tusplit[:] = (flags & 4) != 0
    return plan


def plan_frame(orig, sps, qp, lam, chroma_weight, chroma_qps,
               device: torch.device, stage1=None):
    """Plan one frame and wait for it.  orig: [Y, Cb, Cr] int32 planes.
    Returns an IntraPlan covering every part whose CTU is fully inside
    the picture; uncovered parts fall back to the caller's per-CU path.
    stage1: optional per-size grids from the row-banded path
    (`parallel.frame_shard.sharded_plan_frame`)."""
    fut = submit_plan(orig, sps, qp, lam, chroma_weight, chroma_qps, device,
                      stage1)
    return fetch_plan(fut, sps.pic_height, sps.pic_width)

"""Batched intra analysis in PyTorch: the plain versions of the encoder's
per-block prediction, SATD and forward transform/quant, plus numpy helpers
for the host fallback search.

Counterpart of `hm16_2_tpu/ops/analysis.py`.  That module imports JAX, which
the port never does, so its constant tables (`angular_tables`, `_hadamard`)
and numpy helpers are copied here; tests assert the copies equal the
originals.  On the CUDA path these functions are not called: the fused
kernels in `csrc/intra_rd.cu` compute the same integers.

Integer products.  Torch has no int32 matrix product on CUDA, and these
plain versions also run on the card (the smoke test holds each kernel
against them there).  The transforms and Hadamard products are therefore
float64 matmuls of integer operands: every input, product and partial sum
is an integer below 2^31 (|residual| < 2^16, |coefficient| <= 90 or a
dequantised level < 2^16, at most 32 terms), far inside float64's 2^53
exact-integer range, so the result equals JAX's int32 einsum exactly.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from hm16_2_tpu.common.tables import ANG_TABLE, DCT, DST4, INV_ANG_TABLE, \
    QUANT_SCALES
from hm16_2_tpu.ops.intra_ref import HOR_IDX, PLANAR_IDX, VER_IDX, \
    should_filter


@lru_cache(maxsize=None)
def angular_tables(s: int, is_luma: bool):
    """Static (mode, y, x) gather/weight tables for modes 2..34 (copy of
    the reference's table builder; the CUDA kernels derive the same
    indices from the angle tables instead of reading these).

    Returns dict of numpy arrays:
      g0, g1: indices into the ref buffer, shape (33, s, s)
      w0, w1: interpolation weights (sum 32), shape (33, s, s)
      plane:  0 = unfiltered refs, 1 = filtered refs, shape (33,)
    """
    g0 = np.zeros((33, s, s), dtype=np.int32)
    w0 = np.zeros((33, s, s), dtype=np.int32)
    g1 = np.zeros((33, s, s), dtype=np.int32)
    plane = np.zeros(33, dtype=np.int32)
    corner = 2 * s
    for mode in range(2, 35):
        mi = mode - 2
        is_ver = mode >= 18
        ang_mode = (mode - VER_IDX) if is_ver else -(mode - HOR_IDX)
        abs_ang = int(ANG_TABLE[abs(ang_mode)])
        inv_angle = int(INV_ANG_TABLE[abs(ang_mode)])
        angle = (-1 if ang_mode < 0 else 1) * abs_ang
        plane[mi] = 1 if should_filter(mode, s, is_luma) else 0
        if is_ver:
            def main(i): return corner + i          # top
            def side(i): return corner - i          # left
        else:
            def main(i): return corner - i          # left
            def side(i): return corner + i          # top
        # refMain as buffer indices, local index base s (k in -s..2s+1)
        ref_idx = np.zeros(3 * s + 2, dtype=np.int32)
        if angle < 0:
            for k in range(0, s + 1):
                ref_idx[s + k] = main(k)
            inv_sum = 128
            k = -1
            while k > (s * angle) >> 5:
                inv_sum += inv_angle
                ref_idx[s + k] = side(inv_sum >> 8)
                k -= 1
            for k in range(s + 1, 2 * s + 2):
                ref_idx[s + k] = main(min(k, 2 * s))
        else:
            for k in range(0, 2 * s + 2):
                ref_idx[s + k] = main(min(k, 2 * s))
        for y in range(s):
            delta = (y + 1) * angle
            i_int = delta >> 5
            frac = delta & 31
            for x in range(s):
                j = s + 1 + i_int + x
                at = (mi, y, x) if is_ver else (mi, x, y)
                g0[at] = ref_idx[j]
                g1[at] = ref_idx[j + 1]
                w0[at] = 32 - frac
    w1 = 32 - w0
    w1[w0 == 32] = 0
    w0[w1 == 0] = 32
    return {"g0": g0, "g1": g1, "w0": w0, "w1": w1, "plane": plane}


@lru_cache(maxsize=None)
def _hadamard(n):
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _imatmul(a, b):
    """Exact integer matrix product through float64 (see module doc)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)) \
        .to(torch.int32)


def _table(arr, device):
    return torch.as_tensor(np.asarray(arr, dtype=np.int32), device=device)


def predict_all_modes(bufs, s: int, is_luma: bool = True,
                      bit_depth: int = 8):
    """All 35 intra predictions for a batch of blocks.

    bufs: (N, 2, 4s+1) int32 — [unfiltered, filtered] reference buffers
          (layout: left bottom-up, corner at 2s, then top left-to-right)
    returns (N, 35, s, s) int32
    """
    lead = bufs.shape[:-2]
    bufs = bufs.reshape((-1,) + tuple(bufs.shape[-2:])).to(torch.int32)
    dev = bufs.device
    t = angular_tables(s, is_luma)
    n = bufs.shape[0]
    corner = 2 * s
    plane = _table(t["plane"], dev).long()
    sel = bufs[:, plane, :]                           # (N, 33, 4s+1)
    g0 = _table(t["g0"], dev).long().reshape(1, 33, s * s).expand(n, -1, -1)
    g1 = _table(t["g1"], dev).long().reshape(1, 33, s * s).expand(n, -1, -1)
    v0 = torch.gather(sel, 2, g0).reshape(n, 33, s, s)
    v1 = torch.gather(sel, 2, g1).reshape(n, 33, s, s)
    ang = (_table(t["w0"], dev)[None] * v0 + _table(t["w1"], dev)[None] * v1
           + 16) >> 5

    unf = bufs[:, 0, :]
    top = unf[:, corner + 1: corner + 1 + s]          # top[1..s], (N, s)
    left = unf[:, corner - s: corner].flip(1)         # left[1..s]
    if is_luma and s <= 16:
        maxv = (1 << bit_depth) - 1
        corner_v = unf[:, corner]
        ang[:, 24, :, 0] = torch.clamp(
            top[:, :1] + ((left - corner_v[:, None]) >> 1), 0, maxv)
        ang[:, 8, 0, :] = torch.clamp(
            left[:, :1] + ((top - corner_v[:, None]) >> 1), 0, maxv)

    pl_plane = 1 if should_filter(PLANAR_IDX, s, is_luma) else 0
    fp = bufs[:, pl_plane, :]
    topf = fp[:, corner + 1: corner + 1 + s]
    leftf = fp[:, corner - s: corner].flip(1)
    tr = fp[:, corner + s + 1]
    bl = fp[:, corner - s - 1]
    shift = s.bit_length() - 1
    xs = torch.arange(s, device=dev, dtype=torch.int32)
    hor = (s - 1 - xs)[None, None, :] * leftf[:, :, None] + \
        (xs + 1)[None, None, :] * tr[:, None, None]
    ver = (s - 1 - xs)[None, :, None] * topf[:, None, :] + \
        (xs + 1)[None, :, None] * bl[:, None, None]
    planar = (hor + ver + s) >> (shift + 1)

    dcval = (top.sum(1, dtype=torch.int32) + left.sum(1, dtype=torch.int32)
             + s) >> (shift + 1)
    dc = dcval[:, None, None].expand(n, s, s).clone()
    if is_luma and s <= 16:
        dc[:, 0, :] = (top + 3 * dcval[:, None] + 2) >> 2
        dc[:, :, 0] = (left + 3 * dcval[:, None] + 2) >> 2
        dc[:, 0, 0] = (top[:, 0] + left[:, 0] + 2 * dcval + 2) >> 2

    out = torch.cat([planar[:, None], dc[:, None], ang], 1).to(torch.int32)
    return out.reshape(tuple(lead) + (35, s, s))


def batched_satd(diffs, tile: int = 8):
    """SATD over (..., bh, bw) int32: HM's 8x8 Hadamard (4x4 when a side is
    not a multiple of 8), normalised per tile as `(sum+2)>>2` / `(sum+1)>>1`."""
    bh, bw = diffs.shape[-2], diffs.shape[-1]
    t = tile if (bh % 8 == 0 and bw % 8 == 0) else 4
    h = torch.as_tensor(_hadamard(t), device=diffs.device)
    shp = tuple(diffs.shape)
    d = diffs.reshape(shp[:-2] + (bh // t, t, bw // t, t)).transpose(-3, -2)
    had = _imatmul(_imatmul(h, d), h)
    sums = had.abs().sum((-1, -2), dtype=torch.int32)
    norm = ((sums + 2) >> 2) if t == 8 else ((sums + 1) >> 1)
    return norm.sum((-1, -2), dtype=torch.int32)


def _transform_matrix(s, use_dst, device):
    m = DST4 if (use_dst and s == 4) else DCT[s]
    return torch.as_tensor(np.asarray(m, dtype=np.int32), device=device)


def batched_fwd_transform(resi, bit_depth: int = 8, use_dst: bool = False):
    """Forward transform of (..., s, s) int32 residuals: DCT-II, or DST-VII
    at 4x4, with HM's stage shifts (transforms_ref.forward_transform)."""
    s = resi.shape[-1]
    t = _transform_matrix(s, use_dst, resi.device)
    log2 = s.bit_length() - 1
    s1 = log2 - 1 + bit_depth - 8
    s2 = log2 + 6
    stage1 = _imatmul(resi, t.T)
    stage1 = (stage1 + (1 << (s1 - 1))) >> s1 if s1 > 0 else stage1 << (-s1)
    out = _imatmul(t, stage1)
    return (out + (1 << (s2 - 1))) >> s2


def batched_quant(coeffs, qp: int, bit_depth: int, log2_tr: int,
                  is_intra: bool = True):
    """Flat quant (intra offset 171, inter 85), levels clipped to 32767."""
    per, rem = qp // 6, qp % 6
    tshift = 15 - bit_depth - log2_tr
    q_bits = 14 + per + tshift
    scale = int(QUANT_SCALES[rem])
    add = (171 if is_intra else 85) << (q_bits - 9)
    c = coeffs.to(torch.int32)
    level = (c.abs() * scale + add) >> q_bits
    return (torch.sign(c) * torch.clamp(level, 0, 32767)).to(torch.int32)


def predict_all_modes_np(buf_u, buf_f, s: int, is_luma: bool = True,
                         bit_depth: int = 8):
    """Numpy version of predict_all_modes for a single block (encoder
    search fallback on the host).  buf_u/buf_f: (4s+1,) refs."""
    t = angular_tables(s, is_luma)
    corner = 2 * s
    sel = np.where(t["plane"][:, None, None] == 1,
                   buf_f[t["g0"]], buf_u[t["g0"]])
    sel1 = np.where(t["plane"][:, None, None] == 1,
                    buf_f[t["g1"]], buf_u[t["g1"]])
    ang = (t["w0"] * sel + t["w1"] * sel1 + 16) >> 5
    top = buf_u[corner + 1: corner + 1 + s]
    left = buf_u[corner - s: corner][::-1]
    shift = s.bit_length() - 1
    if is_luma and s <= 16:
        maxv = (1 << bit_depth) - 1
        cv = buf_u[corner]
        ang[24, :, 0] = np.clip(top[0] + ((left - cv) >> 1), 0, maxv)
        ang[8, 0, :] = np.clip(left[0] + ((top - cv) >> 1), 0, maxv)
    pl_plane = 1 if should_filter(PLANAR_IDX, s, is_luma) else 0
    fp = buf_f if pl_plane else buf_u
    topf = fp[corner + 1: corner + 1 + s]
    leftf = fp[corner - s: corner][::-1]
    tr = int(fp[corner + s + 1])
    bl = int(fp[corner - s - 1])
    xs = np.arange(s)
    hor = (s - 1 - xs)[None, :] * leftf[:, None] + (xs + 1)[None, :] * tr
    ver = (s - 1 - xs)[:, None] * topf[None, :] + (xs + 1)[:, None] * bl
    planar = (hor + ver + s) >> (shift + 1)
    dcval = (int(top.sum()) + int(left.sum()) + s) >> (shift + 1)
    dc = np.full((s, s), dcval, dtype=np.int64)
    if is_luma and s <= 16:
        dc[0, :] = (top + 3 * dcval + 2) >> 2
        dc[:, 0] = (left + 3 * dcval + 2) >> 2
        dc[0, 0] = (top[0] + left[0] + 2 * dcval + 2) >> 2
    return np.concatenate([planar[None], dc[None], ang], axis=0)


def satd_all_np(diffs):
    """SATD over (M, s, s) via batched Hadamard matmuls (numpy)."""
    m, s, _ = diffs.shape
    t = 8 if s % 8 == 0 else 4
    h = _hadamard(t).astype(np.int64)
    d = diffs.reshape(m, s // t, t, s // t, t).swapaxes(2, 3)
    had = np.einsum("ij,mabjk,kl->mabil", h, d, h)
    sums = np.abs(had).sum(axis=(3, 4))
    norm = (sums + 2) >> 2 if t == 8 else (sums + 1) >> 1
    return norm.sum(axis=(1, 2))

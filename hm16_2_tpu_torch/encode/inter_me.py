"""Frame-batched integer motion estimation of the per-CU inter search, in
PyTorch.

Counterpart of `hm16_2_tpu/encode/inter_me.py`, which describes the
algorithm: when a P or B picture has no fused plan (HM16_NO_INTER_PLAN,
HM16_EXACT_RD, or a plan that returns None) the host searches CU by CU and
takes its integer MV candidates from one dense ME over +-64 full-pel per
reference and aligned square block (8..64): a coarse SSD grid on
4x-downsampled planes summed up the size pyramid, the coarse argmin, then a
+-3 full-resolution refinement around the coarse winner and around zero.

`me_frame` is a wrapper: on a CUDA tensor it launches K5 in its log bit
model (`kernels.me_frame`, csrc/inter_me.cu), on a CPU tensor it runs the
plain version beside it, which shares the plan's grid and refinement code
(`inter_plan._coarse_grid8`, `_quad4`, `_me_shape_plain`).

Float32 parity.  The reference prices an MV by `_mv_bits`,
2*log2(|d| + 1) + 1 per component, under XLA:CPU.  Read from its optimised
HLO and LLVM IR: log2 is `ln(x) * 1.44269502` with the 2 folded into the
constant (2.88539004), ln is XLA's own Cephes polynomial, and the backend
fuses every product that has one use into the add that consumes it: inside
the polynomial, in `t*2.88539 + 1`, and in both costs `g + lamf*bits` and
`sse + lamf*bits`.  `_xla_log` reproduces that ln bit for bit (a test holds
it to `jnp.log` inside a jit); the y and x terms are summed with one plain
add.
"""

from __future__ import annotations

import numpy as np
import torch

from hm16_2_tpu_torch import kernels
from hm16_2_tpu_torch.encode.inter_plan import _coarse_grid8, _device_ref, \
    _me_shape_plain, _quad4, _to_device
from hm16_2_tpu_torch.encode.intra_rd import _fma32, _on_cuda

# XLA:CPU's float32 ln: the Cephes coefficients of its LLVM IR
_LOG_P = tuple(float.fromhex(v) for v in (
    "0x1.204376p-4", "-0x1.d7a37p-4", "0x1.de4a34p-4", "-0x1.fcba9ep-4",
    "0x1.23d37ep-3", "-0x1.555ca0p-3", "0x1.999d58p-3", "-0x1.fffff8p-3",
    "0x1.555554p-2"))
_LOG_Q1, _LOG_Q2 = float.fromhex("-0x1.bd0106p-13"), float.fromhex("0x1.63p-1")
_SQRT_HALF = float.fromhex("0x1.6a09e6p-1")
_TWO_LOG2E = float.fromhex("0x1.715476p+1")   # 2 * 1.44269502 in float32


def _xla_log(x):
    """XLA:CPU's float32 natural log of a positive normal float32 tensor:
    mantissa in [0.5, 1) and exponent, the Cephes polynomial, each product
    with one use fused into its add."""
    bits = x.view(torch.int32)
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    e = 1.0 + ((bits >> 23) - 127).to(torch.float32)
    lo = m < _SQRT_HALF
    zero = torch.zeros_like(m)
    xx = (m - 1.0) + torch.where(lo, m, zero)
    e = e - torch.where(lo, torch.ones_like(m), zero)
    c = lambda v: torch.full_like(xx, v)
    p = _LOG_P
    x2 = xx * xx
    x3 = x2 * xx
    y = _fma32(xx, c(p[0]), c(p[1]))
    y1 = _fma32(xx, c(p[3]), c(p[4]))
    y2 = _fma32(xx, c(p[6]), c(p[7]))
    y = _fma32(y, xx, c(p[2]))
    y1 = _fma32(y1, xx, c(p[5]))
    y2 = _fma32(y2, xx, c(p[8]))
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, _LOG_Q1 * e)
    r = (xx - 0.5 * x2) + y
    return _fma32(c(_LOG_Q2), e, r)


def _mv_bits(d):
    """Approximate signalling bits of an MV delta component (full-pel
    domain): 2*log2(|d| + 1) + 1 as XLA:CPU computes it in float32."""
    x = d.abs().to(torch.float32) + 1.0
    return _fma32(_xla_log(x), torch.full_like(x, _TWO_LOG2E),
                  torch.ones_like(x))


def _me_frame_plain(cur, refs, mvp8, lam, h, w):
    grids = {8: _coarse_grid8(cur, refs, h, w)}
    for s in (16, 32, 64):
        grids[s] = _quad4(grids[s // 2], h // s, w // s)
    R = refs.shape[0]
    out = {}
    for s in (8, 16, 32, 64):
        ny, nx = h // s, w // s
        if not (ny and nx):
            continue
        mvp = mvp8[:, ::s // 8, ::s // 8][:, :ny, :nx]
        mv, cost = _me_shape_plain(cur, refs, grids[s].contiguous(), mvp, lam,
                                   s, s, comp_bits=_mv_bits)
        out[s] = (mv.reshape(R, ny * nx, 2), cost)
    return out


def me_frame(cur, refs, mvp8, lam: float, h: int, w: int):
    """Dense ME for all aligned blocks of sizes 8/16/32/64 (K5, log bit
    model).  cur: (h, w) int32; refs: (R, h, w) int32; mvp8: (R, h/8, w/8,
    2) int32 full-pel per-8x8-block prior; lam: the sqrt-domain lambda of
    the MV-bits term (rounded to float32).  Returns {size: (mv (R, N, 2)
    int32 full-pel (dy, dx), cost (R, N) float32)}, blocks in raster order,
    sizes that fit only."""
    if _on_cuda(cur):
        return kernels.me_frame(cur, refs, mvp8, lam, h, w)
    return _me_frame_plain(cur, refs, mvp8, lam, h, w)


class MePlan:
    """Fetched per-frame ME grids: (lx, r_idx, size) -> (mv, cost)."""

    __slots__ = ("grids", "h", "w")

    def __init__(self, h, w):
        self.grids = {}
        self.h, self.w = h, w

    def lookup(self, lx, r_idx, size, x0, y0):
        """Full-pel (mvx, mvy) for the aligned size-block at (x0, y0),
        or None (grids store (dy, dx))."""
        g = self.grids.get((lx, r_idx, size))
        if g is None or x0 % size or y0 % size:
            return None
        nx = self.w // size
        bx, by = x0 // size, y0 // size
        if bx >= nx or by >= self.h // size:
            return None
        mv, cost = g
        i = by * nx + bx
        return (int(mv[i, 1]), int(mv[i, 0]))


def submit_me(cur_y, ref_lists, prev_mv8, lam_sqrt, h, w, device):
    """Enqueue me_frame on `device` for every reference of both lists
    (deduplicated by identity), and on CUDA the copy of its results into
    pinned host memory; returns a callable that waits for them and builds
    the MePlan."""
    uniq = []                      # deduplicated reference planes
    keymap = {}                    # (lx, r_idx) -> index into uniq
    for lx, refs in enumerate(ref_lists):
        for r_idx, ref in enumerate(refs):
            key = id(ref)
            for j, (k2, _) in enumerate(uniq):
                if k2 == key:
                    keymap[(lx, r_idx)] = j
                    break
            else:
                keymap[(lx, r_idx)] = len(uniq)
                uniq.append((key, ref.rec[0]))
    if not uniq:
        return lambda: MePlan(h, w)
    R = len(uniq)
    refs = torch.stack([_device_ref(p, h, w, device) for _, p in uniq])
    cur = _to_device(cur_y[:h, :w], device)
    if prev_mv8 is None:
        mvp8 = torch.zeros((R, h // 8, w // 8, 2), dtype=torch.int32,
                           device=device)
    else:
        mvp8 = _to_device(prev_mv8, device)[None] \
            .expand(R, h // 8, w // 8, 2).contiguous()
    res = me_frame(cur, refs, mvp8, float(np.float32(lam_sqrt)), h, w)
    event = None
    if cur.device.type == "cuda":
        host = {}
        for s, (mv, cost) in res.items():
            host[s] = tuple(torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True) for t in (mv, cost))
            for dst, src in zip(host[s], (mv, cost)):
                dst.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        res = host

    def fetch():
        if event is not None:
            event.synchronize()
        plan = MePlan(h, w)
        for s, (mv, cost) in res.items():
            mvn = mv.numpy()
            costn = cost.numpy()
            for (lx, r_idx), j in keymap.items():
                plan.grids[(lx, r_idx, s)] = (mvn[j], costn[j])
        return plan

    return fetch

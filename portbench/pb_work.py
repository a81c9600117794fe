"""The work of K2 and K7, counted from shapes and frozen here.

Copied from `chip_smoke.py` (`_ops_rd`, the K7 cases' operation counts and
`_nbytes`' rule) so that later changes to the program cannot move the
yardstick.  Operations are int32 and float32 operations, a multiply-add
counting two; bytes read each input once and write each output once per
launch.  The least time is the larger of bytes over the card's HBM rate and
operations over its float32 rate outside the tensor cores (one H100 SXM,
NVIDIA's data sheet)."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

NUM_RD_CANDS = {4: 4, 8: 4, 16: 3, 32: 3}   # K2's RD candidates by size
SIZES = (8, 16, 32, 64)                     # the inter plan's CU sizes
RECT_SIZES = (16, 32, 64)                   # ... with 2NxN and Nx2N
MARGIN = 80                                 # sub-pel plane padding


def least_s(ops, nbytes):
    """(seconds, "operations" or "bytes"): the bound and what sets it."""
    o, b = ops / PEAK_OPS_S, nbytes / HBM_BYTES_S
    return (o, "operations") if o >= b else (b, "bytes")


def ops_rd(n, s, k):
    """35-mode prediction and SATD, then k candidates through the forward
    and inverse transforms, quant, dequant, SSE and bits."""
    return n * (35 * 12 * s * s + k * (8 * s ** 3 + 16 * s * s))


def k2_size_rd(h, w, s, k=None, want_satd=None):
    """(ops, bytes) of one K2 RD launch over every s-block of an h x w
    plane: reference buffers (2 x (4s + 1) int32) and blocks (s x s int32)
    in; mode, cost, top-3 and, at s = 32, the 35 SATDs out."""
    k = NUM_RD_CANDS[s] if k is None else k
    want_satd = s == 32 if want_satd is None else want_satd
    n = (h // s) * (w // s)
    nbytes = n * (2 * (4 * s + 1) * 4 + s * s * 4) \
        + n * (4 + 4 + 12 + (35 * 4 if want_satd else 0))
    return ops_rd(n, s, k), nbytes


def shapes(h, w):
    """(s, part, bh, bw, Ny, Nx) of every CU shape the inter plan prices."""
    out = [(s, 0, s, s, h // s, w // s) for s in SIZES if h // s and w // s]
    for s in RECT_SIZES:
        if h // s and w // s:
            out.append((s, 1, s // 2, s, 2 * (h // s), w // s))
            out.append((s, 2, s, s // 2, h // s, 2 * (w // s)))
    return out


def k7_launches(h, w, refs, bi):
    """[(ops, bytes)] of K7's launches in one P or B plan with `refs` live
    reference planes: the quarter-pel refinement of every shape over every
    reference, and on a B picture the two bi passes of every square size."""
    sub = refs * 16 * (h + 2 * MARGIN + 1) * (w + 2 * MARGIN + 1) * 2
    cur = h * w * 4
    out = []
    for s, part, bh, bw, ny, nx in shapes(h, w):
        n = ny * nx
        # in: sub-pel planes, picture, MVs and MVD anchors; out: MVs, SATDs
        out.append((refs * n * 49 * bh * bw * 10,
                    sub + cur + refs * n * (8 + 8) + refs * n * (8 + 4)))
    if bi:
        for s in SIZES:
            n = (h // s) * (w // s)
            # in: planes, picture, MV, reference, anchor, the other list's
            # reference and MV; out: MV, SATD
            out += [(n * 49 * s * s * 14,
                     sub + cur + n * (8 + 4 + 8 + 4 + 8) + n * (8 + 4))] * 2
    return out

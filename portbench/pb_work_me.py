"""The work of K5's integer ME in one P or B plan, counted from shapes and
frozen here.

Copied from `chip_smoke.py` (`_ops_me` with the plan's bit model,
`MVD_BIN_OPS`, and `_nbytes`' rule over the kernel's inputs and outputs) and
from the plan's CU shapes (`inter_plan._shapes(h, w, True)`, which
`pb_work.shapes` already freezes), so that later changes to the program
cannot move the yardstick.  The least time follows `pb_work.least_s`."""

from __future__ import annotations

import pb_work

MVD_BIN_OPS = 11    # one MV component's MVD bins, chip_smoke's count


def ops_me(refs, h, w):
    """Operations of K5 over `refs` reference planes of an h x w picture:
    the downsampling, the coarse 33 x 33 grid of the 8x8 blocks and its
    pyramid, then per CU shape, block and reference the coarse argmin over
    1089 offsets and the 98-candidate refinement, each offset and candidate
    adding its MV bits, a multiply-add of the lambda term and a compare (a
    rectangle also adds its two half cells)."""
    n = {s: (h // s) * (w // s) for s in (8, 16, 32, 64)}
    ops = (refs * h + h) * w + refs * 1089 * (12 * n[8] + 3 * (
        n[16] + n[32] + n[64]))
    for _, _, bh, bw, ny, nx in pb_work.shapes(h, w):
        ops += refs * ny * nx * ((2 * 33 + 4 * 7) * MVD_BIN_OPS
                                 + 1089 * (4 + (bh != bw))
                                 + 98 * (bh * bw * 3 + 4))
    return ops


def bytes_me(refs, h, w):
    """Bytes K5 reads and writes once: the picture, the references and the
    per-reference prior (int32, two components at 8x8) in, one int32 MV
    pair per reference and block of every CU shape out."""
    mvs = sum(refs * ny * nx * 2 for _, _, _, _, ny, nx in
              pb_work.shapes(h, w))
    return 4 * (h * w + refs * h * w + refs * (h // 8) * (w // 8) * 2 + mvs)


def least_s(refs, h, w):
    """The least time the card could take for one plan's K5, in seconds."""
    return pb_work.least_s(ops_me(refs, h, w), bytes_me(refs, h, w))[0]

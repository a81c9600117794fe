"""Row-banded frame ME of the per-CU inter search.

Counterpart of `hm16_2_tpu/parallel/me_shard.py`: `inter_me.me_frame` (K5
with the log bit model) on row bands of the current picture, one per mesh
entry, each against the whole reference pictures.  Every distortion is an
exact integer sum and band edges are 64-multiples, so the gathered grids
equal the whole picture's.
"""

from __future__ import annotations

import numpy as np

from hm16_2_tpu_torch.encode import inter_me
from hm16_2_tpu_torch.parallel.frame_shard import gather, on_device


def shardable(mesh, h: int) -> bool:
    return h % (len(mesh) * 64) == 0


def sharded_me_frame(mesh, cur, refs, mvp8, lam, h: int, w: int):
    """me_frame with the current picture (h, w) and its prior mvp8 (R, h/8,
    w/8, 2) row-banded over the mesh and the whole references (R, h, w)
    copied to each band's device.  Returns {size: (mv (R, N, 2), cost (R,
    N))} on the lead device, blocks in raster order."""
    band = h // len(mesh)
    outs = []
    for i, dev in enumerate(mesh):
        with on_device(dev):
            rows8 = slice(i * band // 8, (i + 1) * band // 8)
            outs.append(inter_me.me_frame(
                cur[i * band:(i + 1) * band].to(dev),
                refs.to(dev, non_blocking=True),
                mvp8[:, rows8].to(dev).contiguous(), lam, band, w,
                row0=i * band, full_h=h))
    return {s: tuple(gather([o[s][j] for o in outs], mesh[0], dim=1)
                     for j in range(2)) for s in outs[0]}


def sharded_submit_me(mesh, cur_y, ref_lists, prev_mv8, lam_sqrt, h, w):
    """inter_me.submit_me running the banded frame ME: the inputs on the
    lead device, the pinned copy of the results and its event there."""
    lead = mesh[0]
    keymap, cur, refs, mvp8 = inter_me._me_inputs(cur_y, ref_lists, prev_mv8,
                                                  h, w, lead)
    if cur is None:
        return lambda: inter_me.MePlan(h, w)
    with on_device(lead):
        res = sharded_me_frame(mesh, cur, refs, mvp8,
                               float(np.float32(lam_sqrt)), h, w)
        return inter_me._me_fetcher(res, keymap, h, w, lead)

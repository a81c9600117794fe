"""Row-banded integer ME for the fused inter plan.

Counterpart of `hm16_2_tpu/parallel/plan_shard.py`: stage 1 of the P/B plan
(`inter_plan.int_me`, K5 with the MVD-bin model) runs on 64-row bands of
the current picture, one per mesh entry, each against the whole reference
pictures (the reference's `all_gather`; here a copy to the band's device,
nothing on one device).  Band edges are 64-multiples, so every coarse
pyramid sum and refinement window equals the whole picture's and the grids
are equal.  The grids are gathered on the lead device and the rest of the
plan takes them (`inter_plan._plan_device(me=)`).
"""

from __future__ import annotations

import numpy as np

from hm16_2_tpu_torch.encode import inter_plan
from hm16_2_tpu_torch.parallel.frame_shard import gather, on_device


def shardable(mesh, h: int, w: int, parts: bool) -> bool:
    """The banded ME is exact only when every band holds a whole number of
    64-row CTU rows (and the picture has full 64-columns)."""
    n = len(mesh)
    return bool(parts and n > 1 and h % (n * 64) == 0 and w >= 64)


def sharded_int_me(mesh, cur, refs, mvn16, dists, lam_sqrt, h: int, w: int):
    """inter_plan.int_me's grids, row-banded over the mesh.  cur: (h, w)
    int32; refs: (R, h, w) int32 live unique references; mvn16: (h/8, w/8,
    2) int32 POC-normalised prior; dists: (R,) int32 signed POC distances
    (torch tensors on any device).  Each band derives its prior from its
    rows of mvn16 as the plan does (`_mvp_full`).  Returns {(s, part): (R,
    Ny, Nx, 2) int32} on the lead device, as `_plan_device(me=)` takes it."""
    band = h // len(mesh)
    lams = float(np.float32(lam_sqrt))
    outs = []
    for i, dev in enumerate(mesh):
        with on_device(dev):
            rows = slice(i * band, (i + 1) * band)
            rows8 = slice(i * band // 8, (i + 1) * band // 8)
            mvp8 = inter_plan._mvp_full(mvn16[rows8].to(dev),
                                        dists.to(dev))
            outs.append(inter_plan.int_me(
                cur[rows].to(dev), refs.to(dev, non_blocking=True), mvp8,
                lams, band, w, True, row0=i * band, full_h=h))
    return {key: gather([o[key] for o in outs], mesh[0], dim=1)
            for key in outs[0]}

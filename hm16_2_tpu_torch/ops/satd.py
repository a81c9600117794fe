"""SAD / Hadamard-SATD distortion kernels (TComRdCost.cpp:223-1606 analogue).

Numpy reference; the batched JAX versions in hm16_2_tpu_torch.ops.analysis evaluate
all candidate modes at once on the MXU.
"""

from __future__ import annotations

import numpy as np

_H4 = None
_H8 = None


def _hadamard(n):
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _get(n):
    global _H4, _H8
    if n == 4:
        if _H4 is None:
            globals()["_H4"] = _hadamard(4)
        return _H4
    if _H8 is None:
        globals()["_H8"] = _hadamard(8)
    return _H8


def satd_block(diff: np.ndarray) -> int:
    """SATD of a residual block; 8x8 Hadamard tiling (4x4 for size 4),
    with HM's normalization (xCalcHADs8x8 / xCalcHADs4x4)."""
    h, w = diff.shape
    if h % 8 == 0 and w % 8 == 0:
        t = 8
        norm = 2   # >>2
    else:
        t = 4
        norm = 1   # >>1
    hm = _get(t)
    total = 0
    for y in range(0, h, t):
        for x in range(0, w, t):
            blk = diff[y:y + t, x:x + t]
            had = hm @ blk @ hm
            s = int(np.abs(had).sum())
            if t == 8:
                s = (s + 2) >> 2
            else:
                s = (s + 1) >> 1
            total += s
    return total


def sad_block(diff: np.ndarray) -> int:
    return int(np.abs(diff).sum())

"""The analysis step over a (frame, row) grid of devices.

Counterpart of `hm16_2_tpu/parallel/mesh.py`: a batch of intra blocks laid
out (F, R, N, ...) (frames x CTU rows x blocks per row) is split over a
(frame, row) grid of devices; each shard runs `analysis_step` (K2's
analysis mode on the card) and the per-shard totals are summed on the lead
device (the reference's `psum`).  Nothing in the encoder calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from hm16_2_tpu_torch import kernels
from hm16_2_tpu_torch.encode.intra_rd import _on_cuda
from hm16_2_tpu_torch.ops import analysis
from hm16_2_tpu_torch.ops.intra_ref import filter_reference_samples
from hm16_2_tpu_torch.parallel.frame_shard import as_int32, on_device


def make_mesh(devices, frame_axis: int):
    """A (frame, row) grid of `devices` (torch devices or their names): a
    tuple of frame_axis rows of len(devices) // frame_axis devices."""
    devices = [torch.device(d) for d in devices]
    row_axis = len(devices) // frame_axis
    if not row_axis:
        raise ValueError(f"make_mesh: {len(devices)} devices, {frame_axis} "
                         "frames")
    return tuple(tuple(devices[f * row_axis:(f + 1) * row_axis])
                 for f in range(frame_axis))


def _analysis_step_plain(orig, bufs, qp, size, bit_depth):
    preds = analysis.predict_all_modes(bufs, size, True, bit_depth)
    costs = analysis.batched_satd(orig[..., None, :, :] - preds)
    best = torch.argmin(costs, dim=-1)
    best_cost = torch.gather(costs, -1, best[..., None])[..., 0]
    idx = best[..., None, None, None].expand(
        tuple(best.shape) + (1, size, size))
    resi = orig - torch.gather(preds, -3, idx)[..., 0, :, :]
    fwd = analysis.batched_fwd_transform(resi, bit_depth, size == 4)
    levels = analysis.batched_quant(fwd, qp, bit_depth,
                                    size.bit_length() - 1, True)
    return (best.to(torch.int32), best_cost, levels,
            best_cost.sum(dtype=torch.int32))


def analysis_step(orig, bufs, qp: int, size: int, bit_depth: int = 8):
    """One analysis step on a batch of intra blocks.  orig: (..., N, s, s)
    int32 original blocks; bufs: (..., N, 2, 4s+1) int32 reference buffers.
    Returns (best mode by SATD (ties to the lowest), its SATD, the quantised
    levels (..., N, s, s) of orig minus the best prediction (DST at s = 4,
    the intra rounding offset), and the int32 sum of the SATDs)."""
    if _on_cuda(orig):
        return kernels.analysis_step(orig, bufs, qp, size, bit_depth)
    return _analysis_step_plain(orig, bufs, qp, size, bit_depth)


def sharded_analysis_step(mesh, size: int = 16, bit_depth: int = 8):
    """The analysis step over (F, R, N, ...) batches split over the (frame,
    row) grid `mesh` (make_mesh): F over its frame axis, R over its row
    axis.  Returns step(orig, bufs, qp) -> (best, best_cost, levels, total),
    the first three reassembled (F, R, ...) on the lead device, total the
    sum of the shards' totals there."""
    lead = mesh[0][0]
    nf, nr = len(mesh), len(mesh[0])

    def step(orig, bufs, qp):
        F, R = orig.shape[:2]
        if F % nf or R % nr:
            raise ValueError(f"sharded_analysis_step: ({F}, {R}) does not "
                             f"split over a ({nf}, {nr}) mesh")
        fs, rs = F // nf, R // nr
        parts = []
        for fi in range(nf):
            row = []
            for ri in range(nr):
                dev = mesh[fi][ri]
                sl = (slice(fi * fs, (fi + 1) * fs), slice(ri * rs,
                                                           (ri + 1) * rs))
                with on_device(dev):
                    row.append(analysis_step(
                        as_int32(orig[sl], dev).contiguous(),
                        as_int32(bufs[sl], dev).contiguous(), int(qp), size,
                        bit_depth))
            parts.append(row)
        out = tuple(torch.cat([torch.cat([p[j].to(lead, non_blocking=True)
                                          for p in row], 1)
                               for row in parts], 0) for j in range(3))
        total = torch.stack([p[3].to(lead, non_blocking=True)
                             for row in parts for p in row]) \
            .sum(dtype=torch.int32)
        return out + (total,)

    return step


def example_batch(f, r, n, size, rng=None):
    """A random (f, r, n) batch of 8-bit blocks and their filtered reference
    buffers (numpy int32): (orig (f, r, n, s, s), bufs (f, r, n, 2, 4s+1))."""
    rng = rng or np.random.default_rng(0)
    orig = rng.integers(0, 256, (f, r, n, size, size)).astype(np.int32)
    tops = rng.integers(0, 256, (f, r, n, 2 * size + 1)).astype(np.int64)
    lefts = rng.integers(0, 256, (f, r, n, 2 * size + 1)).astype(np.int64)
    lefts[..., 0] = tops[..., 0]
    bufs = np.zeros(tops.shape[:-1] + (2, 4 * size + 1), dtype=np.int32)
    flat_t = tops.reshape(-1, 2 * size + 1)
    flat_l = lefts.reshape(-1, 2 * size + 1)
    flat_b = bufs.reshape(-1, 2, 4 * size + 1)
    for i in range(flat_t.shape[0]):
        tf, lf = filter_reference_samples(flat_t[i], flat_l[i], size, 8, False)
        flat_b[i] = analysis.pack_ref_buffers(
            flat_t[i:i + 1], flat_l[i:i + 1], tf[None], lf[None])[0]
    return orig, bufs

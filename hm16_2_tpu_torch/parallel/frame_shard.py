"""Row-banded per-size intra RD: the all-intra plan's stage 1 over a mesh.

Counterpart of `hm16_2_tpu/parallel/frame_shard.py`.  The luma plane is
split into n row bands, one per mesh entry; each band evaluates its aligned
s-blocks (K1's band mode, then K2) with the last row of the band above
(`halo_top`) and the first s rows of the band below (`halo_bot`) as halos.
The sizes that share a band height B take one K1 launch per band, with
the first smax rows of the band below as `halo_bot` (smax the largest of
them; each size reads its first s rows).
The reference moves the halos with `ppermute`, which gives zeros to a device
that receives nothing: band 0's `halo_top` (masked at the picture's top) and
the last band's `halo_bot`, which the left references can reach when the
banded rows stop short of the picture (ROADMAP "Faults found"); the zeros
are reproduced.  The grids are gathered on the lead device (the mesh's
first) and the plan runs there from them (`intra_rd.submit_plan(stage1=)`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from hm16_2_tpu_torch import kernels
from hm16_2_tpu_torch.encode import intra_rd
from hm16_2_tpu_torch.encode.intra_rd import NUM_RD_CANDS


def make_row_mesh(devices):
    """The row mesh over `devices` (torch devices or their names), band 0
    on the first, which is the lead device."""
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_row_mesh: no device")
    return mesh


def on_device(dev):
    """The context that makes `dev` the current CUDA device, so that a
    kernel launches on its stream (nothing to do on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def as_int32(a, device):
    """An int32 tensor of `a` (numpy or torch) on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)) \
        .to(device)


def gather(parts, lead, dim=0):
    """The concatenation of per-band tensors on the lead device."""
    return torch.cat([p.to(lead, non_blocking=True) for p in parts], dim)


def band_groups(h: int, w: int, n: int):
    """{band height B: sizes} of the sizes s whose (h // s) * s rows split
    into n bands of whole s-blocks, B = (h // s) * s // n: the sizes that
    share one K1 launch per band."""
    groups = {}
    for s in (4, 8, 16, 32):
        rows = (h // s) * s
        if h // s and w // s and rows % (n * s) == 0:
            groups.setdefault(rows // n, []).append(s)
    return groups


def split_bands(mesh, plane, smax: int):
    """plane (n * B, W) (numpy or torch) as one band per mesh entry, with
    the halos of `ppermute`: each band's halo_top (1, W), the last row of
    the band above, and halo_bot (smax, W), the first rows of the band
    below, zeros at the ends.  Returns (bands, tops, bots)."""
    n = len(mesh)
    B, W = plane.shape[0] // n, plane.shape[1]
    bands = [as_int32(plane[i * B:(i + 1) * B], dev)
             for i, dev in enumerate(mesh)]
    zeros = lambda rows, dev: torch.zeros((rows, W), dtype=torch.int32,
                                          device=dev)
    tops = [zeros(1, mesh[0])] + [bands[i - 1][-1:].to(mesh[i],
                                                        non_blocking=True)
                                  for i in range(1, n)]
    bots = [bands[i + 1][:smax].to(mesh[i], non_blocking=True)
            for i in range(n - 1)] + [zeros(smax, mesh[-1])]
    return bands, tops, bots


# ---------------------------------------------------------------------------
# K1's band mode
# ---------------------------------------------------------------------------

def _ref_buffers_band_plain(band, halo_top, halo_bot, s, bd, strong,
                            band_first, pic_h):
    B, W = band.shape
    nby, nbx = B // s, W // s
    dev = band.device
    x0s = (torch.arange(nbx, device=dev) * s).repeat(nby)
    y0s = (torch.arange(nby, device=dev) * s).repeat_interleave(nbx)
    cols = torch.clamp(x0s[:, None] + torch.arange(-1, 2 * s, device=dev),
                       0, W - 1)
    ext = torch.cat([halo_top, band])            # top refs of row y0: ext[y0]
    tops = torch.where((band_first + y0s > 0)[:, None], ext[y0s[:, None], cols],
                       band[y0s[:, None], cols])
    ext2 = torch.cat([band, halo_bot])
    max_row = min(B + s - 1, pic_h - 1 - band_first)
    rows = torch.clamp(y0s[:, None] + torch.arange(-1, 2 * s, device=dev), 0,
                       max_row)
    lefts = ext2[rows, torch.clamp(x0s - 1, min=0)[:, None]]
    blocks = band[:nby * s, :nbx * s].reshape(nby, s, nbx, s) \
        .transpose(1, 2).reshape(nby * nbx, s, s).to(torch.int32)
    return intra_rd._pack_buffers(tops, lefts, s, bd, strong), blocks


def ref_buffers_band(band, halo_top, halo_bot, s: int, bd: int, strong: bool,
                     band_first: int, pic_h: int):
    """K1 on one row band: (N, 2, 4s+1) buffers and (N, s, s) blocks of the
    aligned s-blocks of band (B, W), whose first row is picture row
    band_first of pic_h, with halo_top (1, W) the band above's last row and
    halo_bot (s, W) the band below's first rows (zeros where there is
    none).  Tops come from [halo_top; band] (the block's own first row at
    the picture's top), lefts from [band; halo_bot] clipped at
    min(B + s - 1, pic_h - 1 - band_first)."""
    return ref_buffers_band_multi(band, halo_top, halo_bot, [s], bd, strong,
                                  band_first, pic_h)[0]


def ref_buffers_band_multi(band, halo_top, halo_bot, sizes, bd: int,
                           strong: bool, band_first: int, pic_h: int):
    """ref_buffers_band of each size in `sizes` on one band in one K1
    launch, halo_bot (max(sizes), W): a list of (bufs, blocks)."""
    if intra_rd._on_cuda(band):
        return kernels.ref_buffers_band_multi(band, halo_top, halo_bot, sizes,
                                              bd, strong, band_first, pic_h)
    return [_ref_buffers_band_plain(band, halo_top, halo_bot[:s], s, bd,
                                    strong, band_first, pic_h)
            for s in sizes]


def _bands_rd(band, halo_top, halo_bot, band_first, sizes, ks, bd, qp, lam,
              strong, pic_h):
    """Candidate RD (ks[i] candidates at sizes[i]) of one band's aligned
    s-blocks for each s in sizes: per size the (mode, cost, top3, satd)
    grids of shape (B/s, W/s, ...)."""
    B, W = band.shape
    out = []
    for s, k, (bufs, blocks) in zip(sizes, ks, ref_buffers_band_multi(
            band, halo_top, halo_bot, sizes, bd, strong, band_first, pic_h)):
        mode, cost, top3, satd = intra_rd.size_rd(
            bufs, blocks, lam, s, bd, k, qp, True, s == 4, True)
        g = (B // s, W // s)
        out.append((mode.reshape(g), cost.reshape(g), top3.reshape(g + (3,)),
                    satd.reshape(g + (35,))))
    return out


def sharded_sizes_rd(mesh, plane, sizes, ks, bd: int, qp: int, lam: float,
                     strong: bool, pic_h: int):
    """Row-banded per-size intra RD (ks[i] candidates at sizes[i]) of the
    sizes of one band height: plane (H, W) (numpy or torch), H a multiple
    of n * s for every s in sizes, split into one band per mesh entry; the
    halos move once, K1 launches once per band.  Returns per size the
    (mode, cost, top3, satd) grids (H/s, W/s, ...) on the lead device."""
    n = len(mesh)
    H = plane.shape[0]
    if any(H % (n * s) for s in sizes):
        raise ValueError(f"sharded_sizes_rd: {H} rows do not split into {n} "
                         f"bands of whole blocks of every size in {sizes}")
    B = H // n
    bands, tops, bots = split_bands(mesh, plane, max(sizes))
    outs = []
    for i, dev in enumerate(mesh):
        with on_device(dev):
            outs.append(_bands_rd(bands[i], tops[i], bots[i], i * B, sizes,
                                  ks, bd, qp, lam, strong, pic_h))
    return [tuple(gather([o[k][j] for o in outs], mesh[0]) for j in range(4))
            for k in range(len(sizes))]


def sharded_size_rd(mesh, plane, s: int, bd: int, k: int, qp: int,
                    lam: float, strong: bool, pic_h: int):
    """Row-banded per-size intra RD: plane (H, W) (numpy or torch), H a
    multiple of n * s, split into one band per mesh entry.  Returns the
    (mode, cost, top3, satd) grids (H/s, W/s, ...) on the lead device."""
    return sharded_sizes_rd(mesh, plane, [s], [k], bd, qp, lam, strong,
                            pic_h)[0]


def sharded_plan_frame(mesh, orig, sps, qp, lam, chroma_weight, chroma_qps):
    """intra_rd.plan_frame with the per-size stage-1 sweeps row-banded over
    the mesh where the geometry divides evenly ((h // s) * s rows, a
    multiple of n * s), the sizes of one band height (h // s) * s // n
    together; the other sizes run whole on the lead device inside the
    plan's own K1 launch, and the plan runs there from all the grids.
    Returns the IntraPlan."""
    n = len(mesh)
    lead = mesh[0]
    h, w = sps.pic_height, sps.pic_width
    bd = sps.bit_depth_luma
    strong = bool(sps.strong_intra_smoothing)
    y = as_int32(orig[0], lead)
    grids = {}
    with on_device(lead):
        for B, group in band_groups(h, w, n).items():
            grids.update(zip(group, sharded_sizes_rd(
                mesh, y[:n * B], group, [NUM_RD_CANDS[s] for s in group], bd,
                int(qp), float(lam), strong, h)))
        fut = intra_rd.submit_plan(orig, sps, qp, lam, chroma_weight,
                                   chroma_qps, lead,
                                   stage1=[grids.get(s) for s in (
                                       4, 8, 16, 32)])
    return intra_rd.fetch_plan(fut, h, w)

"""The frozen work counts equal chip_smoke.py's at the 1080p shapes."""

import pytest
import torch

import chip_smoke
import pb_work
from hm16_2_tpu_torch.encode import inter_plan, intra_rd

H, W = 1080, 1920


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_k2_counts(s):
    k = intra_rd.NUM_RD_CANDS[s]
    assert pb_work.NUM_RD_CANDS[s] == k
    n = (H // s) * (W // s)
    ops, nbytes = pb_work.k2_size_rd(H, W, s)
    assert ops == chip_smoke._ops_rd(n, s, k)
    # chip_smoke counts the inputs (bufs, blocks) and the outputs of
    # kernels.intra_size_rd, each once
    ins = (torch.empty((n, 2, 4 * s + 1), dtype=torch.int32),
           torch.empty((n, s, s), dtype=torch.int32))
    outs = [torch.empty(n, dtype=torch.int32),
            torch.empty(n, dtype=torch.float32),
            torch.empty((n, 3), dtype=torch.int32)]
    if s == 32:
        outs.append(torch.empty((n, 35), dtype=torch.int32))
    assert nbytes == chip_smoke._nbytes(ins) + chip_smoke._nbytes(outs)


def test_k7_shapes():
    assert pb_work.shapes(H, W) == inter_plan._shapes(H, W, True)
    assert (pb_work.SIZES, pb_work.RECT_SIZES, pb_work.MARGIN) == \
        (inter_plan.SIZES, inter_plan.RECT_SIZES, inter_plan.MARGIN)


@pytest.mark.parametrize("refs", [1, 2, 4])
def test_k7_counts(refs):
    """Operations as chip_smoke.py's K7 cases count them (q-pel:
    refs * Ny * Nx * 49 * bh * bw * 10; each bi pass: ny * nx * 49 * s * s
    * 14) and bytes by its _nbytes over the kernel's inputs and outputs."""
    launches = pb_work.k7_launches(H, W, refs, bi=True)
    shapes = inter_plan._shapes(H, W, True)
    Hp, Wp = H + 2 * inter_plan.MARGIN + 1, W + 2 * inter_plan.MARGIN + 1
    sub = _meta((refs, 16, Hp, Wp), torch.int16)
    cur = torch.empty((H, W), dtype=torch.int32)
    want = []
    for s, part, bh, bw, ny, nx in shapes:
        n = ny * nx
        ins = (sub, cur, torch.empty((refs, ny, nx, 2), dtype=torch.int32),
               torch.empty((refs, ny, nx, 2), dtype=torch.int32))
        outs = (torch.empty((refs, n, 2), dtype=torch.int32),
                torch.empty((refs, n), dtype=torch.float32))
        want.append((refs * ny * nx * 49 * bh * bw * 10,
                     chip_smoke._nbytes(ins) + chip_smoke._nbytes(outs)))
    for s in inter_plan.SIZES:
        n = (H // s) * (W // s)
        ins = (sub, cur) + tuple(
            torch.empty(shape, dtype=torch.int32)
            for shape in ((n, 2), (n,), (n, 2), (n,), (n, 2)))
        outs = (torch.empty((n, 2), dtype=torch.int32),
                torch.empty(n, dtype=torch.float32))
        want += [(n * 49 * s * s * 14,
                  chip_smoke._nbytes(ins) + chip_smoke._nbytes(outs))] * 2
    assert launches == want
    assert len(pb_work.k7_launches(H, W, refs, bi=False)) == len(shapes)


def test_bounds_name_their_limit():
    t, by = pb_work.least_s(67e12, 0)
    assert (t, by) == (1.0, "operations")
    t, by = pb_work.least_s(0, 3.35e12)
    assert (t, by) == (1.0, "bytes")

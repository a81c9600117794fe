"""K5's frozen work counts (pb_work_me) equal chip_smoke.py's at the 1080p
shapes, and `k5_me_roofline` reads only the plan's K5 kernels."""

import pytest
import torch

import chip_smoke
import pb_spec
import pb_work
import pb_work_me
import run
from hm16_2_tpu_torch.encode import inter_plan

H, W = 1080, 1920


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("refs", [1, 2, 3, 4])
def test_k5_counts(refs):
    shapes = inter_plan._shapes(H, W, True)
    me_shapes = [(bh, bw, ny * nx) for _, _, bh, bw, ny, nx in shapes]
    assert pb_work_me.MVD_BIN_OPS == chip_smoke.MVD_BIN_OPS
    assert pb_work_me.ops_me(refs, H, W) == chip_smoke._ops_me(
        refs, H, W, me_shapes, chip_smoke.MVD_BIN_OPS)
    # chip_smoke's K5 case reads (cur, refs, mvp8) and writes one MV grid
    # per shape (kernels.inter_me), each once
    ins = (_meta((H, W)), _meta((refs, H, W)),
           _meta((refs, H // 8, W // 8, 2)))
    outs = [_meta((refs, ny, nx, 2)) for _, _, _, _, ny, nx in shapes]
    nb = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    assert pb_work_me.bytes_me(refs, H, W) == nb
    assert pb_work_me.least_s(refs, H, W) == pb_work.least_s(
        pb_work_me.ops_me(refs, H, W), nb)[0]


def test_four_references_bound():
    """PERF.md's K5 row: 0.4146 ms at four references, set by operations."""
    t, by = pb_work.least_s(pb_work_me.ops_me(4, H, W),
                            pb_work_me.bytes_me(4, H, W))
    assert by == "operations" and round(t * 1e3, 4) == 0.4146


def _ctx(events, plans):
    return run.Ctx(pictures=len(plans), stage_ms={}, launches=0,
                   device_events=events, window_s=1.0, busy_s=0.0,
                   plans=plans, width=W, height=H)


def test_reads_nothing_without_a_trace():
    read = pb_spec.reader("k5_me_roofline")
    assert read(_ctx([], [])) is None
    assert read(_ctx([], [(4, False)])) is None


def test_reads_the_plan_kernels_only():
    read = pb_spec.reader("k5_me_roofline")
    events = [
        ("hm::me_coarse8_kernel(int const*, int const*, int)", 0.0, 0.001),
        ("void hm::me_refine_kernel<hm::MvdBins>(int const*, int)", 0.002,
         0.004),
        ("void hm::me_argmin_kernel<hm::MvdBins>(float const*, int)", 0.005,
         0.006),
        ("void hm::me_refine_kernel<hm::MvLog>(int const*, int)", 0.0, 1.0),
        ("hm::frac_refine_kernel(short const*, int)", 0.0, 1.0),
        ("Memcpy HtoD (Pageable -> Device)", 0.0, 1.0)]
    plans = [(4, False), (2, True)]
    least = pb_work_me.least_s(4, H, W) + pb_work_me.least_s(2, H, W)
    assert read(_ctx(events, plans)) == pytest.approx(100 * least / 0.004)

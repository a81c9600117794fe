"""K1 with every size and plane of a picture in one launch
(`intra_rd.ref_buffers_multi`) and its band mode with the sizes of one band
height in one launch per band (`frame_shard.ref_buffers_band_multi`): on
the CPU their plain versions against the JAX package's `_jnp_ref_buffers`
and banded plan, with zero tolerance, on the inputs of
`chip_smoke.k1_edge_inputs` and `K1_BAND_CASES`, which `check_k1_edges`
holds the kernels to on the card; and the plans' K1 calls counted: one
per picture.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_k1_multi.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K1_BAND_CASES, k1_band_plane, k1_edge_inputs, \
    k4_intra_args, k4_plan_args, run_intra_plan, run_plan
from hm16_2_tpu.encode import intra_rd as RR
from hm16_2_tpu.encode.top import EncoderConfig, build_sps_pps
from hm16_2_tpu.parallel import frame_shard as RF
from hm16_2_tpu_torch.encode import intra_rd as PR
from hm16_2_tpu_torch.parallel import frame_shard as PF
from make_fixtures import make_yuv

torch.set_num_threads(1)

CPU = torch.device("cpu")
QP = 32
LAM = float(np.float32(0.57 * 2.0 ** ((QP - 12) / 3.0)))


def _multi_equals_jax(case, strong):
    """ref_buffers_multi of one edge case on the CPU against
    _jnp_ref_buffers entry by entry; returns the JAX buffers."""
    planes, entries = k1_edge_inputs(case, strong)
    t = [torch.from_numpy(p) for p in planes]
    got = PR.ref_buffers_multi([(t[i],) + tuple(e) for i, *e in entries])
    assert len(got) == len(entries)
    ref = []
    for (i, s, bd, st, h, w), (bufs, blocks) in zip(entries, got):
        rb, rbl = RR._jnp_ref_buffers(jnp.asarray(planes[i]), s, bd, st, h,
                                      w)
        assert bufs.shape == (h // s * (w // s), 2, 4 * s + 1)
        np.testing.assert_array_equal(bufs.numpy(), np.asarray(rb))
        np.testing.assert_array_equal(blocks.numpy(), np.asarray(rbl))
        ref.append(np.asarray(rb))
    return entries, ref


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_luma_group_at_threshold_equals_jax(bd, strong):
    """The luma group s = 4-32 on a flat-plus-noise plane whose 32x32
    blocks meet the strong-smoothing test exactly at thr - 1 and thr
    (thr = 2^(bd-5)), on both tests and both signs."""
    entries, ref = _multi_equals_jax(f"bd{bd}", strong)
    assert [e[1] for e in entries] == [4, 8, 16, 32]
    u = ref[3][:, 0].astype(np.int64)                # s = 32, unfiltered
    dt = np.abs(u[:, 64] + u[:, 128] - 2 * u[:, 96])
    dl = np.abs(u[:, 64] + u[:, 0] - 2 * u[:, 32])
    thr = 1 << (bd - 5)
    assert {thr - 1, thr} <= set(dt) and {thr - 1, thr} <= set(dl)
    use = (dt < thr) & (dl < thr)
    assert use.any() and not use.all()


@pytest.mark.parametrize("case", ["232x152", "136x72", "one_ctu", "short",
                                  "big_plane"])
def test_picture_group_equals_jax(case):
    """An AI picture's ten entries (luma s = 4-32, Cb and Cr at s = 4-16,
    4:2:0) at 232x152, 136x72 and one CTU; 24x136, where luma s = 32 and
    chroma s = 16 have no block; the luma group on a 100x144 plane holding
    96x136."""
    entries, ref = _multi_equals_jax(case, True)
    empty = [e[1:2] + (e[0],) for e, r in zip(entries, ref) if not len(r)]
    assert empty == ([(32, 0), (16, 1), (16, 2)] if case == "short" else [])


@pytest.mark.parametrize("h, w, n", K1_BAND_CASES)
def test_band_groups_equal_one_size(h, w, n):
    """ref_buffers_band_multi on each band of each band height's group
    against the one-size band mode (held to the JAX package by
    test_torch_parallel*.py) per size, with the group's smax-row
    halo_bot; at 136x72 over 2 bands the groups are {4} at B = 36 and
    {16, 32} at B = 32, whose last band reads its zero halo_bot."""
    y = torch.from_numpy(k1_band_plane(h, w))
    groups = PF.band_groups(h, w, n)
    if (h, w) == (72, 136):
        assert groups == {36: [4], 32: [16, 32]}
    else:
        assert groups == {h // n: [4, 8, 16, 32]}
    for B, group in groups.items():
        bands, tops, bots = PF.split_bands([CPU] * n, y[:n * B], max(group))
        assert bots[-1].shape == (max(group), w) and not bots[-1].any()
        for i in range(n):
            got = PF.ref_buffers_band_multi(bands[i], tops[i], bots[i], group,
                                            8, True, i * B, h)
            for s, (bufs, blocks) in zip(group, got):
                wb, wbl = PF.ref_buffers_band(bands[i], tops[i],
                                              bots[i][:s].contiguous(), s, 8,
                                              True, i * B, h)
                assert torch.equal(bufs, wb) and torch.equal(blocks, wbl)
        if n * B < h:
            # rows below the bands: the last band's left references reach
            # into its zero halo_bot
            assert all(min(B + s - 1, h - 1 - (n - 1) * B) >= B
                       for s in group)


def test_sharded_plan_frame_136x72_equals_jax():
    """The banded AI plan at 136x72 over 2 bands (s = 4 and s = 16, 32 in
    two band groups, s = 8 whole inside the plan's K1 launch) against the
    JAX package's: every plan field equal."""
    h, w = 72, 136
    planes = [p.astype(np.int32) for p in make_yuv(w, h, 1, seed=23)[0]]
    sps, _ = build_sps_pps(EncoderConfig(w, h, qp=QP, intra_period=1))
    args = (sps, QP, LAM, 1.0, (QP - 1, QP - 1))
    ref = RF.sharded_plan_frame(RF.make_row_mesh(jax.devices("cpu")[:2]),
                                planes, *args)
    got = PF.sharded_plan_frame(PF.make_row_mesh([CPU, CPU]), planes, *args)
    for f in ("depth", "nxn", "mode", "cov", "tusplit", "cmode", "cands"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)


def _count(monkeypatch, mod, name):
    """Count the calls of mod.name (still calling it)."""
    calls = []
    fn = getattr(mod, name)

    def counted(*a, **kw):
        calls.append(a)
        return fn(*a, **kw)

    monkeypatch.setattr(mod, name, counted)
    return calls


def _refuse(monkeypatch, mod, name):
    def refused(*a, **kw):
        raise AssertionError(f"{name} called")
    monkeypatch.setattr(mod, name, refused)


def test_intra_plan_calls_k1_once(monkeypatch):
    """The AI plan (232x152, chroma on) calls ref_buffers_multi once, with
    all ten entries, and never the one-size wrapper."""
    calls = _count(monkeypatch, PR, "ref_buffers_multi")
    _refuse(monkeypatch, PR, "ref_buffers")
    run_intra_plan(k4_intra_args("moving", (152, 232)), CPU)
    assert len(calls) == 1 and len(calls[0][0]) == 10


@pytest.mark.parametrize("is_b", [False, True])
def test_inter_plan_calls_k1_once(monkeypatch, is_b):
    """A P and a B plan (136x72) call ref_buffers_multi once, for the
    intra alternative's sizes 8-32, and never the one-size wrapper."""
    calls = _count(monkeypatch, PR, "ref_buffers_multi")
    _refuse(monkeypatch, PR, "ref_buffers")
    run_plan(k4_plan_args("one_ctu", is_b, (72, 136)), CPU)
    assert [[e[1] for e in c[0]] for c in calls] == [[8, 16, 32]]


@pytest.mark.parametrize("h, w, n", [(72, 136, 2), (128, 128, 2),
                                     (128, 128, 4)])
def test_sharded_plan_frame_calls_k1_per_band_group(monkeypatch, h, w, n):
    """sharded_plan_frame calls the band mode once per band per band
    height's group, and the plan's K1 once (chroma, the unbanded sizes and
    s = 32 for the 64x64 level)."""
    bands = _count(monkeypatch, PF, "ref_buffers_band_multi")
    whole = _count(monkeypatch, PR, "ref_buffers_multi")
    _refuse(monkeypatch, PR, "ref_buffers")
    planes = [p.astype(np.int32) for p in make_yuv(w, h, 1, seed=29)[0]]
    sps, _ = build_sps_pps(EncoderConfig(w, h, qp=QP, intra_period=1))
    PF.sharded_plan_frame(PF.make_row_mesh([CPU] * n), planes, sps, QP, LAM,
                          1.0, (QP - 1, QP - 1))
    groups = PF.band_groups(h, w, n)
    assert [c[3] for c in bands] == [g for g in groups.values()
                                     for _ in range(n)]
    assert len(whole) == 1
    sizes = [e[1] for e in whole[0][0] if e[0].shape == (h, w)]
    banded = {s for g in groups.values() for s in g}
    assert sizes == [s for s in (4, 8, 16, 32) if s not in banded] + (
        [32] if 32 in banded and h >= 64 and w >= 64 else [])

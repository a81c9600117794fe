"""The port's row-banded integer ME (hm16_2_tpu_torch/parallel/plan_shard.py,
me_shard.py) against the JAX package's on its virtual 8-device CPU mesh
(conftest): every MV and cost equal, with zero tolerance, with priors that
point across band edges; an LDP stream whose plans take the banded ME,
byte for byte; and the banded intra RD's zero-halo case.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hm16_2_tpu.encode import intra_rd as RR
from hm16_2_tpu.encode import inter_plan as RP
from hm16_2_tpu.encode.top import Encoder as REncoder, EncoderConfig
from hm16_2_tpu.parallel import frame_shard as RF
from hm16_2_tpu.parallel import me_shard as RMS
from hm16_2_tpu.parallel import plan_shard as RPS
from hm16_2_tpu_torch.decode.top import Decoder
from hm16_2_tpu_torch.encode import inter_me as PM
from hm16_2_tpu_torch.encode import inter_plan as PP
from hm16_2_tpu_torch.encode.top import Encoder as PEncoder
from hm16_2_tpu_torch.parallel import frame_shard as PF
from hm16_2_tpu_torch.parallel import me_shard as PMS
from hm16_2_tpu_torch.parallel import plan_shard as PPS
from test_torch_parallel import LAM, QP, assert_grids_equal, content, \
    sizes_rd

torch.set_num_threads(1)

CPU = torch.device("cpu")
# (h, w, bands, references)
SHAPES = [(128, 128, 2, 1), (128, 128, 2, 2), (256, 128, 4, 2)]


def pictures(h, w, R, seed):
    """A current picture and R references: shifted noise plus a little
    more noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 16, w + 16))
    cur = base[8:8 + h, 8:8 + w]
    refs = np.stack([np.roll(base, (3 * r + 2, -2 * r - 1), (0, 1))
                     [8:8 + h, 8:8 + w] + rng.integers(-3, 4, (h, w))
                     for r in range(R)])
    return cur.astype(np.int32), np.clip(refs, 0, 255).astype(np.int32)


def jax_mesh(n):
    return RF.make_row_mesh(jax.devices("cpu")[:n])


@pytest.mark.parametrize("h,w,n,R", SHAPES)
def test_sharded_int_me_equals_jax(h, w, n, R):
    """The plan's integer-ME grids of every CU shape, with a POC-normalised
    prior of +-70 full-pel at distance 1 (so that MVs cross band edges)."""
    cur, refs = pictures(h, w, R, h + R)
    rng = np.random.default_rng(n * R)
    mvn16 = rng.integers(-70 * 64, 70 * 64 + 1,
                         (h // 8, w // 8, 2)).astype(np.int32)
    dists = np.arange(1, R + 1, dtype=np.int32) * np.array([1, -1])[:R]
    lams = float(np.float32(np.sqrt(0.578 * 2.0 ** (21 / 3.0))))
    sq, rect = RPS.sharded_int_me(jax_mesh(n), cur, refs, mvn16, dists, lams,
                                  h, w)
    ref = {(s, 0): g for s, g in sq.items()}
    ref.update(rect)
    got = PPS.sharded_int_me(PF.make_row_mesh([CPU] * n),
                             torch.from_numpy(cur), torch.from_numpy(refs),
                             torch.from_numpy(mvn16), torch.from_numpy(dists),
                             lams, h, w)
    assert sorted(got) == sorted(ref)
    for k, g in got.items():
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), ref[k], str(k))
    assert PPS.shardable(PF.make_row_mesh([CPU] * n), h, w, True)
    whole = PP.int_me(torch.from_numpy(cur), torch.from_numpy(refs),
                      PP._mvp_full(torch.from_numpy(mvn16),
                                   torch.from_numpy(dists)), lams, h, w, True)
    for k, g in got.items():
        assert torch.equal(g, whole[k]), k


@pytest.mark.parametrize("h,w,n,R", SHAPES)
def test_sharded_me_frame_equals_jax(h, w, n, R):
    """The per-CU search's frame ME (log bit model), MVs and costs, with a
    prior of +-70 full-pel."""
    cur, refs = pictures(h, w, R, 2 * h + R)
    mvp8 = np.random.default_rng(R).integers(
        -70, 71, (R, h // 8, w // 8, 2)).astype(np.int32)
    lam = float(np.float32(np.sqrt(0.85 * 2.0 ** (20 / 3.0))))
    ref = RMS.sharded_me_frame(jax_mesh(n), jnp.asarray(cur),
                               jnp.asarray(refs), jnp.asarray(mvp8),
                               jnp.float32(lam), h, w)
    got = PMS.sharded_me_frame(PF.make_row_mesh([CPU] * n),
                               torch.from_numpy(cur), torch.from_numpy(refs),
                               torch.from_numpy(mvp8), lam, h, w)
    whole = PM.me_frame(torch.from_numpy(cur), torch.from_numpy(refs),
                        torch.from_numpy(mvp8), lam, h, w)
    assert sorted(got) == sorted(ref) == sorted(whole)
    for s, (mv, cost) in ref.items():
        np.testing.assert_array_equal(got[s][0].numpy(), np.asarray(mv))
        np.testing.assert_array_equal(got[s][1].numpy(), np.asarray(cost))
        assert torch.equal(got[s][0], whole[s][0])
        assert torch.equal(got[s][1], whole[s][1])


class _Ref:
    def __init__(self, plane, poc):
        self.rec, self.poc = [plane], poc


def test_sharded_submit_me_same_plan():
    """sharded_submit_me builds the MePlan that submit_me does."""
    h, w = 128, 128
    cur, refs = pictures(h, w, 2, 9)
    pics = [_Ref(refs[i], i) for i in range(2)]
    lists = [[pics[0], pics[1]], [pics[1]]]
    prior = np.random.default_rng(3).integers(
        -40, 41, (h // 8, w // 8, 2)).astype(np.int32)
    lam = 7.5
    mesh = PF.make_row_mesh([CPU, CPU])
    got = PMS.sharded_submit_me(mesh, cur, lists, prior, lam, h, w)()
    want = PM.submit_me(cur, lists, prior, lam, h, w, CPU)()
    assert sorted(got.grids) == sorted(want.grids) and len(got.grids) == 12
    for k, (mv, cost) in want.grids.items():
        np.testing.assert_array_equal(got.grids[k][0], mv)
        np.testing.assert_array_equal(got.grids[k][1], cost)
    assert PMS.sharded_submit_me(mesh, cur, [[], []], None, lam, h,
                                 w)().grids == {}


def _content(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 17.0) * np.cos(yy / 13.0)
         + rng.normal(0, 2, (h, w))).clip(0, 255).astype(np.int32)
    u = (128 + 20 * np.sin(xx[::2, ::2] / 9.0)).astype(np.int32)
    v = (128 - 20 * np.cos(yy[::2, ::2] / 11.0)).astype(np.int32)
    return [y, u, v]


def test_banded_ldp_stream_equals_jax(monkeypatch):
    """A 3-frame 128x128 LDP stream whose plans take the integer ME banded
    over 2 devices: the port's bytes equal the JAX package's banded stream
    and decode with every hash intact."""
    w, h = 128, 128
    frames = [_content(w, h, s) for s in (1, 2, 3)]
    for i, f in enumerate(frames[1:], 1):
        f[0][:] = np.roll(frames[0][0], 3 * i, axis=1)
    cfg = lambda: EncoderConfig(w, h, qp=32, intra_period=-1, gop="ldp")

    rmesh = jax_mesh(2)
    r_plan = RP.plan_frame
    monkeypatch.setattr(RP, "plan_frame", lambda *a, **kw: r_plan(
        *a, **dict(kw, mesh=rmesh)))
    ref = b"".join(REncoder(cfg()).encode_stream(
        [[p.copy() for p in f] for f in frames]))

    pmesh = PF.make_row_mesh([CPU, CPU])
    p_plan, p_me, calls = PP.plan_frame, PPS.sharded_int_me, []

    def banded_me(mesh, *a):
        calls.append(mesh)
        return p_me(mesh, *a)

    monkeypatch.setattr(PP, "plan_frame", lambda *a, **kw: p_plan(
        *a, **dict(kw, mesh=pmesh)))
    monkeypatch.setattr(PPS, "sharded_int_me", banded_me)
    got = b"".join(PEncoder(cfg(), CPU).encode_stream(
        [[p.copy() for p in f] for f in frames]))
    assert calls == [pmesh, pmesh]           # both P pictures banded
    assert got == ref
    pics = Decoder().decode_stream(got)
    assert len(pics) == 3 and all(p.hash_ok is True for p in pics)


def test_zero_halo_fault_reproduced():
    """136x72 over 2 bands at s = 32: (72 // 32) * 32 = 64 rows pass the
    banding rule, so the last band's left references reach its zero
    `halo_bot` where the whole picture reads rows 64-71.  The port gives
    the JAX package's banded grids, whose SATD differs from the
    single-device one."""
    plane = content(72, 136, 8, 3)
    ref, got = sizes_rd(2, np.ascontiguousarray(plane[:64]), 32, 8, 72)
    assert_grids_equal(got, ref)
    b, bl = RR._jnp_ref_buffers(jnp.asarray(plane), 32, 8, True, 72, 136)
    single = RR._size_rd(b, bl, jnp.float32(LAM), 32, 8, 3, QP, True, False,
                         True)
    satd1 = np.asarray(single[3]).reshape(2, 4, 35)
    differs = (got[3] != satd1).any(-1)
    assert differs[1].all() and not differs[0].any()


def test_zero_halo_fault_reaches_the_plan():
    """The same geometry through the port's whole intra plan: the banded
    stage 1 changes the packed plan's modes, so a 136x72 stream banded over
    2 devices is not the unbanded stream (both packages alike)."""
    from make_fixtures import make_yuv
    from hm16_2_tpu_torch.encode import intra_rd as PR
    from hm16_2_tpu_torch.encode.top import EncoderConfig as PConfig, \
        build_sps_pps

    planes = [p.astype(np.int32) for p in make_yuv(136, 72, 1, seed=2)[0]]
    sps, _ = build_sps_pps(PConfig(136, 72, qp=QP, intra_period=1))
    args = (sps, QP, LAM, 1.0, (QP - 1, QP - 1))
    banded = PF.sharded_plan_frame(PF.make_row_mesh([CPU, CPU]), planes, *args)
    whole = PR.plan_frame(planes, *args, CPU)
    assert (banded.mode != whole.mode).any()
    assert (banded.mode[:8] == whole.mode[:8]).all()     # band 0's rows

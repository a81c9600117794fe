"""The port's row-banded intra RD and analysis step
(hm16_2_tpu_torch/parallel/{frame_shard,mesh}.py) against the JAX
package's on its virtual 8-device CPU mesh (conftest): every grid, plan
and level equal, with zero tolerance.  The port's mesh is `[cpu] * n`.
The 10-bit grids are in test_torch_parallel_10bit.py, the zero-halo case
in test_torch_parallel_me.py (files of their own, so that the reference's
programs compile in processes of their own).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hm16_2_tpu.encode import intra_rd as RR
from hm16_2_tpu.encode.top import EncoderConfig, build_sps_pps
from hm16_2_tpu.ops import analysis as RA
from hm16_2_tpu.parallel import frame_shard as RF
from hm16_2_tpu.parallel import mesh as RM
from hm16_2_tpu_torch.encode import intra_rd as PR
from hm16_2_tpu_torch.ops import analysis as PA
from hm16_2_tpu_torch.parallel import frame_shard as PF
from hm16_2_tpu_torch.parallel import mesh as PM

torch.set_num_threads(1)

CPU = torch.device("cpu")
QP = 32
LAM = float(np.float32(0.57 * 2.0 ** ((QP - 12) / 3.0)))


def content(h, w, bd, seed):
    """Textured noise with a flat ramp over the top-left quadrant, so the
    modes vary and the strong smoothing of 32x32 blocks fires."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    p = (120 + 60 * np.sin(xx / rng.uniform(4, 12) + rng.uniform(0, 6))
         * np.cos(yy / rng.uniform(3, 9)) + rng.normal(0, 6, (h, w)))
    ramp = 100 + (xx + yy) * 0.5
    p = np.where((yy < h // 2) & (xx < w // 2), ramp, p)
    return np.clip(p * (1 << (bd - 8)), 0, (1 << bd) - 1).astype(np.int32)


def jax_mesh(n):
    return RF.make_row_mesh(jax.devices("cpu")[:n])


def sizes_rd(mesh_n, plane, s, bd, pic_h):
    """The JAX package's and the port's sharded_size_rd of one plane."""
    k = RR.NUM_RD_CANDS[s]
    ref = RF.sharded_size_rd(jax_mesh(mesh_n), plane, s, bd, k, QP, LAM,
                             True, pic_h)
    got = PF.sharded_size_rd(PF.make_row_mesh([CPU] * mesh_n),
                             torch.from_numpy(plane), s, bd, k, QP, LAM,
                             True, pic_h)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def assert_grids_equal(got, ref):
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def check_size_rd(n, s, bd):
    """128x128: every band's mode, cost, top-3 and SATD grids equal the
    JAX package's and, the bands covering the picture, the whole
    picture's."""
    plane = content(128, 128, bd, 10 * n + s + bd)
    ref, got = sizes_rd(n, plane, s, bd, 128)
    assert_grids_equal(got, ref)
    b, bl = PR.ref_buffers(torch.from_numpy(plane), s, bd, True, 128, 128)
    whole = PR.size_rd(b, bl, LAM, s, bd, RR.NUM_RD_CANDS[s], QP, True,
                       s == 4, True)
    for g, w_ in zip(got, whole):
        np.testing.assert_array_equal(g.reshape(-1), w_.numpy().reshape(-1))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_sharded_size_rd_equals_jax(n, s):
    check_size_rd(n, s, 8)


def test_sharded_plan_frame_equals_jax():
    """The whole intra plan from the banded stage 1, 128x128 over 2 bands
    (every size banded): every plan array equal."""
    h = w = 128
    planes = [content(h, w, 8, 5), content(h // 2, w // 2, 8, 6),
              content(h // 2, w // 2, 8, 7)]
    cfg = EncoderConfig(w, h, qp=QP, intra_period=1)
    sps, _ = build_sps_pps(cfg)
    args = (sps, QP, LAM, 1.0, (QP - 1, QP - 1))
    ref = RF.sharded_plan_frame(jax_mesh(2), planes, *args)
    got = PF.sharded_plan_frame(PF.make_row_mesh([CPU, CPU]), planes, *args)
    for f in ("depth", "nxn", "mode", "cov", "tusplit", "cmode", "cands"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
    whole = PR.plan_frame(planes, *args, CPU)
    for f in ("depth", "mode", "cands"):
        np.testing.assert_array_equal(getattr(got, f), getattr(whole, f), f)


def test_pack_ref_buffers_copy():
    rng = np.random.default_rng(1)
    t, l, tf, lf = (rng.integers(0, 1024, (5, 17)) for _ in range(4))
    np.testing.assert_array_equal(PA.pack_ref_buffers(t, l, tf, lf),
                                  RA.pack_ref_buffers(t, l, tf, lf))


@pytest.mark.parametrize("size", [4, 16])
def test_analysis_step_equals_jax(size):
    """analysis_step on a (2, 2, 3) batch, and sharded_analysis_step over a
    (frame=2, row=2) mesh, against mesh.py's."""
    orig, bufs = PM.example_batch(2, 2, 3, size, np.random.default_rng(size))
    o2, b2 = RM.example_batch(2, 2, 3, size, np.random.default_rng(size))
    np.testing.assert_array_equal(orig, o2)
    np.testing.assert_array_equal(bufs, b2)
    ref = RM.analysis_step(jnp.asarray(orig), jnp.asarray(bufs),
                           jnp.int32(QP), size, 8)
    got = PM.analysis_step(torch.from_numpy(orig), torch.from_numpy(bufs),
                           QP, size, 8)
    step = RM.sharded_analysis_step(
        RM.make_mesh(jax.devices("cpu")[:4], 2), size, 8)
    ref_sh = step(jnp.asarray(orig), jnp.asarray(bufs), jnp.int32(QP))
    got_sh = PM.sharded_analysis_step(PM.make_mesh([CPU] * 4, 2), size, 8)(
        orig, bufs, QP)
    for g, gs, r, rs in zip(got, got_sh, ref, ref_sh):
        r, rs = np.asarray(r), np.asarray(rs)
        assert g.dtype == torch.int32 and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), r)
        np.testing.assert_array_equal(gs.numpy(), rs)
        np.testing.assert_array_equal(gs.numpy(), r)

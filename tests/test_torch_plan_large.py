"""Packed-plan parity with the JAX package at larger geometries than the
tier-1 tests use: the intra plan at 1920x1080 (8- and 10-bit), the P plan
at 1920x1080 (8-bit, four references), 10-bit P and B plans at 416x240,
and an 8-bit P and B plan at 832x480.  Zero tolerance, as everywhere.

Slow: each geometry compiles its own JAX program (the 1080p P program
about 85 s on a CPU host) and the port's plain P plan at 1080p takes a few
minutes on one CPU thread.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_plan_large.py -m slow
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_inter_plan as TP
import test_torch_inter_plan_b as TB
from hm16_2_tpu.encode import intra_rd as RR
from hm16_2_tpu_torch.encode import intra_rd as PR
from make_fixtures import make_yuv

torch.set_num_threads(1)

pytestmark = pytest.mark.slow


@pytest.mark.parametrize("bd", [8, 10])
def test_intra_plan_1080p(bd):
    """The AI frame plan of make_yuv content at QP 32 (+ 6 per extra bit)."""
    y, cb, cr = (p.astype(np.int32) for p in
                 make_yuv(1920, 1080, 1, seed=42, bits=bd)[0])
    qp = 32 + 6 * (bd - 8)
    kw = dict(h=1080, w=1920, bd=bd, cbd=bd, strong=True, qp=qp,
              cqp0=qp - 1, cqp1=qp - 1, chroma=True)
    lam = float(np.float32(0.57 * 2.0 ** ((32 - 12) / 3.0)))
    cw = float(np.float32(2 ** (1 / 3)))
    ref = np.asarray(RR._plan_device(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), jnp.float32(lam),
        jnp.float32(cw), None, use_stage1=False, **kw))
    got = PR._plan_device(torch.as_tensor(y), torch.as_tensor(cb),
                          torch.as_tensor(cr), lam, cw, **kw).numpy()
    TP._assert_plan_equal(got, ref)


@pytest.mark.parametrize("h,w,bd,qp", [(1080, 1920, 8, 32),
                                       (240, 416, 10, 22),
                                       (240, 416, 10, 37),
                                       (480, 832, 8, 37)])
def test_p_plan_large(h, w, bd, qp):
    """The P plan with four live references."""
    cur, refs, mvn16 = TP._inputs(h, w, bd)
    TP._assert_plan_equal(TP._port_plan(cur, refs, mvn16, 4, qp, bd),
                          TP._ref_plan(cur, refs, mvn16, 4, qp, bd))


@pytest.mark.parametrize("h,w,bd,qp", [(240, 416, 10, 22),
                                       (480, 832, 8, 22)])
def test_b_plan_large(h, w, bd, qp):
    """The B plan with two past and two future references ("2x2")."""
    cur, refs, dists, mvn16 = TB._inputs(h, w, bd)
    lists = TB.LISTS["2x2"]
    TP._assert_plan_equal(
        TB._port_plan(cur, refs, dists, mvn16, lists, qp, bd),
        TB._ref_plan(cur, refs, dists, mvn16, lists, qp, bd))

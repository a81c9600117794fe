"""The port's packed B-picture plan against the JAX reference at 10 bits
(the coarse ME pyramid's float32 sums are no longer exact there, so their
order is held too).  Its own file, so that the reference's 10-bit B program
compiles in a process of its own."""

import pytest
import torch

from test_torch_inter_plan import _assert_plan_equal
from test_torch_inter_plan_b import LISTS, _inputs, _port_plan, _ref_plan

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def geom_10bit():
    return _inputs(72, 136, 10, seed=5)


@pytest.mark.parametrize("lists,qp", [("2x2", 32), ("gpb", 22)])
def test_packed_plan_b_10bit(geom_10bit, lists, qp):
    cur, refs, dists, mvn16 = geom_10bit
    _assert_plan_equal(
        _port_plan(cur, refs, dists, mvn16, LISTS[lists], qp, 10),
        _ref_plan(cur, refs, dists, mvn16, LISTS[lists], qp, 10))

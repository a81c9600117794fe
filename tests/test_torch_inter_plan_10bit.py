"""The port's packed P-picture plan against the JAX reference at 10 bits:
the coarse ME pyramid's float32 sums are no longer exact there, so the
summation order is held too.  Its own file, so that the reference's
10-bit program compiles in a process of its own."""

import pytest
import torch

from test_torch_inter_plan import _assert_plan_equal, _inputs, _port_plan, \
    _ref_plan

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def geom_10bit():
    return _inputs(72, 136, 10, seed=5)


@pytest.mark.parametrize("nref", [1, 2, 3, 4])
@pytest.mark.parametrize("qp", [22, 32, 37])
def test_packed_plan_10bit(geom_10bit, nref, qp):
    cur, refs, mvn16 = geom_10bit
    _assert_plan_equal(_port_plan(cur, refs, mvn16, nref, qp, 10),
                       _ref_plan(cur, refs, mvn16, nref, qp, 10))

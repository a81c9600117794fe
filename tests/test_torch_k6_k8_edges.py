"""The inputs on which the K6 / K8 kernels' invariants rest: the sub-pel
planes of all-zero, all-maximum, 0/max checkerboard and edge-line
references at 8, 10 and 12 bits (`chip_smoke.k6_edge_refs`: the int32
headroom's extremes, the clamped padding), and the P and B plans of a flat
picture where the bits decide every choice, a picture of one CTU where every
rolled merge neighbour is invalid, and a 10-bit picture whose priors sit at
the +-69 cap (`chip_smoke.plan_edge_args`).  The port's plain versions
against the JAX package's, every output equal.  The kernels are held to
these plain versions on the same inputs by `chip_smoke.check_k6_k8_edges`
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K6_EDGE_CONTENTS, K6_EDGE_SIZES, PLAN_EDGE_CASES, \
    k6_edge_refs, plan_edge_args, run_plan
from hm16_2_tpu.encode import inter_plan as RI
from hm16_2_tpu_torch.encode import inter_plan as PI

torch.set_num_threads(1)

_SUBPEL = jax.jit(RI._subpel_planes, static_argnums=(1, 2, 3))


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("hw", K6_EDGE_SIZES, ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("content", K6_EDGE_CONTENTS)
def test_subpel_planes_edges(content, bd, hw, R):
    h, w = hw
    refs = k6_edge_refs(content, bd, h, w, R)
    want = np.asarray(_SUBPEL(jnp.asarray(refs), bd, h, w))
    got = PI.subpel_planes(torch.from_numpy(refs), bd, h, w)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


def _ref_plan(a):
    """The JAX package's packed plan on plan_edge_args' arguments (a P
    plan passes list 0's map twice, with no live list-1 entry)."""
    map1 = a["map1"] if a["is_b"] else a["map0"]
    out = RI._plan_device(
        jnp.asarray(a["cur"]), jnp.asarray(a["refs"]), jnp.asarray(a["mvn16"]),
        jnp.asarray(a["dists"]), jnp.float32(a["lam"]), jnp.float32(a["lams"]),
        jnp.int32(a["qp"]), jnp.asarray(a["map0"]), jnp.asarray(map1),
        jnp.int32(a["nref0"]), jnp.int32(a["nref1"]), None, h=a["h"],
        w=a["w"], bd=a["bd"], is_b=a["is_b"], nmerge=5, parts=True,
        has_me=False)
    return np.asarray(out)


@pytest.mark.parametrize("is_b", [False, True], ids=["P", "B"])
@pytest.mark.parametrize("case", PLAN_EDGE_CASES)
def test_plan_edges(case, is_b):
    a = plan_edge_args(case, is_b)
    got = run_plan(a, torch.device("cpu"))
    assert got.dtype == torch.int16
    want = _ref_plan(a)
    assert got.shape == want.shape
    bad = [c for c in range(want.shape[0])
           if not np.array_equal(got[c].numpy(), want[c])]
    assert not bad, f"plan channels differ: {bad}"


def test_edge_inputs_reach_their_edges():
    """The cases test what they name: the checkerboard saturates the
    planes at both ends, the edge lines reach the far side of the padding,
    the flat picture's SATDs are all 0, the far priors sit at the cap, and
    the one-CTU picture has a single 64x64 CU."""
    for bd in (8, 12):
        planes = PI.subpel_planes(torch.from_numpy(
            k6_edge_refs("checker", bd, 24, 40, 1)), bd, 24, 40)
        assert planes.min() == 0 and planes.max() == (1 << bd) - 1
    lines = PI.subpel_planes(torch.from_numpy(
        k6_edge_refs("edge_lines", 8, 24, 40, 2)), 8, 24, 40)
    assert (lines[0, 0, :, 0] == 255).all() and (lines[1, 0, :, -1] == 255).all()
    flat = plan_edge_args("flat", True)
    assert (flat["refs"] == flat["cur"]).all()
    far = plan_edge_args("far10", False)
    mvp = PI._mvp_full(torch.from_numpy(far["mvn16"]),
                       torch.from_numpy(far["dists"]))
    assert (mvp.abs() == PI.MARGIN - PI.REFINE_R - 8).all()
    one = plan_edge_args("one_ctu", True)
    assert (one["h"], one["w"]) == (64, 64)

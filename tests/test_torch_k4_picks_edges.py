"""The inputs on which the redesigned K4 (the plans' DP and emission, a CTA
per CTU) and K7's list picks (one launch per picture) rest: the packed AI,
P and B plans at 232x152, where every border rule of the emission is live
(232 % 64 = 40: nbx32 = 7 against 2 * nbx64 = 6, so the 64x64 level
gathers a non-prefix of the TU32 rows; nby16 = 9 against 8 and nby8 = 19
against 18), on moving content and on a flat picture whose equal costs
meet the strict DP comparisons (`chip_smoke.k4_intra_args`,
`chip_smoke.k4_plan_args`: chroma on, 8-bit, two live references for P,
two and one for B).  The port's plain path against the JAX package's,
every output equal.  The kernels are held to these plain versions on the
same inputs, and on synthetic tied cost grids, by
`chip_smoke.check_k4_picks_edges` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import k4_intra_args, k4_plan_args, k4_tied_picks, \
    run_intra_plan, run_plan
from hm16_2_tpu.encode import inter_plan as RI
from hm16_2_tpu.encode import intra_rd as RR
from hm16_2_tpu_torch.encode import inter_plan as PI

torch.set_num_threads(1)

SIZE = (152, 232)
CPU = torch.device("cpu")


def _ref_intra(a):
    return np.asarray(RR._plan_device(
        jnp.asarray(a["y"]), jnp.asarray(a["cb"]), jnp.asarray(a["cr"]),
        jnp.float32(a["lam"]), jnp.float32(a["cw"]), None, use_stage1=False,
        **a["kw"]))


def _ref_inter(a):
    """The JAX package's packed plan (a P plan passes list 0's map twice,
    with no live list-1 entry)."""
    map1 = a["map1"] if a["is_b"] else a["map0"]
    return np.asarray(RI._plan_device(
        jnp.asarray(a["cur"]), jnp.asarray(a["refs"]), jnp.asarray(a["mvn16"]),
        jnp.asarray(a["dists"]), jnp.float32(a["lam"]), jnp.float32(a["lams"]),
        jnp.int32(a["qp"]), jnp.asarray(a["map0"]), jnp.asarray(map1),
        jnp.int32(a["nref0"]), jnp.int32(a["nref1"]), None, h=a["h"],
        w=a["w"], bd=a["bd"], is_b=a["is_b"], nmerge=5, parts=True,
        has_me=False))


def _channels_equal(got, want):
    assert got.shape == want.shape
    bad = [c for c in range(want.shape[0])
           if not np.array_equal(got[c].numpy(), want[c])]
    assert not bad, f"plan channels differ: {bad}"


@pytest.mark.parametrize("case", ["moving", "flat"])
def test_intra_plan_borders(case):
    a = k4_intra_args(case, SIZE)
    got = run_intra_plan(a, CPU)
    assert got.dtype == torch.int8
    _channels_equal(got, _ref_intra(a))


@pytest.mark.parametrize("case,is_b", [("one_ctu", False), ("flat", False),
                                       ("one_ctu", True)],
                         ids=["P", "P-flat", "B"])
def test_inter_plan_borders(case, is_b):
    a = k4_plan_args(case, is_b, SIZE)
    got = run_plan(a, CPU)
    assert got.dtype == torch.int16
    _channels_equal(got, _ref_inter(a))


def test_uni_select_all_equals_per_entry():
    """One pick call for every entry equals a call per entry, on entries
    with tied and near-tied costs, masked list entries and reordered
    lists."""
    entries = k4_tied_picks(*SIZE, CPU)
    got = PI._uni_select_all_plain(entries, 0.5)
    assert len(got) == len(entries)
    for g, e in zip(got, entries):
        want = PI._uni_select_plain(*e, 0.5)
        assert g.keys() == want.keys()
        for k in want:
            assert torch.equal(g[k], want[k]), k
    # the first of equal costs wins: nref 2 with equal SATDs and bits
    assert (got[1]["ridx"] == 0).all()


def test_edge_geometry_reaches_its_rules():
    """232x152 has the border grids the test names, and the flat picture
    ties the costs it is meant to tie."""
    h, w = SIZE
    assert (w // 32, 2 * (w // 64)) == (7, 6)
    assert (h // 16, 2 * (h // 32)) == (9, 8)
    assert (h // 8, 2 * (h // 16)) == (19, 18)
    plan = run_intra_plan(k4_intra_args("flat", SIZE), CPU)
    depth = plan[0].numpy()
    # equal texture everywhere: the covered CTUs all take one depth
    assert len(np.unique(depth[:32, :48])) == 1

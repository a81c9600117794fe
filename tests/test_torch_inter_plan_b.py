"""The port's B-picture plan (hm16_2_tpu_torch/encode/inter_plan.py with
is_b=True) against the JAX reference (hm16_2_tpu/encode/inter_plan.py
`_plan_device(is_b=True)`): the bi refinement stage and the whole packed
plan, exactly equal.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
are held to those plain versions on the card (tests/test_torch_gpu.py and
chip_smoke.py).  The reference's B program is its own compiled module
(is_b is static); it is compiled once per geometry and bit depth through
module-scoped fixtures, and the reference lists, QP and prior are run-time
inputs of that one program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm16_2_tpu.encode import inter_plan as RI
from hm16_2_tpu_torch.encode import inter_plan as PI
from make_fixtures import make_yuv
from test_torch_inter_plan import _assert_plan_equal, _lam

torch.set_num_threads(1)

# (list 0, list 1) of each case as indices into the unique references:
# the GPB case (one reference in both lists), two past and two future
# references, two past references and one future one
LISTS = {"gpb": ([0], [0]), "2x2": ([0, 1], [2, 3]), "2x1": ([0, 1], [2])}


def _inputs(h, w, bd, seed=42):
    """cur = frame 2 of a moving sequence; the unique references are frames
    1, 0 (past) and 3, 4 (future), with signed POC distances 1, 2, -1, -2;
    a random POC-normalised prior."""
    frames = make_yuv(w, h, 5, seed=seed, bits=bd)
    cur = frames[2][0].astype(np.int32)
    refs = np.stack([frames[i][0] for i in (1, 0, 3, 4)]).astype(np.int32)
    dists = np.asarray([1, 2, -1, -2], np.int32)
    rng = np.random.default_rng(seed)
    mvn16 = rng.integers(-160, 160, (h // 8, w // 8, 2)).astype(np.int32)
    return cur, refs, dists, mvn16


def _live(refs, dists, lists):
    """The live unique references of a case and the lists mapped onto
    them, in the order plan_frame builds them (list 0, then list 1)."""
    order = []
    for lst in lists:
        for i in lst:
            if i not in order:
                order.append(i)
    maps = [[order.index(i) for i in lst] for lst in lists]
    return refs[order], dists[order], maps


def _pad(m):
    return np.asarray((m + [0] * RI.MAXREF_PLAN)[:RI.MAXREF_PLAN], np.int32)


def _ref_plan(cur, refs, dists, mvn16, lists, qp, bd):
    """The reference's inputs as its plan_frame builds them: the live
    planes padded to MAXREF_PLAN with the first, padded distances 1."""
    h, w = cur.shape
    live, ld, maps = _live(refs, dists, lists)
    n = len(live)
    rp = np.concatenate([live, np.repeat(live[:1], RI.MAXREF_PLAN - n, 0)])
    dp = np.concatenate([ld, np.ones(RI.MAXREF_PLAN - n, np.int32)])
    lam, lams = _lam(qp)
    out = RI._plan_device(
        jnp.asarray(cur), jnp.asarray(rp), jnp.asarray(mvn16),
        jnp.asarray(dp), jnp.float32(lam), jnp.float32(lams),
        jnp.int32(qp + 6 * (bd - 8)), jnp.asarray(_pad(maps[0])),
        jnp.asarray(_pad(maps[1])), jnp.int32(len(maps[0])),
        jnp.int32(len(maps[1])), None, h=h, w=w, bd=bd, is_b=True, nmerge=5,
        parts=True, has_me=False)
    return np.asarray(out)


def _port_plan(cur, refs, dists, mvn16, lists, qp, bd, pad=False):
    """The port's plan on the live references (pad: on the reference's
    padded stack instead)."""
    h, w = cur.shape
    live, ld, maps = _live(refs, dists, lists)
    if pad:
        n = len(live)
        live = np.concatenate([live, np.repeat(live[:1], RI.MAXREF_PLAN - n,
                                               0)])
        ld = np.concatenate([ld, np.ones(RI.MAXREF_PLAN - n, np.int32)])
    lam, lams = _lam(qp)
    got = PI._plan_device(
        torch.as_tensor(cur), torch.as_tensor(live), torch.as_tensor(mvn16),
        torch.as_tensor(ld), lam, lams, qp + 6 * (bd - 8),
        torch.as_tensor(_pad(maps[0])), len(maps[0]),
        torch.as_tensor(_pad(maps[1])), len(maps[1]), h=h, w=w, bd=bd,
        nmerge=5, is_b=True)
    assert got.dtype == torch.int16
    return got.numpy()


# ---------------------------------------------------------------------------
# the bi refinement pass
# ---------------------------------------------------------------------------

_REFINE_ANY = jax.jit(RI._frac_refine_any, static_argnames=("s",))
_GATHER = jax.jit(RI._gather_pred, static_argnames=("bh", "bw"))


@pytest.mark.parametrize("s", [8, 16, 32, 64])
def test_frac_refine_any(s):
    """Negative and positive quarter-pel start MVs (the start is floored
    toward -inf), per-block references over four planes, and the bi target
    2 * orig - pred(other) that the port forms from the other list's
    hypothesis, the reference from a materialised target."""
    h, w = 128, 192
    cur, refs, _, _ = _inputs(h, w, 8, seed=s)
    ny, nx = h // s, w // s
    n = ny * nx
    rng = np.random.default_rng(100 + s)
    mv4 = rng.integers(-75, 75, (n, 2)).astype(np.int32)
    mv4[: n // 2] = -np.abs(mv4[: n // 2]) - 1        # odd negatives too
    o_mv4 = rng.integers(-75, 75, (n, 2)).astype(np.int32)
    uref = rng.integers(0, 4, n).astype(np.int32)
    o_uref = rng.integers(0, 4, n).astype(np.int32)
    anchor = rng.integers(-90, 90, (n, 2)).astype(np.int32)
    _, lams = _lam(29)
    sub = PI.subpel_planes(torch.as_tensor(refs), 8, h, w)
    got_mv, got_satd = PI.frac_refine_any(
        sub, torch.as_tensor(cur), torch.as_tensor(mv4),
        torch.as_tensor(uref), torch.as_tensor(anchor),
        torch.as_tensor(o_uref), torch.as_tensor(o_mv4), lams, s)
    suball = jnp.asarray(sub.reshape(-1, *sub.shape[2:]).numpy())
    ys = jnp.repeat(jnp.arange(ny) * s, nx)
    xs = jnp.tile(jnp.arange(nx) * s, ny)
    blocks = jnp.asarray(cur[:ny * s, :nx * s].reshape(ny, s, nx, s)
                         .swapaxes(1, 2).reshape(n, s, s))
    other = _GATHER(suball, ys, xs, jnp.asarray(o_mv4), jnp.asarray(o_uref),
                    bh=s, bw=s)
    mv, satd = _REFINE_ANY(suball, 2 * blocks - other, ys, xs,
                           jnp.asarray(mv4), jnp.asarray(uref),
                           jnp.asarray(anchor), jnp.float32(lams), s=s)
    np.testing.assert_array_equal(got_mv.numpy(), np.asarray(mv))
    np.testing.assert_array_equal(got_satd.numpy(), np.asarray(satd))


# ---------------------------------------------------------------------------
# the packed plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def geom_136x72():
    return _inputs(72, 136, 8)


@pytest.fixture(scope="module")
def geom_128():
    return _inputs(128, 128, 8, seed=9)


@pytest.mark.parametrize("lists", sorted(LISTS))
@pytest.mark.parametrize("qp", [22, 32, 37])
def test_packed_plan_b_136x72(geom_136x72, lists, qp):
    cur, refs, dists, mvn16 = geom_136x72
    _assert_plan_equal(
        _port_plan(cur, refs, dists, mvn16, LISTS[lists], qp, 8),
        _ref_plan(cur, refs, dists, mvn16, LISTS[lists], qp, 8))


@pytest.mark.parametrize("lists,qp", [("2x2", 27), ("gpb", 35)])
def test_packed_plan_b_128x128(geom_128, lists, qp):
    cur, refs, dists, mvn16 = geom_128
    _assert_plan_equal(
        _port_plan(cur, refs, dists, mvn16, LISTS[lists], qp, 8),
        _ref_plan(cur, refs, dists, mvn16, LISTS[lists], qp, 8))


def test_padding_leaves_b_plan_unchanged(geom_136x72):
    """Computing only the live references equals the reference's padded
    stack: the port's B plan on the padded stack is the same plan."""
    cur, refs, dists, mvn16 = geom_136x72
    for lists in ("gpb", "2x1"):
        np.testing.assert_array_equal(
            _port_plan(cur, refs, dists, mvn16, LISTS[lists], 32, 8,
                       pad=True),
            _port_plan(cur, refs, dists, mvn16, LISTS[lists], 32, 8))

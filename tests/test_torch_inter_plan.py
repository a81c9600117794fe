"""The port's P-picture plan (hm16_2_tpu_torch/encode/inter_plan.py)
against the JAX reference (hm16_2_tpu/encode/inter_plan.py): every stage
and the whole packed plan, exactly equal.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
are held to those plain versions on the card (tests/test_torch_gpu.py and
chip_smoke.py).  The reference's P program is compiled once per geometry
(module-scoped fixtures); the number of live references, the QP and the
motion prior are run-time inputs of that one program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm16_2_tpu.encode import inter_plan as RI
from hm16_2_tpu.encode import intra_rd as RR
from hm16_2_tpu_torch.encode import inter_plan as PI
from hm16_2_tpu_torch.encode import intra_rd as PR
from make_fixtures import make_yuv

torch.set_num_threads(1)


def _lam(qp):
    lam = 0.4624 * 2.0 ** ((qp - 12) / 3.0)
    return float(np.float32(lam)), float(np.float32(np.sqrt(lam)))


def _inputs(h, w, bd, seed=42):
    """cur = frame 4 of a moving sequence, the four previous frames as the
    live references (nearest first), a random POC-normalised prior."""
    frames = make_yuv(w, h, 5, seed=seed, bits=bd)
    cur = frames[4][0].astype(np.int32)
    refs = np.stack([frames[4 - d][0] for d in range(1, 5)]).astype(np.int32)
    rng = np.random.default_rng(seed)
    mvn16 = rng.integers(-160, 160, (h // 8, w // 8, 2)).astype(np.int32)
    return cur, refs, mvn16


def _padded(refs, nref):
    """The reference's inputs as its plan_frame builds them: the live
    planes padded to MAXREF_PLAN with the first, the list map padded with
    0, padded distances 1."""
    live = list(refs[:nref])
    pad = [live[0]] * (RI.MAXREF_PLAN - nref)
    dists = list(range(1, nref + 1)) + [1] * (RI.MAXREF_PLAN - nref)
    map0 = list(range(nref)) + [0] * (RI.MAXREF_PLAN - nref)
    return np.stack(live + pad), np.asarray(dists, np.int32), \
        np.asarray(map0, np.int32)


def _ref_plan(cur, refs, mvn16, nref, qp, bd):
    h, w = cur.shape
    rp, dists, map0 = _padded(refs, nref)
    lam, lams = _lam(qp)
    out = RI._plan_device(
        jnp.asarray(cur), jnp.asarray(rp), jnp.asarray(mvn16),
        jnp.asarray(dists), jnp.float32(lam), jnp.float32(lams),
        jnp.int32(qp + 6 * (bd - 8)), jnp.asarray(map0),
        jnp.asarray(map0), jnp.int32(nref), jnp.int32(0), None, h=h, w=w,
        bd=bd, is_b=False, nmerge=5, parts=True, has_me=False)
    return np.asarray(out)


def _port_plan(cur, refs, mvn16, nref, qp, bd):
    h, w = cur.shape
    lam, lams = _lam(qp)
    map0 = torch.as_tensor(list(range(nref)) + [0] * (PI.MAXREF_PLAN - nref),
                           dtype=torch.int32)
    got = PI._plan_device(
        torch.as_tensor(cur), torch.as_tensor(refs[:nref]),
        torch.as_tensor(mvn16),
        torch.arange(1, nref + 1, dtype=torch.int32), lam, lams,
        qp + 6 * (bd - 8), map0, nref, h=h, w=w, bd=bd, nmerge=5)
    assert got.dtype == torch.int16
    return got.numpy()


def _assert_plan_equal(got, ref):
    assert got.shape == ref.shape
    bad = [c for c in range(ref.shape[0]) if not np.array_equal(got[c],
                                                                ref[c])]
    assert not bad, f"plan channels differ: {bad}"


# ---------------------------------------------------------------------------
# copied constants and exact helpers
# ---------------------------------------------------------------------------

def test_constants():
    for name in ("COARSE_R", "REFINE_R", "MAXREF_PLAN", "MARGIN",
                 "MERGE_FLAG_BITS", "SKIP_EXTRA_BITS", "UNI_BASE_BITS",
                 "BI_BASE_BITS", "SPLIT_BITS", "INTRA_EXTRA_BITS",
                 "RECT_PART_BITS", "RECT_SIZES", "SIZES", "KIND_MERGE",
                 "KIND_UNI0", "KIND_UNI1", "KIND_BI", "_QOFFS"):
        assert getattr(PI, name) == getattr(RI, name), name


def test_mvd_bits_full_range():
    """Against the reference's bins jitted inside a fused consumer, where
    XLA's log2 decides the floor (|d| up to 2^15)."""
    d = np.arange(-(1 << 15) - 2, (1 << 15) + 3, dtype=np.int32)
    rev = d[::-1].copy()
    fused = jax.jit(lambda x, y: RI._mvd_bits_j(x, y) * 3.0 + 1.0)
    ref = (np.asarray(fused(jnp.asarray(d), jnp.asarray(rev))) - 1.0) / 3.0
    got = PI._mvd_bits(torch.as_tensor(d), torch.as_tensor(rev)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.float32))
    eager = np.asarray(RI._mvd_comp_bits_j(jnp.asarray(d)))
    np.testing.assert_array_equal(
        PI._mvd_comp_bits(torch.as_tensor(d)).numpy(), eager)


@pytest.mark.parametrize("qp", [22, 32, 37, 45])
@pytest.mark.parametrize("bd", [8, 10])
def test_quant_dequant(qp, bd):
    rng = np.random.default_rng(qp * bd)
    for log2 in (3, 4, 5):
        s = 1 << log2
        c = rng.integers(-20000, 20000, (50, s, s)).astype(np.int32)
        ref = np.asarray(RI._quant_t(jnp.asarray(c), jnp.int32(qp), bd, log2))
        got = PI._quant_t(torch.as_tensor(c), qp, bd, log2).numpy()
        np.testing.assert_array_equal(got, ref)
        dq = np.asarray(RI._dequant_t(jnp.asarray(ref), jnp.int32(qp), bd,
                                      log2))
        np.testing.assert_array_equal(
            PI._dequant_t(torch.as_tensor(ref), qp, bd, log2).numpy(), dq)


@pytest.mark.parametrize("bd", [8, 10])
def test_subpel_planes(bd):
    cur, refs, _ = _inputs(40, 48, bd, seed=3)
    ref = np.asarray(jax.jit(RI._subpel_planes, static_argnums=(1, 2, 3))(
        jnp.asarray(refs[:2]), bd, 40, 48))
    got = PI.subpel_planes(torch.as_tensor(refs[:2]), bd, 40, 48)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)


_INT_ME = jax.jit(RI._int_me_grids, static_argnames=("h", "w", "parts"))


@pytest.mark.parametrize("nref", [1, 2, 3, 4])
def test_int_me_grids(nref):
    """The reference runs on the stack padded to MAXREF_PLAN (one compiled
    shape), the port on the live references only."""
    h, w = 72, 136
    cur, refs, mvn16 = _inputs(h, w, 8, seed=nref)
    rp, dists, _ = _padded(refs, nref)
    mvp8 = PI._mvp_full(torch.as_tensor(mvn16), torch.as_tensor(dists))
    lam, lams = _lam(32)
    sq, rect = _INT_ME(jnp.asarray(cur), jnp.asarray(rp),
                       jnp.asarray(mvp8.numpy()), jnp.float32(lams), h=h, w=w,
                       parts=True)
    got = PI.int_me(torch.as_tensor(cur), torch.as_tensor(refs[:nref]),
                    mvp8[:nref], lams, h, w, True)
    want = {(s, 0): v for s, v in sq.items() if v.size} | rect
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v)[:nref],
                                      err_msg=str(k))


@pytest.mark.parametrize("bd", [8, 10])
def test_coarse_pyramid(bd):
    """The float32 pyramid sums to 16/32/64 in the reference's order."""
    h, w = 128, 128
    cur, refs, _ = _inputs(h, w, bd, seed=7)
    g8 = PI._coarse_grid8(torch.as_tensor(cur), torch.as_tensor(refs[:2]),
                          h, w)
    ref, got = jnp.asarray(g8.numpy()), g8
    for s in (16, 32, 64):
        ny, nx = h // s, w // s
        R, O = ref.shape[:2]
        ref = ref[:, :, :ny * 2, :nx * 2].reshape(R, O, ny, 2, nx, 2) \
            .sum((3, 5))
        got = PI._quad4(got, ny, nx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("bh,bw", [(8, 8), (16, 16), (8, 16), (32, 16),
                                   (64, 64)])
def test_frac_refine(bh, bw):
    h, w = 72, 136
    cur, refs, mvn16 = _inputs(h, w, 8, seed=bh + bw)
    ny, nx = h // bh, w // bw
    rng = np.random.default_rng(bh * bw)
    mv = rng.integers(-20, 20, (2, ny, nx, 2)).astype(np.int32)
    p4 = rng.integers(-60, 60, (2, ny, nx, 2)).astype(np.int32)
    lam, lams = _lam(27)
    sub = PI.subpel_planes(torch.as_tensor(refs[:2]), 8, h, w)
    got_mv, got_satd = PI.frac_refine(sub, torch.as_tensor(cur),
                                      torch.as_tensor(mv), torch.as_tensor(p4),
                                      lams, bh, bw)
    n = ny * nx
    ys = jnp.repeat(jnp.arange(ny) * bh, nx)
    xs = jnp.tile(jnp.arange(nx) * bw, ny)
    blocks = jnp.asarray(cur[:ny * bh, :nx * bw].reshape(ny, bh, nx, bw)
                         .swapaxes(1, 2).reshape(n, bh, bw))
    fn = jax.jit(RI._frac_refine, static_argnames=("bh", "bw"))
    for r in range(2):
        mv4, satd = fn(jnp.asarray(sub[r].numpy()), blocks, ys, xs,
                       jnp.asarray(mv[r].reshape(n, 2)),
                       jnp.asarray(p4[r].reshape(n, 2)), jnp.float32(lams),
                       bh=bh, bw=bw)
        np.testing.assert_array_equal(got_mv[r].numpy(), np.asarray(mv4))
        np.testing.assert_array_equal(got_satd[r].numpy(), np.asarray(satd))


@pytest.mark.parametrize("s", [8, 16, 32])
def test_intra_size_rd_t(s):
    """The intra alternative: K2 at the inter rounding offset, k = 3."""
    h, w = 72, 136
    cur, _, _ = _inputs(h, w, 8, seed=s)
    lam, _ = _lam(37)
    b, bl = RR._jnp_ref_buffers(jnp.asarray(cur), s, 8, True, h, w)
    fn = jax.jit(RI._intra_size_rd_t, static_argnames=("s", "bd", "k"))
    im, icost, ic3 = fn(b, bl, jnp.float32(lam), s=s, bd=8, k=3,
                        qp=jnp.int32(37))
    pb, pbl = PR.ref_buffers(torch.as_tensor(cur), s, 8, True, h, w)
    m, c, c3, _ = PR.size_rd(pb, pbl, lam, s, 8, 3, 37, True, False, False,
                             inter=True)
    np.testing.assert_array_equal(m.numpy(), np.asarray(im))
    np.testing.assert_array_equal(c.numpy(), np.asarray(icost))
    np.testing.assert_array_equal(c3.numpy(), np.asarray(ic3))


# ---------------------------------------------------------------------------
# the packed plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def geom_136x72():
    return _inputs(72, 136, 8)


@pytest.fixture(scope="module")
def geom_128():
    return _inputs(128, 128, 8, seed=9)


@pytest.mark.parametrize("nref", [1, 2, 3, 4])
@pytest.mark.parametrize("qp", [22, 32, 37])
def test_packed_plan_136x72(geom_136x72, nref, qp):
    cur, refs, mvn16 = geom_136x72
    _assert_plan_equal(_port_plan(cur, refs, mvn16, nref, qp, 8),
                       _ref_plan(cur, refs, mvn16, nref, qp, 8))


@pytest.mark.parametrize("nref,qp", [(1, 32), (2, 22), (3, 37), (4, 32)])
def test_packed_plan_128x128(geom_128, nref, qp):
    cur, refs, mvn16 = geom_128
    _assert_plan_equal(_port_plan(cur, refs, mvn16, nref, qp, 8),
                       _ref_plan(cur, refs, mvn16, nref, qp, 8))


def test_padding_leaves_plan_unchanged(geom_136x72):
    """Computing only the live references equals the reference's padded
    stack: the port's plan on the padded stack is the same plan."""
    cur, refs, mvn16 = geom_136x72
    lam, lams = _lam(32)
    rp, dists, map0 = _padded(refs, 2)
    padded = PI._plan_device(
        torch.as_tensor(cur), torch.as_tensor(rp), torch.as_tensor(mvn16),
        torch.as_tensor(dists), lam, lams, 32, torch.as_tensor(map0), 2,
        h=72, w=136, bd=8, nmerge=5)
    np.testing.assert_array_equal(padded.numpy(),
                                  _port_plan(cur, refs, mvn16, 2, 32, 8))


def test_plan_frame_like_reference(geom_136x72):
    """The host interface on a RefCtx from a short low-delay P encode (the
    port's, on the CPU): list 0's unique planes, distances, the real motion
    prior; both packages' InterPlans are equal field by field."""
    from hm16_2_tpu.decode.mvpred import RefCtx
    from hm16_2_tpu.decode.refpics import build_ref_lists
    from hm16_2_tpu.encode import top as RT
    from hm16_2_tpu_torch.encode import top as PT
    frames = make_yuv(136, 72, 6, seed=21)
    enc = PT.Encoder(RT.EncoderConfig(136, 72, qp=32, intra_period=0,
                                      gop="ld"), torch.device("cpu"))
    for poc in range(5):
        enc.push_frame([np.ascontiguousarray(p, dtype=np.int32)
                        for p in frames[poc]], poc)
    slot = RT.LDP_GOP[0]
    sh = enc._ra_slice_header(5, slot)
    sh.poc = 5
    rc = RefCtx(sh, build_ref_lists(sh, enc.dpb))
    assert len(rc.ref_lists[0]) >= 2 and enc._prev_mv8 is not None
    alpha, mult = enc._lambda_args(sh, slot)
    lam = alpha * 2.0 ** ((sh.qp - 12) / 3.0) * mult
    y = np.ascontiguousarray(frames[5][0], dtype=np.int32)
    args = (y, enc.sps, sh, rc, enc._prev_mv8, float(lam),
            float(np.sqrt(lam)))
    ref = RI.plan_frame(*args, jax.devices("cpu")[0])
    got = PI.plan_frame(*args, torch.device("cpu"))
    for k in RI.InterPlan.__slots__:
        a, b = getattr(ref, k), getattr(got, k)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            assert a == b, k
    later = PI.plan_frame(*args, torch.device("cpu"), fetch=False)
    np.testing.assert_array_equal(later().depth, got.depth)

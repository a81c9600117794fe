"""The port's intra plan (hm16_2_tpu_torch/encode/intra_rd.py) against the
JAX reference (hm16_2_tpu/encode/intra_rd.py): every stage and the whole
packed frame plan, exactly equal.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
are held to those plain versions on the card (tests/test_torch_gpu.py, and
chip_smoke.py at 1080p shapes).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm16_2_tpu.encode import intra_rd as RR
from hm16_2_tpu.ops import analysis as RA
from hm16_2_tpu_torch.encode import intra_rd as PR

torch.set_num_threads(1)

LAM = float(np.float32(0.57 * 2.0 ** ((32 - 12) / 3.0)))


def _plane(rng, h, w, bd):
    """Smooth texture plus noise, so RD decisions are not degenerate."""
    yy, xx = np.mgrid[0:h, 0:w]
    p = (120 + 60 * np.sin(xx / rng.uniform(4, 12) + rng.uniform(0, 6))
         * np.cos(yy / rng.uniform(3, 9)) + rng.normal(0, rng.uniform(1, 12),
                                                       (h, w)))
    return np.clip(p * (1 << (bd - 8)), 0, (1 << bd) - 1).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("s", [4, 8, 16, 32])
@pytest.mark.parametrize("strong", [False, True])
def test_ref_buffers(s, strong):
    rng = np.random.default_rng(s)
    bd = 10 if strong else 8
    # flat planes exercise the strong-smoothing branch at s = 32
    plane = _plane(rng, 100, 136, bd) if s != 32 else \
        np.full((100, 136), 300, np.int32) + rng.integers(0, 3, (100, 136),
                                                           dtype=np.int32)
    rb, rbl = RR._jnp_ref_buffers(jnp.asarray(plane), s, bd, strong, 96, 136)
    pb, pbl = PR.ref_buffers(torch.as_tensor(plane), s, bd, strong, 96, 136)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(pbl.numpy(), np.asarray(rbl))


@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_size_rd(s):
    rng = np.random.default_rng(40 + s)
    plane = _plane(rng, 128, 128, 8)
    b, bl = RR._jnp_ref_buffers(jnp.asarray(plane), s, 8, True, 128, 128)
    k = RR.NUM_RD_CANDS[s]
    ref = RR._size_rd(b, bl, jnp.float32(LAM), s, 8, k, 32, True, s == 4,
                      s == 32)
    got = PR.size_rd(_t(b), _t(bl), LAM, s, 8, k, 32, True, s == 4, s == 32)
    for r, g in zip(ref, got):
        if r is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_premodes():
    rng = np.random.default_rng(3)
    plane = _plane(rng, 64, 96, 8)
    b, bl = RR._jnp_ref_buffers(jnp.asarray(plane), 16, 8, True, 64, 96)
    preds = RA.predict_all_modes(b, 16, True, 8)
    satd = RA.batched_satd(preds - bl[:, None])
    ref = np.asarray(jnp.argmin(satd, axis=-1))
    got = PR.premodes(_t(b), _t(bl), 16, 8)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_chroma_rd5(cs):
    rng = np.random.default_rng(cs)
    plane = _plane(rng, 64, 96, 8)
    b, bl = RR._jnp_ref_buffers(jnp.asarray(plane), cs, 8, False, 64, 96)
    dm = rng.integers(0, 35, b.shape[0]).astype(np.int32)
    modes5 = PR.chroma_modes5(torch.as_tensor(dm))
    ref_m5 = jnp.stack([jnp.where(dm == m, 34, m) for m in (0, 26, 10, 1)]
                       + [jnp.asarray(dm)], axis=1)
    np.testing.assert_array_equal(modes5.numpy(), np.asarray(ref_m5))
    fn = jax.jit(RR._chroma_rd5, static_argnames=("s", "bd", "qp"))
    rd, rb = fn(b, bl, ref_m5, jnp.float32(LAM), s=cs, bd=8, qp=31)
    gd, gb = PR.cand_rd(_t(b), _t(bl), modes5, cs, 8, 31)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))


def test_size_rd_fixed_mode():
    rng = np.random.default_rng(5)
    plane = _plane(rng, 128, 128, 10)
    b, bl = RR._jnp_ref_buffers(jnp.asarray(plane), 32, 10, True, 128, 128)
    modes = rng.integers(0, 35, b.shape[0]).astype(np.int32)
    rd, rb = RR._size_rd_fixed_mode(b, bl, jnp.asarray(modes),
                                    jnp.float32(LAM), 32, 10, 44, True,
                                    False)
    gd, gb = PR.cand_rd(_t(b), _t(bl), torch.as_tensor(modes)[:, None], 32,
                        10, 44, True, False)
    np.testing.assert_array_equal(gd[:, 0].numpy(), np.asarray(rd))
    np.testing.assert_array_equal(gb[:, 0].numpy(), np.asarray(rb))


@pytest.mark.parametrize("s", [4, 32])
def test_bits_estimate(s):
    rng = np.random.default_rng(s)
    n = 3000
    dens = rng.uniform(0, 0.5, (n, 1, 1))
    mag = rng.geometric(0.3, (n, s, s)) * (rng.uniform(size=(n, s, s)) < dens)
    lvl = (mag * rng.choice([-1, 1], (n, s, s))).astype(np.int32)
    ref = np.asarray(jax.jit(RR._bits_estimate)(jnp.asarray(lvl)))
    np.testing.assert_array_equal(
        PR._bits_estimate(torch.as_tensor(lvl)).numpy(), ref)


@partial(jax.jit, static_argnames=("cs", "qp"))
def _ref_chroma_tot(bcb, blcb, bcr, blcr, modes5, lamf, cw, cs, qp):
    """The chroma cost lines of the reference's _plan_device (:435-441)."""
    mode_bits = jnp.asarray([4.0, 4.0, 4.0, 4.0, 1.0], jnp.float32)
    tot = lamf * mode_bits[None, :]
    for bufs, blocks in ((bcb, blcb), (bcr, blcr)):
        d, b = RR._chroma_rd5(bufs, blocks, modes5, lamf, cs, 8, qp)
        tot = tot + d * cw + lamf * b
    return tot


def test_chroma_fold():
    """The fold's float32 steps match XLA's contraction of the chroma
    cost: the argmin and the added cost are equal."""
    rng = np.random.default_rng(9)
    cs = 8
    cb, cr = _plane(rng, 64, 128, 8), _plane(rng, 64, 128, 8)
    bcb, blcb = RR._jnp_ref_buffers(jnp.asarray(cb), cs, 8, False, 64, 128)
    bcr, blcr = RR._jnp_ref_buffers(jnp.asarray(cr), cs, 8, False, 64, 128)
    n = bcb.shape[0]
    dm = torch.as_tensor(rng.integers(0, 35, n).astype(np.int32))
    m5 = PR.chroma_modes5(dm)
    cw = float(np.float32(2 ** (1 / 3)))
    tot = np.asarray(_ref_chroma_tot(bcb, blcb, bcr, blcr, jnp.asarray(
        m5.numpy()), jnp.float32(LAM), jnp.float32(cw), cs=cs, qp=31))
    db = [*PR.cand_rd(_t(bcb), _t(blcb), m5, cs, 8, 31),
          *PR.cand_rd(_t(bcr), _t(blcr), m5, cs, 8, 31)]
    cost = torch.as_tensor(rng.uniform(0, 1e4, (8, 16)).astype(np.float32))
    new, add, cmode = PR.chroma_fold(*db, cost, LAM, cw)
    best = tot.argmin(1)
    np.testing.assert_array_equal(cmode.numpy().ravel(), best)
    np.testing.assert_array_equal(add.numpy().ravel(),
                                  tot[np.arange(n), best])
    np.testing.assert_array_equal(new.numpy(),
                                  cost.numpy() + add.numpy())


# 136x72: border CTUs (72 = 64 + 8, 136 = 2 * 64 + 8); 128x128: whole CTUs
PLAN_CASES = [(72, 136, 8, True, True), (72, 136, 10, False, False),
              (128, 128, 10, True, False), (128, 128, 8, False, True)]


@pytest.mark.parametrize("h,w,bd,chroma,strong", PLAN_CASES)
def test_plan_device_packed_plan(h, w, bd, chroma, strong):
    rng = np.random.default_rng(h * w + bd)
    y = _plane(rng, h, w, bd)
    cb, cr = _plane(rng, h // 2, w // 2, bd), _plane(rng, h // 2, w // 2, bd)
    qp = 27 + 6 * (bd - 8)
    kw = dict(h=h, w=w, bd=bd, cbd=bd, strong=strong, qp=qp, cqp0=qp - 1,
              cqp1=qp - 2, chroma=chroma)
    cw = float(np.float32(2 ** (1 / 3)))
    lam = float(np.float32(0.57 * 2.0 ** ((qp - 6 * (bd - 8) - 12) / 3.0)))
    ref = np.asarray(RR._plan_device(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), jnp.float32(lam),
        jnp.float32(cw), None, use_stage1=False, **kw))
    got = PR._plan_device(torch.as_tensor(y), torch.as_tensor(cb),
                          torch.as_tensor(cr), lam, cw, **kw)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plan_frame_unpacks_like_reference():
    class Sps:
        bit_depth_luma = bit_depth_chroma = 8
        strong_intra_smoothing = 1
        pic_height, pic_width = 72, 136
        chroma_format_idc = 1

    rng = np.random.default_rng(11)
    orig = [_plane(rng, 72, 136, 8), _plane(rng, 36, 68, 8),
            _plane(rng, 36, 68, 8)]
    # the static arguments of PLAN_CASES[0], so the reference's compiled
    # plan is reused
    ref = RR.plan_frame(orig, Sps, 27, LAM, 1.26, (26, 25),
                        jax.devices("cpu")[0])
    got = PR.plan_frame(orig, Sps, 27, LAM, 1.26, (26, 25),
                        torch.device("cpu"))
    for k in RR.IntraPlan.__slots__:
        a, b = getattr(ref, k), getattr(got, k)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        else:
            assert a == b


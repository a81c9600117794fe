"""The port's frame ME of the per-CU inter search
(hm16_2_tpu_torch.encode.inter_me) against the JAX package's: every MV and
cost of every block size equal, with zero tolerance, and XLA's float32 log,
which prices the MVs, re-derived from jnp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hm16_2_tpu.encode import inter_me as RM
from hm16_2_tpu_torch.encode import inter_me as PM

torch.set_num_threads(1)


def _content(h, w, R, bd, seed, contrast=False):
    """A current picture and R references: shifted noise, or (contrast)
    random 4x4 blocks at 0 or the peak, whose 10-bit 64x64 coarse sums
    exceed 2^24 so that their float32 order matters."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    if contrast:
        tile = lambda: np.kron(rng.integers(0, 2, (h // 4 + 1, w // 4 + 1)),
                               np.ones((4, 4), np.int64))[:h, :w] * maxv
        return tile(), np.stack([tile() for _ in range(R)])
    base = rng.integers(0, maxv + 1, (h + 16, w + 16))
    cur = base[8:8 + h, 8:8 + w]
    refs = np.stack([np.roll(base, (r + 1, -2 * r), (0, 1))[8:8 + h, 8:8 + w]
                     + rng.integers(-3, 4, (h, w)) for r in range(R)])
    return cur, np.clip(refs, 0, maxv)


def _check(h, w, R, bd, prior, seed, qp=32, contrast=False):
    cur, refs = _content(h, w, R, bd, seed, contrast)
    rng = np.random.default_rng(seed + 100)
    mvp8 = rng.integers(-prior, prior + 1, (R, h // 8, w // 8, 2))
    lam = np.float32(np.sqrt(0.85 * 2.0 ** ((qp - 12) / 3.0)))
    ref = RM.me_frame(jnp.asarray(cur, jnp.int32), jnp.asarray(refs, jnp.int32),
                      jnp.asarray(mvp8, jnp.int32), jnp.float32(lam), h=h, w=w)
    got = PM.me_frame(torch.as_tensor(cur, dtype=torch.int32),
                      torch.as_tensor(refs, dtype=torch.int32),
                      torch.as_tensor(mvp8, dtype=torch.int32), float(lam),
                      h, w)
    assert sorted(got) == sorted(ref)
    for s, (mv, cost) in ref.items():
        np.testing.assert_array_equal(got[s][0].numpy(), np.asarray(mv))
        np.testing.assert_array_equal(got[s][1].numpy(), np.asarray(cost))
        assert got[s][0].dtype == torch.int32
        assert got[s][1].dtype == torch.float32


@pytest.mark.parametrize("h,w,R,bd,prior,seed", [
    (72, 136, 1, 8, 0, 1), (72, 136, 2, 8, 12, 2), (72, 136, 3, 8, 40, 3),
    (72, 136, 4, 8, 70, 4), (128, 128, 2, 8, 0, 5), (128, 128, 4, 8, 9, 6),
    (72, 136, 2, 10, 20, 7), (128, 128, 3, 10, 0, 8), (128, 128, 1, 10, 5, 9)])
def test_me_frame_equals_jax(h, w, R, bd, prior, seed):
    """136x72 and 128x128, 1-4 references, bit depths 8 and 10, a zero
    prior and priors reaching beyond the +-64 search range."""
    _check(h, w, R, bd, prior, seed)


@pytest.mark.parametrize("h,w,bd,qp", [(128, 128, 10, 37), (72, 136, 8, 22)])
def test_me_frame_high_contrast_equals_jax(h, w, bd, qp):
    """Coarse sums above 2^24 (10-bit): the pyramid's float32 order."""
    _check(h, w, 2, bd, 6, 11, qp=qp, contrast=True)


def test_xla_log_rederived_from_jax():
    """The port's float32 ln equals XLA's inside a jit for every |d| + 1
    of a multiple of 4 below 2^24 (the deltas the ME prices), and the bits
    of a delta equal the reference's `_mv_bits` there."""
    d = np.arange(1 << 22, dtype=np.int32) * 4
    ln = jax.jit(lambda v: jnp.log(jnp.abs(v).astype(jnp.float32) + 1.0))
    got = PM._xla_log(torch.from_numpy(np.abs(d).astype(np.float32)) + 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ln(d)))
    sd = d * np.where(np.arange(d.size) % 2, -1, 1).astype(np.int32)
    ref = np.asarray(jax.jit(RM._mv_bits)(jnp.asarray(sd)))
    np.testing.assert_array_equal(PM._mv_bits(torch.from_numpy(sd)).numpy(),
                                  ref)


def test_xla_log_is_not_the_rounded_log():
    """The model is needed: XLA's ln differs from the correctly rounded
    float32 ln on part of that range."""
    x = np.arange(1 << 16, dtype=np.float64) * 4 + 1
    exact = np.log(x).astype(np.float32)
    got = PM._xla_log(torch.from_numpy(x.astype(np.float32))).numpy()
    assert (got != exact).sum() > 100


class _Ref:
    def __init__(self, plane, poc):
        self.rec, self.poc = [plane], poc


def test_submit_me_same_grids():
    """submit_me searches every reference of both lists (deduplicated by
    identity, not cut at num_ref_idx), broadcasts one prior to all, and
    keys the grids (lx, r_idx, size) as the reference does."""
    h, w = 72, 136
    cur, refs = _content(h, w, 3, 8, 21)
    pics = [_Ref(refs[i].astype(np.int32), i) for i in range(3)]
    lists = [[pics[0], pics[1], pics[0]], [pics[2], pics[1]]]
    prior = np.random.default_rng(4).integers(-6, 7, (h // 8, w // 8, 2)) \
        .astype(np.int32)
    lam = float(np.sqrt(0.85 * 2.0 ** (20 / 3.0)))
    ref = RM.submit_me(cur, lists, prior, lam, h, w, jax.devices("cpu")[0])()
    got = PM.submit_me(cur, lists, prior, lam, h, w, torch.device("cpu"))()
    assert sorted(got.grids) == sorted(ref.grids)
    assert len(got.grids) == 5 * 4
    for k, (mv, cost) in ref.grids.items():
        np.testing.assert_array_equal(got.grids[k][0], mv)
        np.testing.assert_array_equal(got.grids[k][1], cost)
    for x0, y0, s in ((0, 0, 8), (64, 0, 64), (16, 32, 16), (8, 8, 16),
                      (128, 64, 8)):
        assert got.lookup(1, 1, s, x0, y0) == ref.lookup(1, 1, s, x0, y0)
    assert PM.submit_me(cur, [[], []], None, lam, h, w,
                        torch.device("cpu"))().grids == {}

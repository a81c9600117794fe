"""The port's plain analysis versions and copied tables against the JAX
reference (hm16_2_tpu/ops/analysis.py), exactly equal.

Inputs are made with numpy from fixed seeds and handed to both packages;
JAX runs on the CPU.  Tolerance is zero everywhere: the plan ranks integer
costs, so any difference would change the stream.
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm16_2_tpu.encode import intra_rd as RR
from hm16_2_tpu.ops import analysis as RA
from hm16_2_tpu_torch.encode import intra_rd as PR
from hm16_2_tpu_torch.ops import analysis as PA

torch.set_num_threads(1)

SIZES = (4, 8, 16, 32)


def _bufs(rng, n, s, bd):
    return rng.integers(0, 1 << bd, (n, 2, 4 * s + 1)).astype(np.int32)


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("is_luma", [True, False])
def test_angular_tables_equal(s, is_luma):
    ref, got = RA.angular_tables(s, is_luma), PA.angular_tables(s, is_luma)
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
        assert got[k].dtype == ref[k].dtype


@pytest.mark.parametrize("n", [4, 8])
def test_hadamard_equal(n):
    np.testing.assert_array_equal(PA._hadamard(n), RA._hadamard(n))


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("is_luma", [True, False])
def test_predict_all_modes(s, bd, is_luma):
    rng = np.random.default_rng(100 + s + bd)
    bufs = _bufs(rng, 24, s, bd)
    ref = np.asarray(RA.predict_all_modes(jnp.asarray(bufs), s, is_luma, bd))
    got = PA.predict_all_modes(torch.as_tensor(bufs), s, is_luma, bd)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", [(6, 35, 4, 4), (6, 35, 8, 8),
                                   (3, 35, 16, 16), (2, 35, 32, 32),
                                   (5, 8, 16), (5, 12, 4)])
def test_batched_satd(shape):
    rng = np.random.default_rng(7)
    d = rng.integers(-1023, 1024, shape).astype(np.int32)
    ref = np.asarray(RA.batched_satd(jnp.asarray(d)))
    np.testing.assert_array_equal(PA.batched_satd(torch.as_tensor(d)).numpy(),
                                  ref)


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("use_dst", [False, True])
def test_fwd_transform_and_quant(s, bd, use_dst):
    rng = np.random.default_rng(s * bd)
    m = (1 << bd) - 1
    resi = rng.integers(-m, m + 1, (10, 3, s, s)).astype(np.int32)
    ref = RA.batched_fwd_transform(jnp.asarray(resi), bd, use_dst)
    got = PA.batched_fwd_transform(torch.as_tensor(resi), bd, use_dst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    log2 = s.bit_length() - 1
    for qp in (22, 37 + 6 * (bd - 8)):
        lref = RA.batched_quant(ref, qp, bd, log2, True)
        lgot = PA.batched_quant(got, qp, bd, log2, True)
        np.testing.assert_array_equal(lgot.numpy(), np.asarray(lref))


@pytest.mark.parametrize("s", SIZES)
def test_numpy_helpers(s):
    rng = np.random.default_rng(s)
    bu = rng.integers(0, 256, 4 * s + 1).astype(np.int64)
    bf = rng.integers(0, 256, 4 * s + 1).astype(np.int64)
    np.testing.assert_array_equal(PA.predict_all_modes_np(bu, bf, s),
                                  RA.predict_all_modes_np(bu, bf, s))
    d = rng.integers(-255, 256, (35, s, s)).astype(np.int64)
    np.testing.assert_array_equal(PA.satd_all_np(d), RA.satd_all_np(d))


def test_ln_table_rederived_from_jax():
    """LN_LAST is XLA:CPU's float32 ln(i + 1.5); ln * LOG2E rounds to
    jnp.log2, which XLA evaluates as that product."""
    x = jnp.arange(32, dtype=jnp.float32) + 1.5
    ln = np.asarray(jax.jit(jnp.log)(x))
    np.testing.assert_array_equal(PR.LN_LAST, ln)
    log2 = np.asarray(jax.jit(jnp.log2)(x))
    np.testing.assert_array_equal((PR.LN_LAST * PR.LOG2E)
                                  .astype(np.float32), log2)


def test_bit_length_matches_ceil_log2():
    esc = np.arange(32768, dtype=np.int32)
    ref = np.asarray(jax.jit(
        lambda e: jnp.ceil(jnp.log2(e + 1.0)))(jnp.asarray(esc)))
    got = PR._bit_length(torch.as_tensor(esc)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int32))


def test_copied_constants_equal():
    assert PR.NUM_RD_CANDS == RR.NUM_RD_CANDS
    assert PR.BITS_SCALE == RR.BITS_SCALE
    assert PR.NXN_OVERHEAD_BITS == RR.NXN_OVERHEAD_BITS
    assert PR.SPLIT_OVERHEAD_BITS == RR.SPLIT_OVERHEAD_BITS
    assert PR.TRANSFORM_MATRIX_SHIFT == RR.TRANSFORM_MATRIX_SHIFT
    assert PR.IntraPlan.__slots__ == RR.IntraPlan.__slots__
    ref, got = RR.IntraPlan(3, 5), PR.IntraPlan(3, 5)
    for k in RR.IntraPlan.__slots__:
        a, b = getattr(ref, k), getattr(got, k)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("seed", [0, 1])
def test_fma32_single_rounding(seed):
    """_fma32 gives the correctly rounded float32 of the exact a*b + c,
    including sums that fall exactly halfway between two float32 values
    in float64."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-300, 300, 400).astype(np.float32)
    b = rng.uniform(-300, 300, 400).astype(np.float32)
    c = (rng.uniform(-1e6, 1e6, 400) * 10.0 ** rng.integers(-8, 3, 400)) \
        .astype(np.float32)
    # crafted: c = -a*b plus a tiny part, and halfway cases
    a[:20] = np.float32(1 + 2 ** -12)
    b[:20] = np.float32(1 + 2 ** -12)
    c[:20] = np.float32(2 ** -40) * np.arange(1, 21)
    got = PR._fma32(torch.as_tensor(a), torch.as_tensor(b),
                    torch.as_tensor(c)).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = fractions.Fraction(float(x)) * fractions.Fraction(float(y)) \
            + fractions.Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        errs = [abs(fractions.Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        ties = [v for v, e in zip(cands, errs) if e == best]
        want = ties[0] if len(ties) == 1 else \
            [v for v in ties if (v.view(np.int32) & 1) == 0][0]
        assert r == want, (x, y, z, r, want)

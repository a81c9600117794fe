"""The inputs on which the K2 / K3 kernels' invariants rest
(`chip_smoke.intra_edge_inputs`): flat blocks and references, where the 35
SATDs and the RD costs tie; 10- and 12-bit blocks at the maximum over zero
references (and the reverse) at QP 0, where the DC level reaches the 32767
cap and, at 12 bits, the 32x32 SSE passes 2^31 and wraps; 8-bit ones at QP
51, where the dequantised DC is clamped; 12-bit noise; each with 37 blocks,
a batch that no CTA's group divides, and at s = 4 with the DST (luma) and
the DCT (chroma).  The port's plain versions of K2 (RD, at the intra and
the inter rounding offset; SATD-only), K3 (chroma K = 5, a luma mode per
block) and the analysis mode against the JAX package's, every output
equal.  The kernels are held to these plain versions on the same inputs by
`chip_smoke.check_intra_edges` on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import INTRA_EDGE_CASES, INTRA_EDGE_N, intra_edge_inputs, \
    intra_edge_lam
from hm16_2_tpu.encode import inter_plan as RI
from hm16_2_tpu.encode import intra_rd as RR
from hm16_2_tpu.ops import analysis as RA
from hm16_2_tpu.parallel import mesh as RM
from hm16_2_tpu_torch.encode import intra_rd as PR
from hm16_2_tpu_torch.ops import analysis as PA
from hm16_2_tpu_torch.parallel import mesh as PM

torch.set_num_threads(1)

SIZES = [4, 8, 16, 32]
_INTRA_RD_T = jax.jit(RI._intra_size_rd_t, static_argnames=("s", "bd", "k"))
# jitted, as the plan runs it: XLA:CPU's fused multiply-adds in the bits
_CHROMA_RD5 = jax.jit(RR._chroma_rd5, static_argnames=("s", "bd", "qp"))


def _args(case, s):
    e = intra_edge_inputs(case, s)
    return e, torch.from_numpy(e["bufs"]), torch.from_numpy(e["blocks"])


def _equal(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("case", INTRA_EDGE_CASES)
def test_size_rd_edges(case, s):
    """K2's RD mode: best mode, float32 cost, RD top 3, the 35 SATDs."""
    e, bufs, blocks = _args(case, s)
    bd, qp, lam, k = e["bd"], e["qp"], intra_edge_lam(e["qp"]), \
        PR.NUM_RD_CANDS[s]
    want = RR._size_rd(jnp.asarray(e["bufs"]), jnp.asarray(e["blocks"]),
                       jnp.float32(lam), s, bd, k, qp, True, s == 4, True)
    got = PR.size_rd(bufs, blocks, lam, s, bd, k, qp, True, s == 4, True)
    _equal(got, want)


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("case", INTRA_EDGE_CASES)
def test_inter_offset_edges(case, s):
    """K2 at the inter rounding offset (the P/B plan's intra alternative)."""
    e, bufs, blocks = _args(case, s)
    bd, qp, lam = e["bd"], e["qp"], intra_edge_lam(e["qp"])
    want = _INTRA_RD_T(jnp.asarray(e["bufs"]), jnp.asarray(e["blocks"]),
                       jnp.float32(lam), s=s, bd=bd, k=3, qp=jnp.int32(qp))
    got = PR.size_rd(bufs, blocks, lam, s, bd, 3, qp, True, s == 4, False,
                     inter=True)
    _equal(got[:3], want)


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("case", INTRA_EDGE_CASES)
def test_premodes_edges(case, s):
    """K2's SATD-only mode: the SATD argmin, as CtuSearch._premodes."""
    e, bufs, blocks = _args(case, s)
    preds = RA.predict_all_modes(jnp.asarray(e["bufs"]), s, True, e["bd"])
    want = jnp.argmin(RA.batched_satd(
        preds - jnp.asarray(e["blocks"])[:, None]), axis=-1)
    _equal((PR.premodes(bufs, blocks, s, e["bd"]),), (want,))


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("case", INTRA_EDGE_CASES)
def test_cand_rd_edges(case, s):
    """K3: a luma mode per block (`_size_rd_fixed_mode`, DST at s = 4) and,
    at chroma sizes, the five chroma modes (`_chroma_rd5`)."""
    e, bufs, blocks = _args(case, s)
    bd, qp, lam = e["bd"], e["qp"], intra_edge_lam(e["qp"])
    jb, jbl = jnp.asarray(e["bufs"]), jnp.asarray(e["blocks"])
    want = RR._size_rd_fixed_mode(jb, jbl, jnp.asarray(e["modes1"][:, 0]),
                                  jnp.float32(lam), s, bd, qp, True, s == 4)
    got = PR.cand_rd(bufs, blocks, torch.from_numpy(e["modes1"]), s, bd, qp,
                     True, s == 4)
    _equal((g[:, 0] for g in got), want)
    if s <= 16:
        m5 = PR.chroma_modes5(torch.from_numpy(e["dm"]))
        want = _CHROMA_RD5(jb, jbl, jnp.asarray(m5.numpy()),
                           jnp.float32(lam), s=s, bd=bd, qp=qp)
        _equal(PR.cand_rd(bufs, blocks, m5, s, bd, qp, False, False), want)


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("case", INTRA_EDGE_CASES)
def test_analysis_edges(case, s):
    """The analysis mode: best mode, its SATD, the levels, the int32 total."""
    e, bufs, blocks = _args(case, s)
    want = RM.analysis_step(jnp.asarray(e["blocks"]), jnp.asarray(e["bufs"]),
                            e["qp"], s, e["bd"])
    got = PM.analysis_step(blocks, bufs, e["qp"], s, e["bd"])
    _equal(got, want)


def _chain64(case, s, mode=0):
    """int64 levels, dequant before its clamp, and reconstruction SSE of one
    mode's prediction of every block of a case (the plain chain's steps)."""
    e, bufs, blocks = _args(case, s)
    bd, qp = e["bd"], e["qp"]
    log2 = s.bit_length() - 1
    pred = PA.predict_all_modes(bufs, s, True, bd)[:, mode]
    fwd = PA.batched_fwd_transform(blocks - pred, bd, s == 4)
    lvl = PA.batched_quant(fwd, qp, bd, log2, True)
    shift = 6 - (15 - bd - log2 + qp // 6)
    q = lvl.long() * int(PR.INV_QUANT_SCALES[qp % 6])
    deq = (q + (1 << (shift - 1))) >> shift if shift > 0 else q << -shift
    rres = PR.batched_inv_transform(PR.batched_dequant(lvl, qp, bd, log2),
                                    bd, s == 4)
    d = (blocks - torch.clamp(pred + rres, 0, (1 << bd) - 1)).long()
    return lvl, deq, (d * d).sum((-1, -2))


def test_edge_inputs_reach_their_edges():
    """The cases test what they name: the flat blocks' 35 SATDs and k RD
    costs tie (so the top 3 is modes 0, 1, 2); the 10-bit 32x32 and 12-bit
    8x8-32x32 levels reach the 32767 cap at QP 0; the 12-bit 32x32 SSE
    passes 2^31 (and the float32 distortion of its int32 sum differs from
    the true one), while every 10-bit 32x32 SSE fits; the 8-bit dequantised
    DC passes 32767 at QP 51; 37 blocks leave a partial CTA at every group
    size; the noise gives distinct SATDs."""
    assert all(INTRA_EDGE_N % g for g in (32, 16, 8, 4, 2))
    for s in SIZES:
        e, bufs, blocks = _args("flat", s)
        satd = PA.batched_satd(PA.predict_all_modes(bufs, s, True, 8)
                               - blocks[:, None])
        assert (satd == satd[:, :1]).all()
        _, _, top3, _ = PR.size_rd(bufs, blocks, intra_edge_lam(e["qp"]), s,
                                   8, PR.NUM_RD_CANDS[s], e["qp"], True,
                                   s == 4, False)
        assert (top3 == torch.tensor([0, 1, 2], dtype=torch.int32)).all()
    lvl, _, _ = _chain64("max10_qp0", 32)
    assert lvl.abs().max() == 32767
    for s in (8, 16, 32):
        lvl, _, sse = _chain64("max12_qp0", s)
        assert lvl.abs().max() == 32767
    assert sse.min() >= 2 ** 31
    e, bufs, blocks = _args("max12_qp0", 32)
    _, cost, _, _ = PR.size_rd(bufs, blocks, intra_edge_lam(0), 32, 12, 3, 0,
                               True, False, False)
    assert (cost < 0).any()
    _, _, sse = _chain64("max10_qp0", 32)
    assert sse.max() < 2 ** 31
    for s in (8, 16, 32):
        _, deq, _ = _chain64("max8_qp51", s)
        assert deq.abs().max() > 32767
    e, bufs, blocks = _args("noise12", 16)
    satd = PA.batched_satd(PA.predict_all_modes(bufs, 16, True, 12)
                           - blocks[:, None])
    assert (satd.sort(1).values.diff(dim=1) != 0).any(1).all()

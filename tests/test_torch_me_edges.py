"""The inputs on which the K5 / K7 kernels' invariants rest
(`chip_smoke.me_edge_inputs`: flat pictures where the bits decide every
argmin, a flat picture against ramps with ties between the refinement's two
centres, 12-bit noise whose 64x64 int32 SSE wraps, priors of +-70 full-pel
past every picture edge, a row band at row 64 of a 192-row picture): the
port's plain integer ME, frame ME and quarter-pel refinements against the
JAX package's, every output equal.  The kernels are held to these plain
versions on the same inputs by `chip_smoke.check_me_edges` on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K7_EDGE_SHAPES, ME_EDGE_CASES, _edge_lams, \
    k7_edge_inputs, me_edge_inputs
from hm16_2_tpu.encode import inter_me as RM
from hm16_2_tpu.encode import inter_plan as RI
from hm16_2_tpu_torch.encode import inter_me as PM
from hm16_2_tpu_torch.encode import inter_plan as PI

torch.set_num_threads(1)

_INT_ME = jax.jit(RI._int_me_grids, static_argnames=("h", "w", "parts"))
_FRAC = jax.jit(RI._frac_refine, static_argnames=("bh", "bw"))
_REFINE_ANY = jax.jit(RI._frac_refine_any, static_argnames=("s",))
_GATHER = jax.jit(RI._gather_pred, static_argnames=("bh", "bw"))
K7_CASES = [c for c in ME_EDGE_CASES if c != "band"]


def _blocks(cur, bh, bw):
    """(jnp) the raster blocks of cur and their origins ys, xs."""
    h, w = cur.shape
    ny, nx = h // bh, w // bw
    ys = jnp.repeat(jnp.arange(ny) * bh, nx)
    xs = jnp.tile(jnp.arange(nx) * bw, ny)
    blocks = cur[:ny * bh, :nx * bw].reshape(ny, bh, nx, bw).swapaxes(1, 2) \
        .reshape(ny * nx, bh, bw)
    return jnp.asarray(blocks), ys, xs


@pytest.mark.parametrize("case", ME_EDGE_CASES)
def test_int_me_edges(case):
    """The plan's integer ME (MVD bins), every CU shape."""
    d = me_edge_inputs(case)
    h, w = d["cur"].shape
    lams, _ = _edge_lams()
    sq, rect = _INT_ME(jnp.asarray(d["cur"]), jnp.asarray(d["refs"]),
                       jnp.asarray(d["mvp8"]), jnp.float32(lams), h=h, w=w,
                       parts=True, y0=d["row0"])
    got = PI.int_me(torch.from_numpy(d["cur"]), torch.from_numpy(d["refs"]),
                    torch.from_numpy(d["mvp8"]), lams, h, w, True, d["row0"],
                    d["full_h"])
    want = {(s, 0): v for s, v in sq.items() if v.size} | rect
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=str(k))


@pytest.mark.parametrize("case", ME_EDGE_CASES)
def test_me_frame_edges(case):
    """The per-CU search's frame ME (log bit model): MVs and costs."""
    d = me_edge_inputs(case)
    h, w = d["cur"].shape
    _, lam = _edge_lams()
    ref = RM.me_frame(jnp.asarray(d["cur"]), jnp.asarray(d["refs"]),
                      jnp.asarray(d["mvp8"]), jnp.float32(lam), d["row0"],
                      h=h, w=w, full_h=d["full_h"])
    got = PM.me_frame(torch.from_numpy(d["cur"]), torch.from_numpy(d["refs"]),
                      torch.from_numpy(d["mvp8"]), lam, h, w, d["row0"],
                      d["full_h"])
    assert sorted(got) == sorted(ref)
    for s, (mv, cost) in ref.items():
        np.testing.assert_array_equal(got[s][0].numpy(), np.asarray(mv))
        np.testing.assert_array_equal(got[s][1].numpy(), np.asarray(cost))


@pytest.mark.parametrize("bh,bw", K7_EDGE_SHAPES)
@pytest.mark.parametrize("case", K7_CASES)
def test_frac_refine_edges(case, bh, bw):
    """The quarter-pel refinement of every (reference, block)."""
    d = me_edge_inputs(case)
    k = k7_edge_inputs(case, d, bh, bw)
    h, w = d["cur"].shape
    lams, _ = _edge_lams()
    sub = PI.subpel_planes(torch.from_numpy(d["refs"]), d["bd"], h, w)
    got_mv, got_satd = PI.frac_refine(sub, torch.from_numpy(d["cur"]),
                                      torch.from_numpy(k["mv"]),
                                      torch.from_numpy(k["p4"]), lams, bh, bw)
    blocks, ys, xs = _blocks(d["cur"], bh, bw)
    n = blocks.shape[0]
    for r in range(d["refs"].shape[0]):
        mv4, satd = _FRAC(jnp.asarray(sub[r].numpy()), blocks, ys, xs,
                          jnp.asarray(k["mv"][r].reshape(n, 2)),
                          jnp.asarray(k["p4"][r].reshape(n, 2)),
                          jnp.float32(lams), bh=bh, bw=bw)
        np.testing.assert_array_equal(got_mv[r].numpy(), np.asarray(mv4))
        np.testing.assert_array_equal(got_satd[r].numpy(), np.asarray(satd))


@pytest.mark.parametrize("s", sorted({bh for bh, bw in K7_EDGE_SHAPES
                                      if bh == bw}))
@pytest.mark.parametrize("case", K7_CASES)
def test_frac_refine_any_edges(case, s):
    """One pass of the B plan's bi refinement: per-block references, start
    MVs floored toward -inf, the bi target 2 * orig - pred(other)."""
    d = me_edge_inputs(case)
    k = k7_edge_inputs(case, d, s, s)
    h, w = d["cur"].shape
    lams, _ = _edge_lams()
    sub = PI.subpel_planes(torch.from_numpy(d["refs"]), d["bd"], h, w)
    got_mv, got_satd = PI.frac_refine_any(
        sub, torch.from_numpy(d["cur"]), torch.from_numpy(k["mv4"]),
        torch.from_numpy(k["uref"]), torch.from_numpy(k["anchor"]),
        torch.from_numpy(k["o_uref"]), torch.from_numpy(k["o_mv4"]), lams, s)
    suball = jnp.asarray(sub.reshape(-1, *sub.shape[2:]).numpy())
    blocks, ys, xs = _blocks(d["cur"], s, s)
    other = _GATHER(suball, ys, xs, jnp.asarray(k["o_mv4"]),
                    jnp.asarray(k["o_uref"]), bh=s, bw=s)
    mv, satd = _REFINE_ANY(suball, 2 * blocks - other, ys, xs,
                           jnp.asarray(k["mv4"]), jnp.asarray(k["uref"]),
                           jnp.asarray(k["anchor"]), jnp.float32(lams), s=s)
    np.testing.assert_array_equal(got_mv.numpy(), np.asarray(mv))
    np.testing.assert_array_equal(got_satd.numpy(), np.asarray(satd))


def test_edge_inputs_reach_their_edges():
    """The cases test what they name: flat SSDs tie, the 12-bit 64x64 SSE
    leaves the int32 range, the far priors' MVs put 8x8 blocks past all
    four picture edges, and the band's MVs point above and below it."""
    lams, _ = _edge_lams()
    flat = me_edge_inputs("flat")
    g8 = PI._coarse_grid8(torch.from_numpy(flat["cur"]),
                          torch.from_numpy(flat["refs"]), 64, 128)
    assert not g8.any()
    noise = me_edge_inputs("noise12")
    d = noise["cur"][:64, :64].astype(np.int64) - noise["refs"][0, :64, :64]
    assert ((d * d) >> 2).sum() > 2 ** 31
    for case in ("far_priors", "band"):
        e = me_edge_inputs(case)
        h, w = e["cur"].shape
        got = PI.int_me(torch.from_numpy(e["cur"]),
                        torch.from_numpy(e["refs"]),
                        torch.from_numpy(e["mvp8"]), lams, h, w, True,
                        e["row0"], e["full_h"])
        mv = got[(8, 0)].numpy()                   # (R, h/8, w/8, 2)
        y = np.arange(h // 8)[None, :, None] * 8 + mv[..., 0]
        x = np.arange(w // 8)[None, None, :] * 8 + mv[..., 1]
        assert y.min() < 0 and y.max() + 8 > h, case
        if case == "far_priors":
            assert x.min() < 0 and x.max() + 8 > w

"""The port's CUDA kernels on the card, against their plain PyTorch
versions and against the CPU path.  Skipped without a CUDA device: the
kernels have no CPU mode.  This file imports neither JAX nor the JAX
package, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from make_fixtures import make_yuv

torch.set_num_threads(1)

# the kernel modes of the row-banded programs (hm16_2_tpu_torch/parallel/)
BAND = ("ref_buffers_band", "inter_me_band", "me_frame_band",
        "analysis_step")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_equal_plain(cuda):
    """Every kernel's outputs equal its plain version's, at the shapes of a
    264x200 frame (border CTUs on both axes)."""
    import chip_smoke
    frame = make_yuv(264, 200, 1, seed=3)[0]
    stats = chip_smoke.check_kernels(frame, cuda, reps=1)
    assert all(v["err"] == 0.0 for v in stats.values())


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 10])
def test_encode_on_card_equals_cpu(cuda, bits):
    from hm16_2_tpu_torch.decode.top import Decoder
    from hm16_2_tpu_torch import kernels
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    frames = make_yuv(136, 72, 2, seed=8, bits=bits)
    cfg = lambda: EncoderConfig(136, 72, qp=30, intra_period=1,
                                bit_depth=bits)
    kernels.reset_launches()
    on_card = list(Encoder(cfg(), cuda).encode_stream(frames))
    assert all(kernels.LAUNCHES[k] > 0 for k in (
        "ref_buffers", "intra_size_rd", "intra_cand_rd", "plan_dp"))
    # per frame: K4's two launches, K1's one (four luma and six chroma
    # entries)
    assert kernels.LAUNCHES["plan_dp"] == 2 * 2
    assert kernels.LAUNCHES["ref_buffers"] == 1 * 2
    assert kernels.LAUNCHES["inter_pick"] == 0
    on_cpu = list(Encoder(cfg(), torch.device("cpu")).encode_stream(frames))
    assert on_card == on_cpu
    pics = Decoder().decode_stream(b"".join(on_card))
    assert [p.hash_ok for p in pics] == [True, True]
    frame = [np.ascontiguousarray(p, dtype=np.int32) for p in frames[0]]
    assert Encoder(cfg(), cuda).encode_frame(frame, 0) == on_card[0]


@pytest.mark.gpu
def test_inter_kernels_equal_plain(cuda):
    """K5-K8, K2 at the inter rounding offset and K4's P-plan emission
    equal their plain versions at the shapes of a 264x200 P picture with
    four live references (border CTUs on both axes)."""
    import chip_smoke
    frames = make_yuv(264, 200, 5, seed=4)
    stats = chip_smoke.check_inter_kernels(frames, cuda, reps=1)
    assert all(v["err"] == 0.0 for v in stats.values())


@pytest.mark.gpu
@pytest.mark.parametrize("lists", [((0, 1), (2, 3)), ((0,), (0,)),
                                   ((0, 1), (2,))])
def test_b_kernels_equal_plain(cuda, lists):
    """K7's bi-refinement mode, K8's B mode, the list picks and K4's
    emission of B records equal their plain versions at the shapes of a
    264x200 B picture: two past and two future references, the GPB case
    (one reference in both lists), and two lists of unequal length."""
    import chip_smoke
    frames = make_yuv(264, 200, 5, seed=6)
    stats = chip_smoke.check_b_kernels(frames, cuda, reps=1, lists=lists)
    assert all(v["err"] == 0.0 for v in stats.values())
    assert stats["inter_bi_refine"]["ms"] > 0
    assert stats["inter_cu_rd_b"]["ms"] > 0


@pytest.mark.gpu
def test_me_edges_equal_plain(cuda):
    """K5 (both bit models, whole and band) and K7 (uni and bi) equal their
    plain versions bit for bit on the edge inputs of the redesign (flat
    pictures, ramps, 12-bit noise, far priors, a band) and on a flat
    1080p picture with four references."""
    import chip_smoke
    assert chip_smoke.check_me_edges(cuda) > 0


@pytest.mark.gpu
def test_k6_k8_edges_equal_plain(cuda):
    """K6 and K8 (P and B, every CU size) equal their plain versions bit
    for bit on the edge inputs of the redesign (zero, maximum,
    checkerboard and edge-line references at 8-12 bits; flat, one-CTU and
    far-prior plans), on 10- and 12-bit 1080p references and in the P and
    B plans of a flat 1080p picture with four references."""
    import chip_smoke
    assert chip_smoke.check_k6_k8_edges(cuda) > 0


@pytest.mark.gpu
def test_k4_picks_equal_plain(cuda):
    """K4 (the AI plan's two launches, the P/B plan's one) and K7's list
    picks equal their plain versions bit for bit inside the AI, P and B
    plans at 232x152 (every border rule) and 1024x768 (whole CTUs), on
    moving, flat and 10-bit content, flat at 1080p, banded over 2 bands,
    and on cost grids and picks where every comparison ties."""
    import chip_smoke
    assert chip_smoke.check_k4_picks_edges(cuda) > 0


@pytest.mark.gpu
def test_intra_edges_equal_plain(cuda):
    """K2 (RD at both rounding offsets, SATD-only, the analysis mode) and
    K3 (chroma, a luma mode per block) equal their plain versions bit for
    bit on the edge inputs of the redesign (tied SATDs and costs, levels at
    the 32767 cap, a wrapped 12-bit SSE, a clamped dequant, 12-bit noise;
    37 blocks at every size)."""
    import chip_smoke
    assert chip_smoke.check_intra_edges(cuda) > 0


@pytest.mark.gpu
def test_k1_edges_equal_plain(cuda):
    """K1 (a picture's sizes and planes in one launch) and its band mode
    equal their plain versions bit for bit on the edge inputs of the
    redesign (232x152, 136x72, one CTU, a picture too short for s = 32, a
    plane larger than the picture, the strong-smoothing threshold at 8, 10
    and 12 bits, the band groups and the zero halo)."""
    import chip_smoke
    assert chip_smoke.check_k1_edges(cuda) > 0


@pytest.mark.gpu
def test_ldp_on_card_equals_cpu(cuda):
    """A low-delay P stream (IDR + one GOP of four P pictures) on the card
    equals the CPU plain path; every kernel of the path was launched."""
    from hm16_2_tpu_torch.decode.top import Decoder
    from hm16_2_tpu_torch import kernels
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    frames = make_yuv(136, 72, 5, seed=8)
    cfg = lambda: EncoderConfig(136, 72, qp=32, intra_period=0, gop="ld")

    def run(dev):
        enc, aus = Encoder(cfg(), dev), []
        for poc, f in enumerate(frames):
            aus += enc.push_frame([np.ascontiguousarray(p, dtype=np.int32)
                                   for p in f], poc)
        return aus + enc.flush()

    kernels.reset_launches()
    on_card = run(cuda)
    idle = ("inter_bi_refine", "inter_cu_rd_b", "me_frame") + BAND
    assert all(v > 0 for k, v in kernels.LAUNCHES.items()
               if k not in idle), kernels.LAUNCHES
    assert all(kernels.LAUNCHES[k] == 0 for k in ("me_frame",) + BAND)
    # one list-pick launch per planned picture, beside its ten q-pel ones
    assert kernels.LAUNCHES["inter_uni"] == 10 * kernels.LAUNCHES["inter_pick"]
    assert on_card == run(torch.device("cpu"))
    pics = Decoder().decode_stream(b"".join(on_card))
    assert [p.hash_ok for p in pics] == [True] * 5


@pytest.mark.gpu
def test_ra_on_card_equals_cpu(cuda):
    """A random-access stream (IDR + one GOP of eight B pictures, three of
    them planned ahead) on the card equals the CPU plain path; every kernel
    of the B path was launched."""
    from hm16_2_tpu_torch.decode.top import Decoder
    from hm16_2_tpu_torch import kernels
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    frames = make_yuv(136, 72, 9, seed=8)
    cfg = lambda: EncoderConfig(136, 72, qp=32, intra_period=32, gop="ra8")

    def run(dev):
        enc, aus = Encoder(cfg(), dev), []
        for poc, f in enumerate(frames):
            aus += enc.push_frame([np.ascontiguousarray(p, dtype=np.int32)
                                   for p in f], poc)
        return aus + enc.flush()

    kernels.reset_launches()
    on_card = run(cuda)
    assert all(v > 0 for k, v in kernels.LAUNCHES.items()
               if k not in ("inter_cu_rd", "me_frame") + BAND), \
        kernels.LAUNCHES
    assert all(kernels.LAUNCHES[k] == 0 for k in ("me_frame",) + BAND)
    assert kernels.LAUNCHES["inter_pick"] == 8
    assert kernels.LAUNCHES["inter_uni"] == 10 * kernels.LAUNCHES["inter_pick"]
    assert on_card == run(torch.device("cpu"))
    pics = Decoder().decode_stream(b"".join(on_card))
    assert [p.hash_ok for p in pics] == [True] * 9


@pytest.mark.gpu
@pytest.mark.parametrize("nref", [1, 2, 3, 4])
def test_me_frame_equals_plain(cuda, nref):
    """K5 in me_frame's mode (log bit model, costs out) equals its plain
    version at the shapes of a 264x200 picture with 1-4 references."""
    import chip_smoke
    frames = make_yuv(264, 200, nref + 1, seed=12)
    stats = chip_smoke.check_me_frame(frames, cuda, reps=1, nref=nref)
    assert stats["me_frame"]["err"] == 0.0 and stats["me_frame"]["ms"] > 0


@pytest.mark.gpu
def test_per_cu_search_on_card_equals_cpu(cuda, monkeypatch):
    """IPPP without a fused plan (HM16_NO_INTER_PLAN, RRSP on): the frame
    ME runs on the card, and the stream equals the CPU plain path."""
    from hm16_2_tpu_torch import kernels
    from hm16_2_tpu_torch.decode.top import Decoder
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    monkeypatch.setenv("HM16_NO_INTER_PLAN", "1")
    frames = make_yuv(136, 72, 4, seed=9)
    cfg = lambda: EncoderConfig(136, 72, qp=32, intra_period=8, rrsp=True)

    def run(dev):
        enc = Encoder(cfg(), dev)
        return [enc.encode_frame([np.ascontiguousarray(p, dtype=np.int32)
                                  for p in f], i)
                for i, f in enumerate(frames)]

    kernels.reset_launches()
    on_card = run(cuda)
    assert kernels.LAUNCHES["me_frame"] > 0
    assert kernels.LAUNCHES["inter_me"] == 0
    assert on_card == run(torch.device("cpu"))
    pics = Decoder().decode_stream(b"".join(on_card))
    assert [p.hash_ok for p in pics] == [True] * 4


@pytest.mark.gpu
def test_band_kernels_equal_plain(cuda):
    """K1's band mode (n = 2 and 4, s = 4..32), K5's band mode in both bit
    models (n = 2 and 4, four references, priors up to +-70 full-pel) and
    K2's analysis mode (s = 4..32) equal their plain versions at the shapes
    of a 256x256 picture, and the banded programs equal the whole
    picture's on the card."""
    import chip_smoke
    frames = make_yuv(256, 256, 5, seed=14)
    stats = chip_smoke.check_band_kernels(frames, cuda, reps=1)
    assert all(v["err"] == 0.0 for v in stats.values())
    assert all(stats[k]["ms"] > 0 for k in BAND)


@pytest.mark.gpu
def test_banded_ra_on_card_equals_cpu(cuda):
    """A 256x256 random-access stream (IDR + one GOP of eight B pictures)
    with both plans banded over 2 and over 4 bands of the card equals the
    CPU's banded stream; every band kernel of the path was launched."""
    import chip_smoke
    from hm16_2_tpu_torch.decode.top import Decoder
    from hm16_2_tpu_torch import kernels
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    from hm16_2_tpu_torch.parallel.frame_shard import make_row_mesh
    from hm16_2_tpu_torch.tools.stream_digest import banded
    frames = make_yuv(256, 256, 9, seed=15)
    cfg = lambda: EncoderConfig(256, 256, qp=32, intra_period=32, gop="ra8")

    def run(dev, n):
        with banded(make_row_mesh([dev] * n)) as seen:
            enc = Encoder(cfg(), dev)
            out = [au for poc, f in enumerate(frames) for au in
                   enc.push_frame([p.astype("int32") for p in f], poc)]
            out += enc.flush()
        assert seen["inter"] == 8
        return out

    kernels.reset_launches()
    on_card = [run(cuda, n) for n in (2, 4)]
    assert all(kernels.LAUNCHES[k] > 0 for k in (
        "ref_buffers_band", "inter_me_band")), kernels.LAUNCHES
    assert kernels.LAUNCHES["inter_me"] == 0
    # K1's band mode: every size in one group at 256x256, so one launch
    # per band of the one I picture
    assert kernels.LAUNCHES["ref_buffers_band"] == 2 + 4
    on_cpu = run(torch.device("cpu"), 2)
    assert on_card[0] == on_cpu and on_card[1] == on_cpu
    pics = Decoder().decode_stream(b"".join(on_cpu))
    assert [p.hash_ok for p in pics] == [True] * 9


@pytest.mark.gpu
def test_small_stream_on_card_pinned(cuda):
    """A small recipe coded on the card writes the JAX package's stream
    (stream_digest.PINNED)."""
    from hm16_2_tpu_torch.tools import stream_digest as S
    r = S.RECIPES["136x72 RA"]
    frames = S.make_frames(r)
    got = S.digest(frames, S.encode(r, S.port_encoder(cuda), frames))
    assert S.mismatch(r.name, got) is None

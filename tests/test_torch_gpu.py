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
    idle = ("inter_bi_refine", "inter_cu_rd_b", "me_frame")
    assert all(v > 0 for k, v in kernels.LAUNCHES.items()
               if k not in idle), kernels.LAUNCHES
    assert kernels.LAUNCHES["me_frame"] == 0
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
               if k not in ("inter_cu_rd", "me_frame")), kernels.LAUNCHES
    assert kernels.LAUNCHES["me_frame"] == 0
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

"""The port's copies of the reference's host tools
(hm16_2_tpu_torch.tools): the Annex-B byte counter, the bit-depth
converter and the lambda-modifier search of BitrateTargeting, as
tests/test_utils_tools.py tests the reference's; the BD-rate harness's
encode arm on the port's encoder and its PSNR/bits measure, held to the
reference's; and the real-content clip, equal in both packages.
"""

import numpy as np
import pytest
import torch

from hm16_2_tpu.tools import bdrate as RB
from hm16_2_tpu_torch.tools import bdrate as PB
from hm16_2_tpu_torch.tools.annexb_bytecount import count
from hm16_2_tpu_torch.tools.bitrate_targeting import guess_lambda_modifiers
from hm16_2_tpu_torch.tools.convert_bitdepth import convert_plane
from make_fixtures import make_yuv

torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_annexb_count():
    from hm16_2_tpu_torch.bitstream.bitio import write_annexb
    nals = [bytes([32 << 1, 1]) + b"x" * 10,    # VPS
            bytes([19 << 1, 1]) + b"y" * 100]   # IDR
    data = write_annexb(nals)
    per_type, total_nal, sc = count(data)
    assert per_type[32] == [1, 12]
    assert per_type[19] == [1, 102]
    assert sc == len(data) - total_nal


def test_convert_bitdepth_roundtrip():
    rng = np.random.default_rng(0)
    p8 = rng.integers(0, 256, (16, 16)).astype(np.int32)
    p10 = convert_plane(p8, 8, 10)
    assert p10.max() <= 1023 and np.array_equal(p10, p8 << 2)
    back = convert_plane(p10, 10, 8)
    np.testing.assert_array_equal(back, p8)
    # down-shift rounds to nearest
    assert convert_plane(np.array([3]), 10, 8)[0] == 1


def test_lambda_modifier_convergence():
    """Simulated encoder with bitrate ~ C/modifier: the guess loop must
    approach the target bitrate within a few iterations."""
    targets = [1000.0]
    C = 800.0

    def encode(mods):
        return [C / m for m in mods]

    meta = []
    mods = [1.0]
    meta.append((mods, encode(mods)))
    for _ in range(8):
        mods = guess_lambda_modifiers(0.5, targets, meta)
        meta.append((mods, encode(mods)))
    achieved = meta[-1][1][0]
    assert abs(achieved - targets[0]) / targets[0] < 0.05
    # multi-layer: inter dampening keeps later layers stable
    t2 = [1000.0, 500.0]
    meta2 = [([1.0, 1.0], [800.0, 300.0])]
    m2 = guess_lambda_modifiers(0.5, t2, meta2)
    assert len(m2) == 2 and all(m > 0 for m in m2)


@pytest.mark.parametrize("mode,n", [("ai", 2), ("ldp", 3)])
def test_bdrate_encode_ours_same_bytes(mode, n):
    """The BD-rate harness's encode arm with its frame plans on the CPU
    gives the reference's stream, and its (Y-PSNR, bits) measure agrees."""
    frames = make_yuv(136, 72, n, seed=42)
    ref, _ = RB.encode_ours(frames, 136, 72, 32, mode)
    got, _ = PB.encode_ours(frames, 136, 72, 32, mode, device=CPU)
    assert got == ref
    assert PB.seq_psnr_bits(got, frames, 136, 72) == \
        RB.seq_psnr_bits(ref, frames, 136, 72)


def test_realclip_same_clip():
    """The pan/zoom clip over matplotlib's bundled photograph."""
    pytest.importorskip("PIL")
    pytest.importorskip("scipy")
    pytest.importorskip("matplotlib")
    from hm16_2_tpu.tools import realclip as RR
    from hm16_2_tpu_torch.tools import realclip as PR
    ref, got = RR.make_clip(136, 72, 3), PR.make_clip(136, 72, 3)
    assert len(got) == 3
    for g, r in zip(got, ref):
        assert all(np.array_equal(a, b) for a, b in zip(g, r))

"""Rate control through the port's encoder (hm16_2_tpu_torch.encode.top)
against the JAX package's: HM's R-lambda model at picture level and at CTU
level sets each picture's QP and a model lambda that is not a function of
the QP, which the frame plans price with.  The same Annex-B bytes, every
picture decoding with its MD5 hash intact; the encoder CLI's
`--RateControl`; and the reference's own fault under an overspent budget,
which the port reproduces.
"""

import os

import pytest
import torch

from hm16_2_tpu.encode import top as RT
from hm16_2_tpu_torch.encode import top as PT
from make_fixtures import make_yuv, write_yuv
from test_torch_encode import _decode_ok, _push_all

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,kw", [
    (5, dict(intra_period=0, gop="ld", target_bps=200000)),
    (5, dict(intra_period=0, gop="ld", target_bps=200000, rc_ctu=True)),
    (3, dict(intra_period=1, target_bps=2000000))],
    ids=["ldp", "ldp_ctu", "ai"])
def test_rc_stream_same_bytes(n, kw):
    """Low-delay P at 200 kbps, at picture and at CTU level, and all-intra
    at 2 Mbps, through push_frame / flush."""
    frames = make_yuv(136, 72, n, seed=42)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, total_frames=n, **kw)
    ref = _push_all(RT.Encoder(cfg()), frames)
    enc = PT.Encoder(cfg(), CPU)
    got = _push_all(enc, frames)
    assert enc.rc is not None
    assert len(got) == n and got == ref
    _decode_ok(b"".join(got), n)


def test_rc_overspent_budget_raises_in_both():
    """The reference's fault F1, pinned: at 200 kbps the budget is overspent
    before the third all-intra picture, and the intra bit refinement raises
    TypeError (a complex power) in both packages alike."""
    frames = make_yuv(136, 72, 3, seed=9)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=1,
                                   target_bps=200000, total_frames=3)
    with pytest.raises(TypeError) as ref:
        _push_all(RT.Encoder(cfg()), frames)
    with pytest.raises(TypeError) as got:
        _push_all(PT.Encoder(cfg(), CPU), frames)
    assert str(got.value) == str(ref.value)


def test_cli_rate_control_same_bytes(tmp_path):
    """The encoder CLI with `--RateControl=1 --TargetBitrate=200000` on HM's
    Low Delay P Main cfg (CTU-level rate control, the CLI's default): the
    port's and the reference's write the same stream."""
    from hm16_2_tpu.tools import encode as RE
    from hm16_2_tpu_torch.tools import encode as PE
    yuv = tmp_path / "in.yuv"
    write_yuv(str(yuv), make_yuv(136, 72, 5, seed=42))
    args = ["-c", os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg"),
            "-i", str(yuv), "-wdt", "136", "-hgt", "72", "-f", "5",
            "--RateControl=1", "--TargetBitrate=200000"]
    assert RE.main(args + ["-b", str(tmp_path / "ref.bin")]) == 0
    assert PE.main(args + ["-b", str(tmp_path / "got.bin"),
                           "--Device", "cpu"]) == 0
    got = (tmp_path / "got.bin").read_bytes()
    assert got == (tmp_path / "ref.bin").read_bytes()
    _decode_ok(got, 5)

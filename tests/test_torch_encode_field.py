"""Field coding through the port's encoder (hm16_2_tpu_torch.encode.top)
against the JAX package's: every frame is split into its two fields, each
coded as a half-height picture, so the frame plans run at the field's
height.  The same Annex-B bytes, every field decoding with its MD5 hash
intact; the encoder CLI's `--FieldCoding`; and the reference's own fault at
a field height that is not a multiple of 8, and the reference CLI's, which
codes one half-height picture per frame; the port reproduces both.
"""

import os

import pytest
import torch

from hm16_2_tpu.encode import top as RT
from hm16_2_tpu_torch.encode import top as PT
from make_fixtures import make_yuv, write_yuv
from test_torch_encode import _decode_ok

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a GOP table of one B picture that references the picture before it
_B_TABLE = [dict(poc=1, qpoff=1, qpfac=0.5, refs=(-1,), type="B")]


@pytest.mark.parametrize("w,h,n,kw", [
    (128, 128, 2, dict(intra_period=1)),
    (136, 80, 3, dict(intra_period=0, gop="ld")),
    (136, 80, 2, dict(intra_period=1, gop_table=_B_TABLE))],
    ids=["ai", "ldp", "gop_table"])
def test_field_stream_same_bytes(w, h, n, kw):
    """All-intra field coded at 128x128 (64-row fields), low-delay P and a
    one-entry GOP table at 136x80 (40-row fields), through encode_stream:
    two pictures per frame."""
    frames = make_yuv(w, h, n, seed=42)
    cfg = lambda: RT.EncoderConfig(w, h, qp=32, field_coding=True, **kw)
    ref = list(RT.Encoder(cfg()).encode_stream(frames))
    enc = PT.Encoder(cfg(), CPU)
    assert enc.cfg.height == h // 2
    got = list(enc.encode_stream(frames))
    assert len(got) == 2 * n and got == ref
    _decode_ok(b"".join(got), 2 * n)


def test_field_height_not_multiple_of_8_raises_in_both():
    """The reference's fault F2, pinned: field coding of 136x72 gives
    36-row fields, whose bottom 8x8 CUs hold 4x8 originals, and the per-CU
    luma search raises ValueError in both packages alike."""
    frames = make_yuv(136, 72, 1, seed=42)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=1,
                                   field_coding=True)
    with pytest.raises(ValueError) as ref:
        list(RT.Encoder(cfg()).encode_stream(frames))
    with pytest.raises(ValueError) as got:
        list(PT.Encoder(cfg(), CPU).encode_stream(frames))
    assert str(got.value) == str(ref.value)


def test_cli_field_coding_same_bytes(tmp_path):
    """The encoder CLI with `--FieldCoding=1` on HM's Low Delay P Main cfg
    at 136x80: the port's and the reference's write the same stream.  The
    reference's fault F4, pinned: the CLI pushes whole frames, which
    push_frame does not split into fields, so each frame is coded as one
    half-height picture (its top 40 rows) and its other half is lost."""
    from hm16_2_tpu.tools import encode as RE
    from hm16_2_tpu_torch.tools import encode as PE
    yuv = tmp_path / "in.yuv"
    write_yuv(str(yuv), make_yuv(136, 80, 3, seed=42))
    args = ["-c", os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg"),
            "-i", str(yuv), "-wdt", "136", "-hgt", "80", "-f", "3",
            "--FieldCoding=1"]
    assert RE.main(args + ["-b", str(tmp_path / "ref.bin")]) == 0
    assert PE.main(args + ["-b", str(tmp_path / "got.bin"),
                           "--Device", "cpu"]) == 0
    got = (tmp_path / "got.bin").read_bytes()
    assert got == (tmp_path / "ref.bin").read_bytes()
    _decode_ok(got, 3)

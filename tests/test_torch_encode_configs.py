"""All-intra and P-picture configurations the port's encoder admits,
against the JAX package's at 136x72: chroma formats 4:2:2 and 4:4:4, the
coding tools that change the plan's inputs or the host commit (intra
smoothing off, the default scaling list, adaptive QP, tiles, WPP with
slices, transform skip), the range-extension tools (HT-RExt,
cross-component prediction, transquant bypass, PCM), byte-limited slices,
IPPP with a long-term reference, and low-delay P with adaptive QP, in
4:2:2 and with the true-RD merge tiebreak (HM16_KIND_RD, set for both
packages).  The same Annex-B bytes, every picture decoding with its MD5
hash intact.  Random access is in test_torch_encode_ra_configs.py.
"""

import pytest
import torch

from hm16_2_tpu.bitstream.bitio import split_annexb
from hm16_2_tpu.decode.top import Decoder
from hm16_2_tpu.encode import top as RT
from hm16_2_tpu_torch.encode import top as PT
from make_fixtures import make_yuv
from test_torch_encode import _decode_ok, _planes, _push_all

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("chroma,kw", [
    (422, dict(chroma_format=2)),
    (444, dict(chroma_format=3)),
    (420, dict(intra_smoothing_disabled=True)),
    (420, dict(scaling_list=1)),
    (420, dict(aq=True)),
    (420, dict(tile_cols=2)),
    (420, dict(wpp=True, slices=2)),
    (420, dict(transform_skip=True))],
    ids=["422", "444", "no_smoothing", "scaling_list", "aq", "tiles",
         "wpp_slices", "transform_skip"])
def test_ai_config_same_bytes(chroma, kw):
    """Two frames through encode_stream (the pipelined all-intra path)."""
    frames = make_yuv(136, 72, 2, seed=42, chroma=chroma)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=1, **kw)
    ref = list(RT.Encoder(cfg()).encode_stream(frames))
    got = list(PT.Encoder(cfg(), CPU).encode_stream(frames))
    assert len(got) == 2 and got == ref
    _decode_ok(b"".join(got), 2)


@pytest.mark.parametrize("chroma,bits,kw", [
    (444, 10, dict(rext_tools=True, transform_skip=True)),
    (444, 8, dict(rext_tools=True, transquant_bypass=True)),
    (444, 8, dict(cross_component_prediction=True)),
    (420, 8, dict(pcm=True))],
    ids=["rext_444_10_ts", "rext_444_bypass", "ccp", "pcm"])
def test_rext_config_same_bytes(chroma, bits, kw):
    """One frame through encode_frame (QP 27)."""
    got, ref = _rext_frame(chroma, bits, kw)
    assert got == ref
    _decode_ok(got, 1)


def _rext_frame(chroma, bits, kw):
    """The port's and the reference's AU of one 136x72 frame, QP 27."""
    frame = make_yuv(136, 72, 1, seed=5, chroma=chroma, bits=bits)[0]
    cfg = lambda: RT.EncoderConfig(
        136, 72, qp=27, intra_period=1, bit_depth=bits,
        chroma_format={420: 1, 422: 2, 444: 3}[chroma], **kw)
    return (PT.Encoder(cfg(), CPU).encode_frame(_planes(frame), 0),
            RT.Encoder(cfg()).encode_frame(_planes(frame), 0))


def test_rext_422_10bit_hash_fault_in_both():
    """The reference's fault F3, pinned: HT-RExt with transform skip on
    10-bit 4:2:2 writes a picture whose decoded Cr plane differs from the
    encoder's reconstruction, so its MD5 hash fails.  Both packages write
    the same bytes, and both decoders find the same mismatch."""
    from hm16_2_tpu_torch.decode.top import Decoder as PortDecoder
    got, ref = _rext_frame(422, 10, dict(rext_tools=True,
                                         transform_skip=True))
    assert got == ref
    for dec in (Decoder, PortDecoder):
        pics = dec().decode_stream(got)
        assert [p.hash_ok for p in pics] == [False]


def test_slice_bytes_same_bytes():
    """Byte-limited slices (HM's SliceMode 2) at a budget that cuts each
    picture into several slices."""
    frames = make_yuv(136, 72, 2, seed=42)

    def cfg():
        c = RT.EncoderConfig(136, 72, qp=22, intra_period=1)
        c.slice_bytes = 400
        return c

    ref = list(RT.Encoder(cfg()).encode_stream(frames))
    got = list(PT.Encoder(cfg(), CPU).encode_stream(frames))
    assert got == ref
    assert len([n for n in split_annexb(b"".join(got))
                if ((n[0] >> 1) & 0x3F) < 32]) > 2
    _decode_ok(b"".join(got), 2)


def test_ippp_long_term_ref_same_bytes():
    """IPPP through encode_frame with a long-term reference picture."""
    frames = make_yuv(136, 72, 4, seed=7)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=8,
                                   long_term_ref=True)
    ref_enc, enc = RT.Encoder(cfg()), PT.Encoder(cfg(), CPU)
    ref = [ref_enc.encode_frame(_planes(f), i) for i, f in enumerate(frames)]
    got = [enc.encode_frame(_planes(f), i) for i, f in enumerate(frames)]
    assert got == ref
    _decode_ok(b"".join(got), 4)


@pytest.mark.parametrize("chroma,kw,env", [
    (420, dict(aq=True), None),
    (422, dict(chroma_format=2), None),
    (420, dict(), "HM16_KIND_RD")],
    ids=["aq", "422", "kind_rd"])
def test_ldp_config_same_bytes(monkeypatch, chroma, kw, env):
    """HM's low-delay P GOP 4 over five frames through push_frame / flush;
    `env`, where given, is set to 1 for both encoders."""
    if env:
        monkeypatch.setenv(env, "1")
    frames = make_yuv(136, 72, 5, seed=42, chroma=chroma)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=0, gop="ld",
                                   **kw)
    ref = _push_all(RT.Encoder(cfg()), frames)
    got = _push_all(PT.Encoder(cfg(), CPU), frames)
    assert len(got) == 5 and got == ref
    _decode_ok(b"".join(got), 5)

"""The port's per-CU inter search against the JAX package's: P and B
pictures without a fused plan (HM16_NO_INTER_PLAN, HM16_EXACT_RD, a plan
that returns None) take their integer MV candidates from the frame ME
(`inter_me.me_frame`) and search CU by CU on the host, where the fork's
fast partitioning (SBD, RRSP) and AMP prune.  Every stream has the same
bytes from both packages and decodes with every MD5 hash intact.
"""

import numpy as np
import pytest
import torch

from hm16_2_tpu.encode import top as RT
from hm16_2_tpu_torch.decode.top import Decoder
from hm16_2_tpu_torch.encode import inter_me as PM
from hm16_2_tpu_torch.encode import top as PT
from make_fixtures import make_yuv

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _planes(frame):
    return [np.ascontiguousarray(p, dtype=np.int32) for p in frame]


def _decode_ok(stream, n):
    pics = Decoder().decode_stream(stream)
    assert len(pics) == n and all(p.hash_ok is True for p in pics)


def _spy(monkeypatch, obj, name):
    """Count the calls of obj.name."""
    calls = []
    fn = getattr(obj, name)

    def spy(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(obj, name, spy)
    return calls


def _ippp(kw, n=3, seed=7):
    frames = make_yuv(136, 72, n, seed=seed)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=8, **kw)
    ref_enc, enc = RT.Encoder(cfg()), PT.Encoder(cfg(), CPU)
    ref = [ref_enc.encode_frame(_planes(f), i) for i, f in enumerate(frames)]
    got = [enc.encode_frame(_planes(f), i) for i, f in enumerate(frames)]
    assert got == ref
    _decode_ok(b"".join(got), n)
    return enc


def _push_all(enc, frames):
    aus = []
    for poc, f in enumerate(frames):
        aus += enc.push_frame(_planes(f), poc)
    return aus + enc.flush()


@pytest.mark.parametrize("var", ["HM16_NO_INTER_PLAN", "HM16_EXACT_RD"])
def test_ippp_fallback_same_bytes(monkeypatch, var):
    """IPPP through encode_frame with the fused plan switched off (and,
    under HM16_EXACT_RD, the I picture's plan too): every P picture runs
    one frame ME."""
    monkeypatch.setenv(var, "1")
    calls = _spy(monkeypatch, PM, "submit_me")
    enc = _ippp({})
    assert len(calls) == 2
    assert enc.stage_ms.get("plan", 0) > 0


def test_ippp_sbd_same_bytes(monkeypatch):
    """SBD (similarity-based depth selection, DER 16) prunes the per-CU
    search."""
    monkeypatch.setenv("HM16_NO_INTER_PLAN", "1")
    calls = _spy(monkeypatch, PT.CtuSearch, "_sbd_allowed")
    _ippp(dict(sbd=True, der=16), n=4, seed=11)
    assert calls


def test_ippp_rrsp_same_bytes(monkeypatch):
    """RRSP (the depth-history fast partitioning) prunes the per-CU
    search."""
    monkeypatch.setenv("HM16_NO_INTER_PLAN", "1")
    from hm16_2_tpu_torch.encode import rrsp
    calls = _spy(monkeypatch, rrsp.RRSP, "ctu_state")
    _ippp(dict(rrsp=True), n=4, seed=12)
    assert calls


def test_no_me_plan_same_bytes(monkeypatch):
    """HM16_NO_ME_PLAN: no device work at all, the host's own +-8 search."""
    monkeypatch.setenv("HM16_NO_INTER_PLAN", "1")
    monkeypatch.setenv("HM16_NO_ME_PLAN", "1")
    calls = _spy(monkeypatch, PM, "me_frame")
    _ippp({})
    assert not calls


def test_plan_returning_none_same_bytes(monkeypatch):
    """A P picture whose fused plan returns None takes the frame ME, in
    both packages."""
    from hm16_2_tpu.encode import inter_plan as RP
    from hm16_2_tpu_torch.encode import inter_plan as PP
    monkeypatch.setattr(RP, "plan_frame", lambda *a, **k: None)
    monkeypatch.setattr(PP, "plan_frame", lambda *a, **k: None)
    calls = _spy(monkeypatch, PM, "submit_me")
    _ippp({})
    assert len(calls) == 2


def test_ldp_b_tail_fallback_same_bytes(monkeypatch):
    """Low-delay P (GOP 4, four references) over seven frames with its
    two-picture low-delay B tail, all under HM16_NO_INTER_PLAN."""
    monkeypatch.setenv("HM16_NO_INTER_PLAN", "1")
    frames = make_yuv(136, 72, 7, seed=42)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=0, gop="ld")
    ref = _push_all(RT.Encoder(cfg()), frames)
    calls = _spy(monkeypatch, PM, "submit_me")
    got = _push_all(PT.Encoder(cfg(), CPU), frames)
    assert len(calls) == 6
    assert len(got) == 7 and got == ref
    _decode_ok(b"".join(got), 7)


def test_ra_gop8_fallback_same_bytes(monkeypatch):
    """Random access GOP 8 (IDR + eight hierarchical B pictures) under
    HM16_NO_INTER_PLAN: no picture is planned ahead, each B picture runs
    one frame ME over both lists."""
    monkeypatch.setenv("HM16_NO_INTER_PLAN", "1")
    frames = make_yuv(136, 72, 9, seed=42)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=32,
                                   gop="ra8")
    ref = _push_all(RT.Encoder(cfg()), frames)
    calls = _spy(monkeypatch, PM, "submit_me")
    got = _push_all(PT.Encoder(cfg(), CPU), frames)
    assert len(calls) == 8
    assert len(got) == 9 and got == ref
    _decode_ok(b"".join(got), 9)

"""The port's encoder (hm16_2_tpu_torch.encode.top) against the JAX
package's: the same Annex-B bytes for all-intra, the P structures
(low-delay P, IPPP, weighted prediction, a pipelined P-only GOP table) and
the B structures (random access GOP 8 with its pipelined plans, the
low-delay B flush tail), the encoder CLI, pictures that decode with their
MD5 hash intact, the refusal of every configuration that is not ported, and
a port that runs with JAX and the JAX package absent.  The per-CU inter
search (no fused plan) is in test_torch_inter_me_encode.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hm16_2_tpu.decode.top import Decoder
from hm16_2_tpu.encode import top as RT
from hm16_2_tpu_torch.encode import inter_plan as PP
from hm16_2_tpu_torch.encode import top as PT
from make_fixtures import make_yuv

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _planes(frame):
    return [np.ascontiguousarray(p, dtype=np.int32) for p in frame]


def _decode_ok(stream, n):
    pics = Decoder().decode_stream(stream)
    assert len(pics) == n and all(p.hash_ok is True for p in pics)


def test_encode_stream_same_bytes():
    frames = make_yuv(136, 72, 3, seed=42)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=1)
    ref = list(RT.Encoder(cfg()).encode_stream(frames))
    got = list(PT.Encoder(cfg(), CPU).encode_stream(frames))
    assert got == ref
    _decode_ok(b"".join(got), 3)


@pytest.mark.parametrize("bits,chroma,rdo", [(8, 420, True), (10, 420, True),
                                             (8, 400, True),
                                             (8, 420, False)])
def test_encode_frame_same_bytes(bits, chroma, rdo):
    """The per-frame entry; 10-bit; 4:0:0; and without RDO, where the
    per-CU search takes its modes from the SATD-only analysis."""
    frame = make_yuv(136, 72, 1, seed=5, bits=bits, chroma=chroma)[0]
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=1,
                                   bit_depth=bits, rdo=rdo,
                                   chroma_format=0 if chroma == 400 else 1)
    ref = RT.Encoder(cfg()).encode_frame(_planes(frame), 0)
    got = PT.Encoder(cfg(), CPU).encode_frame(_planes(frame), 0)
    assert got == ref
    _decode_ok(got, 1)


@pytest.mark.parametrize("kw", [
    dict(gop_table=[dict(poc=1, qpoff=1, qpfac=0.5, refs=(-1,), type="B")],
         field_coding=True),
    dict(intra_period=-1, gop="ra8", target_bps=200000, total_frames=9),
    dict(gop="ra8", delta_qp_rd=1),
    dict(target_bps=200000, total_frames=4), dict(field_coding=True),
    dict(delta_qp_rd=1)])
def test_non_intra_configs_refused(kw):
    """Rate control, field coding and delta_qp_rd are not ported, with any
    GOP structure."""
    cfg = dict(intra_period=1)
    cfg.update(kw)
    with pytest.raises(NotImplementedError):
        PT.Encoder(RT.EncoderConfig(64, 64, **cfg), CPU)


def test_device_is_required():
    with pytest.raises(TypeError):
        PT.Encoder(RT.EncoderConfig(64, 64, intra_period=1), "cpu")


def test_runs_without_jax(tmp_path):
    """With jax and the whole JAX package unimportable, the port encodes
    all-intra, low-delay P, random access and the per-CU inter search,
    decodes each stream with its own decoder (every hash intact), runs its
    encoder and decoder CLIs, and loads no module of the JAX package."""
    code = """
import os, sys
sys.modules['jax'] = None
sys.modules['hm16_2_tpu'] = None
import numpy as np, torch
torch.set_num_threads(1)
from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
from hm16_2_tpu_torch.decode.top import Decoder
from hm16_2_tpu_torch.io.yuv import write_yuv_frame
from hm16_2_tpu_torch.tools import decode, encode
CPU = torch.device('cpu')
rng = np.random.default_rng(0)
y = rng.integers(0, 256, (64, 64)).astype(np.int32)
c = rng.integers(0, 256, (32, 32)).astype(np.int32)
frames = [[np.roll(y, (i, 2 * i), (0, 1)), c, c.copy()] for i in range(9)]

def ok(aus, n):
    pics = Decoder().decode_stream(b''.join(aus))
    assert [p.hash_ok for p in pics] == [True] * n

def push(cfg, k):
    enc, aus = Encoder(cfg, CPU), []
    for i in range(k):
        aus += enc.push_frame(frames[i], i)
    return aus + enc.flush()

enc = Encoder(EncoderConfig(64, 64, intra_period=1), CPU)
ok([enc.encode_frame(frames[0], 0)], 1)
ok(push(EncoderConfig(64, 64, intra_period=0, gop='ld'), 5), 5)
ok(push(EncoderConfig(64, 64, intra_period=32, gop='ra8'), 9), 9)
os.environ['HM16_NO_INTER_PLAN'] = '1'
enc = Encoder(EncoderConfig(64, 64, intra_period=8, rrsp=True), CPU)
ok([enc.encode_frame(f, i) for i, f in enumerate(frames[:3])], 3)
del os.environ['HM16_NO_INTER_PLAN']
d = sys.argv[1]
with open(os.path.join(d, 'in.yuv'), 'wb') as f:
    for fr in frames[:3]:
        write_yuv_frame(f, fr, [8, 8, 8])
assert encode.main(['-c', 'cfg/encoder_lowdelay_P_main.cfg',
                    '-i', os.path.join(d, 'in.yuv'),
                    '-b', os.path.join(d, 'out.bin'), '-wdt', '64',
                    '-hgt', '64', '-f', '3', '--Device', 'cpu']) == 0
with open(os.path.join(d, 'out.bin'), 'rb') as f:
    ok([f.read()], 3)
assert decode.main([os.path.join(d, 'out.bin')]) == 0
assert sys.modules['jax'] is None and sys.modules['hm16_2_tpu'] is None
assert not [m for m in sys.modules if m.startswith('hm16_2_tpu.')]
print('ok')
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "ok"


# ---------------------------------------------------------------------------
# P-only structures
# ---------------------------------------------------------------------------

def _push_all(enc, frames):
    aus = []
    for poc, f in enumerate(frames):
        aus += enc.push_frame(_planes(f), poc)
    return aus + enc.flush()


def test_ldp_stream_same_bytes():
    """HM's low-delay P GOP-4 table: IDR + one GOP of four P pictures with
    four references and the +5/+4/+5/+1 QP ladder."""
    frames = make_yuv(136, 72, 5, seed=42)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=0, gop="ld")
    ref = _push_all(RT.Encoder(cfg()), frames)
    enc = PT.Encoder(cfg(), CPU)
    got = _push_all(enc, frames)
    assert len(got) == 5 and got == ref
    assert enc.stage_ms.get("plan", 0) > 0
    _decode_ok(b"".join(got), 5)


def test_cli_same_bytes(tmp_path):
    """The port's encoder CLI (`--Device cpu`) and the reference's, run on
    the same cfg (HM's Low Delay P Main) and 136x72 YUV, write the same
    stream."""
    from hm16_2_tpu.tools import encode as RE
    from hm16_2_tpu_torch.tools import encode as PE
    from make_fixtures import write_yuv
    yuv = tmp_path / "in.yuv"
    write_yuv(str(yuv), make_yuv(136, 72, 5, seed=42))
    args = ["-c", os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg"),
            "-i", str(yuv), "-wdt", "136", "-hgt", "72", "-f", "5"]
    assert RE.main(args + ["-b", str(tmp_path / "ref.bin")]) == 0
    assert PE.main(args + ["-b", str(tmp_path / "got.bin"),
                           "--Device", "cpu"]) == 0
    got = (tmp_path / "got.bin").read_bytes()
    assert got == (tmp_path / "ref.bin").read_bytes()
    _decode_ok(got, 5)


@pytest.mark.parametrize("opts", [
    ["--RateControl=1", "--TargetBitrate=200000"], ["--FieldCoding=1"],
    ["--DeltaQpRD=1"]])
def test_cli_refuses_unported(tmp_path, opts):
    """The CLI builds the port's Encoder, which refuses rate control, field
    coding and delta_qp_rd before reading any input."""
    from hm16_2_tpu_torch.tools import encode as PE
    with pytest.raises(NotImplementedError):
        PE.main(["-i", str(tmp_path / "none.yuv"), "-b",
                 str(tmp_path / "out.bin"), "-wdt", "64", "-hgt", "64",
                 "--Device", "cpu"] + opts)


def test_ippp_encode_frame_same_bytes():
    """The flat-QP IPPP entry: one reference per P picture."""
    frames = make_yuv(136, 72, 3, seed=7)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=8)
    ref_enc, enc = RT.Encoder(cfg()), PT.Encoder(cfg(), CPU)
    ref = [ref_enc.encode_frame(_planes(f), i) for i, f in enumerate(frames)]
    got = [enc.encode_frame(_planes(f), i) for i, f in enumerate(frames)]
    assert got == ref
    _decode_ok(b"".join(got), 3)


def test_weighted_prediction_fade_same_bytes():
    """The 192x128 fade of test_encode_roundtrip.test_weighted_pred_fade
    through encode_frame with weighted prediction on: the plan prices the
    weighted reference planes.  Held to the JAX encoder, so no HM decoder
    is needed."""
    rng = np.random.default_rng(3)
    base = rng.integers(30, 220, (128, 192)).astype(np.float64)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    frames = []
    for t in range(4):
        y = np.clip(base * (1.0 - 0.13 * t), 0, 255).astype(np.int32)
        u = np.full((64, 96), 128, np.int32)
        frames.append([y, u, u.copy()])
    cfg = lambda: RT.EncoderConfig(192, 128, qp=32, intra_period=0,
                                   weighted_pred=True)
    ref_enc, enc = RT.Encoder(cfg()), PT.Encoder(cfg(), CPU)
    ref = [ref_enc.encode_frame(_planes(f), i) for i, f in enumerate(frames)]
    got = [enc.encode_frame(_planes(f), i) for i, f in enumerate(frames)]
    assert got == ref
    _decode_ok(b"".join(got), 4)


# P-only table whose third picture does not reference the second: its plan
# is enqueued before the second picture commits
_P_TABLE = [dict(poc=1, qpoff=2, qpfac=0.4624, refs=(-1,), type="P",
                 n_active=1, depth=1),
            dict(poc=2, qpoff=3, qpfac=0.4624, refs=(-1, -2), type="P",
                 n_active=2, depth=2),
            dict(poc=3, qpoff=1, qpfac=0.578, refs=(-2,), type="P",
                 n_active=1, depth=0)]


def test_p_table_predispatch_same_bytes(monkeypatch):
    frames = make_yuv(136, 72, 4, seed=11)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=0,
                                   gop_table=_P_TABLE)
    ref = _push_all(RT.Encoder(cfg()), frames)
    calls = []
    plan_frame = PP.plan_frame

    def spy(*a, **kw):
        calls.append(kw.get("fetch", True))
        return plan_frame(*a, **kw)

    monkeypatch.setattr(PP, "plan_frame", spy)
    got = _push_all(PT.Encoder(cfg(), CPU), frames)
    assert calls.count(False) == 1 and calls.count(True) == 2
    assert got == ref
    _decode_ok(b"".join(got), 4)


# ---------------------------------------------------------------------------
# B structures
# ---------------------------------------------------------------------------

def _spy_plans(monkeypatch):
    """Record (POC, slice type, fetch) of every plan the port submits."""
    calls = []
    plan_frame = PP.plan_frame

    def spy(*a, **kw):
        calls.append((a[2].poc, a[2].slice_type, kw.get("fetch", True)))
        return plan_frame(*a, **kw)

    monkeypatch.setattr(PP, "plan_frame", spy)
    return calls


def test_ra_gop8_stream_same_bytes(monkeypatch):
    """HM's random-access GOP 8 (RA8_GOP, QP 32, intra period 32): IDR +
    one GOP of eight hierarchical B pictures through push_frame / flush.
    The plans of pictures 3, 6 and 7 are enqueued while their predecessors
    commit, as in the reference."""
    frames = make_yuv(136, 72, 9, seed=42)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=32,
                                   gop="ra8")
    ref = _push_all(RT.Encoder(cfg()), frames)
    calls = _spy_plans(monkeypatch)
    got = _push_all(PT.Encoder(cfg(), CPU), frames)
    assert sorted(p for p, _, fetch in calls if not fetch) == [3, 6, 7]
    assert sorted(p for p, _, _ in calls) == list(range(1, 9))
    assert all(t == 0 for _, t, _ in calls)               # B slices
    assert len(got) == 9 and got == ref
    _decode_ok(b"".join(got), 9)


def test_ldp_b_tail_same_bytes(monkeypatch):
    """Low-delay P over seven frames: IDR, one GOP of four P pictures, and
    the flush tail's two low-delay B pictures."""
    frames = make_yuv(136, 72, 7, seed=42)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, intra_period=0, gop="ld")
    ref = _push_all(RT.Encoder(cfg()), frames)
    calls = _spy_plans(monkeypatch)
    got = _push_all(PT.Encoder(cfg(), CPU), frames)
    assert [(p, t) for p, t, _ in calls] == [(1, 1), (2, 1), (3, 1), (4, 1),
                                             (5, 0), (6, 0)]
    assert got == ref
    _decode_ok(b"".join(got), 7)

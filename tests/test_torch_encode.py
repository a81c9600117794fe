"""The port's all-intra encoder (hm16_2_tpu_torch.encode.top) against the
JAX package's: the same Annex-B bytes, pictures that decode with their MD5
hash intact, the refusal of every configuration that is not all-intra, and
a port that runs with JAX absent.
"""

import difflib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hm16_2_tpu.decode.top import Decoder
from hm16_2_tpu.encode import top as RT
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


@pytest.mark.parametrize("kw", [dict(intra_period=0), dict(intra_period=8),
                                dict(gop="ra8"), dict(target_bps=200000,
                                                      total_frames=4),
                                dict(field_coding=True),
                                dict(delta_qp_rd=1)])
def test_non_intra_configs_refused(kw):
    cfg = dict(intra_period=1)
    cfg.update(kw)
    with pytest.raises(NotImplementedError):
        PT.Encoder(RT.EncoderConfig(64, 64, **cfg), CPU)


def test_device_is_required():
    with pytest.raises(TypeError):
        PT.Encoder(RT.EncoderConfig(64, 64, intra_period=1), "cpu")


def test_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig\n"
        "from hm16_2_tpu.decode.top import Decoder\n"
        "rng = np.random.default_rng(0)\n"
        "y = rng.integers(0, 256, (64, 64)).astype(np.int32)\n"
        "c = rng.integers(0, 256, (32, 32)).astype(np.int32)\n"
        "enc = Encoder(EncoderConfig(64, 64, intra_period=1), "
        "torch.device('cpu'))\n"
        "au = enc.encode_frame([y, c, c.copy()], 0)\n"
        "assert Decoder().decode_stream(au)[0].hash_ok is True\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok', len(au))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok ")


def _blocks(src, start, end):
    lines = src.splitlines()
    i = next(k for k, ln in enumerate(lines) if start in ln)
    j = next(k for k, ln in enumerate(lines) if end in ln)
    return lines[:i], lines[j:]


def test_encode_one_copy_differs_only_in_plan_block():
    """The port's _encode_one is the reference's with only the plan and
    P/B block (from building CtuSearch to the commit pass) replaced."""
    ref = inspect.getsource(RT.Encoder._encode_one)
    got = inspect.getsource(PT.Encoder._encode_one)
    start, end = "search = CtuSearch(", "# pass 1: mode decisions"
    ref_head, ref_tail = _blocks(ref, start, end)
    got_head, got_tail = _blocks(got, start, end)
    diff = list(difflib.unified_diff(ref_head + ref_tail,
                                     got_head + got_tail, lineterm=""))
    assert not diff, "\n".join(diff)

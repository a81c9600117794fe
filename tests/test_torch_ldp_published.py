"""HM-16.2's Low Delay P Main as JCTVC-L1100 publishes it (the table of
portbench/configs/ctc-ldp-main-1080p.json: four P pictures, QP offsets
+3/+2/+3/+1, QP factors 0.4624 and 0.578, four active references, all in
the past), passed as `gop_table`: the port's plain path on the CPU writes
the JAX package's bytes over 17 pictures at 64x64, POC 10-16 with four
references live, and the stream decodes with every MD5 intact."""

import json
import os

import numpy as np
import torch

from hm16_2_tpu.decode.top import Decoder
from hm16_2_tpu.encode import top as RT
from hm16_2_tpu_torch.encode import inter_plan as PP
from hm16_2_tpu_torch.encode import top as PT
from make_fixtures import make_yuv

torch.set_num_threads(1)

CPU = torch.device("cpu")
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "portbench", "configs", "ctc-ldp-main-1080p.json")


def _table():
    with open(CONFIG) as f:
        enc = json.load(f)["encoder"]
    assert (enc["gop"], enc["intra_period"],
            enc["decoding_refresh_type"]) == ("ld", 0, 0)
    return enc["gop_table"]


def _push_all(enc, frames):
    aus = []
    for poc, f in enumerate(frames):
        aus += enc.push_frame([np.ascontiguousarray(p, dtype=np.int32)
                               for p in f], poc)
    return aus + enc.flush()


def test_published_table():
    table = _table()
    assert [(s["qpoff"], s["qpfac"], s["n_active"], s["refs"])
            for s in table] == [(3, 0.4624, 4, [-1, -5, -9, -13]),
                                (2, 0.4624, 4, [-1, -2, -6, -10]),
                                (3, 0.4624, 4, [-1, -3, -7, -11]),
                                (1, 0.578, 4, [-1, -4, -8, -12])]


def test_ldp_published_same_bytes(monkeypatch):
    frames = make_yuv(64, 64, 17, seed=42)
    cfg = lambda: RT.EncoderConfig(64, 64, qp=32, intra_period=0, gop="ld",
                                   decoding_refresh_type=0,
                                   gop_table=_table())
    ref = _push_all(RT.Encoder(cfg()), frames)
    refs = {}
    inputs = PP._plan_inputs

    def spy(sps, sh, rc):
        out = inputs(sps, sh, rc)
        refs[int(sh.poc)] = len(out[0])
        return out
    monkeypatch.setattr(PP, "_plan_inputs", spy)
    got = _push_all(PT.Encoder(cfg(), CPU), frames)
    assert len(got) == 17 and got == ref
    # the table's references held by then: four from POC 10 on
    assert [refs[p] for p in range(1, 17)] == [1] + [2] * 4 + [3] * 4 + \
        [4] * 7
    pics = Decoder().decode_stream(b"".join(got))
    assert len(pics) == 17 and all(p.hash_ok is True for p in pics)

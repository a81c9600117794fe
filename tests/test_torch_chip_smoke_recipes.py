"""chip_smoke.py's 1080p phases code the recipes of
hm16_2_tpu_torch/tools/stream_digest.py, whose streams they hold to the
JAX package's pinned digests on the card: each phase, run on the CPU at
64x64 with its checks of the card's launches and profile stubbed, writes
the AUs of stream_digest.encode of the same recipe at that size.  Its own
file, so that it runs beside the JAX digests of
test_torch_stream_digest.py.
"""

import dataclasses

import numpy as np
import torch

import chip_smoke as C
from hm16_2_tpu_torch.tools import stream_digest as S

torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_chip_smoke_phases_code_the_recipes(monkeypatch):
    """Every 1080p recipe is coded by its phase, frame for frame and byte
    for byte."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(C, "_launches_of",
                        lambda K, run, label, need: (run(), dict(K.LAUNCHES)))
    monkeypatch.setattr(C, "_timed_pictures", lambda enc, code, label, top: (
        code(), 1.0, dict(enc.stage_ms)))
    monkeypatch.setattr(C, "_k1_once_per_plan", lambda *a: None)
    monkeypatch.setattr(C, "_picks_per_picture", lambda *a: None)
    seen = {}
    monkeypatch.setattr(C, "_pinned", lambda name, frames, aus:
                        seen.setdefault(name, (frames, aus)))
    small = {n: dataclasses.replace(S.RECIPES[n], width=64, height=64)
             for n in S.LARGE}
    content = S.make_frames(small["RA"])          # as chip_smoke.main
    for name, phase in (("AI", C.ai_phase), ("LDP", C.ldp_phase),
                        ("RA", C.ra_phase),
                        ("per-CU search", C.fallback_phase)):
        r = small[name]
        aus, _ = phase(r, content[:r.frames], CPU)
        seen[name] = (content[:r.frames], aus)
    C.main10_phase(CPU, small["AI-Main10"], small["RA-Main10"])
    assert list(seen) == S.LARGE
    for name, (frames, aus) in seen.items():
        r = small[name]
        want = S.make_frames(r)
        assert all(np.array_equal(a, b) for f, g in zip(frames, want,
                                                        strict=True)
                   for a, b in zip(f, g, strict=True))
        assert aus == S.encode(r, S.port_encoder(CPU), want), name

"""chip_smoke.py's timed phases code the large recipes of
hm16_2_tpu_torch/tools/stream_digest.py, whose streams they hold to the
JAX package's pinned digests on the card: each phase, run on the CPU at
64x64 (the field phase at 64x128) with its checks of the card's launches,
profile and plan replays stubbed, writes the AUs of stream_digest.encode
of the same recipe at that size (the banded recipes through the port's
`banded` over CPU bands, in test_torch_chip_smoke_banded.py).  Files of
their own, so that they run beside the JAX digests of
test_torch_stream_digest.py and beside each other.
"""

import dataclasses

import numpy as np
import torch

import chip_smoke as C
from hm16_2_tpu_torch.tools import stream_digest as S

torch.set_num_threads(1)

CPU = torch.device("cpu")
# the recipes of chip_smoke's first timed phases, and of its rate-control,
# delta_qp_rd and field phases
FIRST = ["AI", "LDP", "RA", "per-CU search", "AI-Main10", "RA-Main10"]
LATER = ["RC LDP", "RC CTU LDP", "delta_qp_rd AI", "delta_qp_rd LDP",
         "field AI", "field LDP"]


def stub_card_checks(monkeypatch):
    """Stub the checks of the card's launches, profile and plan replays;
    returns the {recipe: (frames, AUs)} that `_pinned` is given."""
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
    return seen


def codes_the_recipes(seen, small):
    """Each phase's stream is stream_digest.encode of its recipe, on the
    recipe's own content."""
    for name, (frames, aus) in seen.items():
        r = small[name]
        want = S.make_frames(r)
        assert all(np.array_equal(a, b) for f, g in zip(frames, want,
                                                        strict=True)
                   for a, b in zip(f, g, strict=True))
        assert aus == S.encode(r, S.port_encoder(CPU), want,
                               S.port_banded(CPU)), name


def test_chip_smoke_phases_code_the_recipes(monkeypatch):
    """Every recipe of the first timed phases (1080p AI, LDP, RA, the
    per-CU search, Main10 AI and RA) is coded by its phase, frame for frame
    and byte for byte."""
    seen = stub_card_checks(monkeypatch)
    small = {n: dataclasses.replace(S.RECIPES[n], width=64, height=64)
             for n in FIRST}
    content = S.make_frames(small["RA"])          # as chip_smoke.main
    for name, phase in (("AI", C.ai_phase), ("LDP", C.ldp_phase),
                        ("RA", C.ra_phase),
                        ("per-CU search", C.fallback_phase)):
        r = small[name]
        aus, _ = phase(r, content[:r.frames], CPU)
        seen[name] = (content[:r.frames], aus)
    C.main10_phase(CPU, small["AI-Main10"], small["RA-Main10"])
    assert list(seen) == FIRST
    codes_the_recipes(seen, small)


def test_later_phases_code_the_recipes(monkeypatch):
    """Rate control at picture and CTU level, delta_qp_rd AI and LDP, and
    field AI and LDP are each coded by their phase and held to PINNED by
    name, byte for byte."""
    seen = stub_card_checks(monkeypatch)
    monkeypatch.setattr(C, "_replay_held", lambda *a, **kw: 0)
    monkeypatch.setattr(C, "_plans_per_picture", lambda *a: None)
    monkeypatch.setattr(C, "_plans_per_field", lambda *a: None)
    small = {n: dataclasses.replace(
        S.RECIPES[n], width=64,
        height=128 if S.RECIPES[n].cfg.get("field_coding") else 64)
        for n in LATER}
    content = S.make_frames(small["RC LDP"])      # as chip_smoke.main
    fields = S.make_frames(small["field LDP"])
    for phase, frames, names in (
            (C.rc_phase, content, ("RC LDP", "RC CTU LDP")),
            (C.dqp_phase, content, ("delta_qp_rd AI", "delta_qp_rd LDP")),
            (C.field_phase, fields, ("field AI", "field LDP"))):
        for name in names:
            r = small[name]
            phase(r, frames[:r.frames], CPU)
    assert list(seen) == LATER
    codes_the_recipes(seen, small)

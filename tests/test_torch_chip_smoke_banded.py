"""chip_smoke.py's banded phase codes the banded recipes of
hm16_2_tpu_torch/tools/stream_digest.py and the unbanded 1024x768 RA,
byte for byte: run on the CPU at 64x64 with its bands on CPU devices and
its checks of the card's launches, analysis step and scaling_bench
stubbed (as in test_torch_chip_smoke_recipes.py, whose helpers it uses;
its own file, so that it runs beside that one).
"""

import dataclasses

import torch

import chip_smoke as C
from hm16_2_tpu_torch.tools import stream_digest as S
from test_torch_chip_smoke_recipes import CPU, FIRST, LATER, \
    codes_the_recipes, stub_card_checks

torch.set_num_threads(1)

BANDED = ["banded AI", "1024x768 RA", "1024x768 banded RA 2",
          "1024x768 banded RA 4"]


def test_banded_phase_codes_the_recipes(monkeypatch):
    """The banded AI, the 1024x768 RA and its runs over 2 and 4 bands are
    each coded by banded_phase and held to PINNED by name, byte for
    byte."""
    seen = stub_card_checks(monkeypatch)
    monkeypatch.setattr(C, "_band_launches", lambda *a: None)
    monkeypatch.setattr(C, "_band_tools", lambda *a: [])
    small = {n: dataclasses.replace(S.RECIPES[n], width=64, height=64)
             for n in BANDED}
    content = S.make_frames(small["banded AI"])
    xga = S.make_frames(small["1024x768 RA"])
    C.banded_phase(content, xga, CPU, [small[n] for n in BANDED])
    assert sorted(seen) == sorted(BANDED)
    codes_the_recipes(seen, small)
    assert FIRST + LATER + BANDED == S.LARGE      # every phase's recipes

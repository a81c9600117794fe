"""The pinned stream digests (hm16_2_tpu_torch/tools/stream_digest.py)
against the JAX package, and the recipes against what chip_smoke.py runs.

`PINNED` holds the SHA-256 of the JAX package's stream of every recipe;
chip_smoke.py and `stream_digest.py --check` hold the card's streams to
them, since the card's machine has no JAX.  The `slow` cases reproduce
every entry from the JAX package on the CPU:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_stream_digest.py -m slow

Tier 1 reproduces the three 136x72 entries that share one compiled JAX
program per geometry, the 1080p input planes, and two small streams of
the port's CPU path; the other small recipes are held to the JAX package
by the same-bytes tests of test_torch_encode*.py as well.  That
chip_smoke.py codes the recipes is test_torch_chip_smoke_recipes.py.
"""

import os

import pytest
import torch

from hm16_2_tpu.encode import top as RT
from hm16_2_tpu_torch.encode.top import EncoderConfig
from hm16_2_tpu_torch.tools import stream_digest as S

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIER1 = ["136x72 AI", "136x72 LDP", "136x72 RA"]


def jax_encoder(kw):
    return RT.Encoder(RT.EncoderConfig(**kw))


def _held(name, make_encoder):
    r = S.RECIPES[name]
    frames = S.make_frames(r)
    got = S.digest(frames, S.encode(r, make_encoder, frames))
    assert S.mismatch(name, got) is None, got


def test_every_recipe_is_pinned():
    assert set(S.PINNED) == set(S.RECIPES)
    assert S.LARGE == ["AI", "LDP", "RA", "per-CU search", "AI-Main10",
                       "RA-Main10"]
    for name, r in S.RECIPES.items():
        assert len(S.PINNED[name]["aus"]) == r.frames * (
            2 if r.cfg.get("field_coding") else 1)


@pytest.mark.parametrize("name", TIER1)
def test_jax_package_writes_pinned(name):
    _held(name, jax_encoder)


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in S.RECIPES if n not in TIER1])
def test_jax_package_writes_pinned_slow(name):
    _held(name, jax_encoder)


@pytest.mark.parametrize("name", ["136x72 RC RA", "136x72 per-CU IPPP"])
def test_port_cpu_writes_pinned(name):
    _held(name, S.port_encoder(CPU))


@pytest.mark.parametrize("bits", [8, 10])
def test_large_inputs_pinned(bits):
    """make_yuv(1920, 1080, 9, seed=42) at 8 and 10 bits: each 1080p
    recipe codes a prefix of it, and its planes hash to PINNED."""
    names = [n for n in S.LARGE if S.RECIPES[n].bits == bits]
    assert len(names) == (4 if bits == 8 else 2)
    frames = S.make_frames(S.RECIPES[names[0]], 9)
    for name in names:
        r = S.RECIPES[name]
        assert (r.seed, r.chroma, r.frames <= 9) == (42, 420, True)
        assert S.input_digest(frames[:r.frames]) == S.PINNED[name]["input"]


@pytest.mark.parametrize("name,cfg", [
    ("AI-Main10", "encoder_intra_main10.cfg"),
    ("RA-Main10", "encoder_randomaccess_main10.cfg")])
def test_cli_derives_main10_recipes(name, cfg, monkeypatch):
    """The Main10 recipes' EncoderConfig is what the port's CLI builds from
    HM's Main10 cfg files at -wdt 1920 -hgt 1080 -q 32."""
    from hm16_2_tpu_torch.tools import encode as cli

    class Built(Exception):
        pass

    def capture(cfg, device):
        raise Built(cfg)

    monkeypatch.setattr(cli, "Encoder", capture)
    r = S.RECIPES[name]
    with pytest.raises(Built) as built:
        cli.main(["-c", os.path.join(ROOT, "cfg", cfg), "-i", "in.yuv",
                  "-b", "out.bin", "-wdt", "1920", "-hgt", "1080", "-q", "32",
                  "-f", str(r.frames), "--Device", "cpu"])
    assert vars(built.value.args[0]) == vars(EncoderConfig(**S.config(r)))

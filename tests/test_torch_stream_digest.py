"""The pinned stream digests (hm16_2_tpu_torch/tools/stream_digest.py)
against the JAX package, and the check that holds the card's streams to
them.

`PINNED` holds the SHA-256 of the JAX package's stream of every recipe;
`stream_digest.check` (`stream_digest.py --check`, and chip_smoke.py)
holds the card's streams to them, since the card's machine has no JAX.  The `slow` cases reproduce
every entry from the JAX package on the CPU:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_stream_digest.py -m slow

The banded recipes run the JAX package through `jax_banded`, the twin of
the port's `stream_digest.banded`, over the 8 virtual CPU devices of
tests/conftest.py.  Each case takes from seconds (the 136x72 recipes) to
tens of minutes (1080p delta_qp_rd LDP, whose 5 pictures run 20 plans).

Tier 1 reproduces the three 136x72 entries that share one compiled JAX
program per geometry, the input planes of every large recipe, three small
streams of the port's CPU path (among them the banded 136x72 AI, over two
CPU bands) and that the banded 136x72 AI differs from its unbanded
stream; the other small recipes are held to the JAX package by the
same-bytes tests of test_torch_encode*.py as well.  Only `-m slow`
reproduces the large recipes and the other small ones.  The check itself
runs here on the CPU at 64x64, with PINNED replaced by the CPU's own
digests: it codes each large recipe once, through `encode`, and fails,
naming the recipe, on a wrong launch count, a corrupted AU or a picture
whose hash does not match.
"""

import contextlib
import dataclasses
import os
import types

import pytest
import torch

from hm16_2_tpu.encode import top as RT
from hm16_2_tpu_torch import kernels as K
from hm16_2_tpu_torch.decode import top as DT
from hm16_2_tpu_torch.encode.top import EncoderConfig
from hm16_2_tpu_torch.tools import stream_digest as S

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIER1 = ["136x72 AI", "136x72 LDP", "136x72 RA"]


def jax_encoder(kw):
    return RT.Encoder(RT.EncoderConfig(**kw))


@contextlib.contextmanager
def jax_banded(n):
    """The twin of stream_digest.banded in the JAX package: its intra plan
    becomes frame_shard.sharded_plan_frame and its inter plan takes the
    mesh, over `n` of the virtual CPU devices."""
    import jax
    from hm16_2_tpu.encode import inter_plan as RP
    from hm16_2_tpu.encode import intra_rd as RI
    from hm16_2_tpu.parallel import frame_shard as RF
    mesh = RF.make_row_mesh(jax.devices("cpu")[:n])
    saved = RI.plan_frame, RP.plan_frame
    RI.plan_frame = lambda orig, sps, qp, lam, cw, cqps, device=None: \
        RF.sharded_plan_frame(mesh, orig, sps, qp, lam, cw, cqps)
    RP.plan_frame = lambda *a, **kw: saved[1](*a, **dict(kw, mesh=mesh))
    try:
        yield
    finally:
        RI.plan_frame, RP.plan_frame = saved


def _held(name, make_encoder, banded):
    r = S.RECIPES[name]
    frames = S.make_frames(r)
    got = S.digest(frames, S.encode(r, make_encoder, frames, banded))
    assert S.mismatch(name, got) is None, got


def test_every_recipe_is_pinned():
    assert set(S.PINNED) == set(S.RECIPES)
    assert S.LARGE == ["AI", "LDP", "RA", "per-CU search", "AI-Main10",
                       "RA-Main10", "RC LDP", "RC CTU LDP", "delta_qp_rd AI",
                       "delta_qp_rd LDP", "field AI", "field LDP",
                       "banded AI", "1024x768 RA", "1024x768 banded RA 2",
                       "1024x768 banded RA 4"]
    assert all(S.RECIPES[n].width <= 264 for n in S.SMALL)
    for name, r in S.RECIPES.items():
        assert len(S.PINNED[name]["aus"]) == r.frames * (
            2 if r.cfg.get("field_coding") else 1)


@pytest.mark.parametrize("name", TIER1)
def test_jax_package_writes_pinned(name):
    _held(name, jax_encoder, jax_banded)


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in S.RECIPES if n not in TIER1])
def test_jax_package_writes_pinned_slow(name):
    _held(name, jax_encoder, jax_banded)


@pytest.mark.parametrize("name", ["136x72 RC RA", "136x72 per-CU IPPP",
                                  "136x72 banded AI"])
def test_port_cpu_writes_pinned(name):
    _held(name, S.port_encoder(CPU), S.port_banded(CPU))


def test_banded_recipe_shows_the_zero_halo():
    """The pinned stream of `136x72 banded AI` is not the unbanded stream
    of the same content: over 2 bands the s = 32 rows stop at row 64, and
    the last band reads its zero halo where the whole picture reads rows
    64-71 (ROADMAP.md, the zero halo of the banded intra RD)."""
    r = S.RECIPES["136x72 banded AI"]
    frames = S.make_frames(r)
    whole = S.digest(frames, S.encode(dataclasses.replace(r, bands=0),
                                      S.port_encoder(CPU), frames))
    pinned = S.PINNED[r.name]
    assert whole["input"] == pinned["input"]
    assert whole["aus"] != pinned["aus"]
    assert whole["stream"] != pinned["stream"]


@pytest.mark.parametrize("size,bits,count", [
    ((1920, 1080), 8, 9), ((1920, 1080), 10, 2), ((1920, 1088), 8, 2),
    ((1024, 768), 8, 3)], ids=["8", "10", "1920x1088", "1024x768"])
def test_large_inputs_pinned(size, bits, count):
    """make_yuv(width, height, n, seed=42) at the bit depth: each large
    recipe of that size and depth codes a prefix of it, and its planes hash
    to PINNED."""
    names = [n for n in S.LARGE if (S.RECIPES[n].width, S.RECIPES[n].height,
                                    S.RECIPES[n].bits) == (*size, bits)]
    assert len(names) == count
    frames = S.make_frames(S.RECIPES[names[0]],
                           max(S.RECIPES[n].frames for n in names))
    for name in names:
        r = S.RECIPES[name]
        assert (r.seed, r.chroma) == (42, 420)
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


# the large recipes in three groups: 1080p AI, LDP, RA, the per-CU search
# and Main10; rate control, delta_qp_rd and field coding; the banded
# recipes with the unbanded 1024x768 RA
GROUPS = {"first": S.LARGE[:6], "later": S.LARGE[6:12],
          "banded": S.LARGE[12:]}


@pytest.mark.parametrize("group", GROUPS)
def test_check_codes_each_recipe_once(group, monkeypatch):
    """`check` on the CPU at 64x64 (fields 64x128), PINNED replaced by the
    CPU's own digests: it codes each recipe of the group once, through
    `encode`, holds those bytes and decodes every picture hash_ok."""
    names, pinned, coded = GROUPS[group], {}, []
    encode = S.encode

    def recorded(r, *a):
        aus = encode(r, *a)
        coded.append(r.name)
        pinned[r.name] = S.digest(a[1], aus)
        return aus

    monkeypatch.setattr(S, "encode", recorded)
    monkeypatch.setattr(S, "PINNED", pinned)
    for n in names:
        r = S.RECIPES[n]
        monkeypatch.setitem(S.RECIPES, n, dataclasses.replace(
            r, width=64, height=128 if r.cfg.get("field_coding") else 64))
    assert list(S.check(names, CPU)) == names
    assert coded == names


def test_every_recipe_has_expectations():
    """EXPECT has an entry for each recipe, naming only kernels of
    kernels.LAUNCHES and, as twins, unbanded recipes coded before it."""
    assert set(S.EXPECT) == set(S.RECIPES)
    order = list(S.RECIPES)
    for name, e in S.EXPECT.items():
        kernels = e.need + e.idle + tuple(k for k, _, _ in e.per_picture)
        assert set(kernels) <= set(K.LAUNCHES), name
        if e.twin:
            assert S.RECIPES[e.twin].bands == 0, name
            assert order.index(e.twin) < order.index(name), name


@pytest.mark.parametrize("fault", ["launches", "au", "hash"])
def test_check_names_the_failing_recipe(fault, monkeypatch):
    """A wrong launch count fails `expect`, and a corrupted AU or a picture
    whose hash does not match fails `check`, each naming the recipe."""
    if fault == "launches":
        # 1080p AI's three pictures on the card
        r, counts = S.RECIPES["AI"], dict.fromkeys(K.LAUNCHES, 0)
        counts.update({"intra_size_rd": 12, "intra_cand_rd": 9, "plan_dp": 6,
                       "ref_buffers": 3, "k1 per plan": [], "ahead": [],
                       "rc updates": 0, "banded inter": 0})
        S.expect(r, counts, 3)
        counts["plan_dp"] = 5
        with pytest.raises(AssertionError, match="^AI: plan_dp 5, not 6$"):
            S.expect(r, counts, 3)
        return
    if fault == "au":
        encode = S.encode

        def corrupted(r, *a):
            aus = encode(r, *a)
            return aus[:1] + [aus[1][:-1] + bytes([aus[1][-1] ^ 1])] + aus[2:]

        monkeypatch.setattr(S, "encode", corrupted)
        match = "^136x72 AI: .*first differing AU 1"
    else:
        class Decoder:
            def decode_stream(self, data):
                return [types.SimpleNamespace(hash_ok=k != 2)
                        for k in range(3)]

        monkeypatch.setattr(DT, "Decoder", Decoder)
        match = r"^136x72 AI: decoded 3 pictures of 3, hash_ok \[True, " \
            r"True, False\]"
    with pytest.raises(AssertionError, match=match):
        S.check(["136x72 AI"], CPU)

"""The streams whose bytes are pinned, and their SHA-256.

`RECIPES` defines every checked stream once: its content
(`make_yuv(width, height, frames, seed=, bits=, chroma=)`), its
`EncoderConfig` keyword arguments, how it is driven (`encode_stream`,
`push_frame` / `flush`, or `encode_frame`) and the environment switches
it runs under.  The 1080p recipes are the streams that chip_smoke.py
encodes on the card (AI, LDP, RA, the per-CU search, and Main10 AI and
RA, whose configurations are what `tools/encode.py` builds from
`cfg/encoder_intra_main10.cfg` and `cfg/encoder_randomaccess_main10.cfg`
at `-wdt 1920 -hgt 1080 -q 32`); the small ones are those of
chip_smoke.small_checks.

`PINNED` holds, for each recipe, the SHA-256 of its input planes (int32,
little-endian, frame by frame in plane order), the SHA-256 and length of
each access unit the JAX package writes, and the SHA-256 of the whole
stream.  `tests/test_torch_stream_digest.py` reproduces every value from
the JAX package on the CPU (`-m slow` for all of them).

    python3 hm16_2_tpu_torch/tools/stream_digest.py [--root DIR]
    python3 hm16_2_tpu_torch/tools/stream_digest.py --check [NAME ...]

Without --check: encodes the 1080p recipes on the card with the
`hm16_2_tpu_torch` of the checkout DIR (default: the one holding this
file), so that two trees unpacked side by side are held to the same bytes
in one call, and prints the card's name and power limit, a line per
stream (pictures, bytes, digest; for push_frame recipes also the
`stage_ms` per picture after the IDR) and one JSON object.  With --check:
encodes the named recipes (default: all) on the card, prints for each
whether its input and stream equal `PINNED` or the first differing access
unit, and exits non-zero if any differed.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
W, H, QP = 1920, 1080, 32

# the GOPEntry table that tools/encode.py reads from the FrameN lines of
# cfg/encoder_randomaccess_main10.cfg
RA_CFG_GOP = [
    dict(type="B", poc=8, qpoff=1, qpfac=0.442, tid=0, n_active=2,
         refs=(-8, -16)),
    dict(type="B", poc=4, qpoff=2, qpfac=0.3536, tid=1, n_active=2,
         refs=(-4, 4)),
    dict(type="B", poc=2, qpoff=3, qpfac=0.3536, tid=2, n_active=2,
         refs=(-2, 2, 6)),
    dict(type="B", poc=1, qpoff=4, qpfac=0.68, tid=3, n_active=2,
         refs=(-1, 1, 3, 7)),
    dict(type="B", poc=3, qpoff=4, qpfac=0.68, tid=3, n_active=2,
         refs=(-1, -3, 1, 5)),
    dict(type="B", poc=6, qpoff=3, qpfac=0.3536, tid=2, n_active=2,
         refs=(-2, -6, 2)),
    dict(type="B", poc=5, qpoff=4, qpfac=0.68, tid=3, n_active=2,
         refs=(-1, -5, 1, 3)),
    dict(type="B", poc=7, qpoff=4, qpfac=0.68, tid=3, n_active=2,
         refs=(-1, -7, 1)),
]


@dataclasses.dataclass(frozen=True)
class Recipe:
    """One checked stream: content, configuration, driving."""
    name: str
    width: int
    height: int
    frames: int
    cfg: dict                   # EncoderConfig keywords after width, height
    drive: str                  # encode_stream | push_frame | encode_frame
    seed: int = 42
    bits: int = 8
    chroma: int = 420
    env: tuple = ()             # (name, value) pairs set while coding


NO_PLAN = (("HM16_NO_INTER_PLAN", "1"),)
AI = dict(qp=QP, intra_period=1)
LD = dict(qp=QP, intra_period=0, gop="ld")
RA = dict(qp=QP, intra_period=32, gop="ra8")
RC = dict(target_bps=200000)

RECIPES = {r.name: r for r in (
    # 1080p: chip_smoke.py's timed phases
    Recipe("AI", W, H, 3, AI, "encode_stream"),
    Recipe("LDP", W, H, 5, LD, "push_frame"),
    Recipe("RA", W, H, 9, RA, "push_frame"),
    Recipe("per-CU search", W, H, 2, dict(qp=QP, intra_period=8, rrsp=True),
           "encode_frame", env=NO_PLAN),
    Recipe("AI-Main10", W, H, 3, dict(qp=QP, bit_depth=10, intra_period=1,
                                      sbd=False, total_frames=3),
           "encode_stream", bits=10),
    Recipe("RA-Main10", W, H, 9, dict(
        qp=QP, bit_depth=10, intra_period=32, gop="ra8", sbd=False,
        total_frames=9, gop_table=RA_CFG_GOP), "push_frame", bits=10),
    # small: chip_smoke.small_checks, card against CPU
    Recipe("136x72 AI", 136, 72, 3, AI, "encode_stream"),
    Recipe("136x72 LDP", 136, 72, 5, LD, "push_frame"),
    Recipe("136x72 RA", 136, 72, 9, RA, "push_frame"),
    Recipe("136x72 RC LDP", 136, 72, 5, dict(LD, **RC, total_frames=5),
           "push_frame"),
    Recipe("136x72 RC CTU LDP", 136, 72, 5,
           dict(LD, **RC, total_frames=5, rc_ctu=True), "push_frame"),
    Recipe("136x72 RC RA", 136, 72, 9, dict(RA, **RC, total_frames=9),
           "push_frame"),
    Recipe("136x72 delta_qp_rd AI", 136, 72, 2, dict(AI, delta_qp_rd=1),
           "push_frame"),
    Recipe("136x72 delta_qp_rd LDP", 136, 72, 3, dict(LD, delta_qp_rd=1),
           "push_frame"),
    # 64-row fields: 136x72's 36-row fields hit the reference's fault F2
    Recipe("128x128 field AI", 128, 128, 2, dict(AI, field_coding=True),
           "encode_stream"),
    Recipe("128x128 field LDP", 128, 128, 3, dict(LD, field_coding=True),
           "encode_stream"),
    Recipe("136x72 per-CU IPPP", 136, 72, 4, dict(
        qp=QP, intra_period=8, rrsp=True, sbd=True), "encode_frame",
        env=NO_PLAN),
    Recipe("136x72 per-CU RA", 136, 72, 9, RA, "push_frame", env=NO_PLAN),
)}
LARGE = [n for n, r in RECIPES.items() if (r.width, r.height) == (W, H)]
SMALL = [n for n in RECIPES if n not in LARGE]


def make_frames(recipe, n=None):
    """The recipe's input frames (the first `n` of them if given): the
    make_yuv content of tests/make_fixtures.py."""
    if os.path.join(REPO, "tests") not in sys.path:
        sys.path.insert(1, os.path.join(REPO, "tests"))
    from make_fixtures import make_yuv
    return make_yuv(recipe.width, recipe.height, n or recipe.frames,
                    seed=recipe.seed, bits=recipe.bits, chroma=recipe.chroma)


def config(recipe):
    """The keyword arguments of the recipe's EncoderConfig."""
    return dict(copy.deepcopy(recipe.cfg), width=recipe.width,
                height=recipe.height)


def port_encoder(dev):
    """make_encoder for `encode`: the port's Encoder on `dev`."""
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    return lambda kw: Encoder(EncoderConfig(**kw), dev)


@contextlib.contextmanager
def environ(recipe):
    """The recipe's environment switches, set for the block."""
    saved = {k: os.environ.get(k) for k, _ in recipe.env}
    os.environ.update(dict(recipe.env))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def code(recipe, enc, frames, start=0, stop=None):
    """Code frames[start:stop] (POC = index) on `enc` the recipe's way;
    push_frame recipes flush after the last frame.  encode_stream codes
    all frames at once."""
    stop = len(frames) if stop is None else stop
    if recipe.drive == "encode_stream":
        if (start, stop) != (0, len(frames)):
            raise ValueError("encode_stream codes every frame at once")
        return list(enc.encode_stream(frames))

    def planes(poc):
        return [np.ascontiguousarray(p, dtype=np.int32) for p in frames[poc]]

    if recipe.drive == "encode_frame":
        return [enc.encode_frame(planes(poc), poc)
                for poc in range(start, stop)]
    aus = []
    for poc in range(start, stop):
        aus += enc.push_frame(planes(poc), poc)
    return aus + (enc.flush() if stop == len(frames) else [])


def encode(recipe, make_encoder, frames):
    """The access units of `recipe` coded on `frames` by the encoder that
    `make_encoder(config(recipe))` returns."""
    with environ(recipe):
        return code(recipe, make_encoder(config(recipe)), frames)


def _sha(data):
    return hashlib.sha256(data).hexdigest()


def input_digest(frames):
    """SHA-256 of the planes as int32 little-endian bytes, frame by frame,
    in plane order."""
    h = hashlib.sha256()
    for f in frames:
        for p in f:
            h.update(np.ascontiguousarray(p, dtype="<i4").tobytes())
    return h.hexdigest()


def digest(frames, aus):
    """{"input", "aus": [[sha256, length], ...], "stream"} of a stream."""
    return {"input": input_digest(frames),
            "aus": [[_sha(a), len(a)] for a in aus],
            "stream": _sha(b"".join(aus))}


def mismatch(name, got):
    """None if the digest `got` of recipe `name` equals PINNED, else a
    message naming the first differing access unit and its lengths."""
    want = PINNED[name]
    if got["input"] != want["input"]:
        return (f"{name}: input planes differ from the pinned content "
                f"(sha256 {got['input']}, pinned {want['input']})")
    if got["stream"] == want["stream"] and got["aus"] == want["aus"]:
        return None
    n = min(len(got["aus"]), len(want["aus"]))
    first = next((i for i in range(n) if got["aus"][i] != want["aus"][i]), n)
    length = lambda aus: aus[first][1] if first < len(aus) else None
    return (f"{name}: {len(got['aus'])} AUs against {len(want['aus'])} "
            f"pinned; first differing AU {first}: {length(got['aus'])} "
            f"bytes here, {length(want['aus'])} pinned; stream sha256 "
            f"{got['stream']}, pinned {want['stream']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose hm16_2_tpu_torch encodes")
    ap.add_argument("--label", default="")
    ap.add_argument("--check", nargs="*", metavar="NAME",
                    help="hold these recipes (default: all) to PINNED")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("stream_digest: no CUDA device")
    sys.path.insert(1, HERE)
    from intra_bench import card_line
    card = card_line()
    label = args.label or root
    print(card, flush=True)
    names = (args.check or list(RECIPES)) if args.check is not None \
        else LARGE
    dev = torch.device("cuda")
    res = {}
    for name in names:
        r = RECIPES[name]
        frames = make_frames(r)
        stage = None
        with environ(r):
            enc = port_encoder(dev)(config(r))
            if r.drive == "push_frame":
                aus = code(r, enc, frames, 0, 1)
                before = dict(enc.stage_ms)
                aus += code(r, enc, frames, 1)
                stage = {k: (v - before.get(k, 0.0)) / (r.frames - 1)
                         for k, v in enc.stage_ms.items()}
            else:
                aus = code(r, enc, frames)
        got = digest(frames, aus)
        res[name] = {"pictures": len(aus), "bytes": sum(map(len, aus)),
                     "sha256": got["stream"], "stage_ms": stage}
        print(f"{label}: {name} {r.width}x{r.height}: {len(aus)} AUs, "
              f"{res[name]['bytes']} bytes, sha256 {got['stream']}"
              + (f"; stage_ms per picture after the IDR "
                 f"{json.dumps(stage)}" if stage else "") + f"  [{card}]",
              flush=True)
        if args.check is not None:
            res[name]["pinned"] = bad = mismatch(name, got)
            print(f"{name}: {bad or 'input and stream equal PINNED'}",
                  flush=True)
    print(json.dumps({"root": label, "card": card, "streams": res}),
          flush=True)
    failed = [n for n, v in res.items() if v.get("pinned")]
    if failed:
        raise SystemExit(f"stream_digest: {failed} differ from PINNED")


# The JAX package's streams (hm16_2_tpu.encode.top on the CPU), made under
# PINNED_WITH; the `-m slow` tests of tests/test_torch_stream_digest.py
# reproduce every entry.
PINNED_WITH = {
    "package": "hm16_2_tpu.encode.top.Encoder",
    "JAX_PLATFORMS": "cpu",
    "python": "3.12.12",
    "jax": "0.9.0",
    "jaxlib": "0.9.0",
    "numpy": "2.0.2",
}
PINNED = {
    "AI": {
        "input": "9dad91d43aa3b6cebf5ef74c976864793dfff607df79ab45ae10a6d592ac6f37",
        "stream": "bf49695a04477b368e5ee0876e04b11826acdeaffcb853a16b363336bdd53233",
        "aus": [
            ["5ff6ee8b7379600f93f9f09c1e268ed548660325770618aabc9bd5e238c13bc2", 34527],
            ["0923928db36f470b1040b53ccea0d6b4eefb1e7f0332304182417286e47acaba", 35156],
            ["ecc8e5f59bf3506f7f9e20aad1eff69c457ce6249b997e30d0cb8e4db4e67ce8", 35038],
        ]},
    "LDP": {
        "input": "dd68e9e7eb344c1aac840a37ce9956be2ba7a8b7f883a2078f91536f99381cd6",
        "stream": "556458d626dc1f0df15e18acaeeb7efa790b1229cee896d9176a6a8e2a53eca5",
        "aus": [
            ["43c9bdaa3697728b34206f79704f115f23a9c05c27fed5c612661f6006dd8987", 34528],
            ["c0d7511b0bd26c4e413df0e7d14ceb19b2bf21899464bbd7e62d09bfd58f58d3", 1093],
            ["46cdca02c14d1ab250292f61a95eb0fa921d6b10b8fbd3db7def6f92f0328a61", 1541],
            ["91ad31b4957a1c8ca83ad0d5ec19649152ceaa961cf9efe718e6465b03426f59", 1140],
            ["fafa84fbc21754b19785f64bea046753bd505db922e2be3488c53e4458112be0", 2573],
        ]},
    "RA": {
        "input": "dc933ac64d58257f99b7a8b51b17a54feda87e59eeab890e5e4d55b1384d5754",
        "stream": "435b33425b2aabbcdf9b0745c3d36548599966c9aa0e09e683b46edb85e2f3c0",
        "aus": [
            ["8d9932b0c1696696264b61b0aa67e6399205f1d17943a211b120238db5639024", 34545],
            ["0bbc3c1b7d2a6a054034b80b6eb5b6e0ba7ff91d09c09cbcdbc4b1c9b8552c39", 4111],
            ["c6ed5e05f231d34a0ead7040acb9e377a9f1d5a32b66331a4e1e1724c201f445", 2586],
            ["d362c087a7ec2ad5be19b8e4f2610eab37303fa0c40cd5c91f75df52e9ca8cee", 1391],
            ["dc351f00f947d9ead652851582b23ddadd63ff5f8a2ab650db237951d7c6c5a5", 622],
            ["bbdc99aa4c3a27bdd05f79234a86985e4eaa498e0847f74f1a0d979ee29024a7", 597],
            ["30951ef6545126cd69fb4647a02387cf3b26f4759a51ec026e44c063b58b92cc", 1158],
            ["cae243530235c3bb648ae8d535fdbdfacc13f05562829e655b114e76cf5f5b9f", 398],
            ["d58cc6b9d1ab75cd063fcbd53c0b4e32e5d33cdff0b60111520edaa182273427", 608],
        ]},
    "per-CU search": {
        "input": "fe587ba481af8982ff42d6ec80b93f30aabb0c5b73ca36543f37594cb2b394bd",
        "stream": "d8a21df8381984acd8d143e26c4f058bd2eebc30548bebee48db48fbf14aef7a",
        "aus": [
            ["43c9bdaa3697728b34206f79704f115f23a9c05c27fed5c612661f6006dd8987", 34528],
            ["92f3c29922020a2bda4a3d1c3c8e5054f6ec017d42de59f14b0607b6503135ed", 2684],
        ]},
    "AI-Main10": {
        "input": "77bd7b6ff000e19c95ab837a53b12070df15b8540329db6e5f04035b33a81f15",
        "stream": "cea6fb74f1f31a341e4301d76585c1f1ec47ab4621cb8a6213c1c183814a53b3",
        "aus": [
            ["eb2f20c8d9224f7a88231b7f63a3e438c28423c661f712dc5f9351920ed23bd8", 51341],
            ["032a0725d71bcb363ac57f8128964f49e9ba4f1070d01111afb351f1a416a087", 51637],
            ["5729faebb9869df4907fbc8d7d53b37094a74bfdc49abf8fb3c50f78ce985c8e", 51706],
        ]},
    "RA-Main10": {
        "input": "0d6a976e3943a058a4734857b4bd42e52621992617b0676ca4f8dfd3af73279f",
        "stream": "adaa7d01c55ed037b06c1ac8d93403cd003fe8bbd42d0547d77054152a2337be",
        "aus": [
            ["b64f608ad83005c0444319cb92b3c1f0d6ebbe0d4663c811aa6e99c7a284bd26", 51360],
            ["e82b66b2a0ffe6d6ea1748c7bb76d48600a9ee3e62605a614888e9a35eff8ced", 16808],
            ["42dbb8b48112bb1bd7be00158541261a78c964d132700394a181e2e96225a40b", 8692],
            ["e35c13373ea283927166c2aa17ef5f72c7521cf17932d1a17c56744b03f83201", 5285],
            ["33036353141be893f37e895e5b5764c0c1e46827f5588e42be8c0a0b1a0e77e3", 2339],
            ["68390e93e73f1f7cfcdcc97855950cfffa8dfe906b206081bd5fa3c483e77f4a", 1820],
            ["5f07e0ad4d5238454244d5b37f817c88d14a59016108e1d15c40b3cdb42937ef", 4677],
            ["300c9f29c4334a2e4f1f5910fe6346da78a630414ac3569495e2e7337a880a6e", 1531],
            ["7c8e5100a6b3a463d533de89e4ebbf861de55db64ea34ec407e240b222a0622f", 2094],
        ]},
    "136x72 AI": {
        "input": "0d7841eddba2cc0db6975fe907e00855099be71b8b161ccb725da7ddf161597e",
        "stream": "4236c209ed28572bf80431db906329133f2fac23e3ba13e773d11b76daba742e",
        "aus": [
            ["7eaeae8981102fe02af1806c8947f83896b607e47c09e4f68c1d5e9050aa57b5", 749],
            ["765f9d00db042fd16082d89315c872f73e0e68ddb043b8e158b554d1a897da43", 683],
            ["ee9c3211c896f11ef1577926cad965cd1fdf43690c74a9621de4b9d11d9bb8a8", 652],
        ]},
    "136x72 LDP": {
        "input": "c4c624a79df499c37fd259ddfbcd97092b8545681f02ca93791cee24c4515c51",
        "stream": "552bda1731c5792caeb05d383bc82ebca61384e8f3193fe4b908811d23742375",
        "aus": [
            ["a63f56df0434a3b54340d39a6cb37f801f2eb49e072f96ea44645ec1795407ed", 750],
            ["3cf62a74a4cf93cfc7cd01d1b3b92d1009f9d7f85a563eff275dcabbb21eae37", 134],
            ["ccbc90af186c54f144adf1d3d1d34a3eb06e4247031275932feb4385578ed2b0", 194],
            ["df7ee7a9204e441ea82bddf6d7207061e56b8883d0b2757e3f1a7eb814b724e6", 181],
            ["2c98449306dac2386a1e8a3131a61ea06b2cedbdf79c138e2a356cc8d2625585", 290],
        ]},
    "136x72 RA": {
        "input": "779c56a75bf27e11bb82f979dfa4e56f1b9fc88f32064aed31d767088e398d17",
        "stream": "0c0ad55e88394c74fd21ca7c5e9524828826a9030157dc591a0fccfcf9ac66d3",
        "aus": [
            ["3f1cae920e3e5b14e7c1b96431afe6996039419905106f39d905d794eb3589f5", 768],
            ["216d10e61c0334a14d15e75da81e464513eb269468a5fb4f1e82d61b60eff3b4", 468],
            ["8789d5051b6f69d3cdd0432abaa5b72cd0043ad419776bdcfc35446ca6d5e1d4", 382],
            ["a82f273dd285910e93437c30a400fd1d71fb94d6eddfe7ccba65a9577a848e62", 212],
            ["8a1ded025d1e25baffef18618ae479c2619a46880636fab4df29b765188e5fce", 144],
            ["b066c68524006758bcbdf47b91fb57ea47b43e4dfd25580060cedc880f2def2e", 149],
            ["99291381b08d32afb12cc536b724a7dd8b191584c7ca67c3f166750e6d891f5f", 190],
            ["07a6fce32fbefca35c3eaaaa25330fad8469b92b71179ccef8e649a93c36546f", 142],
            ["75a8507f8aa9921108f45a3e50c8ae5af14ffb1e2b258f2e915591bfefd48290", 130],
        ]},
    "136x72 RC LDP": {
        "input": "c4c624a79df499c37fd259ddfbcd97092b8545681f02ca93791cee24c4515c51",
        "stream": "a345821a25affaadc2b1ba4dae7e230bfb4993f676f06c036da1a7f8f6c88c50",
        "aus": [
            ["c8179019443ac366010de40ed1a96d2160944e9cb91f60ef8ddf9ed168cfb900", 1784],
            ["68526514f616fd2f8733139525f54147044bdb60aa2b8c0073607cbb50d957ad", 1630],
            ["ffe27a35f1a32b86bf3fcb78ef9d9f2a469d3c47517d95bf928cf71299f9bc7c", 2526],
            ["26027648e004757ce40b0d1ce91a7f22bb427a245b9f172e9346d819d09b90db", 1708],
            ["620065663ed82810ff5d68ba215d9ecd536425f001de07d47ddddfca06050f8c", 1072],
        ]},
    "136x72 RC CTU LDP": {
        "input": "c4c624a79df499c37fd259ddfbcd97092b8545681f02ca93791cee24c4515c51",
        "stream": "66a8ed0934c4b2e0c3a39d5304da3c571a9415496b36b93427e86abe3423be66",
        "aus": [
            ["d5942f2a85524a827d290fdeb3098b5db7b15fa1154819b2caa07f6a401eac2b", 1797],
            ["f2e1d938334852ec5f57302a679ad0f04d5d0a4333c95cc7098bf16d20836c74", 1739],
            ["83f645eac77112fe6401d5ee1db8e23ce4a725d67a9fc8016eb629236add012f", 3493],
            ["15c39d5d21aefbb1d409701752249c689c0fa516f83b70ae9b9559b7aef54066", 2132],
            ["05d1bb72b85b8e8eab3f547030b329018f39ca673e0939271bf0cd22b8e5b6c6", 961],
        ]},
    "136x72 RC RA": {
        "input": "779c56a75bf27e11bb82f979dfa4e56f1b9fc88f32064aed31d767088e398d17",
        "stream": "e0a0688be1383981ee216cd742b027daf0fa22d0bd08857fd9e12709e3ac913f",
        "aus": [
            ["c8d21c2b2840a51237d9505b092a2735bbd5b4a9eb1049bf6df2c8df27cc1f2f", 1802],
            ["628e4b11e19ec01d5360331b04f786bae4d5375481753107fa91a378531beb3f", 2219],
            ["6a9cd039b2d34ad78a3bee469144e38fb17266443d5eff8f493b15461f368ede", 945],
            ["9b04dca4eb5cbc332c96f964026bc17c41850d21afa70d447889fc44ec977280", 574],
            ["40efd39c92c823c6d982413f32b8680216fcf05ee8241eb5c0b1c793fd5355f2", 248],
            ["331ca15efaace5458b73afd1be5af1c2c61d647992091222f32a4de832cad9ed", 316],
            ["3edef3602be23bbc3525210e885a418ca6ca17b8b7205422581bf2c682eca5cf", 706],
            ["47b85e59b035c5217c7533df79d0ef404d23b5e34614c6f55bcfc77ab84be2bf", 423],
            ["f60a06723a410e99aa9851bb47e7ae787fa8034300a821504dee504b63241b43", 461],
        ]},
    "136x72 delta_qp_rd AI": {
        "input": "dcf30c2a0ed4330d65cc2463523f0ce8eafeb5b06e86f11ea501485452552c7b",
        "stream": "db6621a663b2b893252a3a6a5311bea8cbdd425b19180cecfe51657b58e7bac5",
        "aus": [
            ["7eaeae8981102fe02af1806c8947f83896b607e47c09e4f68c1d5e9050aa57b5", 749],
            ["765f9d00db042fd16082d89315c872f73e0e68ddb043b8e158b554d1a897da43", 683],
        ]},
    "136x72 delta_qp_rd LDP": {
        "input": "0d7841eddba2cc0db6975fe907e00855099be71b8b161ccb725da7ddf161597e",
        "stream": "5870dd712f512b68a9cf9e57c30a997c6ac1c789828fa4c95d4b83212e4b6d10",
        "aus": [
            ["a63f56df0434a3b54340d39a6cb37f801f2eb49e072f96ea44645ec1795407ed", 750],
            ["a83c1219ff946ef40caa15afd9724c9380a6ba72c34bac6ca2db5b786b5e3ca4", 132],
            ["ac9ff2598f9625cb8f5efc7f9c91429e185531db5213b88a6daa8ca4185e3dc5", 205],
        ]},
    "128x128 field AI": {
        "input": "59e6b844287fbb140b0da62fb10caa16a4bcc7fa20aeed819fb8a3e0d35df94a",
        "stream": "847ca92abd9df20d7706fb5d1ca3cfd8e2f9903ee42d5ef453883780cdbe343a",
        "aus": [
            ["a1814b57fcede94ea3ef12d2c78dec8eab4fa39d0883dc4fb1a1af652f25bfc6", 686],
            ["4f24590bf8c15894f8f5e25d7a748984295a2579063b18d0dd6785c1066dcef7", 616],
            ["6a0371acfd4f78c762d4508e830e33272ad06952ed9dda0247b564ba9726956a", 671],
            ["d8c11465bba5fe16036799259d1bfd0e8512864f1f3ef9efbeca3750cfa1f31f", 620],
        ]},
    "128x128 field LDP": {
        "input": "6adc5200653b19c5400670a5ac063a0c2b37d061967e5632547755cca0f9e911",
        "stream": "818114e24b3480fd7544bf46d98c1ac9f1b085f875d70dc90bee5ae89ee4854f",
        "aus": [
            ["ef6dd8e5f24366ec8f2dd5d6fd1bdeef1901ac09e9a26f6c8baf81ab3236e2fb", 687],
            ["73416f11fe999ed6c8c6d9f41075beb58f6cfca50f6d62d7ec6c44a9d68d7a8b", 108],
            ["27292b5380f843f0644cbf3bc24284e4e25c22746ecd47f9d3970b5903816f81", 155],
            ["5fea54524f4b127fbf2739d3520f39d586174054c6c1524f6560d893e2317b54", 114],
            ["c0b4d0da81eca36d962fa71d508f46005cc689591eda8d4570d2fc4af5b4b2db", 277],
            ["06bc3fd2ade318a31e0a0a70ef08743e6381ae9ab1013b778681c6df53c85d79", 131],
        ]},
    "136x72 per-CU IPPP": {
        "input": "b8f254281fe22a3e3976a1c04cd74c8e078ac30cb513734add9435f86bd1ed31",
        "stream": "325fe134c6981898092b2f69fd652d4ef039358f8c5f879f1a565efdc967910b",
        "aus": [
            ["a63f56df0434a3b54340d39a6cb37f801f2eb49e072f96ea44645ec1795407ed", 750],
            ["7cd79440c77fa0604666dfd65174ef45cd139f761de1847f7b1facf1510f9f16", 205],
            ["ab5039046549383ee31c7a46aa782de4bb9b51d120d931a2927de7e8254dba53", 253],
            ["20bc81530b52409efe7c0243049251c7ccb908d7cce63c22163e88f3d1709f03", 231],
        ]},
    "136x72 per-CU RA": {
        "input": "779c56a75bf27e11bb82f979dfa4e56f1b9fc88f32064aed31d767088e398d17",
        "stream": "fcf19fce4883ecf524533f9c92eba662043b11a9b469e0f4761488f773725a4b",
        "aus": [
            ["3f1cae920e3e5b14e7c1b96431afe6996039419905106f39d905d794eb3589f5", 768],
            ["d80d42e89b6ff8c115c6f35cf32e1256ec96213ba5dab43cee0c95772ee1009e", 450],
            ["abccb45112a08d666866a3b262912cc448661e6d751ae2bdd25928e3a82121bb", 316],
            ["a6274371bb4001b95f63d20d0bf1e89180844651c8111930ba0ceedd8c0e0128", 198],
            ["e93afb39efdf569f687d0952d3b7c74f2d2da5f5335cab7c4df23c1ae0161306", 118],
            ["09e86a95feecc12c189a2ce4b1186935203d7dcffb3ae71281e02cdf6f78fb75", 122],
            ["5c9cba7e2d8f6ac9644b79f9ff72b7a8293e6ec9845e19d70de66f9f9314c2a9", 197],
            ["b69c04c4328e8a22a70c23e0a2c3d30ddf5f51ed12f87bed6417cfc500fa4ff9", 131],
            ["50be7614eef654d9f06a2b26205df0f4f1f59d277541b862806829f43c2c7ef1", 118],
        ]},
}

if __name__ == "__main__":
    main()

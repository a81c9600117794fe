"""The streams whose bytes are pinned, their SHA-256, and the one check
that holds the port's streams on the card to them.

`RECIPES` defines every checked stream once: its content
(`make_yuv(width, height, frames, seed=, bits=, chroma=)`), its
`EncoderConfig` keyword arguments, how it is driven (`encode_stream`,
`push_frame` / `flush`, or `encode_frame`), the environment switches
it runs under and the number of row bands its plans are banded over
(`bands`; `encode` enters the caller's `banded(bands)` around the
coding).  `LARGE` are 1080p AI, LDP, RA, the per-CU search, Main10 AI and
RA (whose configurations are what `tools/encode.py` builds from
`cfg/encoder_intra_main10.cfg` and `cfg/encoder_randomaccess_main10.cfg`
at `-wdt 1920 -hgt 1080 -q 32`), rate control at picture and CTU level,
`delta_qp_rd`, field coding at 1920x1088, and the row-banded encoder
(1080p AI over 2 bands; 1024x768 RA unbanded and over 2 and 4 bands).
`SMALL` are the streams of at most 264x264 that `check` also codes on
the CPU, among them a 136x72 AI banded over 2 bands, whose stream shows
the zero halo of the banded intra RD (it differs from the unbanded stream
of the same content).  `EXPECT` holds, beside each recipe, what its coding
launches on a CUDA device (`kernels.LAUNCHES`) and what `check` sees of
it besides its bytes; `expect` reads it.

`PINNED` holds, for each recipe, the SHA-256 of its input planes (int32,
little-endian, frame by frame in plane order), the SHA-256 and length of
each access unit the JAX package writes, and the SHA-256 of the whole
stream.  `tests/test_torch_stream_digest.py` reproduces every value from
the JAX package on the CPU (`-m slow` for all of them; the banded recipes
through the JAX twin of `banded` there).

    python3 hm16_2_tpu_torch/tools/stream_digest.py [--root DIR]
    python3 hm16_2_tpu_torch/tools/stream_digest.py --check [NAME ...]

Runs `check` on the card with the `hm16_2_tpu_torch` of the checkout DIR
(default: the one holding this file), so that a tree unpacked beside this
one is held to the same bytes and launches: the named recipes with
--check (default: all), the LARGE recipes without it.  Prints the card's
name and power limit, then a line per recipe; raises at the first recipe
that fails.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
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
    bands: int = 0              # row bands of the plans; 0: unbanded


NO_PLAN = (("HM16_NO_INTER_PLAN", "1"),)
AI = dict(qp=QP, intra_period=1)
LD = dict(qp=QP, intra_period=0, gop="ld")
RA = dict(qp=QP, intra_period=32, gop="ra8")
RC = dict(target_bps=200000)
# rate control's target at 1080p: a few Mbit/s at 30 fps
RC_1080 = dict(LD, target_bps=4_000_000, frame_rate=30, total_frames=5)
XGA = 1024, 768

RECIPES = {r.name: r for r in (
    # large
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
    Recipe("RC LDP", W, H, 5, RC_1080, "push_frame"),
    Recipe("RC CTU LDP", W, H, 5, dict(RC_1080, rc_ctu=True), "push_frame"),
    Recipe("delta_qp_rd AI", W, H, 2, dict(AI, delta_qp_rd=1), "push_frame"),
    Recipe("delta_qp_rd LDP", W, H, 5, dict(LD, delta_qp_rd=1),
           "push_frame"),
    # 544-row fields: eight 64-row CTU rows and a 32-row one (1080p's
    # 540-row fields hit the reference's fault F2)
    Recipe("field AI", W, 1088, 2, dict(AI, field_coding=True),
           "encode_stream"),
    Recipe("field LDP", W, 1088, 3, dict(LD, field_coding=True),
           "encode_stream"),
    # the row-banded encoder
    Recipe("banded AI", W, H, 2, AI, "encode_frame", bands=2),
    Recipe("1024x768 RA", *XGA, 9, RA, "push_frame"),
    Recipe("1024x768 banded RA 2", *XGA, 9, RA, "push_frame", bands=2),
    Recipe("1024x768 banded RA 4", *XGA, 9, RA, "push_frame", bands=4),
    # small: the card's bytes also equal the CPU's
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
    # s = 32 rows stop short of the picture over 2 bands: the zero halo
    Recipe("136x72 banded AI", 136, 72, 2, AI, "encode_frame", seed=2,
           bands=2),
)}
SMALL = [n for n, r in RECIPES.items() if r.width <= 264]
LARGE = [n for n in RECIPES if n not in SMALL]

# the kernels of kernels.LAUNCHES by the plans that launch them
INTRA = ("ref_buffers", "intra_size_rd", "intra_cand_rd", "plan_dp")
UNI = ("subpel_planes", "inter_uni", "inter_pick")      # K6, K7's uni modes
B_ONLY = ("inter_bi_refine", "inter_cu_rd_b")
PLAN_ONLY = ("inter_me",) + UNI + ("inter_cu_rd",) + B_ONLY
P_PLAN = INTRA + ("inter_me",) + UNI + ("inter_cu_rd",)
B_PLAN = INTRA + ("inter_me",) + UNI + B_ONLY
BAND = ("ref_buffers_band", "inter_me_band", "me_frame_band",
        "analysis_step")                    # the kernels of parallel/ only
PICKS = (("inter_pick", 0, 1),)             # one list pick per P/B plan


@dataclasses.dataclass(frozen=True)
class Expect:
    """What coding a recipe launches on a CUDA device, and what `check`
    sees of it besides its bytes."""
    need: tuple = ()            # kernels that launch at least once
    idle: tuple = ()            # kernels that never launch (an unbanded
                                # recipe also launches none of BAND)
    per_picture: tuple = ()     # (kernel, launches per I, per P/B picture)
    k1_per_plan: bool = False   # K1 once in each P/B plan
    ahead: tuple = ()           # the POCs whose RA plans go ahead
    rc: bool = False            # one rate-control update per picture
    banded: bool = False        # K1's band mode once per band per band
                                # height in each I picture, the banded ME
                                # in each P/B plan
    twin: str = ""              # the unbanded recipe whose first AUs the
                                # stream equals where PINNED says so
    frame0: bool = False        # encode_frame of frame 0 writes AU 0


BANDED_RA = Expect(INTRA + ("ref_buffers_band", "inter_me_band") + UNI
                   + B_ONLY, idle=("inter_me", "inter_cu_rd"), banded=True,
                   twin="1024x768 RA")
RC_LDP = Expect(P_PLAN, per_picture=PICKS, k1_per_plan=True, rc=True)
EXPECT = {
    "AI": Expect(INTRA, per_picture=(("plan_dp", 2, 0), ("ref_buffers", 1, 0)),
                 frame0=True),
    "LDP": Expect(P_PLAN, per_picture=PICKS, k1_per_plan=True),
    "RA": Expect(B_PLAN, per_picture=PICKS, k1_per_plan=True,
                 ahead=(3, 6, 7)),
    "per-CU search": Expect(INTRA + ("me_frame",), idle=PLAN_ONLY),
    "AI-Main10": Expect(INTRA),
    "RA-Main10": Expect(B_PLAN),
    "RC LDP": RC_LDP,
    "RC CTU LDP": RC_LDP,
    # four plans per picture (QP - 1, QP, QP + 1, the best)
    "delta_qp_rd AI": Expect(INTRA, per_picture=(
        ("plan_dp", 8, 0), ("ref_buffers", 4, 0), ("inter_pick", 0, 4))),
    "delta_qp_rd LDP": Expect(P_PLAN, per_picture=(
        ("plan_dp", 8, 4), ("ref_buffers", 4, 4), ("inter_pick", 0, 4)),
        k1_per_plan=True),
    # pictures are fields
    "field AI": Expect(INTRA, per_picture=(("ref_buffers", 1, 0),)),
    "field LDP": Expect(P_PLAN + B_ONLY, per_picture=(
        ("ref_buffers", 1, 1), ("inter_pick", 0, 1)), k1_per_plan=True),
    "banded AI": Expect(INTRA + ("ref_buffers_band",), banded=True,
                        twin="AI"),
    "1024x768 RA": Expect(),
    "1024x768 banded RA 2": BANDED_RA,
    "1024x768 banded RA 4": BANDED_RA,
    # the small recipes: held to the CPU's bytes instead
    **dict.fromkeys(SMALL, Expect()),
}


def expect(recipe, counts, pictures):
    """Hold what coding `recipe` into `pictures` pictures launched on a
    CUDA device to EXPECT: `counts` is kernels.LAUNCHES with `check`'s
    "k1 per plan", "ahead", "rc updates" and "banded inter".  Raises an
    AssertionError naming the recipe and every expectation it missed."""
    e, cfg = EXPECT[recipe.name], recipe.cfg
    period = cfg["intra_period"]
    n_i = pictures if period == 1 else \
        len(range(0, recipe.frames, period or recipe.frames))
    n_p = pictures - n_i
    want = {k: i * n_i + p * n_p for k, i, p in e.per_picture}
    want.update(dict.fromkeys(e.idle + (() if recipe.bands else BAND), 0))
    if e.k1_per_plan:
        want["k1 per plan"] = [1] * n_p * (4 if cfg.get("delta_qp_rd") else 1)
    if e.ahead:
        want["ahead"] = list(e.ahead)
    if e.rc:
        want["rc updates"] = pictures
    if e.banded:
        from hm16_2_tpu_torch.parallel.frame_shard import band_groups
        want["ref_buffers_band"] = n_i * recipe.bands * len(band_groups(
            recipe.height, recipe.width, recipe.bands))
        want["banded inter"] = n_p
    bad = [f"{k} {counts[k]}, not {v}" for k, v in want.items()
           if counts[k] != v]
    bad += [f"{k} never launched" for k in e.need if not counts[k]]
    if bad:
        raise AssertionError(f"{recipe.name}: " + "; ".join(bad))


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
def banded(mesh):
    """Point the port's two plans at the row mesh for the block:
    intra_rd.plan_frame becomes frame_shard.sharded_plan_frame, and
    inter_plan.plan_frame takes the mesh (its integer ME banded where
    plan_shard.shardable allows).  Yields a dict whose "inter" counts the
    inter plans that took the banded ME."""
    from hm16_2_tpu_torch.encode import inter_plan, intra_rd
    from hm16_2_tpu_torch.parallel import plan_shard
    from hm16_2_tpu_torch.parallel.frame_shard import sharded_plan_frame
    saved = intra_rd.plan_frame, inter_plan.plan_frame, \
        plan_shard.sharded_int_me
    seen = {"inter": 0}

    def int_me(*a):
        seen["inter"] += 1
        return saved[2](*a)

    intra_rd.plan_frame = lambda orig, sps, qp, lam, cw, cqps, device=None: \
        sharded_plan_frame(mesh, orig, sps, qp, lam, cw, cqps)
    inter_plan.plan_frame = lambda *a, **kw: saved[1](*a, **dict(kw,
                                                                mesh=mesh))
    plan_shard.sharded_int_me = int_me
    try:
        yield seen
    finally:
        intra_rd.plan_frame, inter_plan.plan_frame, \
            plan_shard.sharded_int_me = saved


def port_banded(dev):
    """banded for `encode`: the port's plans over `n` bands, each on
    `dev`."""
    from hm16_2_tpu_torch.parallel.frame_shard import make_row_mesh
    return lambda n: banded(make_row_mesh([dev] * n))


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


@contextlib.contextmanager
def coding(recipe, banded=None):
    """The recipe's environment switches and, for a banded recipe, its
    `banded(recipe.bands)` block.  Yields what that block yields (None
    when unbanded)."""
    if recipe.bands and banded is None:
        raise ValueError(f"{recipe.name} is banded: pass `banded`")
    with environ(recipe), (banded(recipe.bands) if recipe.bands
                           else contextlib.nullcontext()) as seen:
        yield seen


def encode(recipe, make_encoder, frames, banded=None):
    """The access units of `recipe` coded on `frames` by the encoder that
    `make_encoder(config(recipe))` returns; a banded recipe codes inside
    `banded(recipe.bands)`."""
    with coding(recipe, banded):
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


def decode_check(label, aus, pictures):
    """Decode the stream with the port's decoder; raises unless it holds
    `pictures` pictures, each of them hash_ok."""
    from hm16_2_tpu_torch.decode.top import Decoder
    ok = [p.hash_ok for p in Decoder().decode_stream(b"".join(aus))]
    if ok != [True] * pictures:
        raise AssertionError(f"{label}: decoded {len(ok)} pictures of "
                             f"{pictures}, hash_ok {ok}")


@contextlib.contextmanager
def _watched(dev):
    """(make_encoder, banded, seen) for `encode` on `dev`: inside the
    block, `seen` gathers K1's launches in each P/B plan, the POCs whose
    RA plans are enqueued ahead, the rate-control updates and the plans
    that took the banded ME."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_plan as P
    seen = {"k1 per plan": [], "ahead": [], "rc updates": 0,
            "banded inter": 0}
    plan_device = P._plan_device

    def plan(*a, **kw):
        k1 = K.LAUNCHES["ref_buffers"]
        out = plan_device(*a, **kw)
        seen["k1 per plan"].append(K.LAUNCHES["ref_buffers"] - k1)
        return out

    def make_encoder(kw):
        enc = port_encoder(dev)(kw)
        predispatch = enc._predispatch_ra

        def ahead(planes, poc, *a, **kw):
            res = predispatch(planes, poc, *a, **kw)
            if res is not None:
                seen["ahead"].append(poc)
            return res

        enc._predispatch_ra = ahead
        if enc.rc is not None:
            update = enc.rc.update_after_picture

            def updated(*a, **kw):
                seen["rc updates"] += 1
                return update(*a, **kw)

            enc.rc.update_after_picture = updated
        return enc

    @contextlib.contextmanager
    def banded(n):
        with port_banded(dev)(n) as b:
            yield b
        seen["banded inter"] += b["inter"]

    P._plan_device = plan
    try:
        yield make_encoder, banded, seen
    finally:
        P._plan_device = plan_device


def check(names, dev):
    """Code each named recipe once on `dev` through `encode` and hold it
    to PINNED (its input planes, each AU, the stream; the first differing
    AU named), decode every picture hash_ok with the port's decoder, and on
    a CUDA device hold its launches to EXPECT (`expect`) and a SMALL
    recipe's bytes to the CPU's; a recipe with a twin also equals the
    twin's bytes of this call where PINNED says the JAX package's two
    streams are equal.  Prints a line per recipe and raises at the first
    that fails.  Returns {name: its launch counts and `_watched`'s}."""
    import torch
    from hm16_2_tpu_torch import kernels as K
    cuda = dev.type == "cuda"
    coded, out = {}, {}
    for name in names:
        r, e = RECIPES[name], EXPECT[name]
        frames = make_frames(r)
        K.reset_launches()
        with _watched(dev) as (make_encoder, banded, seen):
            aus = encode(r, make_encoder, frames, banded)
        out[name] = counts = {**K.LAUNCHES, **seen,
                              "ahead": sorted(seen["ahead"])}
        coded[name] = aus
        got = digest(frames, aus)
        bad = mismatch(name, got)
        if bad:
            raise AssertionError(f"{bad}; recipe {r}")
        decode_check(name, aus, len(aus))
        notes = [f"{len(aus)} pictures hash_ok"]
        if cuda:
            expect(r, counts, len(aus))
            notes.append("launches as expected")
        if e.frame0:
            planes = [np.ascontiguousarray(p, dtype=np.int32)
                      for p in frames[0]]
            if port_encoder(dev)(config(r)).encode_frame(planes, 0) \
                    != aus[0]:
                raise AssertionError(f"{name}: encode_frame of frame 0 "
                                     "differs from AU 0")
            notes.append("encode_frame writes AU 0")
        if e.twin in coded:
            n = len(aus)
            same = PINNED[name]["aus"] == PINNED[e.twin]["aus"][:n]
            if same and aus != coded[e.twin][:n]:
                raise AssertionError(f"{name}: bytes differ from {e.twin}'s, "
                                     "as the JAX package's do not")
            notes.append(f"{'equal to' if same else 'unlike'} {e.twin}'s "
                         "bytes, as in the JAX package")
        if cuda and name in SMALL:
            cpu = torch.device("cpu")
            on_cpu = encode(r, port_encoder(cpu), frames, port_banded(cpu))
            if on_cpu != aus:
                raise AssertionError(
                    f"{name}: card bytes differ from the CPU's; CPU "
                    f"against PINNED: "
                    f"{mismatch(name, digest(frames, on_cpu)) or 'equal'}")
            notes.append("equal to the CPU's bytes")
        print(f"{name} {r.width}x{r.height}: {len(aus)} AUs, "
              f"{sum(map(len, aus))} bytes, input and stream equal PINNED; "
              + "; ".join(notes), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose hm16_2_tpu_torch encodes")
    ap.add_argument("--check", nargs="*", metavar="NAME",
                    help="check these recipes (default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("stream_digest: no CUDA device")
    from hm16_2_tpu_torch.tools.intra_bench import card_line
    print(card_line(), flush=True)
    check((args.check or list(RECIPES)) if args.check is not None else LARGE,
          torch.device("cuda"))


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
    "RC LDP": {
        "input": "dd68e9e7eb344c1aac840a37ce9956be2ba7a8b7f883a2078f91536f99381cd6",
        "stream": "438cd6b0d9748eb0f13e4a6dbc2c172d8e584786e8c1e62feac3034b1f846cde",
        "aus": [
            ["2fc6479b727269252a4e38f6a3866a42d91a922a88cf71baef294f724834148e", 73508],
            ["bada95d862b4102e204537ea75861a1b05c48228b6414ca74d4421d51b21a07b", 1517],
            ["32c1fcf22d0e86beeeace588ff39dd3380e85b2c59d9eba700cb024e97bb09de", 3112],
            ["54fc314932d19d89a2598ddc829859f6dd21807e7a671e299b27e640386c1401", 5199],
            ["565faa6b73bd038be22d314aba254e8211c2cd2b75c38044376c8c6593f65faa", 3412],
        ]},
    "RC CTU LDP": {
        "input": "dd68e9e7eb344c1aac840a37ce9956be2ba7a8b7f883a2078f91536f99381cd6",
        "stream": "349bd216fd3f2aec6c22f5feaad280fd988907f5d16ea9de4944d408f20530c1",
        "aus": [
            ["7b0903fb4c103075f019a80bdeece98bbc79a79d9b7bdf1186785a86489a4432", 73556],
            ["38dae80c2f45606d5c545d9060bffbe212edcdb73ee0c61c069684a3d8afc9cd", 2284],
            ["cf12ae5a564d187c8fd21ebabaab74b57025fec06258f14788de7ce25db42be0", 5999],
            ["70b1a1249f47bb19e9ae876dc14ddec9377eb423d1ced33306257a9df3b27ff1", 11021],
            ["37703813d4ff5f7f784a07dfa8e08dbc88a854fbd12c03b9286609f9c47084a2", 4256],
        ]},
    "delta_qp_rd AI": {
        "input": "fe587ba481af8982ff42d6ec80b93f30aabb0c5b73ca36543f37594cb2b394bd",
        "stream": "70b34839b26874e4fcd711b609adfbb2e1174540e5d5ad8fa6f6848a90e336f5",
        "aus": [
            ["5ff6ee8b7379600f93f9f09c1e268ed548660325770618aabc9bd5e238c13bc2", 34527],
            ["0923928db36f470b1040b53ccea0d6b4eefb1e7f0332304182417286e47acaba", 35156],
        ]},
    "delta_qp_rd LDP": {
        "input": "dd68e9e7eb344c1aac840a37ce9956be2ba7a8b7f883a2078f91536f99381cd6",
        "stream": "8af5c1d2ff2545f8ab529e125a68a63135195a0e1760eee8dd9185c7fedae797",
        "aus": [
            ["43c9bdaa3697728b34206f79704f115f23a9c05c27fed5c612661f6006dd8987", 34528],
            ["34918f15f16d7869ccdd882c800516bc7895eb9b137f03d92d9886d7ebb67b31", 1392],
            ["1bb1700d32ec0d816132e0d99a1b3ad26c5171f5b201e0a15e66c70003a40dda", 1503],
            ["9eb1bd8f09925ac5c0e2de5a84f0c094f3b96a0776e360a74e06de889e5980b8", 1446],
            ["0c5abbb041e1955114502d52faffcac5b3aa046610d7840ef7cd931ded3c5103", 3316],
        ]},
    "field AI": {
        "input": "5306be6ac0ea16c1d3172e58bed87f02d71d10fc78ba0cb657edbb0c4d573bd6",
        "stream": "ba214b4362c6b5d30f4e8177992dc1e92107dcb222afe77d866a301467dd6e5c",
        "aus": [
            ["fe8fb4cca37dce2a92a91491e09d9f25e31c351e5c38b667e79e02f8145ab06d", 21619],
            ["fd438ae7365b2cfce145b003af14aa25a16d9eddb143e01fb2565386e72ce184", 21981],
            ["dd9c97df060d21cd815d891cc1711ef3105d7a41ca9922c61d96a6bd01443bf7", 22313],
            ["fedbf76d002305e13339af5a13aa89e66e91dd85a0ef61f873c5e8389617466f", 21835],
        ]},
    "field LDP": {
        "input": "14528b5cc4f296c067fd2fd749619bb1cbb385d8b449d8f8592cf888bcb653ea",
        "stream": "02eea4caffcc8a38571961c164e562b288aa449f6faff241a1af9e6afa811487",
        "aus": [
            ["a774db1e5d664b13df864a0e8f7ffc5a843c2954a34eaa852a04950b24e3c7d6", 21620],
            ["9fde51306266c31656e82b5621f70de6b3b4cb0803ded682e3f14a1445f5bd84", 986],
            ["7bbfcabc5652b1c56f2798dea61778434bb7999074e08e840e1c9e940c9b2e9c", 1406],
            ["e4ab42c14fb8205359563977e04c12ae5c8aa965af160369635b77745c6b9925", 847],
            ["16d72b2341a61e6f502252a2bd827d743f3ac5bb67a77374eb62618ef02723f7", 2456],
            ["2ddc39beb73c82edf1d335f683a5f8adb4a3c2e3342fd17a87664ee8570bf96a", 793],
        ]},
    "banded AI": {
        "input": "fe587ba481af8982ff42d6ec80b93f30aabb0c5b73ca36543f37594cb2b394bd",
        "stream": "70b34839b26874e4fcd711b609adfbb2e1174540e5d5ad8fa6f6848a90e336f5",
        "aus": [
            ["5ff6ee8b7379600f93f9f09c1e268ed548660325770618aabc9bd5e238c13bc2", 34527],
            ["0923928db36f470b1040b53ccea0d6b4eefb1e7f0332304182417286e47acaba", 35156],
        ]},
    "1024x768 RA": {
        "input": "367122ca19a3b6dad443fb327aa641418f915cbca3113bb77554db56fac05a14",
        "stream": "2d6ab2c6cdf685582fae375b303aef4db4c2e43d600155cf7f3ad7e6d8c26b38",
        "aus": [
            ["a4fce1d67d9858c445a44fe6a5d817335aab692b266677b07d8445b5e53f2b6d", 14689],
            ["7583d6f609100f110f81f605c7f1dae22fdc539b8ce5f39a7098b5bcec854fa3", 2477],
            ["a62e6aaf71163e0bd84293f42738b17738d394c009ee2ae70f34e96c606fd414", 1737],
            ["434df3983d339a9a1ccc6052f27163bb58c7f591f749d7af55ee51fec58192cb", 886],
            ["0d1bda9a3193c070d1428cb3a09c7103d54f8771ec5708e24c0017ff2e4d9398", 377],
            ["d2d6ca4c2764c1691431481de526b1a628bc85ab7deeea5d23ae47e4b01ef348", 328],
            ["c6692e6536c8250c0d27f789b0bd771074c2720019794de8a8713abbc53456ac", 627],
            ["0323ee9d61786e3d813310967521483f5941b1d2c1bec7239ae5d2b825bb3170", 285],
            ["25db06ae9588b9f5ed76d7460a394f9a2e7f06f85a77506af0ffc6ecf3134ea7", 422],
        ]},
    "1024x768 banded RA 2": {
        "input": "367122ca19a3b6dad443fb327aa641418f915cbca3113bb77554db56fac05a14",
        "stream": "2d6ab2c6cdf685582fae375b303aef4db4c2e43d600155cf7f3ad7e6d8c26b38",
        "aus": [
            ["a4fce1d67d9858c445a44fe6a5d817335aab692b266677b07d8445b5e53f2b6d", 14689],
            ["7583d6f609100f110f81f605c7f1dae22fdc539b8ce5f39a7098b5bcec854fa3", 2477],
            ["a62e6aaf71163e0bd84293f42738b17738d394c009ee2ae70f34e96c606fd414", 1737],
            ["434df3983d339a9a1ccc6052f27163bb58c7f591f749d7af55ee51fec58192cb", 886],
            ["0d1bda9a3193c070d1428cb3a09c7103d54f8771ec5708e24c0017ff2e4d9398", 377],
            ["d2d6ca4c2764c1691431481de526b1a628bc85ab7deeea5d23ae47e4b01ef348", 328],
            ["c6692e6536c8250c0d27f789b0bd771074c2720019794de8a8713abbc53456ac", 627],
            ["0323ee9d61786e3d813310967521483f5941b1d2c1bec7239ae5d2b825bb3170", 285],
            ["25db06ae9588b9f5ed76d7460a394f9a2e7f06f85a77506af0ffc6ecf3134ea7", 422],
        ]},
    "1024x768 banded RA 4": {
        "input": "367122ca19a3b6dad443fb327aa641418f915cbca3113bb77554db56fac05a14",
        "stream": "2d6ab2c6cdf685582fae375b303aef4db4c2e43d600155cf7f3ad7e6d8c26b38",
        "aus": [
            ["a4fce1d67d9858c445a44fe6a5d817335aab692b266677b07d8445b5e53f2b6d", 14689],
            ["7583d6f609100f110f81f605c7f1dae22fdc539b8ce5f39a7098b5bcec854fa3", 2477],
            ["a62e6aaf71163e0bd84293f42738b17738d394c009ee2ae70f34e96c606fd414", 1737],
            ["434df3983d339a9a1ccc6052f27163bb58c7f591f749d7af55ee51fec58192cb", 886],
            ["0d1bda9a3193c070d1428cb3a09c7103d54f8771ec5708e24c0017ff2e4d9398", 377],
            ["d2d6ca4c2764c1691431481de526b1a628bc85ab7deeea5d23ae47e4b01ef348", 328],
            ["c6692e6536c8250c0d27f789b0bd771074c2720019794de8a8713abbc53456ac", 627],
            ["0323ee9d61786e3d813310967521483f5941b1d2c1bec7239ae5d2b825bb3170", 285],
            ["25db06ae9588b9f5ed76d7460a394f9a2e7f06f85a77506af0ffc6ecf3134ea7", 422],
        ]},
    "136x72 banded AI": {
        "input": "567647e99c3d109ce05a8deb2437c1c5dcb414ec4cb217f1511a4c85bb6dbf65",
        "stream": "c60acd7d09114ce8360f8572d2a125f15804c5627a727d50905b8670b4e3dbc2",
        "aus": [
            ["09327c4bd6762892ca7bbddaa357200e48f8cabeb6810a0788c9d9c2fd41a8c3", 644],
            ["3771c7a7dbdd9da1217b0dc2dc64a739efb7ac98c7970bf47c1dd004d4cad041", 601],
        ]},
}

if __name__ == "__main__":
    main()

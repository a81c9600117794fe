"""The P and B pictures' native inter walk as a CTU wavefront
(hm16_2_tpu_torch/encode/inter_walk.py's `commit_frame`, native/
inter_walk.cpp's `iw_wave_ctu` on native/intra_wave.cpp's scheduler)
against the raster walk it replaces, the per-CTU loop of
`Encoder._encode_one`.  With 1, 2, 3 and 4 threads the wavefront leaves
every array of each P and B picture as the raster walk does, and the AUs
are the raster walk's, in RA GOP 8 and LDP over 5 x 3 CTUs; the 136x72 RA
and LDP streams keep their pinned digests; planned intra CUs commit
through the host's callback on the workers' threads; a CTU handed back
first, mid-picture or last gives the raster walk's bytes and return code;
the counters per POC are the raster walk's, with the wavefront's own;
CTU-level rate control, AQ, two slices and two tiles keep the per-CTU
loop.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_inter_wave.py -q
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from make_fixtures import make_yuv

from hm16_2_tpu_torch import trace
from hm16_2_tpu_torch.encode import inter_walk, intra_wave
from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
from hm16_2_tpu_torch.tools import stream_digest as S

torch.set_num_threads(1)

CPU = torch.device("cpu")

# (config, width, height, pictures): 5 x 3 CTUs, three wavefront threads
CASES = {
    "ra": (dict(qp=32, intra_period=32, gop="ra8"), 320, 192, 9),
    "ldp": (dict(qp=32, intra_period=0, gop="ld"), 320, 192, 5),
}
WC, HC = 5, 3
THREADS = (1, 2, 3, 4)
COUNTERS = ("commit.walk_ctus", "commit.native_cus", "commit.python_cus",
            "commit.native_refused_ctus")


def _encode(kw, w, h, n, threads=None):
    """The AUs of n pictures of make_yuv content; threads: the wavefronts'
    thread count in place of `intra_wave.threads`' (1: the raster walk)."""
    saved = intra_wave.threads
    if threads is not None:
        intra_wave.threads = lambda wc, hc: threads
    try:
        enc = Encoder(EncoderConfig(w, h, **kw), CPU)
        aus = []
        for poc, f in enumerate(make_yuv(w, h, n, seed=42)):
            aus += enc.push_frame(
                [np.ascontiguousarray(p, dtype=np.int32) for p in f], poc)
        aus += enc.flush()
    finally:
        intra_wave.threads = saved
    return aus


def _traced(*a, **kw):
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        aus = _encode(*a, **kw)
    finally:
        trace.disable()
    return aus, trace.drain()


def _arrays(pic):
    """{name: array} of every array of the picture."""
    out = {}
    for name, v in vars(pic).items():
        if isinstance(v, np.ndarray):
            out[name] = v
        elif isinstance(v, (list, tuple, dict)):
            items = v.items() if isinstance(v, dict) else enumerate(v)
            for i, a in items:
                if isinstance(a, np.ndarray):
                    out[f"{name}{i}"] = a
    return out


def _raster(search, pic, start=0):
    """The per-CTU loop of `_encode_one` from raster index start on."""
    search.cenc.slice_idx = 0
    for idx in range(start, pic.w_ctbs * pic.h_ctbs):
        search.decide_ctu(idx % pic.w_ctbs, idx // pic.w_ctbs)


@pytest.fixture(scope="module")
def runs():
    """{case: {"raster": (AUs, record), "wave": (AUs, record, the threads
    the host's intra commit ran on, the main thread)}}, the tracer on."""
    out = {}
    commit_intra = inter_walk._commit_intra
    for case, (kw, w, h, n) in CASES.items():
        raster = _traced(kw, w, h, n, threads=1)
        seen = []

        def recorded(*a):
            seen.append(threading.get_ident())
            return commit_intra(*a)

        inter_walk._commit_intra = recorded
        try:
            wave = _traced(kw, w, h, n)
        finally:
            inter_walk._commit_intra = commit_intra
        out[case] = {"raster": raster,
                     "wave": wave + (seen, threading.get_ident())}
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_wavefront_leaves_the_raster_walks_arrays(case, runs, monkeypatch):
    """From the same P or B picture and plan, the wavefront with 1, 2, 3
    and 4 threads leaves every array of the picture as the raster walk
    does (one thread: the raster walk itself), and the AUs are the
    raster walk's."""
    kw, w, h, n = CASES[case]
    commit = inter_walk.commit_frame
    seen = []

    def compare(search, pic, nthreads=None):
        arrays = _arrays(pic)
        before = {k: a.copy() for k, a in arrays.items()}
        _raster(search, pic)
        raster = {k: a.copy() for k, a in arrays.items()}
        for t in THREADS:
            for k, a in arrays.items():
                a[...] = before[k]
            rc = commit(search, pic, t)
            assert rc == (None if t == 1 else 0), t
            _raster(search, pic, 0 if rc is None else WC * HC)
            for k, a in arrays.items():
                np.testing.assert_array_equal(
                    a, raster[k], err_msg=f"{k}, {t} threads")
        seen.append(search.sh.poc)
        return rc

    monkeypatch.setattr(inter_walk, "commit_frame", compare)
    aus = _encode(kw, w, h, n)
    assert sorted(seen) == list(range(1, n))
    assert aus == runs[case]["raster"][0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_wavefront_codes_the_raster_walks_bytes(case, runs):
    assert runs[case]["wave"][0] == runs[case]["raster"][0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_per_poc(case, runs):
    """Each P and B picture: commit.wave_ctus is every CTU,
    commit.wave_threads the grid's threads, commit.wave_wait_ms is there,
    one commit.recon span keyed "inter_walk" covers the walk, and the CTUs
    walked and handed back and the CUs committed natively and by the host
    are the raster walk's.  The raster walk records one thread and no
    wavefront CTU."""
    kw, w, h, n = CASES[case]
    c = runs[case]["wave"][1].counters
    c1 = runs[case]["raster"][1].counters
    spans = runs[case]["wave"][1].spans
    for poc in range(1, n):
        assert c[("commit.wave_ctus", poc)] == WC * HC, poc
        assert c[("commit.wave_threads", poc)] == \
            intra_wave.threads(WC, HC) > 1, poc
        assert ("commit.wave_wait_ms", poc) in c, poc
        assert len([s for s in spans if s.key == "inter_walk"
                    and s.poc == poc]) == 1, poc
        assert c1[("commit.wave_threads", poc)] == 1, poc
        assert ("commit.wave_ctus", poc) not in c1, poc
        for name in COUNTERS:
            assert c.get((name, poc)) == c1.get((name, poc)), (name, poc)
        assert c[("commit.walk_ctus", poc)] == WC * HC, poc


def test_planned_intra_cus_commit_on_the_workers_threads(runs):
    """The host's intra commit runs in the wavefront's worker threads as
    well as in the caller's, and the CUs it commits are counted."""
    for case in CASES:
        _, rec, seen, main = runs[case]["wave"]
        python = sum(v for (name, _), v in rec.counters.items()
                     if name == "commit.python_cus")
        assert python == len(seen), case
    _, rec, seen, main = runs["ra"]["wave"]
    assert seen and any(t != main for t in seen)


def test_host_commits_never_overlap(runs, monkeypatch):
    """With 16 threads (more than the host's cores) and the interpreter
    switching threads every microsecond, no two of the host's intra
    commits run at once, though each gives the interpreter away inside,
    and the bytes are the raster walk's."""
    kw, w, h, n = CASES["ra"]
    commit_intra = inter_walk._commit_intra
    inside, most, calls = [0], [0], [0]

    def exclusive(*a):
        inside[0] += 1
        most[0] = max(most[0], inside[0])
        calls[0] += 1
        time.sleep(0.0005)
        try:
            return commit_intra(*a)
        finally:
            inside[0] -= 1

    monkeypatch.setattr(inter_walk, "_commit_intra", exclusive)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        aus = _encode(kw, w, h, n, threads=16)
    finally:
        sys.setswitchinterval(interval)
    assert calls[0] > 0 and most[0] == 1
    assert aus == runs["ra"]["raster"][0]


@pytest.mark.parametrize("name", ["136x72 RA", "136x72 LDP"])
def test_pinned_streams(name):
    """The 136x72 RA and LDP streams, their P and B pictures walked as a
    wavefront of two threads, keep the JAX package's digests
    (tools/stream_digest.py's PINNED)."""
    r = S.RECIPES[name]
    aus, rec = _traced(dict(r.cfg), r.width, r.height, r.frames)
    assert S.mismatch(name, S.digest(S.make_frames(r), aus)) is None
    waved = {p for (n, p), v in rec.counters.items()
             if n == "commit.wave_ctus" and v == 6}
    assert waved == set(range(r.frames))


@pytest.mark.parametrize("k", [0, 7, WC * HC - 1])
def test_hand_back_at_k(k, monkeypatch):
    """A CTU the walk cannot take (an uncovered area at its origin in the
    first P picture's plan) at raster index k: the wavefront returns 1 + k
    after committing every CTU before it, the per-CTU loop hands the CTU
    back again and commits it on the host, and the bytes and counters are
    the raster walk's."""
    kw, w, h, n = CASES["ldp"][0], 320, 192, 2
    plan_context = inter_walk._plan_context
    edited = []

    def uncovered(search):
        plan = search.plan
        if search.sh.poc == 1 and not any(p is plan for p in edited):
            edited.append(plan)
            plan.cov = plan.cov.copy()
            plan.cov[(k // WC) * 16, (k % WC) * 16] = False
        return plan_context(search)

    monkeypatch.setattr(inter_walk, "_plan_context", uncovered)
    raster, rec1 = _traced(kw, w, h, n, threads=1)
    commit = inter_walk.commit_frame
    rcs = []

    def recorded(search, pic, nthreads=None):
        rcs.append(commit(search, pic, nthreads))
        return rcs[-1]

    monkeypatch.setattr(inter_walk, "commit_frame", recorded)
    wave, rec = _traced(kw, w, h, n)
    assert rcs == [1 + k]
    assert wave == raster
    c, c1 = rec.counters, rec1.counters
    assert c[("commit.wave_ctus", 1)] == k
    assert c[("commit.native_refused_ctus", 1)] == 1
    for name in COUNTERS + ("commit.search_cus",):
        assert c.get((name, 1)) == c1.get((name, 1)), name


@pytest.mark.parametrize("variant", ["ctu_rc", "aq", "two_slices",
                                     "two_tiles"])
def test_wavefront_stays_off(variant, monkeypatch):
    """CTU-level rate control, AQ, two slices and two tiles: no P picture
    records commit.wave_ctus, and the bytes are those of the per-CTU loop
    with the wavefront taken out."""
    extra = {"ctu_rc": dict(target_bps=200000, rc_ctu=True, total_frames=3),
             "aq": dict(aq=True), "two_slices": dict(slices=2),
             "two_tiles": dict(tile_cols=2)}[variant]
    kw = dict(CASES["ldp"][0], **extra)
    w, h, n = 136, 72, 3
    aus, rec = _traced(kw, w, h, n)
    assert not any(name == "commit.wave_ctus" and poc
                   for name, poc in rec.counters)
    monkeypatch.setattr(inter_walk, "commit_frame", lambda *a, **k: None)
    assert aus == _encode(kw, w, h, n)

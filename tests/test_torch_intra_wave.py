"""The planned I picture's native intra walk as a CTU wavefront
(hm16_2_tpu_torch/encode/intra_wave.py, native/intra_wave.cpp) against the
raster walk it replaces, dsp_core's `commit_plan_frame`.  With 1, 2, 3 and
16 threads the wavefront leaves every array of the commit context as the
raster walk does, at 8 and 10 bits and with partial CTU rows and columns;
a CTU that fails mid-frame gives the raster walk's return code and, once
the host has committed the rest, its bytes; the wavefront starts a CTU
only after its row's left neighbour and the row above up to its
above-right neighbour, and clears the `coded` flags of the CTUs after a
failure that it started; its counters say how it ran.  This file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_intra_wave.py -q
"""

import ctypes
import threading
import time

import numpy as np
import pytest
import torch

from make_fixtures import make_yuv

from hm16_2_tpu_torch import native, trace
from hm16_2_tpu_torch.encode import intra_wave
from hm16_2_tpu_torch.encode.top import CtuSearch, Encoder, EncoderConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")

# (width, height, bits): a partial CTU row and column in each
CASES = {
    "416x240": (416, 240, 8),
    "200x136": (200, 136, 8),
    "200x136-10bit": (200, 136, 10),
}
THREADS = (1, 2, 3, 16)


def _fields(pic):
    """{name: array} of every picture array the commit context writes."""
    out = {"coded": pic.coded, "depth": pic.depth,
           "part_size": pic.part_size, "pred_mode": pic.pred_mode,
           "intra_luma": pic.intra_luma, "intra_chroma": pic.intra_chroma,
           "qp": pic.qp, "slice_id": pic.slice_id, "tr_idx": pic.tr_idx}
    for c in range(3):
        out[f"cbf{c}"] = pic.cbf[c]
    for c in range(pic.num_comps):
        out[f"rec{c}"] = pic.rec[c]
        out[f"coeff{c}"] = pic.coeff[c]
    return out


def _encode(w, h, bits, frames=1):
    """The AUs of `frames` all-intra pictures of make_yuv content."""
    kw = dict(qp=32, intra_period=1)
    if bits != 8:
        kw["bit_depth"] = bits
    enc = Encoder(EncoderConfig(w, h, **kw), CPU)
    aus = []
    for poc, f in enumerate(make_yuv(w, h, frames, seed=42, bits=bits)):
        aus += enc.encode_frame(
            [np.ascontiguousarray(p, dtype=np.int32) for p in f], poc)
    return aus


@pytest.mark.parametrize("case", sorted(CASES))
def test_wavefront_leaves_the_raster_walks_arrays(case, monkeypatch):
    """From the same planned I picture, the wavefront with 1, 2, 3 and 16
    threads leaves the rec and coeff planes and every part-grid field
    exactly as the raster walk does, and returns what it returns."""
    w, h, bits = CASES[case]
    commit = intra_wave.commit_frame
    seen = []

    def compare(cctx, pic, nthreads=None):
        fields = _fields(pic)
        before = {k: a.copy() for k, a in fields.items()}
        rc0 = native.get_dsp().commit_plan_frame(ctypes.byref(cctx))
        serial = {k: a.copy() for k, a in fields.items()}
        for n in THREADS:
            for k, a in fields.items():
                a[...] = before[k]
            assert commit(cctx, pic, n) == rc0, n
            for k, a in fields.items():
                np.testing.assert_array_equal(
                    a, serial[k], err_msg=f"{k}, {n} threads")
        seen.append((pic.w_ctbs, pic.h_ctbs, rc0))
        return rc0

    monkeypatch.setattr(intra_wave, "commit_frame", compare)
    _encode(w, h, bits)
    wc, hc = -(-w // 64), -(-h // 64)
    assert seen == [(wc, hc, 0)]


def _last_cu_origin(plan, cx, cy, parts):
    """(px, py) of the CTU's last CU in z-order (the plan is dense: each
    part holds its CU's depth)."""
    px1, py1 = (cx + 1) * parts - 1, (cy + 1) * parts - 1
    n = parts >> int(plan.depth[py1, px1])
    return (cx + 1) * parts - n, (cy + 1) * parts - n


@pytest.mark.parametrize("nthreads", [3, 16])
def test_failure_mid_frame_gives_the_raster_walks_bytes(nthreads,
                                                        monkeypatch):
    """A plan made inconsistent at the last CU of a mid-frame CTU stops the
    native walk there: the wavefront returns the raster walk's code, and
    once the host has committed that CTU and the rest, the stream's bytes
    are the raster walk's."""
    w, h, bits = CASES["416x240"]
    cx, cy = 4, 1
    ctx_of = CtuSearch._commit_ctx
    commit = intra_wave.commit_frame

    def broken_ctx(self):
        if not getattr(self, "_broken", False):
            self._broken = True
            parts = self.pic.ctb // 4
            px, py = _last_cu_origin(self.plan, cx, cy, parts)
            self.plan.depth[py, px] = 4
        return ctx_of(self)

    def run(n):
        rcs = []

        def counted(cctx, pic, nthreads=None):
            rcs.append(commit(cctx, pic, n))
            return rcs[-1]

        monkeypatch.setattr(intra_wave, "commit_frame", counted)
        aus = _encode(w, h, bits)
        return aus, rcs

    monkeypatch.setattr(CtuSearch, "_commit_ctx", broken_ctx)
    serial, rc_serial = run(1)
    wave, rc_wave = run(nthreads)
    assert rc_serial == rc_wave == [1 + cy * 7 + cx]
    assert wave == serial


# ---------------------------------------------------------------------------
# the schedule, through a commit function that records it
# ---------------------------------------------------------------------------

COMMIT_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int)


def _schedule(wc, hc, parts, nthreads, fail_at=None, slow=0.3):
    """Runs the wavefront over a wc x hc grid whose commit marks the CTU's
    `coded` parts and sleeps a little (the CTU `fail_at` sleeps `slow` s,
    then fails).  Returns (rc, coded, the (start, end) events in order,
    the most CTUs that ran at once)."""
    lib = intra_wave.get_lib()
    assert lib is not None
    coded = np.zeros((hc * parts, wc * parts), dtype=np.bool_)
    events, lock, running, peak = [], threading.Lock(), [0], [0]

    def fn(ctx, x, y):
        with lock:
            events.append(("start", x, y))
            running[0] += 1
            peak[0] = max(peak[0], running[0])
        coded[y * parts:(y + 1) * parts, x * parts:(x + 1) * parts] = True
        bad = (x, y) == fail_at
        time.sleep(slow if bad else 0.002)
        with lock:
            running[0] -= 1
            events.append(("end" if not bad else "fail", x, y))
        return -1 if bad else 0

    cb = COMMIT_FN(fn)
    waited = ctypes.c_int64(-1)
    rc = lib.intra_wave_commit(
        None, ctypes.cast(cb, ctypes.c_void_p).value, wc, hc, nthreads,
        coded.ctypes.data, wc * parts, parts, ctypes.byref(waited))
    assert waited.value >= 0
    return rc, coded, events, peak[0]


@pytest.mark.parametrize("wc, hc, nthreads", [(7, 4, 4), (5, 6, 16),
                                              (1, 3, 2), (4, 1, 3),
                                              (40, 24, 32)])
def test_each_ctu_starts_after_its_neighbours(wc, hc, nthreads):
    """Every CTU starts after its left neighbour and the row above up to
    its above-right neighbour (or the row's end) have finished; every CTU
    is committed once; rows run at once where the grid allows; with more
    threads than the host has cores too."""
    rc, coded, events, peak = _schedule(wc, hc, 2, nthreads)
    assert rc == 0 and coded.all()
    ended = set()
    for kind, x, y in events:
        if kind == "end":
            ended.add((x, y))
            continue
        need = {(x - 1, y)} if x else set()
        if y:
            need |= {(i, y - 1) for i in range(min(x + 2, wc))}
        assert need <= ended, (x, y)
    assert len([e for e in events if e[0] == "start"]) == wc * hc
    if min(hc, (wc + 1) // 2, nthreads) > 1:
        assert peak > 1


@pytest.mark.parametrize("fail_at", [(5, 1), (6, 0), (0, 2)])
def test_a_failure_stops_what_follows_it_and_clears_its_coded_flags(
        fail_at):
    """After a CTU fails, the CTUs before it in raster order are all
    committed, no CTU after it starts anew, and each CTU after it that had
    started has its `coded` flags cleared; the failing CTU keeps what it
    wrote, as in the raster walk."""
    wc, hc, parts = 7, 4, 2
    rc, coded, events, _ = _schedule(wc, hc, parts, 4, fail_at=fail_at)
    k = fail_at[1] * wc + fail_at[0]
    assert rc == 1 + k
    done = {(x, y) for kind, x, y in events if kind == "end"}
    started = {(x, y) for kind, x, y in events if kind == "start"}
    for y in range(hc):
        for x in range(wc):
            idx = y * wc + x
            region = coded[y * parts:(y + 1) * parts,
                           x * parts:(x + 1) * parts]
            if idx < k:
                assert (x, y) in done and region.all(), (x, y)
            elif idx == k:
                assert region.all()
            else:
                assert not region.any(), (x, y)
    # the CTUs of the next rows that did not wait for the failing one ran
    # while it was failing, and were undone
    assert any(y * wc + x > k for x, y in started) or fail_at == (0, 2)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nthreads", [None, 1, 3])
def test_counters(nthreads, monkeypatch):
    """commit.wave_threads is the threads the walk ran with (the grid's
    and the cores' number by default, 1 when serial); commit.wave_ctus is
    the CTUs the wavefront committed, absent when serial;
    commit.wave_wait_ms is there whenever the wavefront ran."""
    w, h, bits = CASES["416x240"]
    wc, hc = 7, 4
    if nthreads is not None:
        commit = intra_wave.commit_frame
        monkeypatch.setattr(intra_wave, "commit_frame",
                            lambda cctx, pic: commit(cctx, pic, nthreads))
    want = intra_wave.threads(wc, hc) if nthreads is None else nthreads
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        _encode(w, h, bits, frames=2)
    finally:
        trace.disable()
    c = trace.drain().counters
    for poc in (0, 1):
        assert c[("commit.wave_threads", poc)] == want
        if want > 1:
            assert c[("commit.wave_ctus", poc)] == wc * hc
            assert ("commit.wave_wait_ms", poc) in c
        else:
            assert ("commit.wave_ctus", poc) not in c
            assert ("commit.wave_wait_ms", poc) not in c
        assert c[("commit.native_cus", poc)] > 0


def test_threads_follow_the_grid_and_the_cores(monkeypatch):
    """min(usable cores, CTU rows, (CTU columns + 1) // 2), at least 1."""
    monkeypatch.setattr(intra_wave.os, "sched_getaffinity",
                        lambda pid: set(range(64)))
    assert intra_wave.threads(30, 17) == 15
    assert intra_wave.threads(7, 4) == 4
    assert intra_wave.threads(1, 17) == 1
    assert intra_wave.threads(30, 1) == 1
    monkeypatch.setattr(intra_wave.os, "sched_getaffinity",
                        lambda pid: {0, 1, 2, 3, 4, 5, 6, 7})
    assert intra_wave.threads(30, 17) == 8
    monkeypatch.setattr(intra_wave.os, "sched_getaffinity", lambda pid: {0})
    assert intra_wave.threads(30, 17) == 1

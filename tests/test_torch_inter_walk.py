"""The native walk of an inter plan's CTUs (hm16_2_tpu_torch/encode/
inter_walk.py, native/inter_walk.cpp) against the host mapping it
replaces.  Its merge and AMVP lists equal MvPredictor's for every PU the
host derives them for (TMVP and the scaled predictors reached); streams
coded with the walk equal those of the host mapping and the JAX
package's pinned digests (tools/stream_digest.py), and
HM16_NO_COMMIT_ENGINE=1 keeps the walk off; a planned intra CU commits
inside the walk; a CTU handed back, before it wrote or after, leaves the
same bytes; every CTU of an inter picture is either walked or handed
back.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_inter_walk.py -q
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from make_fixtures import make_yuv

from hm16_2_tpu_torch import trace
from hm16_2_tpu_torch.decode import mvpred
from hm16_2_tpu_torch.encode import inter_plan, inter_walk
from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
from hm16_2_tpu_torch.tools import stream_digest as S

torch.set_num_threads(1)

CPU = torch.device("cpu")

# (config, width, height, pictures): RA GOP 8 and LDP, as the pinned
# 136x72 recipes code them, and LDP at 64x64
CASES = {
    "ra": (dict(qp=32, intra_period=32, gop="ra8"), 136, 72, 9),
    "ldp": (dict(qp=32, intra_period=0, gop="ld"), 136, 72, 5),
    "ldp64": (dict(qp=32, intra_period=0, gop="ld"), 64, 64, 5),
}
PINS = {"ra": "136x72 RA", "ldp": "136x72 LDP"}


def _encode(case, walk=True):
    """The AUs of a case, and the encoder; walk=False commits every CTU
    through the host mapping (neither the wavefront nor the per-CTU walk
    engages)."""
    kw, w, h, n = CASES[case]
    enc = Encoder(EncoderConfig(w, h, **kw), CPU)
    saved = inter_walk.commit_ctu, inter_walk.commit_frame
    if not walk:
        inter_walk.commit_ctu = lambda *a: False
        inter_walk.commit_frame = lambda *a, **k: None
    try:
        aus = []
        for poc, f in enumerate(make_yuv(w, h, n, seed=42)):
            aus += enc.push_frame(
                [np.ascontiguousarray(p, dtype=np.int32) for p in f], poc)
        aus += enc.flush()
    finally:
        inter_walk.commit_ctu, inter_walk.commit_frame = saved
    return aus


@pytest.fixture(scope="module")
def walked():
    """{case: (AUs, trace record, rect CUs the walk committed, inter POCs)}
    with the walk on (its wavefront where the grid has two CTU rows and
    columns, the per-CTU walk elsewhere) and the tracer recording."""
    out = {}
    saved = inter_walk.commit_ctu, inter_walk.commit_frame
    for case in CASES:
        rects, pocs = [0], set()

        def count_rects(pic, cx, cy):
            c = pic.ctb // 4
            ps = pic.part_size[cy * c:(cy + 1) * c, cx * c:(cx + 1) * c]
            rects[0] += int(np.isin(ps, (1, 2)).sum())

        def commit(search, cx, cy):
            pocs.add(search.sh.poc)
            if not saved[0](search, cx, cy):
                return False
            count_rects(search.pic, cx, cy)
            return True

        def frame(search, pic, nthreads=None):
            rc = saved[1](search, pic, nthreads)
            if rc is not None:
                pocs.add(search.sh.poc)
                for idx in range(pic.w_ctbs * pic.h_ctbs
                                 if rc == 0 else rc - 1):
                    count_rects(pic, idx % pic.w_ctbs, idx // pic.w_ctbs)
            return rc

        inter_walk.commit_ctu, inter_walk.commit_frame = commit, frame
        trace.disable()
        trace.drain()
        trace.enable()
        try:
            aus = _encode(case)
        finally:
            trace.disable()
            inter_walk.commit_ctu, inter_walk.commit_frame = saved
        out[case] = (aus, trace.drain(), rects[0], pocs)
    return out


@pytest.fixture(scope="module")
def host():
    """{case: AUs} of the host mapping (the walk off)."""
    return {case: _encode(case, walk=False) for case in CASES}


# ---------------------------------------------------------------------------
# (a) the lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ra", "ldp64"])
def test_lists_equal_mvpredictor(case, monkeypatch):
    """Every merge and AMVP list the host mapping derives equals the
    native derivation on the same committed state; the colocated
    predictor, scaled and unscaled, and the scaled spatial predictor are
    among them."""
    merge, amvp = mvpred.MvPredictor.merge_candidates, \
        mvpred.MvPredictor.amvp_candidates
    tmvp, dsf = mvpred.MvPredictor._tmvp, mvpred.dist_scale_factor
    ctxs, seen = {}, {"merge": 0, "amvp": 0, "tmvp": 0, "tmvp_scaled": 0,
                      "spatial_scaled": 0}

    def ctx_of(self):
        key = (id(self.pic), id(self.rc))
        if key not in ctxs:
            ctxs[key] = (self, inter_walk.lists_context(self.pic, self.rc))
        assert ctxs[key][1] is not None
        return ctxs[key][1]

    def merge_twin(self, x, y, w, h, pu_idx, part_size, cu_x, cu_y,
                   merge_idx=-1):
        got = merge(self, x, y, w, h, pu_idx, part_size, cu_x, cu_y,
                    merge_idx)
        if merge_idx == -1:
            want = got[:self.rc.sh.max_num_merge_cand]
            assert inter_walk.merge_list(ctx_of(self), x, y, w, h, pu_idx,
                                         part_size) == want, (x, y, w, h)
            seen["merge"] += 1
        return got

    def amvp_twin(self, x, y, w, h, lx, ref_idx):
        got = amvp(self, x, y, w, h, lx, ref_idx)
        assert inter_walk.amvp_list(ctx_of(self), x, y, w, h, lx,
                                    ref_idx) == [tuple(m) for m in got], \
            (x, y, w, h, lx, ref_idx)
        seen["amvp"] += 1
        return got

    def tmvp_count(self, *a):
        got = tmvp(self, *a)
        seen["tmvp"] += got is not None
        return got

    def dsf_count(cur_poc, cur_ref_poc, col_poc, col_ref_poc):
        s = dsf(cur_poc, cur_ref_poc, col_poc, col_ref_poc)
        if s != 4096:
            seen["spatial_scaled" if col_poc == cur_poc
                 else "tmvp_scaled"] += 1
        return s

    monkeypatch.setattr(mvpred.MvPredictor, "merge_candidates", merge_twin)
    monkeypatch.setattr(mvpred.MvPredictor, "amvp_candidates", amvp_twin)
    monkeypatch.setattr(mvpred.MvPredictor, "_tmvp", tmvp_count)
    monkeypatch.setattr(mvpred, "dist_scale_factor", dsf_count)
    _encode(case, walk=False)
    assert len(ctxs) == CASES[case][3] - 1        # every P and B picture
    assert min(seen.values()) > 0, seen


def test_native_lists_see_slices():
    """A neighbour in another slice is not available to the native lists,
    as to MvPredictor's."""
    captured = {}
    saved = inter_walk.commit_ctu

    def commit(search, cx, cy):
        captured.setdefault("search", search)
        return False

    inter_walk.commit_ctu = commit
    try:
        kw, w, h, _ = CASES["ldp64"]
        enc = Encoder(EncoderConfig(w, h, **kw), CPU)
        for poc, f in enumerate(make_yuv(w, h, 2, seed=42)):
            enc.push_frame([np.ascontiguousarray(p, dtype=np.int32)
                            for p in f], poc)
        enc.flush()
    finally:
        inter_walk.commit_ctu = saved
    search = captured["search"]
    pic, mvp = search.pic, search.mvp
    ctx = inter_walk.lists_context(pic, mvp.rc)
    x, y = 32, 32
    before = inter_walk.merge_list(ctx, x, y, 16, 16, 0, 0)
    assert before == mvp.merge_candidates(x, y, 16, 16, 0, 0, 8, 8)
    pic.slice_id[y // 4:, :] += 1         # the PU's rows: another slice
    after = inter_walk.merge_list(ctx, x, y, 16, 16, 0, 0)
    assert after == mvp.merge_candidates(x, y, 16, 16, 0, 0, 8, 8)
    assert inter_walk.amvp_list(ctx, x, y, 16, 16, 0, 0) == \
        mvp.amvp_candidates(x, y, 16, 16, 0, 0)
    assert after != before


# ---------------------------------------------------------------------------
# (b) the streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_walk_codes_the_host_mappings_bytes(walked, host, case):
    aus, rec, rects, _ = walked[case]
    assert aus == host[case]
    walk_ctus = sum(v for (n, _), v in rec.counters.items()
                    if n == "commit.walk_ctus")
    assert walk_ctus > 0


@pytest.mark.parametrize("case", list(PINS))
def test_walk_codes_the_pinned_bytes(walked, case):
    """The JAX package's bytes, as tools/stream_digest.py pins them."""
    name = PINS[case]
    r = S.RECIPES[name]
    assert (dict(r.cfg), r.width, r.height, r.frames) == CASES[case]
    frames = S.make_frames(r)
    assert S.mismatch(name, S.digest(frames, walked[case][0])) is None


def test_walk_codes_rect_partitions(walked):
    """2NxN and Nx2N CUs went through the walk, PU by PU."""
    assert sum(walked[case][2] for case in CASES) > 0


@pytest.mark.parametrize("case", ["ra", "ldp64"])
def test_no_commit_engine_keeps_the_walk_off(case, monkeypatch):
    """HM16_NO_COMMIT_ENGINE=1 turns the native engine off, and the walk
    with it: every CU maps and reconstructs in Python, as with the walk
    taken out.  (The Python reconstruction does not code the native
    engine's bytes, walk or no walk.)"""
    monkeypatch.setenv("HM16_NO_COMMIT_ENGINE", "1")
    trace.drain()
    trace.enable()
    try:
        aus = _encode(case)
    finally:
        trace.disable()
    rec = trace.drain()
    assert aus == _encode(case, walk=False)
    assert not any(n == "commit.walk_ctus" for n, _ in rec.counters)
    assert not any(s.key == "inter_walk" for s in rec.spans)


# ---------------------------------------------------------------------------
# (c) hand-backs
# ---------------------------------------------------------------------------

def _first_cu_of_b(monkeypatch, edit):
    """edit(plan, n) on every B picture's plan whose first CU, n x n parts
    at the corner, is a planned inter CU; the list of edits made."""
    fetch = inter_plan.fetch_plan
    edits = []

    def edited(*a):
        plan = fetch(*a)
        if plan.pred_inter[0, 0]:
            edit(plan, 16 >> int(plan.depth[0, 0]))
            edits.append(plan)
        return plan

    monkeypatch.setattr(inter_plan, "fetch_plan", edited)
    return edits


def _traced_ra():
    trace.drain()
    trace.enable()
    try:
        aus = _encode("ra")
    finally:
        trace.disable()
    return aus, trace.drain()


def test_planned_intra_commits_inside_the_walk(monkeypatch):
    """A planned intra CU in a B picture is committed by the host's intra
    commit in its z-order place, and its CTU stays in the walk."""
    def intra(plan, n):
        plan.pred_inter = plan.pred_inter.copy()
        plan.pred_inter[:n, :n] = False

    edits = _first_cu_of_b(monkeypatch, intra)
    host = _encode("ra", walk=False)
    aus, rec = _traced_ra()
    assert aus == host and edits
    c = rec.counters
    for poc in range(1, 9):
        assert c[("commit.walk_ctus", poc)] == 6, poc
        assert c.get(("commit.python_cus", poc), 0) >= 1, poc
    assert not any(n == "commit.native_refused_ctus" and v
                   for (n, _), v in c.items())


def test_unsignalled_motion_is_handed_back(monkeypatch):
    """A planned reference index out of range: the walk hands the CTU
    back before it writes, and the host falls back to its local search."""
    def bad_ref(plan, n):
        plan.ref = plan.ref.copy()
        plan.pu = plan.pu.copy()
        plan.ref[:, :n, :n] = 99
        plan.pu[:, 3, :n, :n] = 99

    edits = _first_cu_of_b(monkeypatch, bad_ref)
    host = _encode("ra", walk=False)
    n_host = len(edits)
    aus, rec = _traced_ra()
    assert aus == host
    refused = [v for (n, _), v in rec.counters.items()
               if n == "commit.native_refused_ctus"]
    assert sum(refused) == len(edits) - n_host == n_host > 0


def test_hand_back_after_writing_restores_the_ctu(host, monkeypatch):
    """A walk whose residual step fails after the first CU it committed
    restores the CTU's fields and planes; the host then codes the same
    bytes.  (Every CTU takes the per-CTU walk here; the wavefront's
    hand-backs are in tests/test_torch_inter_wave.py.)"""
    monkeypatch.setattr(inter_walk, "commit_frame", lambda *a, **k: None)
    saved = inter_walk.commit_ctu
    handed = []

    def commit(search, cx, cy):
        got = getattr(search, "_iwalk", None)
        if got is None or got[0] is not search.plan:
            got = search._iwalk = (search.plan,
                                   inter_walk._plan_context(search))
        ctx = got[1]
        if ctx is None or (cx, cy) != (0, 0):
            return saved(search, cx, cy)
        real = ctx.commit_cu
        fn = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, *[ctypes.c_int]
                              * 6)(real)
        calls = [0]

        def second_fails(ic, px, py, log2, skip_hint, is_merge, psize):
            calls[0] += 1
            if calls[0] > 1:
                return -1
            return fn(ic, px, py, log2, skip_hint, is_merge, psize)

        hook = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                *[ctypes.c_int] * 6)(second_fails)
        pic = search.pic
        fields = {k: np.copy(v) for k, v in vars(pic).items()
                  if isinstance(v, np.ndarray)}
        planes = [p.copy() for p in pic.rec + pic.coeff]
        cbf = [pic.cbf[c].copy() for c in range(3)]
        ctx.commit_cu = ctypes.cast(hook, ctypes.c_void_p).value
        try:
            n = inter_walk.get_lib().iw_commit_ctu(
                ctypes.byref(ctx), cx, cy, float(search.lam),
                int(search.cur_qp))
        finally:
            ctx.commit_cu = real
        if calls[0] > 1:
            assert n == -1
            handed.append(search.sh.poc)
            for k, v in fields.items():
                assert np.array_equal(getattr(pic, k), v), k
            for a, b in zip(pic.rec + pic.coeff, planes):
                assert np.array_equal(a, b)
            for c in range(3):
                assert np.array_equal(pic.cbf[c], cbf[c])
            return False
        return n >= 0

    monkeypatch.setattr(inter_walk, "commit_ctu", commit)
    aus = []
    kw, w, h, n = CASES["ra"]
    enc = Encoder(EncoderConfig(w, h, **kw), CPU)
    for poc, f in enumerate(make_yuv(w, h, n, seed=42)):
        aus += enc.push_frame([np.ascontiguousarray(p, dtype=np.int32)
                               for p in f], poc)
    aus += enc.flush()
    assert handed
    assert aus == host["ra"]


# ---------------------------------------------------------------------------
# (d) the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_walked_and_refused_ctus_are_the_pictures(walked, case):
    """commit.walk_ctus plus commit.native_refused_ctus is each inter
    picture's CTUs; an I picture counts neither."""
    _, rec, _, pocs = walked[case]
    kw, w, h, n = CASES[case]
    ctb = 64
    n_ctus = -(-w // ctb) * -(-h // ctb)
    c = rec.counters
    assert pocs == set(range(1, n))
    for poc in range(n):
        got = c.get(("commit.walk_ctus", poc), 0) + \
            c.get(("commit.native_refused_ctus", poc), 0)
        assert got == (n_ctus if poc in pocs else 0), poc


def test_walk_is_a_commit_recon_span(walked):
    """The walk's C call is a commit.recon span keyed "inter_walk" with no
    child, and the CUs it commits count as native."""
    rec = walked["ra"][1]
    spans = [s for s in rec.spans if s.key == "inter_walk"]
    assert spans and {s.name for s in spans} == {"commit.recon"}
    idx = {i for i, s in enumerate(rec.spans) if s.key == "inter_walk"}
    assert not any(s.parent in idx for s in rec.spans)


def test_unavailable_library_falls_back(host, monkeypatch):
    """Without the library the walk does not engage, records why, and the
    host mapping codes the same bytes."""
    monkeypatch.setattr(inter_walk, "_lib", None)
    monkeypatch.setattr(inter_walk, "_failed", False)
    monkeypatch.setattr(trace, "UNAVAILABLE", {})
    monkeypatch.setattr(inter_walk, "_SRC", os.path.join(
        os.path.dirname(inter_walk._SRC), "no_such_source.cpp"))
    monkeypatch.setattr(inter_walk, "_SO", os.path.join(
        os.path.dirname(inter_walk._SO), "no_such_library.so"))
    assert _encode("ldp64") == host["ldp64"]
    assert "inter_walk" in trace.drain().unavailable

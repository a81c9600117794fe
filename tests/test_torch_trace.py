"""The port's tracer (hm16_2_tpu_torch.trace): spans and counters of the
encoder's host work.  Tracing on and off code the same bytes; off, nothing
is recorded; on, every span has its parent and its POC, each picture's
commit parts lie inside its commit, the stage spans equal `stage_ms`, each
plan is dispatched before it is waited for, the CUs counted by the code
that reconstructed them cover each picture once, and the CTUs counted by
syntax writer are the picture's CTUs.  On the card each plan's kernels run
inside its dispatch-to-wait interval, read through the benchmark's device
trace (`portbench/pb_trace.py`, `pb_spans.py`) with the spans put on its
clock.  This file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

from make_fixtures import make_yuv

from hm16_2_tpu_torch import trace
from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 136, 72
PORTBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")


def _planes(frame):
    return [np.ascontiguousarray(p, dtype=np.int32) for p in frame]


def _cfg(kind):
    if kind == "ai":
        return EncoderConfig(W, H, qp=32, intra_period=1)
    if kind in ("ra", "python"):
        return EncoderConfig(W, H, qp=32, intra_period=32, gop="ra8")
    return EncoderConfig(64, 64, qp=32, intra_period=0, gop="ld")


def _encode(kind, device=CPU):
    """AUs of one stream and, per coded POC, its CU depths and stage_ms
    change.  ai: three pictures through the pipelined encode_stream; ra:
    IDR + GOP 8 through push_frame and flush (python: the same, with the
    native commit engine off); search: IDR + one P picture of the per-CU
    search (no inter plan)."""
    enc = Encoder(_cfg(kind), device)
    depth, stages = {}, {}
    add, one = enc.dpb.add, enc._encode_one

    def dpb_add(ref):
        depth[ref.poc] = ref.depth.copy()
        return add(ref)

    def encode_one(planes, poc, sh, **kw):
        before = dict(enc.stage_ms)
        au = one(planes, poc, sh, **kw)
        stages[poc] = {k: v - before.get(k, 0.0)
                       for k, v in enc.stage_ms.items()}
        return au

    enc.dpb.add, enc._encode_one = dpb_add, encode_one
    if kind == "ai":
        aus = list(enc.encode_stream(make_yuv(W, H, 3, seed=42)))
    else:
        n = 2 if kind == "search" else 9
        side = (64, 64) if kind == "search" else (W, H)
        aus = []
        for poc, f in enumerate(make_yuv(*side, n, seed=42)):
            aus += enc.push_frame(_planes(f), poc)
        aus += enc.flush()
    return aus, depth, stages, enc.sps.log2_ctb


@pytest.fixture(scope="module")
def runs():
    """{kind: (AUs off, AUs on, record on, record off, depths, stages,
    log2 CTB)} for each of KINDS."""
    from hm16_2_tpu_torch import native
    native.get_dsp()
    out = {}
    dsp = native._dsp, native._dsp_failed
    env = os.environ.get("HM16_NO_INTER_PLAN")
    try:
        for kind in KINDS:
            if kind == "search":
                os.environ["HM16_NO_INTER_PLAN"] = "1"
            if kind == "python":
                native._dsp, native._dsp_failed = None, True
            trace.disable()
            trace.drain()
            off = _encode(kind)[0]
            rec_off = trace.drain()
            trace.enable()
            on, depth, stages, log2_ctb = _encode(kind)
            trace.disable()
            out[kind] = (off, on, trace.drain(), rec_off, depth, stages,
                         log2_ctb)
            if env is None:
                os.environ.pop("HM16_NO_INTER_PLAN", None)
            else:
                os.environ["HM16_NO_INTER_PLAN"] = env
    finally:
        trace.disable()
        native._dsp, native._dsp_failed = dsp
        if env is None:
            os.environ.pop("HM16_NO_INTER_PLAN", None)
        else:
            os.environ["HM16_NO_INTER_PLAN"] = env
    return out


KINDS = ("ai", "ra", "search", "python")


@pytest.mark.parametrize("kind", KINDS)
def test_tracing_codes_the_same_bytes(runs, kind):
    off, on = runs[kind][:2]
    assert on == off and len(on) == (3 if kind == "ai" else
                                     2 if kind == "search" else 9)


@pytest.mark.parametrize("kind", KINDS)
def test_off_records_nothing(runs, kind):
    rec = runs[kind][3]
    assert rec.spans == []
    assert {k for k in rec.counters if k[0] != "native.unavailable"} == set()


@pytest.mark.parametrize("kind", KINDS)
def test_spans_have_parents_and_pocs(runs, kind):
    rec = runs[kind][2]
    names = {s.name for s in rec.spans}
    assert {"call", "picture", "plan.dispatch", "plan.wait", "commit",
            "filters.deblock", "filters.sao", "emit", "finish"} <= names
    for s in rec.spans:
        assert s.poc is not None, s
        assert s.end_ns is not None and s.end_ns >= s.start_ns, s
        assert (s.parent is None) == (s.name == "call"), s
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
    pocs = sorted(s.poc for s in rec.spans if s.name == "picture")
    assert pocs == sorted(runs[kind][5])
    parents = {s.name: {rec.spans[p.parent].name for p in rec.spans
                        if p.name == s.name and p.parent is not None}
               for s in rec.spans}
    assert parents["picture"] == {"call"}
    for name in trace.STAGE_SPANS + ("plan.wait",):
        assert parents[name] == {"picture"}, name
    assert parents["plan.dispatch"] <= {"call", "picture"}


@pytest.mark.parametrize("kind", KINDS)
def test_commit_parts_inside_their_commit(runs, kind):
    rec = runs[kind][2]
    commits = {s.poc: s for s in rec.spans if s.name == "commit"}
    parts = [s for s in rec.spans if s.name.startswith("commit.")]
    assert parts
    for s in parts:
        c = commits[s.poc]
        assert c.start_ns <= s.start_ns and s.end_ns <= c.end_ns
        p = s.parent
        while rec.spans[p].name != "commit":
            p = rec.spans[p].parent
        assert rec.spans[p] is c
    want = {"ai": {"commit.recon"}, "ra": {"commit.map", "commit.recon"},
            "python": {"commit.map", "commit.recon"},
            "search": {"commit.recon", "commit.search"}}[kind]
    assert {s.name for s in parts} == want
    # commit's own time, commit.map's self time, commit.recon's time and a
    # search's whole time make up the commit: its parts nest this way and
    # children of one span do not overlap
    kids = {}
    for i, s in enumerate(rec.spans):
        kids.setdefault(s.parent, []).append(i)
    allowed = {"commit": {"commit.map", "commit.recon", "commit.search"},
               "commit.map": {"commit.recon"}, "commit.recon": set()}
    for i, s in enumerate(rec.spans):
        if s.name not in allowed:
            continue
        mine = sorted((rec.spans[k] for k in kids.get(i, ())),
                      key=lambda k: k.start_ns)
        assert {k.name for k in mine} <= allowed[s.name], s
        for a, b in zip(mine, mine[1:]):
            assert a.end_ns <= b.start_ns, (a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_stage_spans_equal_stage_ms(runs, kind):
    rec, stages = runs[kind][2], runs[kind][5]
    for poc, d in stages.items():
        mine = {n: sum(s.end_ns - s.start_ns for s in rec.spans
                       if s.name == n and s.poc == poc) / 1e6
                for n in trace.STAGE_SPANS}
        for stage, names in (("commit", ("commit",)),
                             ("filters", ("filters.deblock", "filters.sao")),
                             ("emit", ("emit",)), ("finish", ("finish",))):
            assert abs(sum(mine[n] for n in names) - d[stage]) <= 1e-3, \
                (poc, stage)
        plan = sum(s.end_ns - s.start_ns for s in rec.spans
                   if s.poc == poc and s.name.startswith("plan.")
                   and rec.spans[s.parent].name == "picture") / 1e6
        assert plan <= d.get("plan", 0.0) + 1e-3


@pytest.mark.parametrize("kind", KINDS)
def test_each_plan_dispatched_before_its_wait(runs, kind):
    rec = runs[kind][2]
    waits = [s for s in rec.spans if s.name == "plan.wait"]
    assert waits
    for w in waits:
        d = [s for s in rec.spans if s.name == "plan.dispatch"
             and s.poc == w.poc]
        assert d and min(s.start_ns for s in d) <= w.start_ns
        assert all(s.end_ns <= w.start_ns for s in d)


@pytest.mark.parametrize("kind", KINDS)
def test_cus_by_path_cover_each_picture_once(runs, kind):
    rec, depth, log2_ctb = runs[kind][2], runs[kind][4], runs[kind][6]
    side = (64, 64) if kind == "search" else (W, H)
    c = rec.counters
    for poc, d in depth.items():
        cus = int(trace._cus(d, log2_ctb, side[1] // 4, side[0] // 4).sum())
        native = c.get(("commit.native_cus", poc), 0)
        python = c.get(("commit.python_cus", poc), 0)
        assert native + python == cus, (poc, native, python, cus)
        assert c.get(("commit.search_cus", poc), 0) <= python
    if kind == "search":
        assert c[("commit.search_cus", 1)] == c[("commit.python_cus", 1)] > 0
    if kind == "ra":
        assert sum(v for (n, p), v in c.items()
                   if n == "commit.native_cus" and p > 0) > 0
    if kind == "python":          # every CU reconstructed in Python
        assert not any(v for (n, _), v in c.items()
                       if n == "commit.native_cus")
        assert any(s.key == "python" for s in rec.spans)


@pytest.mark.parametrize("kind", KINDS)
def test_emitted_ctus_by_writer(runs, kind):
    rec = runs[kind][2]
    side = (64, 64) if kind == "search" else (W, H)
    ctb = 1 << runs[kind][6]
    n_ctus = -(-side[0] // ctb) * -(-side[1] // ctb)
    for poc in runs[kind][5]:
        nat = rec.counters[("emit.native_ctus", poc)]
        py = rec.counters[("emit.python_ctus", poc)]
        # I slices: the native writer; P and B slices: the Python one
        assert (nat, py) == ((n_ctus, 0) if kind == "ai" or poc == 0
                             else (0, n_ctus))


def test_pipelined_dispatch_belongs_to_the_next_picture(runs):
    """encode_stream dispatches picture N+1's plan in the call that codes
    picture N: that dispatch carries N+1 and has the call as its parent."""
    rec = runs["ai"][2]
    for s in rec.spans:
        if s.name == "plan.dispatch":
            call = rec.spans[s.parent]
            assert call.name == "call" and s.poc in (call.poc, call.poc + 1)
    assert sorted(s.poc for s in rec.spans if s.name == "plan.dispatch") == \
        [0, 1, 2]


def test_unavailable_is_kept_once(monkeypatch):
    monkeypatch.setattr(trace, "UNAVAILABLE", {})
    trace.unavailable("dsp_core", "first")
    trace.unavailable("dsp_core", "second")
    rec = trace.drain()
    assert rec.unavailable == {"dsp_core": "first"}
    assert rec.counters[("native.unavailable", None)] == 1


def test_native_loader_records_why(monkeypatch):
    from hm16_2_tpu_torch import native
    monkeypatch.setattr(trace, "UNAVAILABLE", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("HM16_NO_NATIVE", "1")
    assert native.get_lib() is None
    assert trace.drain().unavailable == {
        "cabac_core": "HM16_NO_NATIVE is set"}


def test_drain_forgets_open_spans():
    trace.drain()
    span = trace.open("call", 3)
    rec = trace.drain()
    assert [s.end_ns for s in rec.spans] == [None]
    trace.close(span)
    assert trace.drain().spans == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("ai", "ra"))
def test_plan_kernels_run_inside_dispatch_to_wait(cuda, kind):
    """Under the benchmark's device trace, every plan's kernels start on
    the device after its plan.dispatch opens and end before its plan.wait
    closes, within 0.1 ms, once the spans are put on the device trace's
    clock: the kernel launches fix that offset to within 0.1 ms.  The
    kernel spans carry the launches kernels.LAUNCHES counts."""
    import time

    from hm16_2_tpu_torch import kernels
    if PORTBENCH not in sys.path:
        sys.path.insert(0, PORTBENCH)
    import pb_spans
    import pb_trace
    _encode(kind, cuda)                      # builds and warms the kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    dev = pb_trace.DeviceTrace()
    dev.start()
    trace.drain()
    trace.enable()
    t0 = time.perf_counter()
    _encode(kind, cuda)
    trace.disable()
    dev.stop()
    rec = trace.drain()
    events = dev.events(t0, time.perf_counter())
    fit = pb_spans.clock_offset(rec, events, t0,
                                pb_spans.launch_lags(dev.prof))
    assert fit is not None and fit[1] - fit[0] < 100_000, fit
    margins = pb_spans.causality(rec, events, t0, (fit[0] + fit[1]) // 2)
    assert margins, margins
    worst = min(min(m) for m in margins.values())
    plain = min(min(m) for m in pb_spans.causality(rec, events,
                                                   t0).values())
    print(f"{kind}: {len(margins)} plans, offset {fit[0] / 1e6:.4f}.."
          f"{fit[1] / 1e6:.4f} ms, worst margin {worst / 1e6:.4f} ms "
          f"({plain / 1e6:.4f} ms uncorrected)")
    assert worst >= -100_000, list(margins.items())
    assert sum(v for (n, _), v in rec.counters.items()
               if n == "kernel.launches") == sum(kernels.LAUNCHES.values())
    assert sum(s.n for s in rec.spans if s.name == "kernel") == \
        sum(kernels.LAUNCHES.values())
    keys = {s.key for s in rec.spans if s.name == "kernel"}
    assert keys <= set(kernels.LAUNCHES) and "ref_buffers" in keys

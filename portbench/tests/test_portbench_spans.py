"""The readers of the encoder's tracer records (`pb_spans.py`) on a
hand-made record, and span_report on the CPU at a small size: the
encoder's tracer is on over the window only, its spans cover the window,
name every idle gap and account for the commit, and run.py's result is the
one it would give."""

import pytest
import torch
from pb_testlib import FakeTrace, small_cell

import pb_spans
import pb_trace
import span_report

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["ai-main-1080p.qp32", "ra-main-1080p.qp32"])
def test_span_report_small(monkeypatch, name):
    from hm16_2_tpu_torch import trace
    cfg, traffic, metrics = small_cell(name, 192, 128)
    monkeypatch.setattr(pb_trace, "DeviceTrace", FakeTrace)
    got = span_report.traced_cell(cfg, traffic, metrics, 3000000019, 3, 1,
                                  CPU, log=lambda s: None)
    assert not trace.ON
    res, rec = got[:2]
    assert res["correct"] is True
    rep = span_report.report(*got)
    pics = [s for s in rec.spans if s.name == "picture"]
    assert len(pics) == res["attempted"] > 0
    pp = rep["per_picture"]
    assert pp["commit_ms"] == pytest.approx(
        res["metrics"]["commit_ms"]["value"], rel=1e-6)
    assert pp["commit.self_ms"] + pp["commit.map_ms"] + \
        pp["commit.recon_ms"] + pp["commit.search_ms"] == \
        pytest.approx(pp["commit_ms"], rel=1e-9)
    assert pp["emit.native_ctus"] + pp["emit.python_ctus"] == 6
    assert rep["coverage"] > 0.95
    assert rep["idle_gaps"] and all(n != "no span" for n, _ in
                                    rep["idle_gaps"])
    assert "causality" not in rep          # FakeTrace has no profiler


def _fake():
    """call(0) > [dispatch(0) > kernel, picture(0) > [wait, commit >
    [map > recon, search > recon > kernel], emit], dispatch(1) > kernel];
    times in ms."""
    from hm16_2_tpu_torch import trace
    ms = 1_000_000
    S = trace.Span
    spans = [S("call", 0, 0, 100 * ms, None, None),
             S("plan.dispatch", 0, 1 * ms, 3 * ms, 0, None),
             S("kernel", 0, 1 * ms, 2 * ms, 1, "ref_buffers", 2),
             S("picture", 0, 5 * ms, 90 * ms, 0, None),
             S("plan.wait", 0, 5 * ms, 9 * ms, 3, None),
             S("commit", 0, 10 * ms, 60 * ms, 3, None),
             S("commit.map", 0, 11 * ms, 21 * ms, 5, None),
             S("commit.recon", 0, 15 * ms, 19 * ms, 6, "python"),
             S("commit.search", 0, 30 * ms, 50 * ms, 5, None),
             S("commit.recon", 0, 31 * ms, 33 * ms, 8, None),
             S("emit", 0, 70 * ms, 80 * ms, 3, None),
             S("plan.dispatch", 1, 91 * ms, 92 * ms, 0, None),
             S("kernel", 1, 91.2 * ms, 91.4 * ms, 11, "inter_pick", 1),
             S("kernel", 0, 31.5 * ms, 32 * ms, 9, "intra_size_rd", 1)]
    counters = {("commit.python_cus", 0): 7, ("emit.python_ctus", 0): 3,
                ("kernel.launches", 0): 3, ("kernel.launches", 1): 1}
    return trace.Record(spans, counters, {})


def test_per_picture_reads_the_record():
    from hm16_2_tpu_torch import trace
    got = pb_spans.per_picture(_fake())
    assert got == pytest.approx({
        "plan.dispatch_ms": 2.0, "plan.wait_ms": 4.0, "kernels.host_ms": 1.5,
        "commit_ms": 50.0, "commit.self_ms": 20.0, "commit.map_ms": 6.0,
        "commit.recon_ms": 4.0, "commit.search_ms": 20.0,
        "commit.python_cus": 7.0, "emit.python_ctus": 3.0,
        "kernel.launches": 3.0})
    assert pb_spans.per_picture(trace.Record([], {}, {})) is None


def test_innermost_and_coverage():
    rec, ms = _fake(), 1_000_000
    assert pb_spans.innermost(rec, 31.7 * ms) == "kernel"
    assert pb_spans.innermost(rec, 32.5 * ms) == "commit.recon"
    assert pb_spans.innermost(rec, 40 * ms) == "commit.search"
    assert pb_spans.innermost(rec, 65 * ms) == "picture"
    assert pb_spans.innermost(rec, 95 * ms) == "call"
    assert pb_spans.innermost(rec, 150 * ms) is None
    assert pb_spans.coverage(rec, 0, 200 * ms) == pytest.approx(0.5)


def test_causality_hands_kernels_to_plans_in_launch_order():
    """Device intervals as DeviceTrace.events gives them, seconds from a
    window opened 0.5 ms into the spans' clock.  The search's kernel, run
    on the device between plan 0's and plan 1's, belongs to neither."""
    rec, ms, start = _fake(), 1_000_000, 0.0005

    def ev(name, a_ms, b_ms):
        return (name, a_ms / 1e3 - start, b_ms / 1e3 - start)

    dev = [ev("void hm::a(int)", 2, 4), ev("memcpy", 4, 5),
           ev("void hm::b(int)", 4, 8), ev("void hm::s(int)", 31.6, 31.9),
           ev("void hm::c(int)", 91.5, 93)]
    got = pb_spans.causality(rec, dev, start)
    assert list(got) == [0]
    assert got[0] == pytest.approx((1 * ms, 1 * ms), abs=2)
    late = dev[:2] + [ev("void hm::b(int)", 4, 10)] + dev[3:]
    assert pb_spans.causality(rec, late, start)[0][1] == \
        pytest.approx(-1 * ms, abs=2)
    early = [ev("void hm::a(int)", 0.5, 4)] + dev[1:]
    assert pb_spans.causality(rec, early, start)[0][0] == \
        pytest.approx(-0.5 * ms, abs=2)
    assert pb_spans.causality(rec, dev[:4], start) is None


def test_clock_offset_from_the_launches():
    """Each launch (its kernel's start less its lag) lies in the kernel
    span that made it: a's in [1, 2] ms, b's in [1, 2], the search's in
    [31.5, 32], c's in [91.2, 91.4]; the offsets that keep all four there
    are [-0.1, +0.05] ms, and a device clock 1 ms ahead moves them by 1 ms
    and leaves the corrected causality as it was."""
    rec, ms, start = _fake(), 1_000_000, 0.0005

    def ev(name, a_ms, b_ms, shift=0.0):
        return (name, (a_ms + shift) / 1e3 - start,
                (b_ms + shift) / 1e3 - start)

    def dev(shift=0.0):
        return [ev("void hm::a(int)", 2, 4, shift),
                ev("void hm::b(int)", 4, 8, shift),
                ev("void hm::s(int)", 31.6, 31.9, shift),
                ev("void hm::c(int)", 91.5, 93, shift)]

    lags = [0.5 * ms, 2.2 * ms, 0.05 * ms, 0.2 * ms]
    lo, hi = pb_spans.clock_offset(rec, dev(), start, lags)
    assert (lo, hi) == (pytest.approx(-0.1 * ms, abs=2),
                        pytest.approx(0.05 * ms, abs=2))
    lo, hi = pb_spans.clock_offset(rec, dev(1.0), start, lags)
    assert (lo, hi) == (pytest.approx(0.9 * ms, abs=2),
                        pytest.approx(1.05 * ms, abs=2))
    plain = pb_spans.causality(rec, dev(), start)[0]
    moved = pb_spans.causality(rec, dev(1.0), start, 1 * ms)[0]
    assert moved == (pytest.approx(plain[0], abs=2),
                     pytest.approx(plain[1], abs=2))
    assert pb_spans.clock_offset(rec, dev(), start, [3 * ms] + lags[1:]) \
        is None
    assert pb_spans.clock_offset(rec, dev()[:3], start, lags[:3]) is None


class _Event:
    def __init__(self, kind, name, start, corr):
        self.kind, self.n, self.t, self.c = kind, name, start, corr

    def device_type(self):
        return f"DeviceType.{self.kind}"

    def name(self):
        return self.n

    def start_ns(self):
        return self.t

    def correlation_id(self):
        return self.c


def test_launch_lags_pair_kernels_with_their_launch_calls():
    import types
    evs = [_Event("CPU", "cudaLaunchKernel", 100, 7),
           _Event("CPU", "cudaLaunchKernel", 150, 8),
           _Event("CUDA", "void hm::b(int)", 400, 8),
           _Event("CUDA", "void hm::a(int)", 300, 7),
           _Event("CUDA", "Memcpy HtoD", 350, 9)]

    def prof(events):
        results = types.SimpleNamespace(events=lambda: events)
        return types.SimpleNamespace(
            profiler=types.SimpleNamespace(kineto_results=results))

    assert pb_spans.launch_lags(prof(evs)) == [200, 250]
    assert pb_spans.launch_lags(prof(evs[1:])) is None

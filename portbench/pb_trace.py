"""Reads the device trace of the window: `torch.profiler` with CUDA
activity only, every kernel, copy and set on the card as an interval."""

from __future__ import annotations

import time


class DeviceTrace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self):
        self.prof.start()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.prof.stop()

    def events(self, start_perf, end_perf):
        """[(name, start_s, end_s)] of the device intervals inside the
        window, in seconds from its start.  Profiler times are wall-clock
        nanoseconds; the offset to perf_counter is read here."""
        off = time.time_ns() - time.perf_counter_ns()
        w0 = int(start_perf * 1e9) + off
        w1 = int(end_perf * 1e9) + off
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).rsplit(".", 1)[-1] != "CUDA":
                continue
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            a, b = max(a, w0), min(b, w1)
            if b > a:
                out.append((e.name(), (a - w0) * 1e-9, (b - w0) * 1e-9))
        return out


def union(events):
    """Merged busy intervals [(start_s, end_s)]."""
    spans = sorted((a, b) for _, a, b in events)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(events):
    return sum(b - a for a, b in union(events))


def top_ops(events, n=10):
    tot = {}
    for name, a, b in events:
        tot[name] = tot.get(name, 0.0) + (b - a)
    return sorted(([k, v] for k, v in tot.items()), key=lambda x: -x[1])[:n]


def idle_gaps(events, window_s, stage_at, n=10):
    """The n longest idle gaps, each named by the host stage running at its
    middle (`stage_at(t)`, t in seconds from the window's start)."""
    edges = [0.0] + [x for ab in union(events) for x in ab] + [window_s]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[stage_at((a + b) / 2), b - a] for a, b in gaps[:n]]

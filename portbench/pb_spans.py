"""Reads a record of the encoder's tracer (`hm16_2_tpu_torch.trace`):
the per-picture figures of its spans and counters, the span open at an
instant, the share of a window its spans cover, and whether each plan's
kernels ran on the device inside its host interval.  Spans are on the
clock of `time.perf_counter_ns()`; the device intervals are those of
`pb_trace.DeviceTrace.events`, seconds from the start of the window they
were read over.  That reading puts the profiler's clock on perf_counter's
through the wall clock; `clock_offset` measures what is left between the
two from the kernel launches, and `causality` takes it on the spans'
side."""

from __future__ import annotations


def _dur(s):
    return s.end_ns - s.start_ns


def _children(spans):
    kids = [[] for _ in spans]
    for i, s in enumerate(spans):
        if s.parent is not None:
            kids[s.parent].append(i)
    return kids


def _under(spans, i, name):
    """Whether a span named `name` encloses span i."""
    p = spans[i].parent
    while p is not None:
        if spans[p].name == name:
            return True
        p = spans[p].parent
    return False


def per_picture(rec, pocs=None):
    """Per-picture means over `pocs` (default: every POC with a picture
    span): milliseconds of plan.dispatch (every site, by target POC),
    plan.wait, kernel wrappers, commit, commit's own time, commit.map's
    self time, commit.recon outside commit.search, commit.search; and each
    counter.  None when the record has no picture."""
    if pocs is None:
        pocs = {s.poc for s in rec.spans if s.name == "picture"}
    pocs = set(pocs)
    if not pocs:
        return None
    kids = _children(rec.spans)
    ms = {k: 0.0 for k in ("plan.dispatch_ms", "plan.wait_ms",
                           "kernels.host_ms", "commit_ms", "commit.self_ms",
                           "commit.map_ms", "commit.recon_ms",
                           "commit.search_ms")}
    for i, s in enumerate(rec.spans):
        if s.poc not in pocs or s.end_ns is None:
            continue
        d = _dur(s) / 1e6
        if s.name == "plan.dispatch":
            ms["plan.dispatch_ms"] += d
        elif s.name == "plan.wait":
            ms["plan.wait_ms"] += d
        elif s.name == "kernel" and not _under(rec.spans, i, "kernel"):
            ms["kernels.host_ms"] += d
        elif s.name == "commit":
            ms["commit_ms"] += d
            ms["commit.self_ms"] += d - sum(_dur(rec.spans[k])
                                            for k in kids[i]) / 1e6
        elif s.name == "commit.map":
            ms["commit.map_ms"] += d - sum(_dur(rec.spans[k])
                                           for k in kids[i]) / 1e6
        elif s.name == "commit.recon" and \
                not _under(rec.spans, i, "commit.search"):
            ms["commit.recon_ms"] += d
        elif s.name == "commit.search" and \
                not _under(rec.spans, i, "commit.search"):
            ms["commit.search_ms"] += d
    out = {k: v / len(pocs) for k, v in ms.items()}
    names = sorted({n for n, p in rec.counters if p is not None})
    for n in names:
        out[n] = sum(v for (n2, p), v in rec.counters.items()
                     if n2 == n and p in pocs) / len(pocs)
    return out


def innermost(rec, t_ns):
    """Name of the innermost span open at t_ns, or None."""
    best, depth = None, -1
    for s in rec.spans:
        if s.end_ns is None or not s.start_ns <= t_ns < s.end_ns:
            continue
        d, p = 0, s.parent
        while p is not None:
            d, p = d + 1, rec.spans[p].parent
        if d > depth:
            best, depth = s.name, d
    return best


def coverage(rec, t0_ns, t1_ns):
    """Share of [t0_ns, t1_ns] inside some span."""
    ivs = sorted((max(s.start_ns, t0_ns), min(s.end_ns, t1_ns))
                 for s in rec.spans if s.end_ns is not None
                 and s.parent is None)
    covered, end = 0, t0_ns
    for a, b in ivs:
        if b <= end:
            continue
        covered += b - max(a, end)
        end = b
    return covered / max(t1_ns - t0_ns, 1)


def launch_lags(prof, kernel_tag="hm::"):
    """ns from each kernel's launch call to its start on the device, in
    order of start, from a stopped `torch.profiler` session's own records
    (differences on its one clock: nothing is converted).  None when a
    kernel has no launch record."""
    launch, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).rsplit(".", 1)[-1] == "CUDA":
            if kernel_tag in e.name():
                kernels.append((e.start_ns(), e.correlation_id()))
        elif "LaunchKernel" in e.name():
            launch[e.correlation_id()] = e.start_ns()
    if any(c not in launch for _, c in kernels):
        return None
    return [t - launch[c] for t, c in sorted(kernels)]


def _launched(rec, events, start_perf, kernel_tag):
    """[(kernel span index, device start, device end)] of each kernel, on
    the spans' clock: the device runs the kernels (names holding
    kernel_tag) in the order they were launched, so in order of start
    they go to the `kernel` spans in the order those opened, each span
    taking its `n` launches.  None when the device ran another number of
    kernels than the spans launched."""
    t0 = int(start_perf * 1e9)
    ks = sorted((t0 + round(a * 1e9), t0 + round(b * 1e9))
                for name, a, b in events if kernel_tag in name)
    spans = sorted((s.start_ns, i) for i, s in enumerate(rec.spans)
                   if s.name == "kernel" and s.n)
    made = [i for _, i in spans for _ in range(rec.spans[i].n)]
    if len(made) != len(ks):
        return None
    return [(i, a, b) for i, (a, b) in zip(made, ks)]


def clock_offset(rec, events, start_perf, lags, kernel_tag="hm::"):
    """(lo, hi), the ns that put the spans on the device trace's clock
    when added to them: every launch call (its kernel's start less its
    lag, `launch_lags`) lies inside the kernel span that made it for each
    offset in [lo, hi].  None when the kernels and spans do not pair up or
    no offset fits."""
    got = _launched(rec, events, start_perf, kernel_tag)
    if got is None or lags is None or len(lags) != len(got):
        return None
    lo = max(a - lag - rec.spans[i].end_ns
             for (i, a, _), lag in zip(got, lags))
    hi = min(a - lag - rec.spans[i].start_ns
             for (i, a, _), lag in zip(got, lags))
    return (lo, hi) if lo <= hi else None


def causality(rec, events, start_perf, offset_ns=0, kernel_tag="hm::"):
    """For each plan, whether its kernels ran on the device inside its
    host interval, with the spans moved by offset_ns onto the device's
    clock (`clock_offset`).  A plan's kernels are those launched inside a
    plan.dispatch or plan.wait of its POC (`_launched` pairs kernels with
    spans).  Returns {poc: (first device start - first dispatch open, last
    wait close - last device end)} in ns for every plan with a wait; a
    negative number breaks causality.  None when the device ran another
    number of kernels than the host launched."""
    got = _launched(rec, events, start_perf, kernel_tag)
    if got is None:
        return None
    spans = rec.spans
    opened, waited, first, last = {}, {}, {}, {}
    for s in spans:
        if s.name == "plan.dispatch" and s.end_ns is not None:
            t = s.start_ns + offset_ns
            opened[s.poc] = min(opened.get(s.poc, t), t)
        elif s.name == "plan.wait" and s.end_ns is not None:
            t = s.end_ns + offset_ns
            waited[s.poc] = max(waited.get(s.poc, t), t)
    for i, a, b in got:
        p = spans[i].parent
        while p is not None and spans[p].name not in ("plan.dispatch",
                                                      "plan.wait"):
            p = spans[p].parent
        if p is None:
            continue                 # launched outside any plan
        poc = spans[p].poc
        first[poc] = min(first.get(poc, a), a)
        last[poc] = max(last.get(poc, b), b)
    return {p: (first[p] - opened[p], waited[p] - last[p])
            for p in first if p in opened and p in waited}

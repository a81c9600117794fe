"""Runs one cell as run.py does, with the encoder's tracer
(`hm16_2_tpu_torch.trace`) on over the measured window, and reports what
its spans and counters show beside run.py's own result:

    python3 portbench/span_report.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The tracer is switched on when the window starts (after run.py's own
start of the window: its device trace, its set-up clock) and off when it
ends; nothing else of the run changes.  The last line of standard output
is one JSON object: run.py's result; "per_picture", the tracer's
per-picture figures over the window's pictures (`pb_spans.per_picture`);
with --trace 1 also "coverage", the share of the window inside a call
span; "clock_offset_ms", the range of offsets that put the spans on the
device trace's clock, read from the kernel launches
(`pb_spans.clock_offset`); "idle_gaps", run.py's ten longest device idle
gaps named by the innermost span open at each one's middle; and
"causality", the worst margins in ms by which each plan's kernels ran on
the device inside its plan.dispatch open ... plan.wait close
(`pb_spans.causality` over `DeviceTrace.events` from the window's start
to the trace's stop, the spans moved by the middle of that range;
negative breaks it; "causality_uncorrected" without the move).  With
--trace 0 the run's fps, set beside run.py's at the same seed, gives the
tracer's cost when on.

run.py does not turn the tracer on itself, so this script stands in for
it from outside: while run.run_cell runs, it replaces
`pb_drive.Client.window` and `pb_trace.DeviceTrace` with wrappers.  Their
signatures are pinned below, and a run in which either wrapper was not
used fails.  Once run.py enables the tracer over its window and hands the
record to its readers, this script goes.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import pb_drive  # noqa: E402
import pb_spans  # noqa: E402
import pb_trace  # noqa: E402
import run  # noqa: E402

# what traced_cell wraps: the window's call and the device trace run.py
# makes, starts, stops and reads
for _f, _want in ((pb_drive.Client.window, ["self", "seconds", "on_start"]),
                  (pb_trace.DeviceTrace.__init__, ["self"]),
                  (pb_trace.DeviceTrace.stop, ["self"]),
                  (pb_trace.DeviceTrace.events,
                   ["self", "start_perf", "end_perf"])):
    assert list(inspect.signature(_f).parameters) == _want, (_f, _want)


def traced_cell(cfg, traffic, metrics, seed, seconds, trace_on, device,
                **kw):
    """run.run_cell with the tracer on over the window: returns (result,
    record, window (t_start, t_end) perf_counter seconds, the device
    trace or None).  The device trace keeps `stopped`, the perf_counter
    reading after it stopped."""
    from hm16_2_tpu_torch import trace
    seen = {}
    window0, device_trace0 = pb_drive.Client.window, pb_trace.DeviceTrace

    def window(self, secs, on_start=None):
        def start():
            if on_start is not None:
                on_start()
            trace.drain()
            trace.enable()
        try:
            out = window0(self, secs, start)
        finally:
            trace.disable()
        seen["window"] = out[:2]
        return out

    class Kept(device_trace0):
        def __init__(self):
            super().__init__()
            seen["device"] = self

        def stop(self):
            super().stop()
            self.stopped = time.perf_counter()

    pb_drive.Client.window, pb_trace.DeviceTrace = window, Kept
    try:
        res = run.run_cell(cfg, traffic, metrics, seed, seconds, trace_on,
                           device, **kw)
    finally:
        pb_drive.Client.window, pb_trace.DeviceTrace = window0, device_trace0
    dev = seen.get("device")
    if "window" not in seen or bool(trace_on) != (dev is not None) or \
            (dev is not None and not hasattr(dev, "stopped")):
        raise RuntimeError("run.run_cell no longer opens its window or "
                           "makes its device trace as span_report wraps "
                           "them")
    return res, trace.drain(), seen["window"], dev


def _worst(m):
    """The worst margins of a causality reading, in ms."""
    if not m:
        return None
    return {"plans": len(m),
            "worst_start_ms": min(v[0] for v in m.values()) / 1e6,
            "worst_end_ms": min(v[1] for v in m.values()) / 1e6}


def report(res, rec, window, dev_trace):
    """The figures named in the module's docstring."""
    out = {"result": res, "per_picture": pb_spans.per_picture(rec),
           "spans": len(rec.spans), "unavailable": rec.unavailable}
    if dev_trace is None:
        return out
    t0, t1 = (round(t * 1e9) for t in window)
    out["coverage"] = pb_spans.coverage(rec, t0, t1)
    off = 0
    if hasattr(dev_trace, "prof"):
        every = dev_trace.events(window[0], dev_trace.stopped)
        fit = pb_spans.clock_offset(rec, every, window[0],
                                    pb_spans.launch_lags(dev_trace.prof))
        out["clock_offset_ms"] = fit and [x / 1e6 for x in fit]
        off = fit and (fit[0] + fit[1]) // 2 or 0
        out["causality"] = _worst(pb_spans.causality(rec, every, window[0],
                                                     off))
        out["causality_uncorrected"] = _worst(
            pb_spans.causality(rec, every, window[0]))

    def name(t):
        return pb_spans.innermost(rec, t0 + round(t * 1e9) - off) or \
            "no span"

    out["idle_gaps"] = pb_trace.idle_gaps(dev_trace.events(*window),
                                          (t1 - t0) / 1e9, name)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    _, cfg, traffic, metrics = run.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("span_report.py: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    got = traced_cell(cfg, traffic, metrics, args.seed, args.seconds,
                      args.trace, device,
                      kind=torch.cuda.get_device_name(device),
                      log=lambda s: print(s, flush=True))
    out = report(*got)
    out["card"] = run.card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

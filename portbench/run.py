"""Runs one cell of the benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (configs/<name>.json: the encoder's keywords
as HM-16.2's cfg file gives them at 1920x1080, how the encoder is driven,
how the output is checked) and a traffic mix (traffic/<name>.json: the
content and the QP it is coded at).  Set-up makes the frames from the seed
on the card, builds `hm16_2_tpu_torch.encode.top.Encoder` and warms it up on
the cell's own shapes; then one closed-loop client hands over frames for
`--seconds` seconds.  With --trace 0 the last line of standard output
carries the end-to-end metrics, with --trace 1 the per-layer metrics read
from a device trace of the window.  After the window the plain reference
judges a seeded sample of the window's pictures (pb_check); each number
compared is printed beside its limit.

Exit codes: 0 with a result; 2 no CUDA device or not enough of them; 3 a
forbidden module was loaded; 1 any other failure.  No result is printed
unless the exit code is 0.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):     # the checkout, then portbench
    if _p not in sys.path:
        sys.path.insert(0, _p)

import pb_spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hm16_2_tpu")
STAGES = ("plan", "commit", "filters", "emit", "finish")


def process_age_s():
    """Seconds since this process started (Linux's /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN
                   and sys.modules[m] is not None})


def card_line():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def frames_needed(cfg, seconds):
    """Warm-up, then ten times today's rate over the window, in whole intra
    periods."""
    n = cfg["warmup_pictures"] + int(10 * cfg["today_fps"] * seconds + 1)
    period = max(1, int(cfg["encoder"]["intra_period"]))
    return -(-n // period) * period


class Ctx:
    """What a metric reader may read about the window."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def stage_per_picture(self, stage):
        if not self.pictures:
            return None
        return self.stage_ms.get(stage, 0.0) / self.pictures


def _stage_at(recs, t_start):
    """Host stage running at t seconds from the window's start, taken from
    the per-picture stage_ms deltas: inside each call that codes a picture
    the plan comes first, and commit, filters, emit and finish run back to
    back at its end (the encoder's order); the rest is "encoder other"."""
    spans = []
    for r in recs:
        d = {st: (r["stage1"].get(st, 0.0) - r["stage0"].get(st, 0.0)) / 1e3
             for st in STAGES}
        a, b = r["t0"] - t_start, r["t1"] - t_start
        spans.append((a, a + d["plan"], "plan"))
        t = b - sum(d[st] for st in STAGES[1:])
        spans.append((a + d["plan"], t, "encoder other"))
        for st in STAGES[1:]:
            spans.append((t, t + d[st], st))
            t += d[st]

    def at(t):
        for a, b, st in spans:
            if a <= t < b:
                return st
        return "between pictures"
    return at


def run_cell(cfg, traffic, metrics, seed, seconds, trace, device,
             age_s=process_age_s, kind=None, log=print, control=False):
    """One run of a cell (its configuration, traffic and metric entries);
    returns the result dict (the last line), or raises."""
    import numpy as np
    import torch

    import pb_content
    import pb_drive
    import pb_trace
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig

    log(f"set-up: run_cell entered at {age_s():.3f} s")
    w, h = cfg["width"], cfg["height"]
    n_frames = frames_needed(cfg, seconds)
    frames = pb_content.make_frames(traffic, w, h, n_frames, seed, device)
    log(f"set-up: {n_frames} frames made at {age_s():.3f} s")
    kw = dict(cfg["encoder"], qp=int(traffic["qp"]))
    enc = Encoder(EncoderConfig(w, h, **kw), device)
    rec = pb_drive.Recorder(enc)
    client = pb_drive.Client(enc, rec, frames, cfg["drive"])
    try:
        client.warm_up(cfg["warmup_pictures"])
        log(f"set-up: warm-up of {len(rec.order)} pictures done at "
            f"{age_s():.3f} s")
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        tracer = pb_trace.DeviceTrace() if trace else None
        launches0 = [0]
        setup = [0.0]

        def on_start():
            if tracer is not None:
                tracer.start()
            setup[0] = age_s()
            launches0[0] = rec.launches()

        t_start, t_end, window, units = client.window(seconds, on_start)
        launches = rec.launches() - launches0[0]
        if tracer is not None:
            tracer.stop()
        elif device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        client.close()
        rec.close()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    peak = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    pics = rec.pics
    order = list(rec.order)
    wrecs = [pics[p] for p in window]
    n = len(window)
    window_s = t_end - t_start
    lat = [(client.returned[p] - client.handed[p]) * 1e3 for p in window]
    bits = sum(len(pics[p]["au"]) * 8 for p in window)
    log(f"window: {n} pictures in {window_s:.6f} s, {bits} bits; latency "
        f"samples {len(lat)} in {units} units (RA: GOPs), median "
        f"{statistics.median(lat):.3f} ms")
    result = {"correct": False, "attempted": n, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": kind or str(device), "count": 1,
                         "memory_peak_bytes": peak}}
    if not trace:
        values = {"fps": n / window_s,
                  "latency_ms.p90": float(np.percentile(lat, 90)),
                  "setup_s": setup[0]}
        for m in metrics["end_to_end"]:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    else:
        events = tracer.events(t_start, t_end)
        stage_ms = {}
        for r in wrecs:
            for k, v in r["stage1"].items():
                stage_ms[k] = stage_ms.get(k, 0.0) + v - r["stage0"].get(k,
                                                                         0.0)
        plans = [(rec.refs[p], pics[p]["slice_type"] == 0)     # B: bi
                 for p in window if p in rec.refs]
        busy = pb_trace.busy_s(events)
        ctx = Ctx(pictures=n, stage_ms=stage_ms, launches=launches,
                  device_events=events, window_s=window_s, busy_s=busy,
                  plans=plans, width=w, height=h)
        for m in metrics["per_layer"]:
            v = pb_spec.reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = window_s
        result["breakdown"] = {
            "device_ops": pb_trace.top_ops(events),
            "idle_gaps": pb_trace.idle_gaps(events, window_s,
                                            _stage_at(wrecs, t_start))}
    # the program's state goes before the reference runs
    del enc, client, rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    import pb_check
    ccfg = dict(cfg, qp=int(traffic["qp"]))
    t_ref = time.perf_counter()
    nums, failed, lines = pb_check.check(ccfg, frames, pics, order, window,
                                         seed, device)
    lines.append(f"reference check took {time.perf_counter() - t_ref:.3f} s")
    for line in lines:
        log(line)
    if control:
        cnums, _, clines = pb_check.check(ccfg, frames, pics, order, window,
                                          seed, device, control=True)
        for line in clines:
            log("control: " + line)
        result["control_checks"] = cnums
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    result["correct"] = all(nums[k] <= pb_check.LIMITS[k] for k in nums)
    result["failed"] = len(failed & set(window))
    result["checks"] = {k: {"value": nums[k], "limit": pb_check.LIMITS[k]}
                        for k in nums}
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__("forbidden modules loaded: " + ", ".join(found))
        self.found = found


def load_cell(name, root=pb_spec.ROOT):
    bench = pb_spec.load(root)
    cell = pb_spec.cell(bench, name)
    metrics = {k: pb_spec.metrics(bench, cell, k)
               for k in ("end_to_end", "per_layer")}
    return cell, pb_spec.config(bench, cell, root), \
        pb_spec.traffic(cell, root), metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, cfg, traffic, metrics = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"run.py: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    try:
        result = run_cell(cfg, traffic, metrics, args.seed,
                          args.seconds, args.trace, device,
                          kind=torch.cuda.get_device_name(device),
                          log=lambda s: print(s, flush=True))
    except ForbiddenModules as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 3
    card = card_line()          # read after the window: not set-up
    print(f"card: {card}")
    for name, v in result["metrics"].items():
        print(f"metric {name} {v['value']} {v['unit']} [{card}]")
    checks = result["checks"]
    for k, v in checks.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the row-banded device stages at 1, 2, 4 and 8 bands.

Counterpart of `hm16_2_tpu/tools/scaling_bench.py`.  Times the two banded
stages, the intra frame plan with its stage 1 row-banded
(`frame_shard.sharded_plan_frame`, halos passed between bands) and the
banded frame ME (`me_shard.sharded_me_frame`, references copied to every
band), on a random picture, at each band count that the device list and
`h % (n * 64) == 0` allow, and prints one JSON line per stage (host wall
clock per frame, ending in a device sync).

Band i runs on the i-th device of `--Devices` (default: every visible GPU).
A device named more than once takes several bands: `--Devices
cuda:0,cuda:0,cuda:0,cuda:0` runs up to four bands on one card, and that
curve is the plumbing cost of banding, not multi-GPU scaling (the JSON
line says so).  `--Devices cpu,cpu` runs the plain versions on the CPU.

Usage: python -m hm16_2_tpu_torch.tools.scaling_bench [--size WxH] [-n N]
           [--Devices DEV,DEV,...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _sync(devices):
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="256x128")
    ap.add_argument("-n", type=int, default=3)
    ap.add_argument("--Devices", default=None,
                    help="comma-separated torch devices, band i on the i-th "
                         "(default: every visible GPU)")
    a = ap.parse_args(argv)
    w, h = (int(v) for v in a.size.split("x"))

    from hm16_2_tpu_torch.encode.top import EncoderConfig, build_sps_pps
    from hm16_2_tpu_torch.parallel.frame_shard import (make_row_mesh,
                                                       sharded_plan_frame)
    from hm16_2_tpu_torch.parallel.me_shard import sharded_me_frame

    if a.Devices:
        devices = [torch.device(d) for d in a.Devices.split(",")]
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if not devices:
        print("scaling_bench: no CUDA device; name the devices with "
              "--Devices (e.g. --Devices cpu,cpu)", file=sys.stderr)
        return 2

    cfg = EncoderConfig(w, h, qp=32, intra_period=1)
    sps, _ = build_sps_pps(cfg)
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    cb = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    planes = [y, cb, cb.copy()]
    lead = devices[0]
    cur = torch.from_numpy(y).to(lead)
    refs = torch.from_numpy(np.roll(y, 2, axis=1)).to(lead)[None]
    mvp8 = torch.zeros((1, h // 8, w // 8, 2), dtype=torch.int32,
                       device=lead)
    lam = 57.9

    counts = [n for n in (1, 2, 4, 8)
              if n <= len(devices) and h % (n * 64) == 0]
    for stage in ("intra_plan", "inter_me"):
        results = {}
        for n in counts:
            mesh = make_row_mesh(devices[:n])
            if stage == "intra_plan":
                def run():
                    return sharded_plan_frame(mesh, planes, sps, 32, lam,
                                              1.0, (32, 32))
            else:
                def run():
                    return sharded_me_frame(mesh, cur, refs, mvp8, 7.0, h, w)
            run()                                  # build, warm-up
            _sync(mesh)
            t0 = time.perf_counter()
            for _ in range(a.n):
                run()
            _sync(mesh)
            results[n] = (time.perf_counter() - t0) / a.n * 1000
        base = results.get(1)
        line = {"stage": stage, "size": a.size,
                "devices": [str(d) for d in devices[:max(counts, default=0)]],
                "ms_per_frame": results,
                "efficiency_vs_1dev": {str(n): base / (results[n] * n)
                                       for n in results if base}}
        if len(set(devices[:max(counts, default=0)])) < max(counts,
                                                             default=0):
            line["note"] = ("several bands share a device: the plumbing "
                            "cost of banding, not multi-GPU scaling")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

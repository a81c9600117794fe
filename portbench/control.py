"""The control of the `correct` check, on the card at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 20

For each seed, one run of the cell (a short window), then the check twice
on the same pictures: the encoder against the reference (the sound reading)
and the reference's plans computed in bfloat16 against its float32 plans
(the control's reading).  The control has to fail a limit the encoder
meets.  The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    cell, cfg, traffic, metrics = run.load_cell(args.workload)
    device = torch.device("cuda", 0)
    print(f"card: {run.card_line()}", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(cfg, traffic, metrics, seed, args.seconds, 0,
                           device, kind=torch.cuda.get_device_name(device),
                           log=lambda s: print(s, flush=True), control=True)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "sound": {k: v["value"]
                                    for k, v in res["checks"].items()},
                          "control": res["control_checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

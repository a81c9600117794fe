"""K2's and K3's time per case on the card, at the shapes of one 1920x1080
all-intra frame (`make_yuv(1920, 1080, 1, seed=42)`, QP 32): K2's RD mode
(s = 4-32, the AI plan's k), its SATD-only mode, its inter rounding offset
(s = 8-32, k = 3, the P/B plan's intra alternative) and its analysis mode
(every 1080p block), K3's chroma cases (Cb and Cr, K = 5, s = 4-16) and the
64x64 level (s = 32, K = 1).

    python3 hm16_2_tpu_torch/tools/intra_bench.py [--root DIR] [--reps N]

Each case is timed two ways after a warm-up: CUDA events around N launches
through the wrapper (host enqueue included, as chip_smoke.py times every
kernel), and the kernels' own device time from torch.profiler over N
launches.  --root names the checkout whose `hm16_2_tpu_torch` is measured
(default: the one holding this file), so that an older tree unpacked beside
this one is measured by the same code on the same card in one call.  Prints
the card's name and power limit, a line per case, and one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
W, H, QP = 1920, 1080, 32
# the kernels of K2 and K3 (both designs) by the names ptxas gives them
KERNEL_NAMES = ("size_rd_kernel", "cand_rd_kernel", "analysis_kernel")


def card_line():
    """The card's name and power limit from nvidia-smi: the one line that
    this tool, plan_bench.py, stream_digest.py and chip_smoke.py print."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def event_ms(fn, reps):
    """ms per call from CUDA events around reps calls, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps, names=KERNEL_NAMES):
    """ms per call of the device time of the kernels whose names hold one
    of `names`, from torch.profiler over reps calls (after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):           # the profiler now and then records nothing
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if any(n in e.key for n in names)]
        if sum(e.count for e in ev) >= reps:
            return sum(e.self_device_time_total for e in ev) / 1e3 / reps
    raise RuntimeError(f"profiler saw {sum(e.count for e in ev)} of {reps} "
                       f"launches")


def cases(frame, dev):
    """(label, fn) of every K2 / K3 case at the frame's shapes, through the
    kernels' wrappers (`hm16_2_tpu_torch.kernels`)."""
    import torch
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import intra_rd as R
    Hf, Wf = frame[0].shape
    y, cb, cr = (torch.from_numpy(p.astype("int32")).to(dev) for p in frame)
    lam = 0.57 * 2.0 ** ((QP - 12) / 3.0)
    lamf = 0.4624 * 2.0 ** ((QP - 12) / 3.0)
    out = []
    luma, rd = {}, {}
    for s in (4, 8, 16, 32):
        luma[s] = K.ref_buffers(y, s, 8, True, Hf, Wf)
        bufs, blocks = luma[s]
        k = R.NUM_RD_CANDS[s]
        args = (bufs, blocks, float(lam), s, 8, k, QP, True, s == 4, s == 32)
        rd[s] = K.intra_size_rd(*args)
        out.append((f"K2 RD s={s} k={k}", lambda a=args: K.intra_size_rd(*a)))
    for s in (4, 8, 16, 32):
        bufs, blocks = luma[s]
        out.append((f"K2 SATD-only s={s}",
                     lambda b=bufs, bl=blocks, s=s: K.intra_premodes(b, bl, s,
                                                                     8)))
    for s in (8, 16, 32):
        bufs, blocks = luma[s]
        args = (bufs, blocks, float(lamf), s, 8, 3, QP, True, False, False,
                True)
        out.append((f"K2 inter offset s={s}",
                     lambda a=args: K.intra_size_rd(*a)))
    for s in (4, 8, 16, 32):
        bufs, blocks = luma[s]
        out.append((f"K2 analysis s={s}",
                     lambda b=bufs, bl=blocks, s=s: K.analysis_step(
                         bl, b, QP, s, 8)))
    for s in (8, 16, 32):
        cs = s // 2
        modes5 = R._chroma_modes5_plain(rd[s][0])
        for name, plane in (("cb", cb), ("cr", cr)):
            bufs, blocks = K.ref_buffers(plane, cs, 8, False, Hf // 2, Wf // 2)
            out.append((f"K3 chroma {name} s={cs} K=5",
                         lambda b=bufs, bl=blocks, m=modes5, cs=cs:
                         K.intra_cand_rd(b, bl, m, cs, 8, 31, False, False)))
    nby64, nbx64 = Hf // 64, Wf // 64
    nbx32 = Wf // 32
    idx = torch.as_tensor([i * nbx32 + j for i in range(2 * nby64)
                           for j in range(2 * nbx64)], device=dev)
    b32, bl32 = luma[32][0][idx], luma[32][1][idx]
    m64 = rd[32][0][idx][:, None].contiguous()
    out.append(("K3 64x64 level s=32 K=1",
                lambda: K.intra_cand_rd(b32, bl32, m64, 32, 8, QP, True,
                                        False)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="checkout whose hm16_2_tpu_torch is measured")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("intra_bench: no CUDA device")
    from hm16_2_tpu_torch import kernels as K
    sys.path.insert(1, os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                    "tests"))
    from make_fixtures import make_yuv
    card = card_line()
    K.build()
    frame = make_yuv(W, H, 1, seed=42)[0]
    label = args.label or root
    res = {}
    for name, fn in cases(frame, torch.device("cuda")):
        ev, dv = event_ms(fn, args.reps), device_ms(fn, args.reps)
        res[name] = {"event_ms": ev, "device_ms": dv}
        print(f"{label}: {name:28s} events {ev:8.4f} ms  device {dv:8.4f} ms"
              f"  [{card}]", flush=True)
    print(json.dumps({"root": label, "card": card, "cases": res}), flush=True)


if __name__ == "__main__":
    main()

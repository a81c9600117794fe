"""K1's, K4's and K7's list picks' time per picture on the card, inside whole
plans at 1920x1080 (`make_yuv(1920, 1080, 5, seed=42)`): the AI plan of
frame 0 (QP 32, chroma on), the P plan of frame 4 against frames 3..0
(four live references, QP 33) and the B plan of frame 2 between frames 1,
0 (list 0) and 3, 4 (list 1), QP 34, each with a seeded motion prior; and
the banded AI plan (`frame_shard.sharded_plan_frame`, bands on this one
card) of frame 0 at 1920x1080 over 2 bands and of `make_yuv(1024, 768, 1,
seed=42)` over 4.

    python3 hm16_2_tpu_torch/tools/plan_bench.py [--root DIR] [--reps N]

Each plan runs N times after a warm-up, through the plan's own entry point
(`intra_rd._plan_device`, `inter_plan._plan_device`,
`frame_shard.sharded_plan_frame`, which also fetches the plan) of the
checkout DIR
(default: the one holding this file), so that an older tree unpacked beside
this one is measured by the same code on the same card in one call.  Per
picture it reports: the launches of every kernel (`kernels.LAUNCHES`); the
CUDA-event time around each call of K1's, K4's and the picks' wrappers
inside the plan (host enqueue included, as chip_smoke.py times every
kernel); the device time of K4's, the picks' and K1's kernels from
torch.profiler; the plan's wall time up to a device sync; and the peak of
device memory allocated during one plan above what was allocated before it
(`torch.cuda.max_memory_allocated`).  Prints the card's name and power
limit, a line per plan, and one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
W, H, QP = 1920, 1080, 32
# the kernels of K4, the picks and K1 (both designs) by their names
GROUPS = {"K4": ("chroma_modes5_kernel", "chroma_fold_kernel",
                 "mode64_kernel", "cost64_kernel", "dp_level_kernel",
                 "emit_kernel", "emit_inter_kernel", "plan_pre_kernel",
                 "plan_ctu_kernel"),
          "picks": ("uni_select",),
          "K1": ("ref_buffers_kernel", "blocks_kernel", "ref_multi_kernel")}
# the wrappers whose calls are timed by events, where the tree has them
WRAPPERS = {"K4": (("intra_rd", ("chroma_modes5", "chroma_fold", "mode64",
                                 "plan_pre", "plan_dp")),
                   ("inter_plan", ("emit",))),
            "picks": (("inter_plan", ("uni_select", "uni_select_all")),),
            "K1": (("intra_rd", ("ref_buffers", "ref_buffers_multi")),
                   ("frame_shard", ("ref_buffers_band",
                                    "ref_buffers_band_multi")))}


class EventTimer:
    """Wraps the WRAPPERS of the checkout's modules so that each call is
    bracketed by CUDA events; `ms()` sums the brackets by group."""

    def __init__(self, mods):
        import torch
        self.torch, self.marks, self.saved = torch, [], []
        for group, spec in WRAPPERS.items():
            for mod_name, names in spec:
                mod = mods[mod_name]
                for name in names:
                    if hasattr(mod, name):
                        fn = getattr(mod, name)
                        self.saved.append((mod, name, fn))
                        setattr(mod, name, self._wrap(group, fn))

    def _wrap(self, group, fn):
        def run(*a, **kw):
            ev = [self.torch.cuda.Event(enable_timing=True) for _ in (0, 1)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            self.marks.append((group, ev))
            return out
        return run

    def ms(self):
        self.torch.cuda.synchronize()
        out = {g: 0.0 for g in WRAPPERS}
        for group, (a, b) in self.marks:
            out[group] += a.elapsed_time(b)
        self.marks = []
        return out

    def restore(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def plans(dev):
    """(label, fn) of the AI, P and B plans at 1080p."""
    import numpy as np
    import torch
    from hm16_2_tpu_torch.encode import inter_plan as P
    from hm16_2_tpu_torch.encode import intra_rd as R
    from make_fixtures import make_yuv
    frames = make_yuv(W, H, 5, seed=42)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    y, cb, cr = (t(p) for p in frames[0])
    ai_kw = dict(h=H, w=W, bd=8, cbd=8, strong=True, qp=QP, cqp0=QP - 1,
                 cqp1=QP - 1, chroma=True)
    ai_lam = float(np.float32(0.57 * 2.0 ** ((QP - 12) / 3.0)))
    ai_cw = float(np.float32(2.0 ** ((QP - 31) / 3.0)))
    out = [("AI", lambda: R._plan_device(y, cb, cr, ai_lam, ai_cw, **ai_kw))]
    rng = np.random.default_rng(7)
    for label, cur_i, ref_i, dists, maps, nrefs, qp in (
            ("P", 4, (3, 2, 1, 0), (1, 2, 3, 4), ([0, 1, 2, 3], None),
             (4, 0), QP + 1),
            ("B", 2, (1, 0, 3, 4), (1, 2, -1, -2),
             ([0, 1, 0, 0], [2, 3, 0, 0]), (2, 2), QP + 2)):
        cur = t(frames[cur_i][0])
        refs = t(np.stack([frames[i][0] for i in ref_i]))
        mvn16 = t(rng.integers(-96, 96, (H // 8, W // 8, 2)))
        lam = float(np.float32(0.4624 * 2.0 ** ((qp - 12) / 3.0)))
        lams = float(np.float32(np.sqrt(lam)))
        m0 = t(maps[0])
        m1 = None if maps[1] is None else t(maps[1])
        out.append((label, lambda cur=cur, refs=refs, mvn16=mvn16,
                    dists=t(dists), lam=lam, lams=lams, qp=qp, m0=m0,
                    m1=m1, n=nrefs, b=label == "B": P._plan_device(
                        cur, refs, mvn16, dists, lam, lams, qp, m0, n[0], m1,
                        n[1], h=H, w=W, bd=8, nmerge=5, is_b=b)))
    from hm16_2_tpu_torch.encode.top import EncoderConfig, build_sps_pps
    from hm16_2_tpu_torch.parallel import frame_shard as F
    for w, h, n in ((W, H, 2), (1024, 768, 4)):
        orig = [np.ascontiguousarray(p, np.int32) for p in (
            frames[0] if (w, h) == (W, H) else make_yuv(w, h, 1, seed=42)[0])]
        sps, _ = build_sps_pps(EncoderConfig(w, h, qp=QP, intra_period=1))
        out.append((f"I {w}x{h} {n} bands", lambda orig=orig, sps=sps, n=n:
                    F.sharded_plan_frame(F.make_row_mesh([dev] * n), orig,
                                         sps, QP, ai_lam, ai_cw,
                                         (QP - 1, QP - 1))))
    return out


def device_ms(fn, reps):
    """Device ms per call of each group's kernels (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    out = {g: sum(e.self_device_time_total for e in ev
                  if any(n in e.key for n in names)) / 1e3 / reps
           for g, names in GROUPS.items()}
    out["all"] = sum(e.self_device_time_total for e in ev) / 1e3 / reps
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose hm16_2_tpu_torch is measured")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("plan_bench: no CUDA device")
    sys.path.insert(1, os.path.join(REPO, "tests"))
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_plan, intra_rd
    from hm16_2_tpu_torch.parallel import frame_shard
    from intra_bench import card_line
    card = card_line()
    K.build()
    label = args.label or root
    dev = torch.device("cuda")
    res = {}
    for name, fn in plans(dev):
        fn()                                             # warm-up
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.reps
        launches = {k: v / args.reps for k, v in K.LAUNCHES.items() if v}
        timer = EventTimer({"intra_rd": intra_rd, "inter_plan": inter_plan,
                            "frame_shard": frame_shard})
        for _ in range(args.reps):
            fn()
        events = {g: v / args.reps for g, v in timer.ms().items()}
        timer.restore()
        dev_ms = device_ms(fn, args.reps)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e6
        res[name] = {"launches": launches, "event_ms": events,
                     "device_ms": dev_ms, "wall_ms": wall, "peak_mb": peak}
        print(f"{label}: {name} plan per picture: peak {peak:.1f} MB above "
              f"the inputs; wall {wall:.3f} ms; events "
              + ", ".join(f"{g} {v:.4f}" for g, v in events.items())
              + " ms; device " + ", ".join(f"{g} {v:.4f}" for g, v in
                                           dev_ms.items())
              + f" ms; launches {json.dumps(launches)}  [{card}]", flush=True)
    print(json.dumps({"root": label, "card": card, "plans": res}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `hm16_2_tpu_torch/csrc`, holds each
against its plain PyTorch version on the card at the shapes of a 1920x1080
all-intra frame, of a 1080p P picture with four live references and of a
1080p B picture with two past and two future references, then drives the
port's three paths:

- all-intra (HM's common-test All Intra Main configuration: QP 32, 8-bit
  4:2:0, deblocking, SAO, MD5 picture hash) over three 1080p frames through
  `Encoder.encode_stream`, and the per-frame entry `encode_frame`;
- low-delay P (HM's Low Delay P Main: GOP 4, four references, QP offsets
  +5/+4/+5/+1 on 32) over five 1080p frames, IDR + one GOP, through
  `push_frame` / `flush`;
- random access (HM's Random Access Main: hierarchical-B GOP 8, intra
  period 32, QP 32 with offsets +1..+4 by depth) over nine 1080p frames,
  IDR + one GOP of eight B pictures, through `push_frame` / `flush`;

decodes the streams and checks every picture hash, and checks small
encodes on the card against the same encodes on the CPU (whose plain path
the tests hold to the JAX reference).  Every failure raises; the last line
of standard output is the device JSON.  Needs a CUDA device and exits
non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H, QP = 1920, 1080, 32


def _frames(w, h, n):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from make_fixtures import make_yuv
    return make_yuv(w, h, n, seed=42)


def _card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def _cuda_ms(fn, reps):
    fn()                                        # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _compare(name, got, want):
    """Exact equality of every output tensor; returns the max abs error."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if g is None and w is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}[{i}]: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{name}[{i}]: kernel differs from the plain "
                                 f"version (max abs err {err})")
    return err


def check_kernels(frame, dev, reps=5):
    """Each kernel against its plain version at the shapes one frame's plan
    gives it.  Returns {kernel: {"err", "ms", "plain_ms"}} summed over its
    cases."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import intra_rd as R

    H, W = frame[0].shape
    y, cb, cr = (torch.from_numpy(p.astype("int32")).to(dev) for p in frame)
    lam = 0.57 * 2.0 ** ((QP - 12) / 3.0)
    cw, cqp = 2.0 ** ((QP - 31) / 3.0), 31
    stats = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in K.LAUNCHES}

    def case(kernel, label, run_k, run_p):
        got, want = run_k(), run_p()
        err = _compare(f"{kernel} {label}", got, want)
        ms, pms = _cuda_ms(run_k, reps), _cuda_ms(run_p, reps)
        st = stats[kernel]
        st["err"] = max(st["err"], err)
        st["ms"] += ms
        st["plain_ms"] += pms
        print(f"kernel {kernel:14s} {label:28s} equal  "
              f"kernel {ms:9.3f} ms  plain {pms:9.3f} ms", flush=True)
        return got

    luma, chroma = {}, {}
    for s in (4, 8, 16, 32):
        luma[s] = case("ref_buffers", f"luma s={s}",
                       lambda: K.ref_buffers(y, s, 8, True, H, W),
                       lambda: R._ref_buffers_plain(y, s, 8, True, H, W))
    for cs in (4, 8, 16):
        chroma[cs] = case(
            "ref_buffers", f"chroma s={cs}",
            lambda: K.ref_buffers(cb, cs, 8, False, H // 2, W // 2),
            lambda: R._ref_buffers_plain(cb, cs, 8, False, H // 2, W // 2))
    crb = {cs: R._ref_buffers_plain(cr, cs, 8, False, H // 2, W // 2)
           for cs in (4, 8, 16)}

    rd = {}
    for s in (4, 8, 16, 32):
        bufs, blocks = luma[s]
        k = R.NUM_RD_CANDS[s]
        args = (bufs, blocks, float(lam), s, 8, k, QP, True, s == 4, s == 32)
        rd[s] = case("intra_size_rd", f"luma s={s} k={k}"
                     + (" +satd" if s == 32 else ""),
                     lambda: K.intra_size_rd(*args),
                     lambda: R._size_rd_plain(*args))
        case("intra_size_rd", f"satd-only s={s}",
             lambda: K.intra_premodes(bufs, blocks, s, 8),
             lambda: R._premodes_plain(bufs, blocks, s, 8))

    nby, nbx = {}, {}
    for s in (4, 8, 16, 32, 64):
        nby[s], nbx[s] = H // s, W // s
    db = {}
    for s in (8, 16, 32):
        cs = s // 2
        modes5 = case("plan_dp", f"chroma modes s={s}",
                      lambda: K.chroma_modes5(rd[s][0]),
                      lambda: R._chroma_modes5_plain(rd[s][0]))
        out = []
        for label, (bufs, blocks) in (("cb", chroma[cs]), ("cr", crb[cs])):
            out += case("intra_cand_rd", f"chroma {label} s={cs} K=5",
                        lambda: K.intra_cand_rd(bufs, blocks, modes5, cs, 8,
                                                cqp, False, False),
                        lambda: R._cand_rd_plain(bufs, blocks, modes5, cs, 8,
                                                 cqp, False, False))
        db[s] = out
    folds = {}
    for s in (8, 16, 32):
        cost = rd[s][1].reshape(nby[s], nbx[s])
        folds[s] = case("plan_dp", f"chroma fold s={s}",
                        lambda: K.chroma_fold(*db[s], cost, lam, cw),
                        lambda: R._chroma_fold_plain(*db[s], cost, lam, cw))
    satd32 = rd[32][3].reshape(nby[32], nbx[32], 35)
    m64, pm64 = case("plan_dp", "mode64",
                     lambda: K.mode64(satd32, nby[64], nbx[64]),
                     lambda: R._mode64_plain(satd32, nby[64], nbx[64]))
    idx = torch.as_tensor([(i * nbx[32] + j) for i in range(2 * nby[64])
                           for j in range(2 * nbx[64])], device=dev)
    b32, bl32 = luma[32][0][idx], luma[32][1][idx]
    d64, b64 = case("intra_cand_rd", "64x64 level s=32 K=1",
                    lambda: K.intra_cand_rd(b32, bl32, pm64[:, None], 32, 8,
                                            QP, True, False),
                    lambda: R._cand_rd_plain(b32, bl32, pm64[:, None], 32, 8,
                                             QP, True, False))
    mode_s = {s: rd[s][0].reshape(nby[s], nbx[s]) for s in (4, 8, 16, 32)}
    cost_s = {4: rd[4][1].reshape(nby[4], nbx[4])}
    cost_s.update({s: folds[s][0] for s in (8, 16, 32)})
    cand_s = {s: rd[s][2].reshape(nby[s], nbx[s], 3) for s in (4, 8, 16, 32)}
    cmode_s = {s: folds[s][2] for s in (8, 16, 32)}
    dp_args = (lam, H, W, mode_s, cost_s, cand_s, cmode_s, folds[32][1],
               d64[:, 0].contiguous(), b64[:, 0].contiguous(), m64)
    case("plan_dp", "DP + packed plan", lambda: K.plan_dp(*dp_args),
         lambda: R._plan_dp_plain(*dp_args))
    return stats


def _flat(x):
    """A stage's outputs as a flat tuple of tensors (dicts in key order)."""
    if isinstance(x, dict):
        return tuple(t for k in sorted(x, key=str) for t in _flat(x[k]))
    if isinstance(x, (tuple, list)):
        return tuple(t for v in x for t in _flat(v))
    return (x,)


def _case(stats, reps):
    """A kernel check: run the kernel and its plain version, require equal
    outputs, time both, add to stats[kernel]; returns the kernel's result."""
    def case(kernel, label, run_k, run_p, r=reps):
        got, want = _flat(run_k()), _flat(run_p())
        err = _compare(f"{kernel} {label}", got, want)
        ms, pms = _cuda_ms(run_k, r), _cuda_ms(run_p, r)
        st = stats[kernel]
        st["err"] = max(st["err"], err)
        st["ms"] += ms
        st["plain_ms"] += pms
        print(f"kernel {kernel:15s} {label:27s} equal  "
              f"kernel {ms:9.3f} ms  plain {pms:9.3f} ms", flush=True)
        return run_k()
    return case


def check_inter_kernels(frames, dev, reps=3, stats=None):
    """K5-K8, K2 at the inter rounding offset and K4's P-plan emission
    against their plain versions at the shapes of one P picture: the last
    of `frames` against the four before it (all live), QP 33, a synthetic
    motion prior.  Each kernel runs on the other kernels' outputs, so every
    case sees what the main path gives it.  Adds to `stats`."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_plan as P
    from hm16_2_tpu_torch.encode import intra_rd as R

    H, W = frames[-1][0].shape
    nref, qp = 4, QP + 1
    cur = torch.from_numpy(frames[-1][0].astype("int32")).to(dev)
    refs = torch.from_numpy(np.stack([frames[-1 - d][0] for d in
                                      range(1, nref + 1)]).astype("int32")) \
        .to(dev)
    rng = np.random.default_rng(7)
    mvn16 = torch.from_numpy(rng.integers(-96, 96, (H // 8, W // 8, 2))
                             .astype("int32")).to(dev)
    dists = torch.arange(1, nref + 1, dtype=torch.int32, device=dev)
    lam = 0.578 * 2.0 ** ((qp - 12) / 3.0)
    lamf, lams = float(np.float32(lam)), float(np.float32(np.sqrt(lam)))
    map0 = torch.arange(nref, dtype=torch.int32, device=dev)
    if stats is None:
        stats = {}
    for k in K.LAUNCHES:
        stats.setdefault(k, {"err": 0.0, "ms": 0.0, "plain_ms": 0.0})

    case = _case(stats, reps)
    mvp8 = P._mvp_full(mvn16, dists)
    me = case("inter_me", f"{nref} refs, all CU shapes",
              lambda: K.inter_me(cur, refs, mvp8, lams, H, W, True),
              lambda: P._int_me_plain(cur, refs, mvp8, lams, H, W, True),
              r=1)
    sub = case("subpel_planes", f"{nref} refs, 16 phases",
               lambda: K.subpel_planes(refs, 8, H, W),
               lambda: P._subpel_planes_plain(refs, 8, H, W))
    recs, costs = {}, {}
    for s in P.SIZES:
        ny, nx = H // s, W // s
        recs[s] = costs[s] = None
        if not (ny and nx):
            continue
        shapes = [(0, s, s, ny, nx)]
        if (s, 1) in me:
            shapes += [(1, s // 2, s, 2 * ny, nx), (2, s, s // 2, ny, 2 * nx)]
        unis = {}
        for part, bh, bw, Ny, Nx in shapes:
            p4 = (4 * P._me_mvp(mvp8, s, part)[:, :Ny, :Nx]).contiguous()
            mv = me[(s, part)]
            mvq, satd = case(
                "inter_uni", f"q-pel refine {bh}x{bw}",
                lambda: K.frac_refine(sub, cur, mv, p4, lams, bh, bw),
                lambda: P._frac_refine_plain(sub, cur, mv, p4, lams, bh,
                                             bw))
            p4 = p4.reshape(nref, -1, 2)
            unis[part] = case(
                "inter_uni", f"list pick {bh}x{bw}",
                lambda: K.uni_select(mvq, satd, p4, map0, nref, lams),
                lambda: P._uni_select_plain(mvq, satd, p4, map0, nref, lams))
            if part == 0:
                tmvp4 = p4[0].contiguous()
        intra = None
        if s <= 32:
            bufs, blocks = R._ref_buffers_plain(cur, s, 8, True, H, W)
            args = (bufs, blocks, lamf, s, 8, 3, qp, True, False, False)
            intra = case("intra_size_rd", f"inter offset s={s} k=3",
                         lambda: K.intra_size_rd(*args, True),
                         lambda: R._size_rd_plain(*args, True))[:3]
        rect = {1: unis[1], 2: unis[2]} if 1 in unis else None
        cargs = (cur, sub, s, unis[0], tmvp4, 0, rect, intra, lamf, lams, qp,
                 8, 5)
        recs[s], costs[s] = case("inter_cu_rd", f"CU pricing s={s}",
                                 lambda: K.cu_rd(*cargs),
                                 lambda: P._cu_rd_plain(*cargs))
    case("plan_dp", "P plan DP + packed plan",
         lambda: K.emit_inter_plan(recs, costs, lamf, H, W),
         lambda: P._emit_plain(recs, costs, lamf, H, W))
    return stats


def check_b_kernels(frames, dev, reps=3, stats=None,
                    lists=((0, 1), (2, 3))):
    """K7's bi-refinement mode, K8's B mode, the list picks of both lists
    and K4's emission of B records against their plain versions at the
    shapes of one B picture: frames[2] between the past frames 1, 0 and the
    future frames 3, 4 (signed POC distances 1, 2, -1, -2), QP 34, a
    synthetic motion prior.  lists: list 0 and list 1 as indices into those
    four references (the default: two past, two future; ((0,), (0,)) is the
    GPB case, one reference in both lists).  Each kernel runs on the other
    kernels' outputs.  Adds to `stats`."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_plan as P

    H, W = frames[2][0].shape
    qp = QP + 2
    order = sorted({i for lst in lists for i in lst})
    cur = torch.from_numpy(frames[2][0].astype("int32")).to(dev)
    refs = torch.from_numpy(np.stack([frames[(1, 0, 3, 4)[i]][0]
                                      for i in order]).astype("int32")).to(dev)
    dists = torch.as_tensor([(1, 2, -1, -2)[i] for i in order],
                            dtype=torch.int32, device=dev)
    maps = [torch.as_tensor([order.index(i) for i in lst] +
                            [0] * (P.MAXREF_PLAN - len(lst)),
                            dtype=torch.int32, device=dev) for lst in lists]
    nref = [len(lst) for lst in lists]
    first = [order.index(lst[0]) for lst in lists]
    rng = np.random.default_rng(11)
    mvn16 = torch.from_numpy(rng.integers(-96, 96, (H // 8, W // 8, 2))
                             .astype("int32")).to(dev)
    lam = 0.3536 * 2.0 ** ((qp - 12) / 3.0)
    lamf, lams = float(np.float32(lam)), float(np.float32(np.sqrt(lam)))
    if stats is None:
        stats = {}
    for k in K.LAUNCHES:
        stats.setdefault(k, {"err": 0.0, "ms": 0.0, "plain_ms": 0.0})
    case = _case(stats, reps)
    mvp8 = P._mvp_full(mvn16, dists)
    me = K.inter_me(cur, refs, mvp8, lams, H, W, True)
    sub = K.subpel_planes(refs, 8, H, W)
    recs, costs = {}, {}
    for s in P.SIZES:
        ny, nx = H // s, W // s
        recs[s] = costs[s] = None
        if not (ny and nx):
            continue
        shapes = [(0, s, s, ny, nx)]
        if (s, 1) in me:
            shapes += [(1, s // 2, s, 2 * ny, nx), (2, s, s // 2, ny, 2 * nx)]
        unis = {}
        for part, bh, bw, Ny, Nx in shapes:
            p4 = (4 * P._me_mvp(mvp8, s, part)[:, :Ny, :Nx]).contiguous()
            mvq, satd = K.frac_refine(sub, cur, me[(s, part)], p4, lams, bh,
                                      bw)
            p4 = p4.reshape(len(order), -1, 2)
            if part == 0:
                tmvp4 = [p4[f].contiguous() for f in first]
            unis[part] = [case(
                "inter_uni", f"list {lx} pick {bh}x{bw}",
                lambda: K.uni_select(mvq, satd, p4, maps[lx], nref[lx], lams),
                lambda: P._uni_select_plain(mvq, satd, p4, maps[lx],
                                            nref[lx], lams))
                for lx in (0, 1)]
        u0, u1 = unis[0]
        a1 = (sub, cur, u1["mv"], u1["uref"], u1["anchor"], u0["uref"],
              u0["mv"], lams, s)
        mv1b = case("inter_bi_refine", f"list 1 pass {s}x{s}",
                    lambda: K.frac_refine_any(*a1),
                    lambda: P._frac_refine_any_plain(*a1))[0]
        a0 = (sub, cur, u0["mv"], u0["uref"], u0["anchor"], u1["uref"], mv1b,
              lams, s)
        mv0b = case("inter_bi_refine", f"list 0 pass {s}x{s}",
                    lambda: K.frac_refine_any(*a0),
                    lambda: P._frac_refine_any_plain(*a0))[0]
        intra = None
        if s <= 32:
            bufs, blocks = K.ref_buffers(cur, s, 8, True, H, W)
            intra = K.intra_size_rd(bufs, blocks, lamf, s, 8, 3, qp, True,
                                    False, False, True)[:3]
        rect = {1: unis[1], 2: unis[2]} if 1 in unis else None
        cargs = (cur, sub, s, unis[0], tmvp4, first, nref, [mv0b, mv1b],
                 rect, intra, lamf, lams, qp, 8, 5)
        recs[s], costs[s] = case("inter_cu_rd_b", f"B CU pricing s={s}",
                                 lambda: K.cu_rd_b(*cargs),
                                 lambda: P._cu_rd_b_plain(*cargs))
    case("plan_dp", "B plan DP + packed plan",
         lambda: K.emit_inter_plan(recs, costs, lamf, H, W),
         lambda: P._emit_plain(recs, costs, lamf, H, W))
    return stats


SOURCES = {
    "ref_buffers": ("ref_buffers.cu", "hm16_2_tpu/encode/intra_rd.py:317"),
    "intra_size_rd": ("intra_rd.cu", "hm16_2_tpu/encode/intra_rd.py:172"),
    "intra_cand_rd": ("intra_rd.cu", "hm16_2_tpu/encode/intra_rd.py:212"),
    "plan_dp": ("plan_dp.cu", "hm16_2_tpu/encode/intra_rd.py:377"),
    "inter_me": ("inter_me.cu", "hm16_2_tpu/encode/inter_plan.py:209"),
    "subpel_planes": ("subpel.cu", "hm16_2_tpu/encode/inter_plan.py:294"),
    "inter_uni": ("inter_rd.cu", "hm16_2_tpu/encode/inter_plan.py:362"),
    "inter_bi_refine": ("inter_rd.cu", "hm16_2_tpu/encode/inter_plan.py:401"),
    "inter_cu_rd": ("inter_rd.cu", "hm16_2_tpu/encode/inter_plan.py:444"),
    "inter_cu_rd_b": ("inter_rd.cu", "hm16_2_tpu/encode/inter_plan.py:444"),
}
B_ONLY = ("inter_bi_refine", "inter_cu_rd_b")     # kernels of B pictures only


def _launches_of(K, run, label, need):
    """Drive `run` with every launch count at 0; fail if a kernel of `need`
    was never launched.  Returns (result, counts)."""
    K.reset_launches()
    out = run()
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    print(f"launches {label} {json.dumps(counts)}", flush=True)
    idle = [k for k in need if counts[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched by {label}: {idle}")
    return out, counts


def _decode_check(aus, n, label):
    from hm16_2_tpu.decode.top import Decoder
    t0 = time.perf_counter()
    pics = Decoder().decode_stream(b"".join(aus))
    print(f"{label}: decoded {len(pics)} pictures in "
          f"{time.perf_counter() - t0:.1f} s, hash_ok "
          f"{[p.hash_ok for p in pics]}", flush=True)
    if len(pics) != n or not all(p.hash_ok is True for p in pics):
        raise AssertionError(f"{label}: decoded picture hash mismatch")


def _push_all(enc, frames):
    aus = []
    for poc, f in enumerate(frames):
        aus += enc.push_frame([p.astype("int32") for p in f], poc)
    return aus + enc.flush()


def ldp_phase(frames, dev):
    """HM's Low Delay P Main over IDR + one GOP of four P pictures through
    push_frame / flush; prints fps, the P pictures' stage_ms and their
    device busy share (torch.profiler, device activity only).  Returns the
    AUs and the launch counts."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    H, W = frames[0][0].shape
    enc = Encoder(EncoderConfig(W, H, qp=QP, intra_period=0, gop="ld"), dev)
    times = {}

    def run():
        t0 = time.perf_counter()
        aus = enc.push_frame([p.astype("int32") for p in frames[0]], 0)
        torch.cuda.synchronize()
        times["idr"] = time.perf_counter() - t0
        idr_ms = dict(enc.stage_ms)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for poc in range(1, len(frames)):
                aus += enc.push_frame(
                    [p.astype("int32") for p in frames[poc]], poc)
            aus += enc.flush()
            torch.cuda.synchronize()
            times["p"] = time.perf_counter() - t1
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events) / 1e3
        print(f"profile of the P pictures: device busy {busy:.3f} ms of "
              f"{times['p'] * 1e3:.3f} ms wall = "
              f"{100 * busy / (times['p'] * 1e3):.3f}%", flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.key[:60]:60s} {e.self_device_time_total / 1e3:10.3f}"
                  f" ms  x{e.count}", flush=True)
        times["stage_p"] = {k: v - idr_ms.get(k, 0.0)
                            for k, v in enc.stage_ms.items()}
        return aus

    aus, counts = _launches_of(K, run, f"LDP {W}x{H}",
                               [k for k in K.LAUNCHES if k not in B_ONLY])
    n_p = len(frames) - 1
    print(f"LDP {W}x{H} QP{QP} GOP4: {len(aus)} pictures; IDR "
          f"{times['idr']:.3f} s; {n_p} P pictures in {times['p']:.3f} s = "
          f"{n_p / times['p']:.3f} fps; bytes {[len(a) for a in aus]}",
          flush=True)
    print("stage_ms per P picture: " + json.dumps(
        {k: round(v / n_p, 3) for k, v in times["stage_p"].items()}),
        flush=True)
    return aus, counts


def ra_phase(frames, dev):
    """HM's Random Access Main over IDR + one GOP of eight B pictures through
    push_frame / flush; prints fps over the B pictures, their stage_ms, the
    number of plans enqueued ahead (pictures 3, 6, 7) and the device busy
    share of the B pictures (torch.profiler, device activity only).
    Returns the AUs and the launch counts."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    H, W = frames[0][0].shape
    enc = Encoder(EncoderConfig(W, H, qp=QP, intra_period=32, gop="ra8"), dev)
    ahead = []
    predispatch = enc._predispatch_ra

    def counted(planes, poc, *a, **kw):
        out = predispatch(planes, poc, *a, **kw)
        if out is not None:
            ahead.append(poc)
        return out

    enc._predispatch_ra = counted
    times = {}

    def run():
        t0 = time.perf_counter()
        aus = enc.push_frame([p.astype("int32") for p in frames[0]], 0)
        torch.cuda.synchronize()
        times["idr"] = time.perf_counter() - t0
        idr_ms = dict(enc.stage_ms)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for poc in range(1, len(frames)):
                aus += enc.push_frame(
                    [p.astype("int32") for p in frames[poc]], poc)
            aus += enc.flush()
            torch.cuda.synchronize()
            times["b"] = time.perf_counter() - t1
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events) / 1e3
        print(f"profile of the B pictures: device busy {busy:.3f} ms of "
              f"{times['b'] * 1e3:.3f} ms wall = "
              f"{100 * busy / (times['b'] * 1e3):.3f}%", flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
            print(f"  {e.key[:60]:60s} {e.self_device_time_total / 1e3:10.3f}"
                  f" ms  x{e.count}", flush=True)
        times["stage_b"] = {k: v - idr_ms.get(k, 0.0)
                            for k, v in enc.stage_ms.items()}
        return aus

    aus, counts = _launches_of(K, run, f"RA {W}x{H}",
                               [k for k in K.LAUNCHES if k != "inter_cu_rd"])
    n_b = len(frames) - 1
    print(f"RA {W}x{H} QP{QP} GOP8: {len(aus)} pictures; IDR "
          f"{times['idr']:.3f} s; {n_b} B pictures in {times['b']:.3f} s = "
          f"{n_b / times['b']:.3f} fps; plans enqueued ahead for POCs "
          f"{ahead}; bytes {[len(a) for a in aus]}", flush=True)
    print("stage_ms per B picture: " + json.dumps(
        {k: round(v / n_b, 3) for k, v in times["stage_b"].items()}),
        flush=True)
    if sorted(ahead) != [3, 6, 7]:
        raise AssertionError(f"RA: plans enqueued ahead for {ahead}, not for "
                             "POCs 3, 6 and 7")
    return aus, counts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    sys.path.insert(0, ROOT)
    from hm16_2_tpu import native
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig

    print(_card_line(), flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"device {name}  torch {torch.__version__}  cuda "
          f"{torch.version.cuda}", flush=True)
    path, secs = K.build()
    print(f"kernels built in {secs:.1f} s: {os.path.relpath(path, ROOT)}",
          flush=True)
    if native.get_lib() is None or native.get_dsp() is None:
        raise AssertionError("native commit engine did not build")

    t0 = time.perf_counter()
    frames = [[p.copy() for p in f] for f in _frames(W, H, 9)]
    print(f"frames {W}x{H} made in {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")
    stats = check_kernels(frames[0], dev)
    check_inter_kernels(frames[1:6], dev, stats=stats)
    check_b_kernels(frames[:5], dev, stats=stats)

    # all-intra: warm-up frame, then a timed 3-frame encode_stream
    from hm16_2_tpu_torch.encode.intra_rd import fetch_plan
    cfg = lambda: EncoderConfig(W, H, qp=QP, intra_period=1)
    warm = Encoder(cfg(), dev)
    list(warm.encode_stream(frames[3:4]))
    planes = [p.astype("int32") for p in frames[3]]
    t0 = time.perf_counter()
    for _ in range(5):
        fetch_plan(warm._submit_plan(planes), H, W)
    print(f"frame plan alone (upload, kernels, packed plan back): "
          f"{(time.perf_counter() - t0) / 5 * 1e3:.3f} ms per frame",
          flush=True)
    enc = Encoder(cfg(), dev)
    t0 = time.perf_counter()
    aus, ai_counts = _launches_of(
        K, lambda: list(enc.encode_stream(frames[:3])), f"AI {W}x{H}",
        ("ref_buffers", "intra_size_rd", "intra_cand_rd", "plan_dp"))
    wall = time.perf_counter() - t0
    print(f"encode_stream {W}x{H} AI QP{QP}: 3 frames in {wall:.3f} s = "
          f"{3 / wall:.3f} fps; bytes {[len(a) for a in aus]}", flush=True)
    print("stage_ms per frame: " + json.dumps(
        {k: round(v / 3, 3) for k, v in enc.stage_ms.items()}), flush=True)
    _decode_check(aus, 3, "AI")
    au0 = Encoder(cfg(), dev).encode_frame(
        [p.astype("int32") for p in frames[0]], 0)
    if au0 != aus[0]:
        raise AssertionError("encode_frame differs from encode_stream's AU 0")
    print("encode_frame(frame 0) equals encode_stream AU 0", flush=True)

    # low-delay P: IDR + one GOP of four P pictures
    ldp_aus, ldp_counts = ldp_phase(frames[:5], dev)
    _decode_check(ldp_aus, 5, "LDP")

    # random access: IDR + one GOP of eight B pictures
    ra_aus, ra_counts = ra_phase(frames, dev)
    _decode_check(ra_aus, 9, "RA")

    small = _frames(136, 72, 9)
    cfg_s = lambda: EncoderConfig(136, 72, qp=QP, intra_period=1)
    on_card = list(Encoder(cfg_s(), dev).encode_stream(small[:3]))
    on_cpu = list(Encoder(cfg_s(), torch.device("cpu"))
                  .encode_stream(small[:3]))
    if on_card != on_cpu:
        raise AssertionError("136x72 AI encode on the card differs from the "
                             "CPU")
    print("136x72 3-frame AI encode: card bytes equal CPU plain-path bytes",
          flush=True)
    cfg_p = lambda: EncoderConfig(136, 72, qp=QP, intra_period=0, gop="ld")
    on_card = _push_all(Encoder(cfg_p(), dev), small[:5])
    on_cpu = _push_all(Encoder(cfg_p(), torch.device("cpu")), small[:5])
    if on_card != on_cpu:
        raise AssertionError("136x72 LDP encode on the card differs from the "
                             "CPU")
    print("136x72 5-frame LDP encode: card bytes equal CPU plain-path bytes",
          flush=True)
    cfg_r = lambda: EncoderConfig(136, 72, qp=QP, intra_period=32, gop="ra8")
    on_card = _push_all(Encoder(cfg_r(), dev), small)
    on_cpu = _push_all(Encoder(cfg_r(), torch.device("cpu")), small)
    if on_card != on_cpu:
        raise AssertionError("136x72 RA encode on the card differs from the "
                             "CPU")
    print("136x72 9-frame RA encode: card bytes equal CPU plain-path bytes",
          flush=True)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print("jax not imported", flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"hm16_2_tpu_torch/csrc/{SOURCES[k][0]}",
         "replaces": SOURCES[k][1],
         "launches": ai_counts[k] + ldp_counts[k] + ra_counts[k],
         "max_abs_err": stats[k]["err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"]} for k in K.LAUNCHES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `hm16_2_tpu_torch/csrc`, holds each
against its plain PyTorch version on the card at the shapes of a 1920x1080
all-intra frame, of a 1080p P picture with four live references, of a
1080p B picture with two past and two future references and of the frame ME
of a 1080p picture without a plan (four references, and the one reference
of the per-CU search's IPPP pictures, a non-zero prior), then drives the
port's paths:

- all-intra (HM's common-test All Intra Main configuration: QP 32, 8-bit
  4:2:0, deblocking, SAO, MD5 picture hash) over three 1080p frames through
  `Encoder.encode_stream`, and the per-frame entry `encode_frame`;
- low-delay P (HM's Low Delay P Main: GOP 4, four references, QP offsets
  +5/+4/+5/+1 on 32) over five 1080p frames, IDR + one GOP, through
  `push_frame` / `flush`;
- random access (HM's Random Access Main: hierarchical-B GOP 8, intra
  period 32, QP 32 with offsets +1..+4 by depth) over nine 1080p frames,
  IDR + one GOP of eight B pictures, through `push_frame` / `flush`;
- the per-CU inter search (no fused plan, HM16_NO_INTER_PLAN, with the
  fork's RRSP fast partitioning) over an IDR and two P pictures of 1080p
  through `encode_frame`;
- the encoder CLI on its default device (HM's Low Delay P Main cfg);

decodes the streams with the port's decoder and checks every picture hash,
and checks small encodes on the card (AI, LDP, RA and the per-CU search's
IPPP and RA) against the same encodes on the CPU (whose plain path the tests
hold to the JAX reference).  Every time printed stands beside the card's
name and power limit.  Every failure raises; the last line of standard
output is the device JSON, the line before it the kernel table.  Needs a
CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H, QP = 1920, 1080, 32
# one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and float32 operations/s
# outside the tensor cores (an FMA counted as two), the peak every kernel's
# int32 and float32 operations are held to
HBM_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12
CARD = "card not read"


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


def _flat(x):
    """A stage's outputs as a flat tuple of tensors (dicts in key order)."""
    if isinstance(x, dict):
        return tuple(t for k in sorted(x, key=str) for t in _flat(x[k]))
    if isinstance(x, (tuple, list)):
        return tuple(t for v in x for t in _flat(v))
    return (x,)


def _nbytes(tensors):
    """Bytes of the distinct tensors among `tensors` (views of one storage
    at one address counted once)."""
    seen, n = set(), 0
    for t in _flat(tensors):
        if isinstance(t, torch.Tensor) and t.numel():
            key = (t.data_ptr(), t.numel(), t.dtype)
            if key not in seen:
                seen.add(key)
                n += t.numel() * t.element_size()
    return n


def _new_stats(stats=None):
    from hm16_2_tpu_torch import kernels as K
    stats = {} if stats is None else stats
    for k in K.LAUNCHES:
        stats.setdefault(k, {"err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                             "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0})
    return stats


def _case(stats, reps):
    """A kernel check: run the kernel and its plain version, require equal
    outputs, time both, and add to stats[kernel] with the least time the
    card could take for the same work: each input read and each output
    written once over the HBM rate, or `ops` (a count of the algorithm's
    int32/float32 operations at these shapes) over the peak, the larger.
    Returns the kernel's result."""
    def case(kernel, label, run_k, run_p, ins, ops, r=reps):
        got, want = _flat(run_k()), _flat(run_p())
        err = _compare(f"{kernel} {label}", got, want)
        ms, pms = _cuda_ms(run_k, r), _cuda_ms(run_p, r)
        b_ms = (_nbytes(ins) + _nbytes(got)) / HBM_BYTES_S * 1e3
        o_ms = ops / PEAK_OPS_S * 1e3
        st = stats[kernel]
        st["err"] = max(st["err"], err)
        st["ms"] += ms
        st["plain_ms"] += pms
        st["bound_ms"] += max(b_ms, o_ms)
        st["bytes_ms"] += b_ms
        st["ops_ms"] += o_ms
        print(f"kernel {kernel:15s} {label:27s} equal  kernel {ms:9.3f} ms  "
              f"plain {pms:9.3f} ms  bound {max(b_ms, o_ms):8.4f} ms  "
              f"[{CARD}]", flush=True)
        return run_k()
    return case


# operation counts of the algorithms at given shapes (int32 and float32
# operations; a multiply-add counts two)
def _ops_rd(n, s, k):
    """35-mode prediction and SATD, then k candidates through the forward
    and inverse transforms, quant, dequant, SSE and bits."""
    return n * (35 * 12 * s * s + k * (8 * s ** 3 + 16 * s * s))


def _ops_me(R, h, w, shapes, comp_ops):
    """Downsample, coarse grid, pyramid, then per block and reference: the
    coarse argmin over 1089 offsets and the 98-candidate refinement.  The
    MV bits split by component, so they cost `comp_ops` for each of the
    2 x 33 coarse and 2 x 2 x 7 refinement components; each offset or
    candidate adds them, multiply-adds the lambda term and compares (a
    rect shape also adds its two half cells)."""
    n = {s: (h // s) * (w // s) for s in (8, 16, 32, 64)}
    ops = (R + 1) * h * w + R * 1089 * (12 * n[8] + 3 * (n[16] + n[32]
                                                        + n[64]))
    for bh, bw, N in shapes:
        ops += R * N * ((2 * 33 + 4 * 7) * comp_ops
                        + 1089 * (4 + (bh != bw)) + 98 * (bh * bw * 3 + 4))
    return ops


# operations of one MV component's bits: the plan's MVD bins (abs, two
# tests, shift, bit length, the 8192 case, 5 + 2e, to float) and
# me_frame's 2*log2(|d| + 1) + 1 (abs, to float, + 1, XLA's ln of about
# 38 operations, the final multiply-add)
MVD_BIN_OPS, MV_LOG_OPS = 11, 43


def check_kernels(frame, dev, reps=5):
    """Each kernel against its plain version at the shapes one frame's plan
    gives it.  Returns {kernel: {"err", "ms", "plain_ms", "bound_ms", ...}}
    summed over its cases."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import intra_rd as R

    H, W = frame[0].shape
    y, cb, cr = (torch.from_numpy(p.astype("int32")).to(dev) for p in frame)
    lam = 0.57 * 2.0 ** ((QP - 12) / 3.0)
    cw, cqp = 2.0 ** ((QP - 31) / 3.0), 31
    stats = _new_stats()
    case = _case(stats, reps)

    luma, chroma = {}, {}
    for s in (4, 8, 16, 32):
        n = (H // s) * (W // s)
        luma[s] = case("ref_buffers", f"luma s={s}",
                       lambda: K.ref_buffers(y, s, 8, True, H, W),
                       lambda: R._ref_buffers_plain(y, s, 8, True, H, W),
                       y, n * (4 * s + 1) * 8)
    for cs in (4, 8, 16):
        n = (H // 2 // cs) * (W // 2 // cs)
        chroma[cs] = case(
            "ref_buffers", f"chroma s={cs}",
            lambda: K.ref_buffers(cb, cs, 8, False, H // 2, W // 2),
            lambda: R._ref_buffers_plain(cb, cs, 8, False, H // 2, W // 2),
            cb, n * (4 * cs + 1) * 8)
    crb = {cs: R._ref_buffers_plain(cr, cs, 8, False, H // 2, W // 2)
           for cs in (4, 8, 16)}

    rd = {}
    for s in (4, 8, 16, 32):
        bufs, blocks = luma[s]
        k = R.NUM_RD_CANDS[s]
        n = blocks.shape[0]
        args = (bufs, blocks, float(lam), s, 8, k, QP, True, s == 4, s == 32)
        rd[s] = case("intra_size_rd", f"luma s={s} k={k}"
                     + (" +satd" if s == 32 else ""),
                     lambda: K.intra_size_rd(*args),
                     lambda: R._size_rd_plain(*args), (bufs, blocks),
                     _ops_rd(n, s, k))
        case("intra_size_rd", f"satd-only s={s}",
             lambda: K.intra_premodes(bufs, blocks, s, 8),
             lambda: R._premodes_plain(bufs, blocks, s, 8), (bufs, blocks),
             _ops_rd(n, s, 0))

    nby, nbx = {}, {}
    for s in (4, 8, 16, 32, 64):
        nby[s], nbx[s] = H // s, W // s
    db = {}
    for s in (8, 16, 32):
        cs = s // 2
        modes5 = case("plan_dp", f"chroma modes s={s}",
                      lambda: K.chroma_modes5(rd[s][0]),
                      lambda: R._chroma_modes5_plain(rd[s][0]), rd[s][0],
                      nby[s] * nbx[s] * 5 * 4)
        out = []
        for label, (bufs, blocks) in (("cb", chroma[cs]), ("cr", crb[cs])):
            n = blocks.shape[0]
            out += case("intra_cand_rd", f"chroma {label} s={cs} K=5",
                        lambda: K.intra_cand_rd(bufs, blocks, modes5, cs, 8,
                                                cqp, False, False),
                        lambda: R._cand_rd_plain(bufs, blocks, modes5, cs, 8,
                                                 cqp, False, False),
                        (bufs, blocks, modes5),
                        n * 5 * (4 * cs * cs + 8 * cs ** 3 + 16 * cs * cs))
        db[s] = out
    folds = {}
    for s in (8, 16, 32):
        cost = rd[s][1].reshape(nby[s], nbx[s])
        folds[s] = case("plan_dp", f"chroma fold s={s}",
                        lambda: K.chroma_fold(*db[s], cost, lam, cw),
                        lambda: R._chroma_fold_plain(*db[s], cost, lam, cw),
                        (db[s], cost), nby[s] * nbx[s] * 5 * 12)
    satd32 = rd[32][3].reshape(nby[32], nbx[32], 35)
    m64, pm64 = case("plan_dp", "mode64",
                     lambda: K.mode64(satd32, nby[64], nbx[64]),
                     lambda: R._mode64_plain(satd32, nby[64], nbx[64]),
                     satd32, nby[64] * nbx[64] * 35 * 8)
    idx = torch.as_tensor([(i * nbx[32] + j) for i in range(2 * nby[64])
                           for j in range(2 * nbx[64])], device=dev)
    b32, bl32 = luma[32][0][idx], luma[32][1][idx]
    d64, b64 = case("intra_cand_rd", "64x64 level s=32 K=1",
                    lambda: K.intra_cand_rd(b32, bl32, pm64[:, None], 32, 8,
                                            QP, True, False),
                    lambda: R._cand_rd_plain(b32, bl32, pm64[:, None], 32, 8,
                                             QP, True, False),
                    (b32, bl32, pm64), bl32.shape[0] * (
                        4 * 32 * 32 + 8 * 32 ** 3 + 16 * 32 * 32))
    mode_s = {s: rd[s][0].reshape(nby[s], nbx[s]) for s in (4, 8, 16, 32)}
    cost_s = {4: rd[4][1].reshape(nby[4], nbx[4])}
    cost_s.update({s: folds[s][0] for s in (8, 16, 32)})
    cand_s = {s: rd[s][2].reshape(nby[s], nbx[s], 3) for s in (4, 8, 16, 32)}
    cmode_s = {s: folds[s][2] for s in (8, 16, 32)}
    dp_args = (lam, H, W, mode_s, cost_s, cand_s, cmode_s, folds[32][1],
               d64[:, 0].contiguous(), b64[:, 0].contiguous(), m64)
    case("plan_dp", "DP + packed plan", lambda: K.plan_dp(*dp_args),
         lambda: R._plan_dp_plain(*dp_args), dp_args[3:],
         (H // 4) * (W // 4) * 7 * 8)
    return stats


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
    stats = _new_stats(stats)
    case = _case(stats, reps)
    mvp8 = P._mvp_full(mvn16, dists)
    me_shapes = [(bh, bw, Ny * Nx) for _, _, bh, bw, Ny, Nx in
                 P._shapes(H, W, True)]
    me = case("inter_me", f"{nref} refs, all CU shapes",
              lambda: K.inter_me(cur, refs, mvp8, lams, H, W, True),
              lambda: P._int_me_plain(cur, refs, mvp8, lams, H, W, True),
              (cur, refs, mvp8), _ops_me(nref, H, W, me_shapes, MVD_BIN_OPS),
              r=1)
    sub = case("subpel_planes", f"{nref} refs, 16 phases",
               lambda: K.subpel_planes(refs, 8, H, W),
               lambda: P._subpel_planes_plain(refs, 8, H, W), refs,
               nref * 16 * (H + 2 * P.MARGIN + 1) * (W + 2 * P.MARGIN + 1)
               * 32)
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
                                             bw), (sub, cur, mv, p4),
                nref * Ny * Nx * 49 * bh * bw * 10)
            p4 = p4.reshape(nref, -1, 2)
            unis[part] = case(
                "inter_uni", f"list pick {bh}x{bw}",
                lambda: K.uni_select(mvq, satd, p4, map0, nref, lams),
                lambda: P._uni_select_plain(mvq, satd, p4, map0, nref, lams),
                (mvq, satd, p4, map0), nref * Ny * Nx * 12)
            if part == 0:
                tmvp4 = p4[0].contiguous()
        intra = None
        if s <= 32:
            bufs, blocks = R._ref_buffers_plain(cur, s, 8, True, H, W)
            args = (bufs, blocks, lamf, s, 8, 3, qp, True, False, False)
            intra = case("intra_size_rd", f"inter offset s={s} k=3",
                         lambda: K.intra_size_rd(*args, True),
                         lambda: R._size_rd_plain(*args, True),
                         (bufs, blocks), _ops_rd(ny * nx, s, 3))[:3]
        rect = {1: unis[1], 2: unis[2]} if 1 in unis else None
        cargs = (cur, sub, s, unis[0], tmvp4, 0, rect, intra, lamf, lams, qp,
                 8, 5)
        recs[s], costs[s] = case(
            "inter_cu_rd", f"CU pricing s={s}", lambda: K.cu_rd(*cargs),
            lambda: P._cu_rd_plain(*cargs),
            (cur, sub, unis, tmvp4, rect, intra),
            ny * nx * s * s * (80 + 16 * min(s, 32) + 32))
    case("plan_dp", "P plan DP + packed plan",
         lambda: K.emit_inter_plan(recs, costs, lamf, H, W),
         lambda: P._emit_plain(recs, costs, lamf, H, W), (recs, costs),
         (H // 4) * (W // 4) * 24 * 4)
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
    stats = _new_stats(stats)
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
                                            nref[lx], lams),
                (mvq, satd, p4, maps[lx]), len(order) * Ny * Nx * 12)
                for lx in (0, 1)]
        u0, u1 = unis[0]
        a1 = (sub, cur, u1["mv"], u1["uref"], u1["anchor"], u0["uref"],
              u0["mv"], lams, s)
        mv1b = case("inter_bi_refine", f"list 1 pass {s}x{s}",
                    lambda: K.frac_refine_any(*a1),
                    lambda: P._frac_refine_any_plain(*a1), a1[:7],
                    ny * nx * 49 * s * s * 14)[0]
        a0 = (sub, cur, u0["mv"], u0["uref"], u0["anchor"], u1["uref"], mv1b,
              lams, s)
        mv0b = case("inter_bi_refine", f"list 0 pass {s}x{s}",
                    lambda: K.frac_refine_any(*a0),
                    lambda: P._frac_refine_any_plain(*a0), a0[:7],
                    ny * nx * 49 * s * s * 14)[0]
        intra = None
        if s <= 32:
            bufs, blocks = K.ref_buffers(cur, s, 8, True, H, W)
            intra = K.intra_size_rd(bufs, blocks, lamf, s, 8, 3, qp, True,
                                    False, False, True)[:3]
        rect = {1: unis[1], 2: unis[2]} if 1 in unis else None
        cargs = (cur, sub, s, unis[0], tmvp4, first, nref, [mv0b, mv1b],
                 rect, intra, lamf, lams, qp, 8, 5)
        recs[s], costs[s] = case(
            "inter_cu_rd_b", f"B CU pricing s={s}", lambda: K.cu_rd_b(*cargs),
            lambda: P._cu_rd_b_plain(*cargs),
            (cur, sub, unis, tmvp4, [mv0b, mv1b], rect, intra),
            ny * nx * s * s * (120 + 16 * min(s, 32) + 32))
    case("plan_dp", "B plan DP + packed plan",
         lambda: K.emit_inter_plan(recs, costs, lamf, H, W),
         lambda: P._emit_plain(recs, costs, lamf, H, W), (recs, costs),
         (H // 4) * (W // 4) * 24 * 4)
    return stats


def check_me_frame(frames, dev, reps=3, stats=None, nref=4):
    """K5 in me_frame's mode (log bit model, costs out) against its plain
    version at the shapes of the frame ME of a picture without a plan: the
    last of `frames` against the `nref` before it, QP 32, a non-zero prior
    (the previous picture's motion field, here random within +-24
    full-pel).  Adds to `stats`."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_me as M

    H, W = frames[-1][0].shape
    cur = torch.from_numpy(frames[-1][0].astype("int32")).to(dev)
    refs = torch.from_numpy(np.stack([frames[-1 - d][0] for d in
                                      range(1, nref + 1)]).astype("int32")) \
        .to(dev)
    rng = np.random.default_rng(13)
    mvp8 = torch.from_numpy(rng.integers(-24, 25, (nref, H // 8, W // 8, 2))
                            .astype("int32")).to(dev)
    lam = float(np.float32(np.sqrt(0.85 * 2.0 ** ((QP - 12) / 3.0))))
    stats = _new_stats(stats)
    case = _case(stats, reps)
    shapes = [(s, s, (H // s) * (W // s)) for s in (8, 16, 32, 64)]
    case("me_frame", f"{nref} refs, squares 8-64",
         lambda: K.me_frame(cur, refs, mvp8, lam, H, W),
         lambda: M._me_frame_plain(cur, refs, mvp8, lam, H, W),
         (cur, refs, mvp8), _ops_me(nref, H, W, shapes, MV_LOG_OPS), r=1)
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
    "me_frame": ("inter_me.cu", "hm16_2_tpu/encode/inter_me.py:47"),
}
B_ONLY = ("inter_bi_refine", "inter_cu_rd_b")     # kernels of B pictures only
INTRA = ("ref_buffers", "intra_size_rd", "intra_cand_rd", "plan_dp")
PLAN_ONLY = ("inter_me", "subpel_planes", "inter_uni", "inter_bi_refine",
             "inter_cu_rd", "inter_cu_rd_b")      # kernels of the fused plan


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
    from hm16_2_tpu_torch.decode.top import Decoder
    t0 = time.perf_counter()
    pics = Decoder().decode_stream(b"".join(aus))
    print(f"{label}: decoded {len(pics)} pictures in "
          f"{time.perf_counter() - t0:.1f} s, hash_ok "
          f"{[p.hash_ok for p in pics]}  [{CARD}]", flush=True)
    if len(pics) != n or not all(p.hash_ok is True for p in pics):
        raise AssertionError(f"{label}: decoded picture hash mismatch")


def _push_all(enc, frames, first=0):
    """Push frames[first:] (POC = index) and flush."""
    aus = []
    for poc in range(first, len(frames)):
        aus += enc.push_frame([p.astype("int32") for p in frames[poc]], poc)
    return aus + enc.flush()


@contextlib.contextmanager
def _env(name, value):
    """Set one environment switch of the encoder for the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def _timed_pictures(enc, code, label, top):
    """Code the pictures of `code()` (a list of AUs) under torch.profiler
    (device activity only); prints the device busy share and the `top`
    kernels by device time.  Returns (AUs, seconds, stage_ms of these
    pictures)."""
    from torch.profiler import ProfilerActivity, profile
    before = dict(enc.stage_ms)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        aus = code()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile of the {label}: device busy {busy:.3f} ms of "
          f"{wall * 1e3:.3f} ms wall = {100 * busy / (wall * 1e3):.3f}%  "
          f"[{CARD}]", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.key[:60]:60s} {e.self_device_time_total / 1e3:10.3f}"
              f" ms  x{e.count}", flush=True)
    return aus, wall, {k: v - before.get(k, 0.0)
                       for k, v in enc.stage_ms.items()}


def _report(label, n, unit, idr_s, wall, stage, aus, extra=""):
    print(f"{label}: {len(aus)} pictures; IDR {idr_s:.3f} s; {n} {unit} "
          f"pictures in {wall:.3f} s = {n / wall:.3f} fps, "
          f"{wall / n:.3f} s per {unit} picture{extra}; bytes "
          f"{[len(a) for a in aus]}  [{CARD}]", flush=True)
    print(f"stage_ms per {unit} picture: " + json.dumps(
        {k: round(v / n, 3) for k, v in stage.items()}) + f"  [{CARD}]",
        flush=True)


def _idr(code):
    """Code the IDR picture(s) of `code()`; returns (AUs, seconds)."""
    t0 = time.perf_counter()
    aus = code()
    torch.cuda.synchronize()
    return aus, time.perf_counter() - t0


def ldp_phase(frames, dev):
    """HM's Low Delay P Main over IDR + one GOP of four P pictures through
    push_frame / flush; prints fps, the P pictures' stage_ms and their
    device busy share.  Returns the AUs and the launch counts."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    H, W = frames[0][0].shape
    enc = Encoder(EncoderConfig(W, H, qp=QP, intra_period=0, gop="ld"), dev)
    out = {}

    def run():
        aus, out["idr"] = _idr(lambda: enc.push_frame(
            [p.astype("int32") for p in frames[0]], 0))
        rest, out["wall"], out["stage"] = _timed_pictures(
            enc, lambda: _push_all(enc, frames, 1), "P pictures", 12)
        return aus + rest

    aus, counts = _launches_of(K, run, f"LDP {W}x{H}",
                               [k for k in K.LAUNCHES
                                if k not in B_ONLY + ("me_frame",)])
    _report(f"LDP {W}x{H} QP{QP} GOP4", len(frames) - 1, "P", out["idr"],
            out["wall"], out["stage"], aus)
    return aus, counts


def ra_phase(frames, dev):
    """HM's Random Access Main over IDR + one GOP of eight B pictures through
    push_frame / flush; prints fps over the B pictures, their stage_ms, the
    number of plans enqueued ahead (pictures 3, 6, 7) and the device busy
    share of the B pictures.  Returns the AUs and the launch counts."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    H, W = frames[0][0].shape
    enc = Encoder(EncoderConfig(W, H, qp=QP, intra_period=32, gop="ra8"), dev)
    ahead = []
    predispatch = enc._predispatch_ra

    def counted(planes, poc, *a, **kw):
        res = predispatch(planes, poc, *a, **kw)
        if res is not None:
            ahead.append(poc)
        return res

    enc._predispatch_ra = counted
    out = {}

    def run():
        aus, out["idr"] = _idr(lambda: enc.push_frame(
            [p.astype("int32") for p in frames[0]], 0))
        rest, out["wall"], out["stage"] = _timed_pictures(
            enc, lambda: _push_all(enc, frames, 1), "B pictures", 14)
        return aus + rest

    aus, counts = _launches_of(K, run, f"RA {W}x{H}",
                               [k for k in K.LAUNCHES
                                if k not in ("inter_cu_rd", "me_frame")])
    _report(f"RA {W}x{H} QP{QP} GOP8", len(frames) - 1, "B", out["idr"],
            out["wall"], out["stage"], aus,
            f"; plans enqueued ahead for POCs {ahead}")
    if sorted(ahead) != [3, 6, 7]:
        raise AssertionError(f"RA: plans enqueued ahead for {ahead}, not for "
                             "POCs 3, 6 and 7")
    return aus, counts


def fallback_phase(frames, dev):
    """The per-CU inter search on an IDR and two P pictures (encode_frame,
    intra period 8, QP 32, HM16_NO_INTER_PLAN, RRSP on): each P picture
    runs one frame ME on the card (K5 in me_frame's mode) and its CU search
    and commit on the host.  Prints s per P picture, their stage_ms, the
    device busy share and me_frame's launches.  Returns the AUs and the
    launch counts."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    H, W = frames[0][0].shape
    enc = Encoder(EncoderConfig(W, H, qp=QP, intra_period=8, rrsp=True), dev)
    out = {}
    planes = [[p.astype("int32") for p in f] for f in frames]

    def run():
        aus, out["idr"] = _idr(lambda: [enc.encode_frame(planes[0], 0)])
        rest, out["wall"], out["stage"] = _timed_pictures(
            enc, lambda: [enc.encode_frame(planes[poc], poc)
                          for poc in range(1, len(frames))],
            "P pictures of the per-CU search", 10)
        return aus + rest

    with _env("HM16_NO_INTER_PLAN", "1"):
        aus, counts = _launches_of(K, run, f"per-CU search {W}x{H}",
                                   INTRA + ("me_frame",))
    if any(counts[k] for k in PLAN_ONLY):
        raise AssertionError("the per-CU search launched a plan kernel")
    _report(f"per-CU search (HM16_NO_INTER_PLAN, RRSP) {W}x{H} QP{QP} IPPP",
            len(frames) - 1, "P", out["idr"], out["wall"], out["stage"], aus,
            f"; me_frame launches {counts['me_frame']}")
    return aus, counts


def small_checks(dev):
    """136x72 encodes on the card against the same encodes on the CPU: AI,
    LDP, RA through the fused plans, and IPPP and RA through the per-CU
    search (HM16_NO_INTER_PLAN)."""
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    small = _frames(136, 72, 9)
    cpu = torch.device("cpu")

    def same(label, cfg, code):
        on_card, on_cpu = code(Encoder(cfg(), dev)), code(Encoder(cfg(), cpu))
        if on_card != on_cpu:
            raise AssertionError(f"136x72 {label} on the card differs from "
                                 "the CPU")
        print(f"136x72 {label}: card bytes equal CPU plain-path bytes",
              flush=True)

    frames_of = lambda enc, k: [enc.encode_frame(
        [p.astype("int32") for p in f], i) for i, f in enumerate(small[:k])]
    same("3-frame AI encode",
         lambda: EncoderConfig(136, 72, qp=QP, intra_period=1),
         lambda enc: list(enc.encode_stream(small[:3])))
    same("5-frame LDP encode",
         lambda: EncoderConfig(136, 72, qp=QP, intra_period=0, gop="ld"),
         lambda enc: _push_all(enc, small[:5]))
    same("9-frame RA encode",
         lambda: EncoderConfig(136, 72, qp=QP, intra_period=32, gop="ra8"),
         lambda enc: _push_all(enc, small))
    with _env("HM16_NO_INTER_PLAN", "1"):
        same("4-frame IPPP per-CU search (RRSP, SBD)",
             lambda: EncoderConfig(136, 72, qp=QP, intra_period=8, rrsp=True,
                                   sbd=True),
             lambda enc: frames_of(enc, 4))
        same("9-frame RA per-CU search",
             lambda: EncoderConfig(136, 72, qp=QP, intra_period=32,
                                   gop="ra8"),
             lambda enc: _push_all(enc, small))


def cli_phase():
    """The encoder CLI on its default device (the card) with HM's Low Delay
    P Main cfg on a 136x72 YUV; its stream must decode.  Returns the launch
    counts."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.tools import encode as cli
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from make_fixtures import write_yuv
    with tempfile.TemporaryDirectory() as d:
        yuv, out = os.path.join(d, "in.yuv"), os.path.join(d, "out.bin")
        write_yuv(yuv, _frames(136, 72, 5))
        args = ["-c", os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg"),
                "-i", yuv, "-b", out, "-wdt", "136", "-hgt", "72", "-f", "5"]
        rc, counts = _launches_of(K, lambda: cli.main(args), "CLI 136x72",
                                  INTRA + ("inter_me",))
        if rc != 0:
            raise AssertionError(f"encoder CLI exited {rc}")
        with open(out, "rb") as f:
            _decode_check([f.read()], 5, "CLI 136x72 LDP")
    return counts


def main():
    global CARD
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    sys.path.insert(0, ROOT)
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch import native
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig

    CARD = _card_line()
    print(CARD, flush=True)
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    print(f"device {name}  torch {torch.__version__}  cuda "
          f"{torch.version.cuda}", flush=True)
    path, secs = K.build()
    print(f"kernels built in {secs:.1f} s: {os.path.relpath(path, ROOT)}  "
          f"[{CARD}]", flush=True)
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
    check_me_frame(frames[1:6], dev, stats=stats)
    check_me_frame(frames[4:6], dev, stats=stats, nref=1)

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
          f"{(time.perf_counter() - t0) / 5 * 1e3:.3f} ms per frame  "
          f"[{CARD}]", flush=True)
    enc = Encoder(cfg(), dev)
    t0 = time.perf_counter()
    aus, ai_counts = _launches_of(
        K, lambda: list(enc.encode_stream(frames[:3])), f"AI {W}x{H}", INTRA)
    wall = time.perf_counter() - t0
    print(f"encode_stream {W}x{H} AI QP{QP}: 3 frames in {wall:.3f} s = "
          f"{3 / wall:.3f} fps; bytes {[len(a) for a in aus]}  [{CARD}]",
          flush=True)
    print("stage_ms per frame: " + json.dumps(
        {k: round(v / 3, 3) for k, v in enc.stage_ms.items()})
        + f"  [{CARD}]", flush=True)
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

    # the per-CU inter search: IDR + two P pictures without a fused plan
    fb_aus, fb_counts = fallback_phase(frames[:3], dev)
    _decode_check(fb_aus, 3, "per-CU search")

    small_checks(dev)
    cli_phase()

    loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "hm16_2_tpu" or m.startswith("hm16_2_tpu.")]
    if loaded:
        raise AssertionError(f"modules of jax or the JAX package loaded: "
                             f"{loaded[:5]}")
    print("neither jax nor the JAX package imported", flush=True)
    print(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s  [{CARD}]",
          flush=True)

    runs = (ai_counts, ldp_counts, ra_counts, fb_counts)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"hm16_2_tpu_torch/csrc/{SOURCES[k][0]}",
         "replaces": SOURCES[k][1],
         "launches": sum(c[k] for c in runs),
         "max_abs_err": stats[k]["err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"], "bound_ms": stats[k]["bound_ms"],
         "bound_by": ("bytes" if stats[k]["bytes_ms"] >= stats[k]["ops_ms"]
                      else "operations"),
         "library_ms": None} for k in K.LAUNCHES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `hm16_2_tpu_torch/csrc`, holds each
against its plain PyTorch version on the card at the shapes of a 1920x1080
all-intra frame, of a 1080p P picture with four live references, of a
1080p B picture with two past and two future references and of the frame ME
of a 1080p picture without a plan (four references, and the one reference
of the per-CU search's IPPP pictures, a non-zero prior), and holds K5 and
K7 to theirs on the edge inputs their invariants rest on (flat pictures,
ramps, 12-bit noise, priors of +-70, a row band; a flat 1080p picture;
`check_me_edges`), K6 and K8 to theirs on the redesign's edge inputs
(zero, maximum, checkerboard and edge-line references at 8-12 bits; flat,
one-CTU and capped-prior P and B plans; 10- and 12-bit references and flat
P and B plans at 1080p; `check_k6_k8_edges`) and K2 and K3 to theirs on
theirs (tied SATDs and costs, levels at the 32767 cap, a wrapped 12-bit
SSE, a clamped dequant, 12-bit noise, batches no CTA's group divides;
`check_intra_edges`) and K4 and K7's list picks to theirs inside AI, P and
B plans at 232x152 (every border rule) and 1024x768, flat 1080p plans,
banded plans and tied cost grids (`check_k4_picks_edges`) and K1 to its
own (a picture's sizes and planes in one launch at 232x152, 136x72, one
CTU and a picture too short for s = 32; a plane larger than the picture;
the strong-smoothing threshold met on both sides at 8, 10 and 12 bits; the
band mode's groups and its zero halo; `check_k1_edges`), prints K2's and
K3's time by case beside the bound, then drives the port's paths:

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
  fork's RRSP fast partitioning) over an IDR and one P picture of 1080p
  through `encode_frame`;
- HM's All Intra Main10 over three 1080p frames and Random Access Main10
  over IDR + one GOP of eight B pictures on 10-bit content (`main10_phase`:
  the configurations tools/encode.py builds from the Main10 cfg files; the
  first 10-bit I and B plans run again with every kernel held to its plain
  version);
- HM's Low Delay P Main under R-lambda rate control at 4 Mbit/s, at
  picture and at CTU level, over five 1080p frames (`rc_phase`: each
  picture's QP, lambda and bits against its target; every kernel of the
  first P plan held to its plain version at the model's lambda and at the
  ends of the model's lambda range);
- delta_qp_rd=1 on two 1080p AI frames and five 1080p LDP frames
  (`dqp_phase`: four plans per picture, asserted by K1's and K4's
  launches);
- field coding of 1920x1088 AI over two frames and LDP over three
  (`field_phase`: 544-row fields, partial CTU rows);
- the encoder CLI on its default device (HM's Low Delay P Main cfg);
- the row-banded path (`hm16_2_tpu_torch/parallel/`) with its bands on this
  one card: K1's and K5's band modes and K2's analysis mode against their
  plain versions (1080p, and 1024x768, HM's class F size, over 2 and 4
  bands with four references), the banded grids against the whole
  picture's, two 1080p AI frames with the intra plan banded and a 1024x768
  RA GOP 8 with both plans banded over 2 and 4 bands against the unbanded
  bytes, and the port's scaling_bench (bands sharing one card: the
  plumbing cost, not multi-GPU scaling);

decodes the streams with the port's decoder and checks every picture hash,
holds every 1080p stream (AI, LDP, RA, the per-CU search, Main10 AI and
RA), its input planes first, to the JAX package's SHA-256 pinned in
`hm16_2_tpu_torch/tools/stream_digest.py` (the card's machine has no JAX;
the tests reproduce the pins from the JAX package), and checks small
encodes on the card (AI, LDP, RA, rate-controlled LDP and RA, delta_qp_rd
AI and LDP, field-coded AI and LDP, and the per-CU search's IPPP and RA)
against the same encodes on the CPU and both against the pinned digests.
Every time printed stands beside the card's name and power limit.  Every
failure raises; the last line of standard output is the device JSON, the
line before it the kernel table.  Needs a CUDA device and exits non-zero
without one.
"""

from __future__ import annotations

import contextlib
import io
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
        st.setdefault("cases", {})[label] = (ms, pms, max(b_ms, o_ms))
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


def _ops_me(R, h, w, shapes, comp_ops, ref_h=None):
    """Downsample, coarse grid, pyramid, then per block and reference: the
    coarse argmin over 1089 offsets and the 98-candidate refinement.  The
    MV bits split by component, so they cost `comp_ops` for each of the
    2 x 33 coarse and 2 x 2 x 7 refinement components; each offset or
    candidate adds them, multiply-adds the lambda term and compares (a
    rect shape also adds its two half cells).  A band of h rows downsamples
    the whole ref_h-row references."""
    n = {s: (h // s) * (w // s) for s in (8, 16, 32, 64)}
    ops = (R * (ref_h or h) + h) * w + R * 1089 * (12 * n[8] + 3 * (
        n[16] + n[32] + n[64]))
    for bh, bw, N in shapes:
        ops += R * N * ((2 * 33 + 4 * 7) * comp_ops
                        + 1089 * (4 + (bh != bw)) + 98 * (bh * bw * 3 + 4))
    return ops


def _ops_analysis(n, s):
    """35-mode prediction and SATD, the argmin, then the winner's forward
    transform (two s x s matrix products) and quant."""
    return n * (35 * 12 * s * s + 35 + 4 * s ** 3 + 8 * s * s)


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

    # K1: an AI picture's group (luma s = 4-32, Cb and Cr at s = 4-16) and
    # a P/B picture's (luma s = 8-32), one launch each
    planes = {"y": (y, 8, True, H, W), "cb": (cb, 8, False, H // 2, W // 2),
              "cr": (cr, 8, False, H // 2, W // 2)}
    keys = [("y", s) for s in (4, 8, 16, 32)] + [
        (c, cs) for cs in (4, 8, 16) for c in ("cb", "cr")]
    for label, ks in (("AI group, 10 entries", keys),
                      ("P/B group, 3 entries", keys[1:4])):
        ent = [(planes[c][0], s) + planes[c][1:] for c, s in ks]
        out = case("ref_buffers", label, lambda: K.ref_buffers_multi(ent),
                   lambda: [R._ref_buffers_plain(*e) for e in ent],
                   [planes[c][0] for c in dict(ks)],
                   sum((e[4] // e[1]) * (e[5] // e[1]) * (4 * e[1] + 1) * 8
                       for e in ent))
        if ks is keys:
            k1 = dict(zip(keys, out))
    luma = {s: k1[("y", s)] for s in (4, 8, 16, 32)}
    chroma = {cs: k1[("cb", cs)] for cs in (4, 8, 16)}
    crb = {cs: k1[("cr", cs)] for cs in (4, 8, 16)}

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
    satd32 = rd[32][3].reshape(nby[32], nbx[32], 35)
    dms = [rd[s][0] for s in (8, 16, 32)]
    modes5, m64, pm64 = case(
        "plan_dp", "pre: chroma modes, mode64",
        lambda: K.plan_pre(dms, satd32, nby[64], nbx[64]),
        lambda: R._plan_pre_plain(dms, satd32, nby[64], nbx[64]),
        (dms, satd32), sum(d.numel() for d in dms) * 5 * 4
        + nby[64] * nbx[64] * 35 * 8)
    db = {}
    for s, m5 in zip((8, 16, 32), modes5):
        cs = s // 2
        out = []
        for label, (bufs, blocks) in (("cb", chroma[cs]), ("cr", crb[cs])):
            n = blocks.shape[0]
            out += case("intra_cand_rd", f"chroma {label} s={cs} K=5",
                        lambda: K.intra_cand_rd(bufs, blocks, m5, cs, 8,
                                                cqp, False, False),
                        lambda: R._cand_rd_plain(bufs, blocks, m5, cs, 8,
                                                 cqp, False, False),
                        (bufs, blocks, m5),
                        n * 5 * (4 * cs * cs + 8 * cs ** 3 + 16 * cs * cs))
        db[s] = out
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
    cost_s = {s: rd[s][1].reshape(nby[s], nbx[s]) for s in (4, 8, 16, 32)}
    cand_s = {s: rd[s][2].reshape(nby[s], nbx[s], 3) for s in (4, 8, 16, 32)}
    dp_args = (lam, cw, H, W, mode_s, cost_s, cand_s, db,
               d64[:, 0].contiguous(), b64[:, 0].contiguous(), m64)
    case("plan_dp", "CTU: fold, DP, packed plan", lambda: K.plan_dp(*dp_args),
         lambda: R._plan_ctu_plain(*dp_args), dp_args[4:],
         sum(nby[s] * nbx[s] for s in (8, 16, 32)) * 5 * 12
         + (H // 4) * (W // 4) * 7 * 8)
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
    qpel = {}
    for s, part, bh, bw, Ny, Nx in P._shapes(H, W, True):
        p4 = (4 * P._me_mvp(mvp8, s, part)[:, :Ny, :Nx]).contiguous()
        mv = me[(s, part)]
        mvq, satd = case(
            "inter_uni", f"q-pel refine {bh}x{bw}",
            lambda: K.frac_refine(sub, cur, mv, p4, lams, bh, bw),
            lambda: P._frac_refine_plain(sub, cur, mv, p4, lams, bh, bw),
            (sub, cur, mv, p4), nref * Ny * Nx * 49 * bh * bw * 10)
        qpel[(s, part)] = (mvq, satd, p4.reshape(nref, -1, 2), map0, nref)
    entries = list(qpel.values())
    picks = dict(zip(qpel, case(
        "inter_pick", f"P picks, {len(entries)} shapes",
        lambda: K.uni_select_all(entries, lams),
        lambda: P._uni_select_all_plain(entries, lams), entries,
        sum(nref * e[1].shape[1] * 12 for e in entries))))
    recs, costs = {}, {}
    for s in P.SIZES:
        ny, nx = H // s, W // s
        recs[s] = costs[s] = None
        if not (ny and nx):
            continue
        unis = {part: picks[(s, part)] for part in (0, 1, 2)
                if (s, part) in picks}
        tmvp4 = qpel[(s, 0)][2][0].contiguous()
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
    qpel = {}
    for s, part, bh, bw, Ny, Nx in P._shapes(H, W, True):
        p4 = (4 * P._me_mvp(mvp8, s, part)[:, :Ny, :Nx]).contiguous()
        mvq, satd = K.frac_refine(sub, cur, me[(s, part)], p4, lams, bh, bw)
        qpel[(s, part)] = (mvq, satd, p4.reshape(len(order), -1, 2))
    keys = [(k, lx) for k in qpel for lx in (0, 1)]
    entries = [qpel[k] + (maps[lx], nref[lx]) for k, lx in keys]
    picks = dict(zip(keys, case(
        "inter_pick", f"B picks, {len(entries)} shapes x lists",
        lambda: K.uni_select_all(entries, lams),
        lambda: P._uni_select_all_plain(entries, lams), entries,
        sum(len(order) * e[1].shape[1] * 12 for e in entries))))
    recs, costs = {}, {}
    for s in P.SIZES:
        ny, nx = H // s, W // s
        recs[s] = costs[s] = None
        if not (ny and nx):
            continue
        unis = {part: [picks[((s, part), lx)] for lx in (0, 1)]
                for part in (0, 1, 2) if ((s, part), 0) in picks}
        tmvp4 = [qpel[(s, 0)][2][f].contiguous() for f in first]
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


# the inputs on which the K5 / K7 redesign's invariants rest
ME_EDGE_CASES = ("flat", "flat_vs_shifted", "noise12", "far_priors", "band")


def me_edge_inputs(case, h=64, w=128, nref=2):
    """Seeded numpy inputs of one edge case of K5: "flat" (every SSD 0, the
    bits decide every argmin, with ties), "flat_vs_shifted" (a flat
    picture against horizontal and vertical ramps: rows or columns of
    equal SSE, ties between the refinement's two centres), "noise12"
    (12-bit noise: the 64x64 int32 SSE wraps), "far_priors" (near-flat
    content and priors of +-69 / +-70 full-pel: MVs and windows past every
    picture edge), "band" (rows 64.. of an (h + 128)-row picture against
    the whole references, priors of +-70 across the band's edges).
    Returns cur (h, w), refs (nref, full_h, w), bit depth, row0, full_h
    and the per-reference full-pel priors mvp8 (nref, h/8, w/8, 2)."""
    rng = np.random.default_rng(31 + ME_EDGE_CASES.index(case))
    full_h, row0, bd, prior = h, 0, 8, 20
    if case == "flat":
        cur, refs = np.full((h, w), 100), np.full((nref, h, w), 100)
    elif case == "flat_vs_shifted":
        cur, prior = np.full((h, w), 128), 0
        ramp = lambda n, r: 96 + (np.arange(n) + 3 * r) // 2
        refs = np.stack([np.broadcast_to(ramp(w, r)[None, :], (h, w))
                         if r % 2 == 0 else
                         np.broadcast_to(ramp(h, r)[:, None], (h, w))
                         for r in range(nref)])
    elif case == "noise12":
        bd, prior = 12, 8
        base = rng.integers(0, 4096, (h + 8, w + 8))
        cur = base[4:4 + h, 4:4 + w]
        refs = np.stack([rng.integers(0, 4096, (h, w)) if r % 2 == 0 else
                         base[4 + r:4 + r + h, 2:2 + w] for r in range(nref)])
    elif case == "far_priors":
        cur = 128 + rng.integers(-1, 2, (h, w))
        refs = 128 + rng.integers(-1, 2, (nref, h, w))
    else:
        full_h, row0, prior = h + 128, 64, 70
        base = rng.integers(0, 256, (full_h + 16, w + 16))
        refs = np.stack([np.clip(np.roll(base, (3 * r + 2, -2 * r - 1), (0, 1))
                                 [8:8 + full_h, 8:8 + w]
                                 + rng.integers(-3, 4, (full_h, w)), 0, 255)
                         for r in range(nref)])
        cur = base[8 + row0:8 + row0 + h, 8:8 + w]
    shape = (nref, h // 8, w // 8, 2)
    mvp8 = rng.choice([-70, -69, 69, 70], shape) if case == "far_priors" \
        else rng.integers(-prior, prior + 1, shape)
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return {"cur": i32(cur), "refs": i32(refs), "bd": bd, "row0": row0,
            "full_h": full_h, "mvp8": i32(mvp8)}


def k7_edge_inputs(case, d, bh, bw):
    """K7's inputs on the pictures of me_edge_inputs(case) (not "band": K7
    has no band mode) for blocks of bh x bw: integer MVs mv and quarter-pel
    anchors p4 (R, ny, nx, 2) of frac_refine; for frac_refine_any (bh ==
    bw) quarter-pel start MVs (negative odd ones too), per-block references,
    anchors and the other list's hypotheses.  "far_priors" puts every MV at
    +-69 or +-70 full-pel, the others within +-20."""
    rng = np.random.default_rng(41 + ME_EDGE_CASES.index(case) + bh + 3 * bw)
    R, h, w = d["refs"].shape[0], *d["cur"].shape
    ny, nx = h // bh, w // bw
    n = ny * nx
    if case == "far_priors":
        full = lambda sh: rng.choice([-70, -69, 69, 70], sh)
    else:
        full = lambda sh: rng.integers(-20, 21, sh)
    quarter = lambda sh: 4 * full(sh) + rng.integers(-3, 4, sh)
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return {"mv": i32(full((R, ny, nx, 2))),
            "p4": i32(quarter((R, ny, nx, 2))),
            "mv4": i32(quarter((n, 2))), "uref": i32(rng.integers(0, R, n)),
            "anchor": i32(quarter((n, 2))),
            "o_uref": i32(rng.integers(0, R, n)),
            "o_mv4": i32(quarter((n, 2)))}


# K7's block shapes in the edge cases: the smallest, a rect, the largest
K7_EDGE_SHAPES = ((8, 8), (16, 8), (64, 64))


def _edge_lams():
    """(lams of the plan's ME and K7, lam of me_frame) at QP, float32."""
    return (float(np.float32(np.sqrt(0.578 * 2.0 ** ((QP - 12) / 3.0)))),
            float(np.float32(np.sqrt(0.85 * 2.0 ** ((QP - 12) / 3.0)))))


def check_me_edges(dev, size=(64, 128), big=(1080, 1920)):
    """K5 (both bit models, whole and band) and K7 (uni and bi modes) on
    the card against their plain versions on the same card, every output
    equal bit for bit, on the edge inputs (me_edge_inputs, at `size`; the
    CPU tests hold the plain versions to the JAX package on the same
    inputs), then on a flat picture at `big` with four references: every
    coarse SSD ties and the bits decide.  Raises on the first difference;
    times nothing."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_me as M
    from hm16_2_tpu_torch.encode import inter_plan as P
    lams, lam_me = _edge_lams()
    t = lambda a: torch.from_numpy(a).to(dev)
    n_eq = 0

    def same(label, got, want):
        nonlocal n_eq
        _compare(f"edge {label}", _flat(got), _flat(want))
        n_eq += 1

    cases = [(c, me_edge_inputs(c, *size)) for c in ME_EDGE_CASES]
    cases.append(("flat", me_edge_inputs("flat", *big, nref=4)))
    for case, d in cases:
        h, w = d["cur"].shape
        label = f"{case} {w}x{h}"
        cur, refs, mvp8 = t(d["cur"]), t(d["refs"]), t(d["mvp8"])
        r0, fh = d["row0"], d["full_h"]
        same(f"{label} int_me",
             K.inter_me(cur, refs, mvp8, lams, h, w, True, r0, fh),
             P._int_me_plain(cur, refs, mvp8, lams, h, w, True, r0))
        same(f"{label} me_frame",
             K.me_frame(cur, refs, mvp8, lam_me, h, w, r0, fh),
             M._me_frame_plain(cur, refs, mvp8, lam_me, h, w, r0))
        if case == "band":
            continue
        sub = K.subpel_planes(refs, d["bd"], h, w)
        shapes = K7_EDGE_SHAPES if (h, w) == size else \
            [(bh, bw) for _, _, bh, bw, _, _ in P._shapes(h, w, True)]
        for bh, bw in shapes:
            k = {key: t(v) for key, v in k7_edge_inputs(case, d, bh,
                                                        bw).items()}
            same(f"{label} frac_refine {bh}x{bw}",
                 K.frac_refine(sub, cur, k["mv"], k["p4"], lams, bh, bw),
                 P._frac_refine_plain(sub, cur, k["mv"], k["p4"], lams, bh,
                                      bw))
            if bh != bw:
                continue
            a = (sub, cur, k["mv4"], k["uref"], k["anchor"], k["o_uref"],
                 k["o_mv4"], lams, bh)
            same(f"{label} frac_refine_any {bh}x{bw}", K.frac_refine_any(*a),
                 P._frac_refine_any_plain(*a))
    print(f"K5/K7 edge inputs ({', '.join(ME_EDGE_CASES)} at "
          f"{size[1]}x{size[0]}; flat {big[1]}x{big[0]}, 4 refs): {n_eq} "
          f"kernel outputs equal their plain versions  [{CARD}]", flush=True)
    return n_eq


# the inputs on which K1's invariants rest: every border and clamping rule,
# an empty entry, and the strong-smoothing threshold met on both sides
K1_EDGE_CASES = ("232x152", "136x72", "one_ctu", "short", "big_plane", "bd8",
                 "bd10", "bd12")
# band mode: (h, w, n); at 136x72 the sizes fall in two groups, and the
# last band's zero halo_bot is read (ROADMAP "Faults found")
K1_BAND_CASES = ((128, 128, 2), (128, 128, 4), (72, 136, 2))


def k1_threshold_plane(h, w, bd, seed):
    """A flat bd-bit plane (2^(bd-1) plus noise in [0, thr], thr = 2^(bd-5))
    whose samples at rows and columns 32i - 1 are 2^(bd-1) + a[i] + b[j],
    a and b with second differences cycling through thr - 1, -(thr - 1),
    thr, -thr, 0: an interior 32x32 block (by, bx) meets the strong-
    smoothing test with its top and left second differences exactly at
    b's cycle[bx % 5] and a's cycle[by % 5], so blocks fall just inside and
    just outside the threshold on both of its tests."""
    thr = 1 << (bd - 5)
    rng = np.random.default_rng(seed)
    p = (1 << (bd - 1)) + rng.integers(0, thr + 1, (h, w))
    cycle = (thr - 1, -(thr - 1), thr, -thr, 0)

    def seq(n):
        v = [0, 0]
        for j in range(n - 2):
            v.append(2 * v[-1] - v[-2] + cycle[j % 5])
        return v

    a, b = seq(h // 32 + 1), seq(w // 32 + 1)
    for i in range(1, h // 32 + 1):
        for j in range(1, w // 32 + 1):
            p[32 * i - 1, 32 * j - 1] = (1 << (bd - 1)) + a[i] + b[j]
    return np.ascontiguousarray(p, dtype=np.int32)


def k1_edge_inputs(case, strong=True):
    """Seeded numpy planes and the entries (plane index, s, bd, strong, h,
    w) of one K1 launch in an edge case.  "232x152", "136x72", "one_ctu"
    (64x64), "short" (24x136: luma s = 32 and chroma s = 16 have no block):
    an AI picture's group, luma s = 4-32 and Cb, Cr at s = 4-16 (make_yuv
    content, 8-bit); "big_plane": a 100x144 plane holding 96x136, so the
    clamps reach rows and columns past (h, w); "bd8", "bd10", "bd12": the
    luma group on a 128x256 k1_threshold_plane.  strong: the luma entries'
    strong-smoothing switch."""
    seed = 91 + K1_EDGE_CASES.index(case)
    size = {"232x152": (152, 232), "136x72": (72, 136), "one_ctu": (64, 64),
            "short": (24, 136)}.get(case)
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    luma = lambda bd, h, w: [(0, s, bd, strong, h, w) for s in (4, 8, 16, 32)]
    if size:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from make_fixtures import make_yuv
        h, w = size
        planes = [i32(p) for p in make_yuv(w, h, 1, seed=seed)[0]]
        return planes, luma(8, h, w) + [(c, s, 8, False, h // 2, w // 2)
                                        for s in (4, 8, 16) for c in (1, 2)]
    if case == "big_plane":
        rng = np.random.default_rng(seed)
        return [i32(rng.integers(0, 256, (100, 144)))], luma(8, 96, 136)
    bd = int(case[2:])
    return [k1_threshold_plane(128, 256, bd, seed)], luma(bd, 128, 256)


def k1_band_plane(h, w):
    """The plane of a K1_BAND_CASES case: a k1_threshold_plane at 8 bits."""
    return k1_threshold_plane(h, w, 8, 97 + h + w)


def check_k1_edges(dev):
    """K1 (one launch per case, both strong-smoothing switches) and its
    band mode (each band height's group of sizes per band) on the card
    against their plain versions on the same card, every output equal bit
    for bit, on k1_edge_inputs and K1_BAND_CASES (the CPU tests hold the
    plain versions to the JAX package on the same inputs).  Returns the
    number of outputs compared."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import intra_rd as R
    from hm16_2_tpu_torch.parallel import frame_shard as F
    n_eq = 0
    for case in K1_EDGE_CASES:
        for strong in (True, False):
            planes, entries = k1_edge_inputs(case, strong)
            t = [torch.from_numpy(p).to(dev) for p in planes]
            ent = [(t[i],) + tuple(e) for i, *e in entries]
            got = _flat(K.ref_buffers_multi(ent))
            n_eq += len(got)
            _compare(f"K1 edge {case} strong={strong}", got,
                     _flat([R._ref_buffers_plain(*e) for e in ent]))
    for h, w, n in K1_BAND_CASES:
        y = torch.from_numpy(k1_band_plane(h, w)).to(dev)
        for B, group in F.band_groups(h, w, n).items():
            bands, tops, bots = F.split_bands([dev] * n, y[:n * B],
                                              max(group))
            for i in range(n):
                a = (bands[i], tops[i], bots[i])
                got = _flat(K.ref_buffers_band_multi(*a, group, 8, True,
                                                     i * B, h))
                n_eq += len(got)
                _compare(f"K1 band edge {w}x{h} n={n} band {i} {group}", got,
                         _flat([F._ref_buffers_band_plain(
                             bands[i], tops[i], bots[i][:s], s, 8, True,
                             i * B, h) for s in group]))
    print(f"K1 edge inputs ({', '.join(K1_EDGE_CASES)}; band mode "
          f"{K1_BAND_CASES}): {n_eq} kernel outputs equal their plain "
          f"versions  [{CARD}]", flush=True)
    return n_eq


# the inputs on which the K6 / K8 redesign's invariants rest
INTRA_EDGE_CASES = ("flat", "max10_qp0", "max12_qp0", "max8_qp51",
                    "noise12")
INTRA_EDGE_N = 37       # blocks: no multiple of a CTA's 32, 16, 8, 4 or 2


def intra_edge_inputs(case, s, n=INTRA_EDGE_N):
    """Seeded numpy arguments of K2 and K3 in one edge case at block size s:
    {"bufs": (n, 2, 4s+1), "blocks": (n, s, s), "bd", "qp", "modes1": (n, 1)
    luma modes for K3, "dm": (n,) chroma DM modes}.  "flat" (8-bit, QP 32,
    every reference and sample 128: the 35 SATDs tie, and so do the RD
    costs); "max10_qp0", "max12_qp0" (10- and 12-bit, QP 0: even blocks at
    the maximum over zero references, odd ones the reverse; the flat
    residual's DC level reaches the 32767 cap at s = 32 (10-bit) and from
    s = 8 (12-bit), and at 12 bits the capped level reconstructs so little
    that the 32x32 SSE passes 2^31 and wraps in int32); "max8_qp51" (the
    same at 8 bits and QP 51, where the dequantised DC passes 32767 and is
    clamped, from s = 8); "noise12" (12-bit random blocks and references,
    QP 40: distinct SATDs and costs)."""
    ci = INTRA_EDGE_CASES.index(case)
    bd, qp = {"flat": (8, 32), "max10_qp0": (10, 0), "max12_qp0": (12, 0),
              "max8_qp51": (8, 51), "noise12": (12, 40)}[case]
    rng = np.random.default_rng(81 + 7 * ci + s)
    maxv, B = (1 << bd) - 1, 4 * s + 1
    if case == "flat":
        u = np.full((n, B), 128)
        blocks = np.full((n, s, s), 128)
    elif case == "noise12":
        u = rng.integers(0, maxv + 1, (n, B))
        blocks = rng.integers(0, maxv + 1, (n, s, s))
    else:
        odd = (np.arange(n) % 2 == 1)
        u = np.where(odd[:, None], maxv, 0) * np.ones((n, B), np.int64)
        blocks = np.where(odd[:, None, None], 0, maxv) * \
            np.ones((n, s, s), np.int64)
    f = u.copy()
    f[:, 1:-1] = (u[:, 2:] + 2 * u[:, 1:-1] + u[:, :-2] + 2) >> 2
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return {"bufs": i32(np.stack([u, f], 1)), "blocks": i32(blocks),
            "bd": bd, "qp": qp, "modes1": i32(rng.integers(0, 35, (n, 1))),
            "dm": i32(rng.integers(0, 35, n))}


def intra_edge_lam(qp):
    """The AI plan's float32 lambda at QP qp."""
    return float(np.float32(0.57 * 2.0 ** ((qp - 12) / 3.0)))


def check_intra_edges(dev):
    """K2 (RD at both rounding offsets, SATD-only, the analysis mode) and
    K3 (chroma K = 5 at s = 4-16, a luma mode per block at s = 4-32, DST at
    s = 4) on the card against their plain versions on the same card, every
    output equal bit for bit, on intra_edge_inputs (the CPU tests hold the
    plain versions to the JAX package on the same inputs).  Raises on the
    first difference; times nothing."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import intra_rd as R
    from hm16_2_tpu_torch.parallel import mesh as M
    n_eq = 0

    def same(label, got, want):
        nonlocal n_eq
        _compare(f"intra edge {label}", _flat(got), _flat(want))
        n_eq += 1

    for case in INTRA_EDGE_CASES:
        for s in (4, 8, 16, 32):
            e = intra_edge_inputs(case, s)
            bufs, blocks = (torch.from_numpy(e[k]).to(dev)
                            for k in ("bufs", "blocks"))
            bd, qp, lam = e["bd"], e["qp"], intra_edge_lam(e["qp"])
            k = R.NUM_RD_CANDS[s]
            label = f"{case} s={s}"
            for inter in (False, True):
                a = (bufs, blocks, lam, s, bd, k, qp, True, s == 4, True,
                     inter)
                same(f"{label} K2 RD inter={inter}", K.intra_size_rd(*a),
                     R._size_rd_plain(*a))
            same(f"{label} K2 SATD-only",
                 K.intra_premodes(bufs, blocks, s, bd),
                 R._premodes_plain(bufs, blocks, s, bd))
            same(f"{label} analysis", K.analysis_step(blocks, bufs, qp, s, bd),
                 M._analysis_step_plain(blocks, bufs, qp, s, bd))
            m1 = torch.from_numpy(e["modes1"]).to(dev)
            a = (bufs, blocks, m1, s, bd, qp, True, s == 4)
            same(f"{label} K3 luma", K.intra_cand_rd(*a), R._cand_rd_plain(*a))
            if s <= 16:
                m5 = R._chroma_modes5_plain(torch.from_numpy(e["dm"]).to(dev))
                a = (bufs, blocks, m5, s, bd, qp, False, False)
                same(f"{label} K3 chroma", K.intra_cand_rd(*a),
                     R._cand_rd_plain(*a))
    print(f"K2/K3 edge inputs ({', '.join(INTRA_EDGE_CASES)}; s = 4-32, "
          f"{INTRA_EDGE_N} blocks): {n_eq} kernel outputs equal their plain "
          f"versions  [{CARD}]", flush=True)
    return n_eq


K6_EDGE_CONTENTS = ("zero", "max", "checker", "edge_lines")
K6_EDGE_SIZES = ((8, 8), (24, 40), (72, 136))
PLAN_EDGE_CASES = ("flat", "one_ctu", "far10")


def k6_edge_refs(content, bd, h, w, R):
    """(R, h, w) int32 references of one K6 edge case at bit depth bd:
    "zero"; "max" (every sample at 2^bd - 1); "checker" (a 0 / max
    checkerboard, shifted by one per reference: the filters' largest sums
    of either sign, the int32 headroom's extremes); "edge_lines" (zero but
    one bright column and one bright row at the picture's edges, left and
    top for even references, right and bottom for odd ones, read again
    and again through the clamped padding)."""
    maxv = (1 << bd) - 1
    r, y, x = np.ogrid[:R, :h, :w]
    if content == "zero":
        a = np.zeros((R, h, w))
    elif content == "max":
        a = np.full((R, h, w), maxv)
    elif content == "checker":
        a = ((r + y + x) % 2) * maxv
    else:
        a = np.zeros((R, h, w))
        for k in range(R):
            a[k, :, 0 if k % 2 == 0 else w - 1] = maxv
            a[k, 0 if k % 2 == 0 else h - 1, :] = maxv
    return np.ascontiguousarray(a, dtype=np.int32)


def plan_edge_args(case, is_b, size=None):
    """Seeded numpy arguments of the P or B plan (`inter_plan._plan_device`,
    four unique references) in one K8 edge case: "flat" (10-bit, 72x136,
    every picture at 512: every SATD is 0, so the bits decide and equal
    costs meet first-least, e.g. B's merge candidates 3-5); "one_ctu"
    (8-bit moving content, 64x64: one CTU, so at s = 64 every rolled
    neighbour is invalid); "far10" (10-bit moving content, 72x136, priors
    of +-4400 or +-4800 64ths of a pel per POC: every per-reference prior
    at the +-69 full-pel cap).  P: QP 32, the current picture after
    references at POC distances 1-4; B: QP 34, between two past and two
    future references (list 0 the past, list 1 the future).  size (h, w)
    overrides the picture size."""
    bd, (h, w) = {"flat": (10, (72, 136)), "one_ctu": (8, (64, 64)),
                  "far10": (10, (72, 136))}[case]
    h, w = size or (h, w)
    rng = np.random.default_rng(51 + PLAN_EDGE_CASES.index(case) + 7 * is_b)
    if case == "flat":
        frames = np.full((5, h, w), 512)
    else:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from make_fixtures import make_yuv
        frames = np.stack([f[0] for f in make_yuv(
            w, h, 5, seed=51 + PLAN_EDGE_CASES.index(case), bits=bd)])
    if is_b:
        cur, order, dists = frames[2], (1, 0, 3, 4), (1, 2, -1, -2)
        maps, nrefs, qp = ([0, 1, 0, 0], [2, 3, 0, 0]), (2, 2), QP + 2
    else:
        cur, order, dists = frames[4], (3, 2, 1, 0), (1, 2, 3, 4)
        maps, nrefs, qp = ([0, 1, 2, 3], None), (4, 0), QP
    shape = (h // 8, w // 8, 2)
    mvn16 = rng.choice([-4800, -4400, 4400, 4800], shape) if \
        case == "far10" else rng.integers(-160, 161, shape)
    lam = float(np.float32(0.4624 * 2.0 ** ((qp - 12) / 3.0)))
    i32 = lambda a: None if a is None else np.ascontiguousarray(
        a, dtype=np.int32)
    return {"cur": i32(cur), "refs": i32(frames[list(order)]),
            "mvn16": i32(mvn16), "dists": i32(dists), "lam": lam,
            "lams": float(np.float32(np.sqrt(lam))),
            "qp": qp + 6 * (bd - 8), "map0": i32(maps[0]), "nref0": nrefs[0],
            "map1": i32(maps[1]), "nref1": nrefs[1], "h": h, "w": w,
            "bd": bd, "is_b": is_b}


def _k6_k8_pairs():
    """(module, wrapper name, label, kernel, plain, index of the size
    argument or None) of K6 and K8 inside the P/B plan."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_plan as P
    return [(P, "subpel_planes", "K6", K.subpel_planes,
             P._subpel_planes_plain, None),
            (P, "cu_rd", "K8 P", K.cu_rd, P._cu_rd_plain, 2),
            (P, "cu_rd_b", "K8 B", K.cu_rd_b, P._cu_rd_b_plain, 2)]


def _k4_pick_pairs():
    """The same of K4 (both plans) and K7's list picks."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_plan as P
    from hm16_2_tpu_torch.encode import intra_rd as R
    return [(R, "plan_pre", "K4 pre", K.plan_pre, R._plan_pre_plain, None),
            (R, "plan_dp", "K4 CTU", K.plan_dp, R._plan_ctu_plain, None),
            (P, "emit", "K4 P/B", K.emit_inter_plan, P._emit_plain, None),
            (P, "uni_select_all", "K7 picks", K.uni_select_all,
             P._uni_select_all_plain, None)]


def _plan_pairs():
    """The same of every kernel a P or B plan launches: K1 and K2 (the
    intra alternative), K5, K6, K7 (q-pel, bi and the list picks), K8 and
    K4's emission, each through its wrapper (which launches the kernel on
    a CUDA tensor) against its plain version."""
    from hm16_2_tpu_torch.encode import inter_plan as P
    from hm16_2_tpu_torch.encode import intra_rd as R
    return [(R, "ref_buffers_multi", "K1", R.ref_buffers_multi,
             lambda entries: [R._ref_buffers_plain(*e) for e in entries],
             None),
            (R, "size_rd", "K2", R.size_rd, R._size_rd_plain, 3),
            (P, "int_me", "K5", P.int_me, P._int_me_plain, None),
            (P, "frac_refine", "K7 q-pel", P.frac_refine,
             P._frac_refine_plain, 5),
            (P, "frac_refine_any", "K7 bi", P.frac_refine_any,
             P._frac_refine_any_plain, 8),
            (P, "uni_select_all", "K7 picks", P.uni_select_all,
             P._uni_select_all_plain, None),
            (P, "subpel_planes", "K6", P.subpel_planes,
             P._subpel_planes_plain, None),
            (P, "cu_rd", "K8 P", P.cu_rd, P._cu_rd_plain, 2),
            (P, "cu_rd_b", "K8 B", P.cu_rd_b, P._cu_rd_b_plain, 2),
            (P, "emit", "K4 P/B", P.emit, P._emit_plain, None)]


@contextlib.contextmanager
def _held_to_plain(check, pairs=None):
    """Inside the block each wrapper of `pairs` (default: the plan's K6 and
    K8) runs the kernel and then the plain version on the same inputs, and
    check(label, got, want)."""
    pairs = _k6_k8_pairs() if pairs is None else pairs
    saved = [(mod, name, getattr(mod, name)) for mod, name, *_ in pairs]

    def held(label, kern, plain, size_at):
        def run(*a, **kw):
            got = kern(*a, **kw)
            check(label + (f" s={a[size_at]}" if size_at else ""), got,
                  plain(*a, **kw))
            return got
        return run

    for mod, name, label, kern, plain, size_at in pairs:
        setattr(mod, name, held(label, kern, plain, size_at))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_plan(args, dev, mesh=None):
    """The port's P or B plan on `dev` from plan_edge_args' arguments; with
    a row mesh, its integer ME banded over the mesh."""
    from hm16_2_tpu_torch.encode import inter_plan as P
    from hm16_2_tpu_torch.parallel import plan_shard as PS
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    cur, refs, mvn16, dists = (t(args[k]) for k in ("cur", "refs", "mvn16",
                                                    "dists"))
    me = None if mesh is None else PS.sharded_int_me(
        mesh, cur, refs, mvn16, dists, args["lams"], args["h"], args["w"])
    return P._plan_device(
        cur, refs, mvn16, dists, args["lam"], args["lams"], args["qp"],
        t(args["map0"]), args["nref0"], t(args["map1"]), args["nref1"], me,
        h=args["h"], w=args["w"], bd=args["bd"], nmerge=5,
        is_b=args["is_b"])


def check_k6_k8_edges(dev, big=(1080, 1920)):
    """K6 and K8 (P and B, every CU size) on the card against their plain
    versions on the same card, every output equal bit for bit: K6 on
    k6_edge_refs (every content at bit depths 8, 10 and 12, sizes
    K6_EDGE_SIZES, one and three references) and on 10- and 12-bit noise
    at `big` with four references; K6 and K8 inside the P and B plans of
    plan_edge_args (the CPU tests hold the plain versions to the JAX
    package on the same inputs), and of a flat picture at `big` with four
    references.  Raises on the first difference; times nothing."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_plan as P
    n_eq = 0

    def same(label, got, want):
        nonlocal n_eq
        _compare(f"edge {label}", _flat(got), _flat(want))
        n_eq += 1

    for content in K6_EDGE_CONTENTS:
        for bd in (8, 10, 12):
            for h, w in K6_EDGE_SIZES:
                for R in (1, 3):
                    refs = torch.from_numpy(k6_edge_refs(content, bd, h, w,
                                                         R)).to(dev)
                    same(f"K6 {content} {bd}-bit {w}x{h} R={R}",
                         K.subpel_planes(refs, bd, h, w),
                         P._subpel_planes_plain(refs, bd, h, w))
    rng = np.random.default_rng(61)
    for bd in (10, 12):
        refs = torch.from_numpy(rng.integers(0, 1 << bd, (4,) + big)
                                .astype(np.int32)).to(dev)
        same(f"K6 noise {bd}-bit {big[1]}x{big[0]} R=4",
             K.subpel_planes(refs, bd, *big), P._subpel_planes_plain(
                 refs, bd, *big))
        del refs
    plans = [(c, b, None) for c in PLAN_EDGE_CASES for b in (False, True)]
    plans += [("flat", b, big) for b in (False, True)]
    for case, is_b, size in plans:
        args = plan_edge_args(case, is_b, size)
        label = f"{case} {'B' if is_b else 'P'} {args['w']}x{args['h']}"
        with _held_to_plain(lambda lb, g, w: same(f"{label} {lb}", g, w)):
            run_plan(args, dev)
    print(f"K6/K8 edge inputs (K6 {', '.join(K6_EDGE_CONTENTS)} at 8-12 "
          f"bits; plans {', '.join(PLAN_EDGE_CASES)}, P and B; K6 10/12-bit "
          f"noise and flat P/B plans at {big[1]}x{big[0]}, 4 refs): {n_eq} "
          f"kernel outputs equal their plain versions  [{CARD}]", flush=True)
    return n_eq


# K4's and the picks' edge geometries: 1080p (1080 % 64 = 56, border
# CTUs at the bottom), 232x152 (232 % 64 = 40: nbx32 = 7 against
# 2 * nbx64 = 6, nby16 = 9 against 8, nby8 = 19 against 18), 1024x768
# (whole CTUs)
K4_EDGE_SIZES = ((1080, 1920), (152, 232), (768, 1024))
K4_EDGE_CASES = ("moving", "flat", "moving10")


def k4_intra_args(case, size):
    """Seeded numpy arguments of the AI plan (`intra_rd._plan_device`,
    chroma on, strong smoothing) at size (h, w): "moving" (make_yuv
    content, 8-bit, QP 32), "flat" (every sample 128: equal costs meet
    the strict DP comparisons and the first-least argmins), "moving10"
    (10-bit make_yuv content, QP 44)."""
    h, w = size
    bd = 10 if case == "moving10" else 8
    if case == "flat":
        y, cb, cr = (np.full(sh, 128) for sh in ((h, w), (h // 2, w // 2),
                                                 (h // 2, w // 2)))
    else:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from make_fixtures import make_yuv
        y, cb, cr = make_yuv(w, h, 1, seed=71, bits=bd)[0]
    qp = QP + 6 * (bd - 8)
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return {"y": i32(y), "cb": i32(cb), "cr": i32(cr),
            "lam": float(np.float32(0.57 * 2.0 ** ((QP - 12) / 3.0))),
            "cw": float(np.float32(2.0 ** (1 / 3))),
            "kw": dict(h=h, w=w, bd=bd, cbd=bd, strong=True, qp=qp,
                       cqp0=qp - 1, cqp1=qp - 2, chroma=True)}


def run_intra_plan(args, dev):
    """The port's AI plan on `dev` from k4_intra_args' arguments."""
    from hm16_2_tpu_torch.encode import intra_rd as R
    t = lambda a: torch.from_numpy(a).to(dev)
    return R._plan_device(t(args["y"]), t(args["cb"]), t(args["cr"]),
                          args["lam"], args["cw"], **args["kw"])


def k4_plan_args(case, is_b, size):
    """plan_edge_args(case, is_b, size) cut to short lists of live
    references: P two (POC distances 1, 2), B two past in list 0 and one
    future in list 1."""
    a = plan_edge_args(case, is_b, size)
    n = 3 if is_b else 2
    i32 = lambda v: np.asarray(v, dtype=np.int32)
    a.update(refs=a["refs"][:n], dists=a["dists"][:n],
             map0=i32([0, 1, 0, 0]), nref0=2)
    if is_b:
        a.update(map1=i32([2, 0, 0, 0]), nref1=1)
    return a


def k4_tied_args(h, w, dev, chroma):
    """plan_dp's arguments at h x w where every DP level ties exactly (lam
    0.5: each parent's cost equals the sum of its children plus the split
    or NxN bits, the 64x64 cost the split's), random modes and candidates;
    with chroma, K3's outputs tie the first four chroma candidates (the
    fifth is dearer) and the fold adds 2.0 at every size."""
    rng = np.random.default_rng(h + w + chroma)
    sh = {s: (h // s, w // s) for s in (4, 8, 16, 32, 64)}
    add = 2.0 if chroma else 0.0
    val = {4: 1.0, 8: 6.0 - add, 16: 25.5 - add, 32: 103.5 - add}
    f32 = lambda v, shape: torch.full(shape, v, dtype=torch.float32,
                                      device=dev)
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
    cost_s = {s: f32(val[s], sh[s]) for s in val}
    mode_s = {s: i32(rng.integers(0, 35, sh[s])) for s in val}
    cand_s = {s: i32(rng.integers(0, 35, sh[s] + (3,))) for s in val}
    db_s = {}
    if chroma:
        for s in (8, 16, 32):
            n = sh[s][0] * sh[s][1]
            d = f32(0.0, (n, 5))
            d[:, 4] = 100.0
            db_s[s] = [d, f32(0.0, (n, 5)), d.clone(), f32(0.0, (n, 5))]
    n64 = sh[64][0] * sh[64][1]
    cc = (415.5 - 4.0 - 4 * add) / 4
    return (0.5, 1.0, h, w, mode_s, cost_s, cand_s, db_s,
            f32(cc, (4 * n64,)), f32(0.0, (4 * n64,)),
            i32(rng.integers(0, 35, sh[64])))


def k4_tied_inter_args(h, w, dev):
    """emit_inter_plan's arguments at h x w where every DP level ties (lam
    0.5), with random records."""
    from hm16_2_tpu_torch.encode.inter_plan import NREC, SIZES
    rng = np.random.default_rng(h * w)
    val = {8: 1.0, 16: 5.5, 32: 23.5, 64: 95.5}
    recs, costs = {}, {}
    for s in SIZES:
        n = (h // s) * (w // s)
        costs[s] = torch.full((n,), val[s], dtype=torch.float32, device=dev) \
            if n else None
        recs[s] = torch.from_numpy(rng.integers(-1, 5, (n, NREC)).astype(
            np.int32)).to(dev) if n else None
    return recs, costs, 0.5, h, w


def k4_tied_picks(h, w, dev):
    """uni_select_all's entries at the CU shapes of an h x w picture, four
    references: MVs equal to their anchors and equal SATDs (nref 1 and 2:
    the first of equal costs wins), then near-ties (SATDs of 100 or 101,
    MVDs of -1..1) with nref 3 and 4 and reordered lists."""
    from hm16_2_tpu_torch.encode.inter_plan import _shapes
    rng = np.random.default_rng(h + 2 * w)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out = []
    for k, (s, part, bh, bw, Ny, Nx) in enumerate(_shapes(h, w, True)):
        N = Ny * Nx
        p4 = rng.integers(-300, 300, (4, N, 2)).astype(np.int32)
        if k % 2 == 0:
            mvq, satd = p4.copy(), np.full((4, N), 100.0, np.float32)
        else:
            mvq = p4 + rng.integers(-1, 2, (4, N, 2)).astype(np.int32)
            satd = rng.integers(100, 102, (4, N)).astype(np.float32)
        for nref, lmap in ((1, [0, 1, 2, 3]), (2, [0, 1, 2, 3]),
                           (3, [2, 0, 3, 1]), (4, [3, 2, 1, 0])):
            out.append((t(mvq), t(satd), t(p4), t(np.int32(lmap)), nref))
    return out


def check_k4_picks_edges(dev, sizes=K4_EDGE_SIZES):
    """K4 (both plans) and K7's list picks on the card against their plain
    versions on the same card, every output equal bit for bit: inside the
    AI plans of k4_intra_args and the P and B plans of k4_plan_args (every
    case at 232x152 and 1024x768, flat at 1080p; the CPU tests hold the
    plain versions to the JAX package at 232x152), inside a 1024x768 AI
    plan and P and B plans banded over 2 bands, and on cost grids where
    every DP level ties (k4_tied_args, with and without chroma;
    k4_tied_inter_args) and picks that tie (k4_tied_picks) at `sizes`.
    Raises on the first difference; times nothing."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_plan as P
    from hm16_2_tpu_torch.encode import intra_rd as R
    from hm16_2_tpu_torch.parallel import frame_shard as F
    n_eq = 0

    def same(label, got, want):
        nonlocal n_eq
        _compare(f"K4/picks edge {label}", _flat(got), _flat(want))
        n_eq += 1

    big, mid, xga = sizes
    plans = [(c, z) for z in (mid, xga) for c in K4_EDGE_CASES]
    plans.append(("flat", big))
    for case, size in plans:
        label = f"{case} {size[1]}x{size[0]}"
        with _held_to_plain(lambda lb, g, w: same(f"{label} AI {lb}", g, w),
                            _k4_pick_pairs()):
            run_intra_plan(k4_intra_args(case, size), dev)
        for is_b in (False, True):
            pc = {"moving": "one_ctu", "flat": "flat",
                  "moving10": "far10"}[case]
            with _held_to_plain(lambda lb, g, w: same(
                    f"{label} {'B' if is_b else 'P'} {lb}", g, w),
                    _k4_pick_pairs()):
                run_plan(k4_plan_args(pc, is_b, size), dev)
    mesh = F.make_row_mesh([dev] * 2)
    a = k4_intra_args("moving", xga)

    class Sps:
        bit_depth_luma = bit_depth_chroma = 8
        strong_intra_smoothing = 1
        pic_height, pic_width = xga
        chroma_format_idc = 1

    with _held_to_plain(lambda lb, g, w: same(f"banded AI {lb}", g, w),
                        _k4_pick_pairs()):
        F.sharded_plan_frame(mesh, [a["y"], a["cb"], a["cr"]], Sps,
                             a["kw"]["qp"], a["lam"], a["cw"],
                             (a["kw"]["cqp0"], a["kw"]["cqp1"]))
        for is_b in (False, True):
            run_plan(k4_plan_args("one_ctu", is_b, xga), dev, mesh)
    for h, w in sizes:
        for chroma in (False, True):
            args = k4_tied_args(h, w, dev, chroma)
            same(f"tied DP {w}x{h} chroma={chroma}", K.plan_dp(*args),
                 R._plan_ctu_plain(*args))
        args = k4_tied_inter_args(h, w, dev)
        same(f"tied P/B DP {w}x{h}", K.emit_inter_plan(*args),
             P._emit_plain(*args))
        e = k4_tied_picks(h, w, dev)
        for i in range(0, len(e), K.MAX_PICK):
            part = e[i:i + K.MAX_PICK]
            same(f"tied picks {w}x{h}", K.uni_select_all(part, 0.5),
                 P._uni_select_all_plain(part, 0.5))
    print(f"K4/picks edge inputs (AI, P, B plans {', '.join(K4_EDGE_CASES)} "
          f"at {mid[1]}x{mid[0]} and {xga[1]}x{xga[0]}, flat at "
          f"{big[1]}x{big[0]}; banded AI, P, B at {xga[1]}x{xga[0]}; tied "
          f"DP and picks): {n_eq} kernel outputs equal their plain versions"
          f"  [{CARD}]", flush=True)
    return n_eq


def k6_conv_yardstick(refs, reps=5):
    """ms of torch.nn.functional.conv2d, float32 with TF32 off, over the
    edge-padded 8-bit references (R, h, w) with the 16 outer-product 8x8
    filters of the quarter-pel phases: the pre-rounding sums of K6 at 8
    bits (below 2^24, so exact in float32), a yardstick of the arithmetic,
    not the same function.  The port never calls it."""
    from hm16_2_tpu_torch.encode.inter_plan import LUMA_FILTER, MARGIN
    R, h, w = refs.shape
    iy = torch.clamp(torch.arange(-(MARGIN + 3), h + MARGIN + 5,
                                  device=refs.device), 0, h - 1)
    ix = torch.clamp(torch.arange(-(MARGIN + 3), w + MARGIN + 5,
                                  device=refs.device), 0, w - 1)
    x = refs[:, iy][:, :, ix].to(torch.float32)[:, None].contiguous()
    taps = torch.tensor(LUMA_FILTER, dtype=torch.float32, device=refs.device)
    wt = (taps[:, None, :, None] * taps[None, :, None, :]).reshape(16, 1, 8, 8)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _cuda_ms(lambda: torch.nn.functional.conv2d(x, wt), reps)
    finally:
        torch.backends.cudnn.allow_tf32 = old


def report_k6_k8(stats, refs8):
    """Print K8's time by CU size and mode, K7's q-pel refinement apart
    from its list picks, and the conv2d yardstick beside K6 (refs8: the
    four 8-bit references of check_inter_kernels), from the cases of
    check_inter_kernels and check_b_kernels in `stats`."""
    cases = {k: stats[k]["cases"] for k in ("inter_cu_rd", "inter_cu_rd_b",
                                            "inter_uni", "inter_pick")}
    print("K8 ms by CU size: P " + ", ".join(
        f"s={s} {cases['inter_cu_rd'][f'CU pricing s={s}'][0]:.3f}"
        for s in (8, 16, 32, 64)) + "; B " + ", ".join(
        f"s={s} {cases['inter_cu_rd_b'][f'B CU pricing s={s}'][0]:.3f}"
        for s in (8, 16, 32, 64)) + f"  [{CARD}]", flush=True)
    qpel = sum(v[0] for k, v in cases["inter_uni"].items()
               if k.startswith("q-pel"))
    picks = {m: sum(v[0] for k, v in cases["inter_pick"].items()
                    if k.startswith(m)) for m in ("P", "B")}
    print(f"K7 ms: q-pel refinement {qpel:.3f} (ten shapes); list picks "
          f"(one launch) P {picks['P']:.3f}, B {picks['B']:.3f} (both lists)"
          f"  [{CARD}]", flush=True)
    h, w = refs8.shape[1:]
    print(f"K6 yardstick, not the port: conv2d float32 (TF32 off) with 16 "
          f"8x8 filters over 4 edge-padded 8-bit {w}x{h} refs "
          f"{k6_conv_yardstick(refs8):.3f} ms; K6 "
          f"{stats['subpel_planes']['ms']:.3f} ms  [{CARD}]", flush=True)


def report_k2_k3(stats):
    """Print K2's time by case (RD and SATD-only by size, the inter offset,
    the analysis mode) and K3's by case, each beside its bound, from the
    cases of check_kernels, check_inter_kernels and check_band_kernels in
    `stats` (CUDA events around the wrapper's launches, host enqueue
    included; hm16_2_tpu_torch/tools/intra_bench.py gives the kernels' own
    device time at the same shapes)."""
    for k in ("intra_size_rd", "intra_cand_rd", "analysis_step"):
        print(f"{k} ms (kernel / bound): " + "; ".join(
            f"{c} {v[0]:.3f} / {v[2]:.4f}"
            for c, v in stats[k]["cases"].items()) + f"  [{CARD}]",
            flush=True)


def _kernel_split(label, fn, top=4):
    """Run fn under torch.profiler (device activity) and print its device
    time by kernel, the `top` largest."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in ev) / 1e3
    print(f"device time of {label}: {total:.3f} ms; " + "; ".join(
        f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
        for e in ev[:top]) + f"  [{CARD}]", flush=True)


def _equal(label, got, want):
    """Banded against whole: every tensor equal, or raise."""
    _compare(label, _flat(got), _flat(want))
    print(f"banded {label}: equal to the whole picture's", flush=True)


def check_band_kernels(frames, dev, reps=3, stats=None, bands=(2, 4),
                       me=True, analysis=(4, 8, 16, 32)):
    """K1's band mode, K5's band mode in both bit models and K2's analysis
    mode against their plain versions at the shapes the row-banded path
    gives them, n bands of the last of `frames` for n in `bands`, all on
    `dev`: K1 once per band for each band height's group of the sizes whose
    rows the banding rule splits (frame_shard.band_groups); K5 (when
    `me`) against the four frames before it, QP 32, priors reaching +-70
    full-pel across band edges; the analysis step on every aligned s-block
    of the picture for s in `analysis`.  Then the banded programs against
    the whole picture on the same card: sharded_sizes_rd where the bands
    cover the picture, sharded_int_me, sharded_me_frame and
    sharded_analysis_step.  Adds to `stats`."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_me as M
    from hm16_2_tpu_torch.encode import inter_plan as P
    from hm16_2_tpu_torch.encode import intra_rd as R
    from hm16_2_tpu_torch.parallel import frame_shard as F
    from hm16_2_tpu_torch.parallel import me_shard as MS
    from hm16_2_tpu_torch.parallel import mesh as MM
    from hm16_2_tpu_torch.parallel import plan_shard as PS

    H, W = frames[-1][0].shape
    y = torch.from_numpy(frames[-1][0].astype("int32")).to(dev)
    lam = 0.57 * 2.0 ** ((QP - 12) / 3.0)
    stats = _new_stats(stats)
    case = _case(stats, reps)

    for n in bands:
        mesh = F.make_row_mesh([dev] * n)
        for B, group in F.band_groups(H, W, n).items():
            bands_, tops, bots = F.split_bands(mesh, y[:n * B], max(group))
            args = [(bands_[i], tops[i], bots[i], group, 8, True, i * B, H)
                    for i in range(n)]
            case("ref_buffers_band", f"{W}x{H} n={n} s={group}",
                 lambda: [K.ref_buffers_band_multi(*a) for a in args],
                 lambda: [F._ref_buffers_band_plain(
                     b, t, o[:s], s, 8, True, r0, H)
                     for b, t, o, _, _, _, r0, _ in args for s in group],
                 (y[:n * B], tops, bots), sum(
                     (n * B // s) * (W // s) * (4 * s + 1) * 8
                     for s in group))
            if n * B == H:
                ks = [R.NUM_RD_CANDS[s] for s in group]
                whole = K.ref_buffers_multi([(y, s, 8, True, H, W)
                                             for s in group])
                for s, k, got, (b, bl) in zip(group, ks, F.sharded_sizes_rd(
                        mesh, y, group, ks, 8, QP, lam, True, H), whole):
                    _equal(f"size_rd {W}x{H} n={n} s={s}",
                           [g.reshape(-1) for g in got],
                           [g.reshape(-1) for g in K.intra_size_rd(
                               b, bl, lam, s, 8, k, QP, True, s == 4, True)])

    if me:
        nref = 4
        refs = torch.from_numpy(np.stack([frames[-1 - d][0] for d in range(
            1, nref + 1)]).astype("int32")).to(dev)
        rng = np.random.default_rng(17)
        mvn16 = torch.from_numpy(rng.integers(-70 * 16, 70 * 16 + 1, (
            H // 8, W // 8, 2)).astype("int32")).to(dev)
        dists = torch.as_tensor([1, 2, -1, 4], dtype=torch.int32, device=dev)
        mvp8 = torch.from_numpy(rng.integers(-70, 71, (
            nref, H // 8, W // 8, 2)).astype("int32")).to(dev)
        lams = float(np.float32(np.sqrt(0.578 * 2.0 ** ((QP - 12) / 3.0))))
        lam_me = float(np.float32(np.sqrt(0.85 * 2.0 ** ((QP - 12) / 3.0))))
        whole_ms = {
            "inter_me": _cuda_ms(lambda: K.inter_me(
                y, refs, P._mvp_full(mvn16, dists), lams, H, W, True), 1),
            "me_frame": _cuda_ms(lambda: K.me_frame(y, refs, mvp8, lam_me, H,
                                                    W), 1)}
        print(f"whole-picture K5 at {W}x{H}, {nref} refs (beside the banded "
              f"cases): MVD bins {whole_ms['inter_me']:.3f} ms, log model "
              f"{whole_ms['me_frame']:.3f} ms  [{CARD}]", flush=True)
        n = max(bands)
        _kernel_split(f"K5 (MVD bins) on the whole {W}x{H} picture",
                      lambda: K.inter_me(y, refs, P._mvp_full(mvn16, dists),
                                         lams, H, W, True))
        _kernel_split(f"K5 (MVD bins) on {n} bands of {W}x{H}",
                      lambda: PS.sharded_int_me(F.make_row_mesh([dev] * n), y,
                                                refs, mvn16, dists, lams, H,
                                                W))
        for n in bands:
            if H % (n * 64):
                continue
            mesh = F.make_row_mesh([dev] * n)
            B = H // n
            band = [(y[i * B:(i + 1) * B], i * B, slice(i * B // 8,
                                                        (i + 1) * B // 8))
                    for i in range(n)]
            pri = [P._mvp_full(mvn16[r8], dists) for _, _, r8 in band]
            shapes = [(bh, bw, Ny * Nx) for _, _, bh, bw, Ny, Nx in
                      P._shapes(B, W, True)]
            case("inter_me_band", f"{W}x{H} n={n} {nref} refs, MVD bins",
                 lambda: [K.inter_me(b, refs, p, lams, B, W, True, r0, H)
                          for (b, r0, _), p in zip(band, pri)],
                 lambda: [P._int_me_plain(b, refs, p, lams, B, W, True, r0)
                          for (b, r0, _), p in zip(band, pri)],
                 (y, refs, pri),
                 n * _ops_me(nref, B, W, shapes, MVD_BIN_OPS, H), r=1)
            pb = [mvp8[:, r8].contiguous() for _, _, r8 in band]
            sq = [(s, s, (B // s) * (W // s)) for s in (8, 16, 32, 64)]
            case("me_frame_band", f"{W}x{H} n={n} {nref} refs, log model",
                 lambda: [K.me_frame(b, refs, p, lam_me, B, W, r0, H)
                          for (b, r0, _), p in zip(band, pb)],
                 lambda: [M._me_frame_plain(b, refs, p, lam_me, B, W, r0)
                          for (b, r0, _), p in zip(band, pb)],
                 (y, refs, mvp8), n * _ops_me(nref, B, W, sq, MV_LOG_OPS, H),
                 r=1)
            _equal(f"int_me {W}x{H} n={n}",
                   PS.sharded_int_me(mesh, y, refs, mvn16, dists, lams, H, W),
                   K.inter_me(y, refs, P._mvp_full(mvn16, dists), lams, H, W,
                              True))
            _equal(f"me_frame {W}x{H} n={n}",
                   MS.sharded_me_frame(mesh, y, refs, mvp8, lam_me, H, W),
                   K.me_frame(y, refs, mvp8, lam_me, H, W))

    grid = MM.make_mesh([dev] * 4, 2)
    for s in analysis:
        bufs, blocks = K.ref_buffers(y, s, 8, True, H, W)
        n = blocks.shape[0]
        case("analysis_step", f"{W}x{H} s={s}",
             lambda: K.analysis_step(blocks, bufs, QP, s, 8),
             lambda: MM._analysis_step_plain(blocks, bufs, QP, s, 8),
             (bufs, blocks), _ops_analysis(n, s))
        q = n // 4 * 4
        o = blocks[:q].reshape(2, 2, q // 4, s, s)
        b = bufs[:q].reshape(2, 2, q // 4, 2, 4 * s + 1)
        _equal(f"analysis_step {W}x{H} s={s} (frame 2, row 2)",
               MM.sharded_analysis_step(grid, s, 8)(o, b, QP),
               K.analysis_step(o, b, QP, s, 8))
    return stats


SOURCES = {
    "ref_buffers": ("ref_buffers.cu", "hm16_2_tpu/encode/intra_rd.py:317"),
    "intra_size_rd": ("intra_rd.cu", "hm16_2_tpu/encode/intra_rd.py:172"),
    "intra_cand_rd": ("intra_rd.cu", "hm16_2_tpu/encode/intra_rd.py:212"),
    "plan_dp": ("plan_dp.cu", "hm16_2_tpu/encode/intra_rd.py:377"),
    "inter_me": ("inter_me.cu", "hm16_2_tpu/encode/inter_plan.py:209"),
    "subpel_planes": ("subpel.cu", "hm16_2_tpu/encode/inter_plan.py:294"),
    "inter_uni": ("inter_rd.cu", "hm16_2_tpu/encode/inter_plan.py:362"),
    "inter_pick": ("inter_rd.cu", "hm16_2_tpu/encode/inter_plan.py:507"),
    "inter_bi_refine": ("inter_rd.cu", "hm16_2_tpu/encode/inter_plan.py:401"),
    "inter_cu_rd": ("inter_rd.cu", "hm16_2_tpu/encode/inter_plan.py:444"),
    "inter_cu_rd_b": ("inter_rd.cu", "hm16_2_tpu/encode/inter_plan.py:444"),
    "me_frame": ("inter_me.cu", "hm16_2_tpu/encode/inter_me.py:47"),
    "ref_buffers_band": ("ref_buffers.cu",
                         "hm16_2_tpu/parallel/frame_shard.py:39"),
    "inter_me_band": ("inter_me.cu", "hm16_2_tpu/parallel/plan_shard.py:51"),
    "me_frame_band": ("inter_me.cu", "hm16_2_tpu/parallel/me_shard.py:40"),
    "analysis_step": ("intra_rd.cu", "hm16_2_tpu/parallel/mesh.py:32"),
}
BAND = ("ref_buffers_band", "inter_me_band", "me_frame_band",
        "analysis_step")                          # kernels of parallel/ only
B_ONLY = ("inter_bi_refine", "inter_cu_rd_b")     # kernels of B pictures only
INTRA = ("ref_buffers", "intra_size_rd", "intra_cand_rd", "plan_dp")
# the kernels of the fused plan
PLAN_ONLY = ("inter_me", "subpel_planes", "inter_uni", "inter_pick",
             "inter_bi_refine", "inter_cu_rd", "inter_cu_rd_b")


def _ptxas(report, names):
    """ptxas's registers, stack, spills and static shared memory of each
    kernel whose mangled name holds one of `names`, one line each."""
    out, entry = [], None
    for line in report.splitlines() + ["=="]:
        if "Compiling entry function" in line or line.startswith("=="):
            if entry:
                out.append(f"ptxas {entry[0]} {entry[1]}: "
                           + "; ".join(entry[2:]))
            name = next((n for n in names if n in line), None)
            entry = [name, line.split("'")[1]] if name else None
        elif entry and "Function properties" not in line:
            entry.append(line.split(":", 1)[-1].strip() if "ptxas" in line
                         else line.strip())
    return out


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


# K4-K8's kernels by the names the profiler gives them
KERNEL_SPLIT = {"K4 plan_dp": ("plan_pre_kernel", "plan_ctu_kernel",
                               "emit_inter_kernel"),
                "K5 refinement": ("me_refine_kernel",),
                "K5 coarse argmin": ("me_argmin_kernel",),
                "K5 rest (downsample, coarse grid, pyramid)": (
                    "me_down_kernel", "me_coarse8_kernel", "me_quad_kernel"),
                "K6 subpel": ("subpel_kernel",),
                "K7 frac_refine": ("frac_refine_kernel",),
                "K7 list picks": ("uni_select_all_kernel",),
                "K8 CU pricing": ("cu_rd_kernel",)}


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
    split = {g: sum(e.self_device_time_total for e in events
                    if any(k in e.key for k in keys)) / 1e3
             for g, keys in KERNEL_SPLIT.items()}
    if any(split.values()):
        print(f"K4-K8 device ms of the {label}: " + "; ".join(
            f"{g} {v:.3f}" for g, v in split.items()) + f"  [{CARD}]",
            flush=True)
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


def _picks_per_picture(counts, n, label):
    """K7's list picks are one launch per planned picture."""
    print(f"{label}: {counts['inter_pick']} list-pick launches for {n} "
          f"planned pictures, {counts['inter_uni']} q-pel launches",
          flush=True)
    if counts["inter_pick"] != n:
        raise AssertionError(f"{label}: {counts['inter_pick']} list-pick "
                             f"launches for {n} pictures")


@contextlib.contextmanager
def _k1_per_plan():
    """Inside the block, each P/B plan (`inter_plan._plan_device`) adds its
    K1 launches to the yielded list."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode import inter_plan as P
    saved, seen = P._plan_device, []

    def plan(*a, **kw):
        before = K.LAUNCHES["ref_buffers"]
        out = saved(*a, **kw)
        seen.append(K.LAUNCHES["ref_buffers"] - before)
        return out

    P._plan_device = plan
    try:
        yield seen
    finally:
        P._plan_device = saved


def _k1_once_per_plan(seen, n, label):
    """K1 is one launch per P/B plan: the intra alternative's sizes."""
    print(f"{label}: K1 launches per P/B plan {seen}", flush=True)
    if seen != [1] * n:
        raise AssertionError(f"{label}: K1 launches per plan {seen}, not one "
                             f"in each of {n}")


def ai_phase(recipe, frames, dev):
    """HM's All Intra Main over three frames through encode_stream
    (`recipe`, stream_digest's "AI"): prints fps and stage_ms, checks every
    picture hash and that encode_frame of frame 0 writes AU 0.  Returns
    the AUs and the launch counts."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.tools import stream_digest as S
    W, H, n = recipe.width, recipe.height, len(frames)
    new_encoder = lambda: S.port_encoder(dev)(S.config(recipe))
    enc = new_encoder()
    t0 = time.perf_counter()
    aus, counts = _launches_of(
        K, lambda: S.code(recipe, enc, frames), f"AI {W}x{H}", INTRA)
    wall = time.perf_counter() - t0
    print(f"encode_stream {W}x{H} AI QP{QP}: {n} frames in {wall:.3f} s = "
          f"{n / wall:.3f} fps; bytes {[len(a) for a in aus]}  [{CARD}]",
          flush=True)
    print("stage_ms per frame: " + json.dumps(
        {k: round(v / n, 3) for k, v in enc.stage_ms.items()})
        + f"  [{CARD}]", flush=True)
    _decode_check(aus, n, "AI")
    au0 = new_encoder().encode_frame(
        [p.astype("int32") for p in frames[0]], 0)
    if au0 != aus[0]:
        raise AssertionError("encode_frame differs from encode_stream's AU 0")
    print("encode_frame(frame 0) equals encode_stream AU 0", flush=True)
    return aus, counts


def ldp_phase(recipe, frames, dev):
    """HM's Low Delay P Main over IDR + one GOP of four P pictures through
    push_frame / flush (`recipe`, stream_digest's "LDP"); prints fps, the
    P pictures' stage_ms and their device busy share.  Returns the AUs and
    the launch counts."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.tools import stream_digest as S
    W, H = recipe.width, recipe.height
    enc = S.port_encoder(dev)(S.config(recipe))
    out = {}

    def run():
        aus, out["idr"] = _idr(lambda: S.code(recipe, enc, frames, 0, 1))
        rest, out["wall"], out["stage"] = _timed_pictures(
            enc, lambda: S.code(recipe, enc, frames, 1), "P pictures", 12)
        return aus + rest

    with _k1_per_plan() as k1:
        aus, counts = _launches_of(K, run, f"LDP {W}x{H}",
                                   [k for k in K.LAUNCHES
                                    if k not in B_ONLY + BAND + ("me_frame",)])
    _report(f"LDP {W}x{H} QP{QP} GOP4", len(frames) - 1, "P", out["idr"],
            out["wall"], out["stage"], aus)
    _picks_per_picture(counts, len(frames) - 1, "LDP")
    _k1_once_per_plan(k1, len(frames) - 1, "LDP")
    return aus, counts


def ra_phase(recipe, frames, dev):
    """HM's Random Access Main over IDR + one GOP of eight B pictures through
    push_frame / flush (`recipe`, stream_digest's "RA"); prints fps over
    the B pictures, their stage_ms, the number of plans enqueued ahead
    (pictures 3, 6, 7) and the device busy share of the B pictures.  Returns the AUs and the launch counts."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.tools import stream_digest as S
    W, H = recipe.width, recipe.height
    enc = S.port_encoder(dev)(S.config(recipe))
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
        aus, out["idr"] = _idr(lambda: S.code(recipe, enc, frames, 0, 1))
        rest, out["wall"], out["stage"] = _timed_pictures(
            enc, lambda: S.code(recipe, enc, frames, 1), "B pictures", 14)
        return aus + rest

    with _k1_per_plan() as k1:
        aus, counts = _launches_of(K, run, f"RA {W}x{H}",
                                   [k for k in K.LAUNCHES if k not in BAND + (
                                       "inter_cu_rd", "me_frame")])
    _report(f"RA {W}x{H} QP{QP} GOP8", len(frames) - 1, "B", out["idr"],
            out["wall"], out["stage"], aus,
            f"; plans enqueued ahead for POCs {ahead}")
    if sorted(ahead) != [3, 6, 7]:
        raise AssertionError(f"RA: plans enqueued ahead for {ahead}, not for "
                             "POCs 3, 6 and 7")
    _picks_per_picture(counts, len(frames) - 1, "RA")
    _k1_once_per_plan(k1, len(frames) - 1, "RA")
    return aus, counts


def fallback_phase(recipe, frames, dev):
    """The per-CU inter search on an IDR and P pictures (encode_frame,
    intra period 8, QP 32, HM16_NO_INTER_PLAN, RRSP on; `recipe`,
    stream_digest's "per-CU search"): each P picture runs one frame ME on
    the card (K5 in me_frame's mode) and its CU search and commit on the
    host.  Prints s per P picture, their stage_ms, the
    device busy share and me_frame's launches.  Returns the AUs and the
    launch counts."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.tools import stream_digest as S
    W, H = recipe.width, recipe.height
    enc = S.port_encoder(dev)(S.config(recipe))
    out = {}

    def run():
        aus, out["idr"] = _idr(lambda: S.code(recipe, enc, frames, 0, 1))
        rest, out["wall"], out["stage"] = _timed_pictures(
            enc, lambda: S.code(recipe, enc, frames, 1),
            "P pictures of the per-CU search", 10)
        return aus + rest

    with S.environ(recipe):
        aus, counts = _launches_of(K, run, f"per-CU search {W}x{H}",
                                   INTRA + ("me_frame",))
    if any(counts[k] for k in PLAN_ONLY):
        raise AssertionError("the per-CU search launched a plan kernel")
    _report(f"per-CU search (HM16_NO_INTER_PLAN, RRSP) {W}x{H} QP{QP} IPPP",
            len(frames) - 1, "P", out["idr"], out["wall"], out["stage"], aus,
            f"; me_frame launches {counts['me_frame']}")
    return aus, counts


@contextlib.contextmanager
def _first_plan(intra=False):
    """Inside the block, the first P/B plan (`inter_plan._plan_device`; with
    `intra`, the first I plan, `intra_rd._plan_device`) records its
    arguments and packed plan in the yielded dict, with the unwrapped
    function, so that it can be run again on the same inputs."""
    from hm16_2_tpu_torch.encode import inter_plan, intra_rd
    mod = intra_rd if intra else inter_plan
    saved, seen = mod._plan_device, {"fn": mod._plan_device}

    def plan(*a, **kw):
        out = saved(*a, **kw)
        seen.setdefault("call", (a, kw, out))
        return out

    mod._plan_device = plan
    try:
        yield seen
    finally:
        mod._plan_device = saved


def _intra_pairs():
    """The same as `_plan_pairs` of every kernel an I plan launches: K1,
    K2, K3 and K4's two launches."""
    from hm16_2_tpu_torch.encode import intra_rd as R
    return [(R, "ref_buffers_multi", "K1", R.ref_buffers_multi,
             lambda entries: [R._ref_buffers_plain(*e) for e in entries],
             None),
            (R, "size_rd", "K2", R.size_rd, R._size_rd_plain, 3),
            (R, "cand_rd", "K3", R.cand_rd,
             lambda b, k, m, s, bd, qp, is_luma=False, use_dst=False:
             R._cand_rd_plain(b, k, m, s, bd, qp, is_luma, use_dst), 3),
            (R, "plan_pre", "K4 pre", R.plan_pre, R._plan_pre_plain, None),
            (R, "plan_dp", "K4 CTU", R.plan_dp, R._plan_ctu_plain, None)]


def _replay_held(seen, label, lam=None, pairs=None):
    """Run the recorded plan again with every kernel of it held to its plain
    version on the same card (`pairs`, default `_plan_pairs`: those of a
    P/B plan), and require the same packed plan; with `lam`, at that lambda
    (and its square root) instead of the recorded one.  Returns the number
    of kernel outputs compared."""
    a, kw, out = seen["call"]
    if lam is not None:
        a = a[:4] + (lam, float(np.sqrt(lam))) + a[6:]
        out = None
    n_eq = 0

    def same(lb, got, want):
        nonlocal n_eq
        _compare(f"{label} {lb}", _flat(got), _flat(want))
        n_eq += 1

    t0 = time.perf_counter()
    with _held_to_plain(same, _plan_pairs() if pairs is None else pairs):
        again = seen["fn"](*a, **kw)
    if out is not None:
        _compare(f"{label} plan run again", again, out)
    at = (f"lambda {a[3]!r}, QP {kw['qp']}" if "cqp0" in kw else
          f"lambda {a[4]!r}, sqrt lambda {a[5]!r}, QP {a[6]}")
    print(f"{label}: {at}: {n_eq} kernel outputs equal their plain versions "
          f"({time.perf_counter() - t0:.1f} s)  [{CARD}]", flush=True)
    return n_eq


def _pinned(name, frames, aus):
    """Hold the stream of recipe `name` to the JAX package's (stream_digest
    PINNED): its input planes first, then each AU.  Raises at a difference,
    naming the recipe, the first differing AU and its lengths."""
    from hm16_2_tpu_torch.tools import stream_digest as S
    bad = S.mismatch(name, S.digest(frames, aus))
    if bad:
        raise AssertionError(f"{bad}; recipe {S.RECIPES[name]}")
    print(f"{name}: input and stream ({len(aus)} AUs, sha256 "
          f"{S.PINNED[name]['stream']}) equal the JAX package's (PINNED)",
          flush=True)


def main10_phase(dev, ai=None, ra=None):
    """HM's All Intra Main10 over three 1080p frames (encode_stream) and
    Random Access Main10 over IDR + one GOP of eight B pictures (push_frame
    / flush), on 10-bit content (stream_digest's "AI-Main10" and
    "RA-Main10", the configurations tools/encode.py builds from the Main10
    cfg files): prints pictures/s, stage_ms and the launches per picture,
    checks every picture hash and each stream against PINNED, and runs the
    first 10-bit I plan and the first 10-bit B plan of RA again with every
    kernel held to its plain version.  Returns {label: launch counts}."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.tools import stream_digest as S
    recipes = (ai or S.RECIPES["AI-Main10"], ra or S.RECIPES["RA-Main10"])
    runs = {}
    for r in recipes:
        frames = S.make_frames(r)
        n, label = r.frames, f"{r.name} {r.width}x{r.height}"
        enc = S.port_encoder(dev)(S.config(r))
        out = {}
        if r.drive == "encode_stream":
            need = INTRA

            def run():
                aus, out["wall"] = _idr(lambda: S.code(r, enc, frames))
                out["stage"] = dict(enc.stage_ms)
                return aus
        else:
            need = [k for k in K.LAUNCHES if k not in BAND + (
                "inter_cu_rd", "me_frame")]

            def run():
                aus, out["idr"] = _idr(lambda: S.code(r, enc, frames, 0, 1))
                rest, out["wall"], out["stage"] = _timed_pictures(
                    enc, lambda: S.code(r, enc, frames, 1),
                    f"{label} B pictures", 8)
                return aus + rest

        with _first_plan(intra=True) as first_i, _first_plan() as first_b:
            aus, counts = _launches_of(K, run, label, need)
        if "idr" in out:
            _report(label, n - 1, "B", out["idr"], out["wall"],
                    out["stage"], aus)
        else:
            print(f"{label}: {n} pictures in {out['wall']:.3f} s = "
                  f"{n / out['wall']:.3f} pictures/s; bytes "
                  f"{[len(a) for a in aus]}  [{CARD}]", flush=True)
            print("stage_ms per picture: " + json.dumps(
                {k: round(v / n, 3) for k, v in out["stage"].items()})
                + f"  [{CARD}]", flush=True)
        print(f"{label} launches per picture: " + json.dumps(
            {k: v / n for k, v in counts.items() if v}) + f"  [{CARD}]",
            flush=True)
        _pinned(r.name, frames, aus)
        if "idr" in out:
            _replay_held(first_i, f"{label} first I plan",
                         pairs=_intra_pairs())
            _replay_held(first_b, f"{label} first B plan")
        _decode_check(aus, n, label)
        runs[label] = counts
    return runs


def _rc_pictures(enc):
    """Record each picture's rate-control slice QP, lambda, target bits and
    coded bits as the model is updated after it."""
    rows, update = [], enc.rc.update_after_picture

    def logged(actual_bits, header_bits=0):
        p = enc.rc.pic
        rows.append((p["qp"], p["lam"], p["target"], actual_bits))
        return update(actual_bits, header_bits)

    enc.rc.update_after_picture = logged
    return rows


# rate control's target: a few Mbit/s for 1080p at 30 fps
RC_BPS, RC_FPS = 4_000_000, 30


def rc_phase(frames, dev, ctu):
    """HM's Low Delay P Main under R-lambda rate control (`ctu`: at CTU
    level too) over IDR + one GOP of four P pictures through push_frame /
    flush: the plans price with the model's lambda, not one derived from
    the QP.  Prints each picture's slice QP, lambda and bits against its
    target, fps and stage_ms of the P pictures, and holds every kernel of
    the first P picture's plan to its plain version at that lambda (at
    picture level also at the ends of the model's lambda range).  Returns
    the AUs and the launch counts."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    H, W = frames[0][0].shape
    n = len(frames)
    enc = Encoder(EncoderConfig(W, H, qp=QP, intra_period=0, gop="ld",
                                target_bps=RC_BPS, frame_rate=RC_FPS,
                                total_frames=n, rc_ctu=ctu), dev)
    rows = _rc_pictures(enc)
    label = f"RC{' CTU' if ctu else ''} LDP {W}x{H} {RC_BPS} bps"
    out = {}

    def run():
        aus, out["idr"] = _idr(lambda: enc.push_frame(
            [p.astype("int32") for p in frames[0]], 0))
        rest, out["wall"], out["stage"] = _timed_pictures(
            enc, lambda: _push_all(enc, frames, 1), f"{label} P pictures", 6)
        return aus + rest

    with _k1_per_plan() as k1, _first_plan() as first:
        aus, counts = _launches_of(K, run, label,
                                   [k for k in K.LAUNCHES
                                    if k not in B_ONLY + BAND + ("me_frame",)])
    for poc, (qp, lam, target, bits) in enumerate(rows):
        print(f"{label} POC {poc}: slice QP {qp}, lambda {lam!r}, {bits} "
              f"bits against a target of {target}", flush=True)
    if len(rows) != n:
        raise AssertionError(f"{label}: {len(rows)} rate-control updates "
                             f"for {n} pictures")
    _report(label, n - 1, "P", out["idr"], out["wall"], out["stage"], aus)
    _picks_per_picture(counts, n - 1, label)
    _k1_once_per_plan(k1, n - 1, label)
    _replay_held(first, f"{label} first P plan")
    if not ctu:
        # the ends of the model's lambda range (ratectrl's clip), at the
        # first P plan's QP
        for lam in (0.1, 10000.0):
            _replay_held(first, f"{label} first P plan at the lambda clip",
                         lam)
    _decode_check(aus, n, label)
    return aus, counts


def dqp_phase(frames, dev):
    """delta_qp_rd=1 (each picture trial-coded at QP - 1, QP, QP + 1, then
    coded at the best) on HM's All Intra Main over two frames and on Low
    Delay P Main over IDR + one GOP of four P pictures: asserts four plans
    per picture by K4's and K1's launches; prints fps and stage_ms.
    Returns {label: launch counts}."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    H, W = frames[0][0].shape
    runs = {}
    planes = lambda f: [p.astype("int32") for p in f]
    for gop, n in (("AI", 2), ("LDP", len(frames))):
        kw = dict(intra_period=1) if gop == "AI" else \
            dict(intra_period=0, gop="ld")
        enc = Encoder(EncoderConfig(W, H, qp=QP, delta_qp_rd=1, **kw), dev)
        label = f"delta_qp_rd {gop} {W}x{H}"
        need = INTRA if gop == "AI" else \
            [k for k in K.LAUNCHES if k not in B_ONLY + BAND + ("me_frame",)]
        t0 = time.perf_counter()
        with _k1_per_plan() as k1:
            aus, counts = _launches_of(
                K, lambda: _push_all(enc, [planes(f) for f in frames[:n]]),
                label, need)
        wall = time.perf_counter() - t0
        n_inter = 0 if gop == "AI" else n - 1
        n_intra = n - n_inter
        # 4 plans per picture: an AI plan is K1 once and K4 twice, a P plan
        # K1 once, K4 once and the list picks once
        want = {"plan_dp": 4 * (2 * n_intra + n_inter),
                "ref_buffers": 4 * n, "inter_pick": 4 * n_inter}
        got = {k: counts[k] for k in want}
        print(f"{label}: launches {got} for {n} pictures (4 plans each)",
              flush=True)
        if got != want:
            raise AssertionError(f"{label}: launches {got}, not {want}")
        if n_inter:
            _k1_once_per_plan(k1, 4 * n_inter, label)
        print(f"{label}: {n} pictures in {wall:.3f} s = {n / wall:.3f} fps; "
              f"bytes {[len(a) for a in aus]}  [{CARD}]", flush=True)
        print(f"{label} stage_ms per picture: " + json.dumps(
            {k: round(v / n, 3) for k, v in enc.stage_ms.items()})
            + f"  [{CARD}]", flush=True)
        _decode_check(aus, n, label)
        runs[label] = counts
    return runs


def field_phase(dev, w=1920, h=1088):
    """Field coding at 1920x1088 (544-row fields: eight 64-row CTU rows and
    a 32-row one) through encode_stream: HM's All Intra Main over two
    frames (four fields) and Low Delay P Main over three (six fields: IDR,
    one GOP of four P, one low-delay B of the flush tail).  Prints fps and
    stage_ms per field, asserts one plan per field by K1's launches, and
    checks every field's hash.  Returns {label: launch counts}."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    frames = _frames(w, h, 3)
    runs = {}
    for gop, n in (("AI", 2), ("LDP", 3)):
        kw = dict(intra_period=1) if gop == "AI" else \
            dict(intra_period=0, gop="ld")
        enc = Encoder(EncoderConfig(w, h, qp=QP, field_coding=True, **kw),
                      dev)
        label = f"field {gop} {w}x{h}"
        need = INTRA if gop == "AI" else \
            [k for k in K.LAUNCHES if k not in BAND + ("me_frame",)]
        t0 = time.perf_counter()
        with _k1_per_plan() as k1:
            aus, counts = _launches_of(
                K, lambda: list(enc.encode_stream(frames[:n])), label, need)
        wall = time.perf_counter() - t0
        if counts["ref_buffers"] != 2 * n:
            raise AssertionError(f"{label}: {counts['ref_buffers']} K1 "
                                 f"launches for {2 * n} fields")
        if gop == "LDP":
            _picks_per_picture(counts, 2 * n - 1, label)
            _k1_once_per_plan(k1, 2 * n - 1, label)
        print(f"{label}: {2 * n} fields of {w}x{h // 2} in {wall:.3f} s = "
              f"{2 * n / wall:.3f} fields/s; bytes {[len(a) for a in aus]}  "
              f"[{CARD}]", flush=True)
        print(f"{label} stage_ms per field: " + json.dumps(
            {k: round(v / (2 * n), 3) for k, v in enc.stage_ms.items()})
            + f"  [{CARD}]", flush=True)
        _decode_check(aus, 2 * n, label)
        runs[label] = counts
    return runs


def small_checks(dev):
    """The small recipes of stream_digest (136x72 and 128x128: AI, LDP, RA
    through the fused plans; LDP under rate control at picture and CTU
    level and RA GOP 8 under it; delta_qp_rd on AI and LDP; field coding
    of AI and LDP at 128x128, whose 64-row fields avoid the reference's
    fault F2; IPPP and RA through the per-CU search) on the card against
    the same encodes on the CPU, and both against the JAX package's
    pinned digests: a card that differs from the CPU and from PINNED
    points at the kernels, a card and a CPU that differ from PINNED
    together at the machine."""
    from hm16_2_tpu_torch.tools import stream_digest as S
    cpu = torch.device("cpu")
    for name in S.SMALL:
        r = S.RECIPES[name]
        frames = S.make_frames(r)
        on_card = S.encode(r, S.port_encoder(dev), frames)
        on_cpu = S.encode(r, S.port_encoder(cpu), frames)
        card = S.mismatch(name, S.digest(frames, on_card))
        host = S.mismatch(name, S.digest(frames, on_cpu))
        if on_card != on_cpu or card or host:
            raise AssertionError(
                f"{name}: card bytes "
                f"{'equal' if on_card == on_cpu else 'differ from'} the "
                f"CPU's; card against PINNED: {card or 'equal'}; CPU "
                f"against PINNED: {host or 'equal'}; recipe {r}")
        print(f"{name}: card bytes equal the CPU plain path's and the JAX "
              "package's (PINNED)", flush=True)


@contextlib.contextmanager
def _banded(mesh):
    """Point the encoder's two plans at the row mesh for the block:
    intra_rd.plan_frame becomes frame_shard.sharded_plan_frame, and
    inter_plan.plan_frame takes the mesh (its integer ME banded where
    plan_shard.shardable allows).  Yields a dict whose "inter" counts the
    inter plans that took the banded ME."""
    from hm16_2_tpu_torch.encode import inter_plan, intra_rd
    from hm16_2_tpu_torch.parallel import plan_shard
    from hm16_2_tpu_torch.parallel.frame_shard import sharded_plan_frame
    saved = intra_rd.plan_frame, inter_plan.plan_frame, \
        plan_shard.sharded_int_me
    seen = {"inter": 0}

    def int_me(*a):
        seen["inter"] += 1
        return saved[2](*a)

    intra_rd.plan_frame = lambda orig, sps, qp, lam, cw, cqps, device=None: \
        sharded_plan_frame(mesh, orig, sps, qp, lam, cw, cqps)
    inter_plan.plan_frame = lambda *a, **kw: saved[1](*a, **dict(kw,
                                                                mesh=mesh))
    plan_shard.sharded_int_me = int_me
    try:
        yield seen
    finally:
        intra_rd.plan_frame, inter_plan.plan_frame, \
            plan_shard.sharded_int_me = saved


def banded_phase(frames, small, dev):
    """The row-banded path on one card, bands on `dev`: two 1080p AI frames
    through encode_frame with the intra plan banded over 2 bands, and a
    1024x768 RA GOP 8 (IDR + 8 B) with both plans banded over 2 and over
    4 bands, each against the same encode unbanded (equal bytes, every
    picture hash_ok); sharded_analysis_step on a (2, 2) mesh; the port's
    scaling_bench over 1, 2 and 4 bands on the card (the plumbing cost of
    banding, not multi-GPU scaling).  Returns the launch counts of the
    banded run."""
    from hm16_2_tpu_torch import kernels as K
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    from hm16_2_tpu_torch.parallel import frame_shard as F
    from hm16_2_tpu_torch.parallel import mesh as MM
    from hm16_2_tpu_torch.tools import scaling_bench
    H, W = frames[0][0].shape
    h2, w2 = small[0][0].shape
    ai_cfg = lambda: EncoderConfig(W, H, qp=QP, intra_period=1)
    ra_cfg = lambda: EncoderConfig(w2, h2, qp=QP, intra_period=32, gop="ra8")
    planes = [[p.astype("int32") for p in f] for f in frames[:2]]

    def ai():
        enc = Encoder(ai_cfg(), dev)
        return [enc.encode_frame(planes[i], i) for i in range(2)]

    whole, secs = {}, {}
    for key, code in (("ai", ai), ("ra", lambda: _push_all(
            Encoder(ra_cfg(), dev), small))):
        t0 = time.perf_counter()
        whole[key] = code()
        torch.cuda.synchronize()
        secs[f"whole {key}"] = time.perf_counter() - t0
    out = {}

    band_k1 = lambda: K.LAUNCHES["ref_buffers_band"]

    def run():
        t1, k0 = time.perf_counter(), band_k1()
        with _banded(F.make_row_mesh([dev] * 2)):
            out["ai"] = ai()
        secs["ai"], out["k1 ai"] = time.perf_counter() - t1, band_k1() - k0
        for n in (2, 4):
            t1, k0 = time.perf_counter(), band_k1()
            with _banded(F.make_row_mesh([dev] * n)) as seen:
                out[n] = _push_all(Encoder(ra_cfg(), dev), small)
            out[f"inter{n}"] = seen["inter"]
            secs[n], out[f"k1 {n}"] = time.perf_counter() - t1, band_k1() - k0
        orig, bufs = MM.example_batch(2, 2, 64, 16)
        out["analysis"] = MM.sharded_analysis_step(
            MM.make_mesh([dev] * 4, 2), 16, 8)(orig, bufs, QP)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = scaling_bench.main([
                "--size", f"{w2}x{h2}", "-n", "3", "--Devices",
                ",".join([f"{dev.type}:{dev.index or 0}"] * 4)])
        if rc != 0:
            raise AssertionError(f"scaling_bench exited {rc}")
        out["bench"] = buf.getvalue().splitlines()

    _, counts = _launches_of(
        K, run, f"banded path {W}x{H} AI, {w2}x{h2} RA", BAND + INTRA + (
            "subpel_planes", "inter_uni", "inter_pick", "inter_bi_refine",
            "inter_cu_rd_b"))
    if counts["inter_me"] or counts["inter_cu_rd"]:
        raise AssertionError("the banded RA plans ran the whole-picture ME "
                             "or a P kernel")
    for line in out["bench"]:
        print(f"scaling_bench {line}  [{CARD}]", flush=True)
    # K1's band mode: one launch per band per band height's group of sizes
    # in each I picture (1080p: s = 4 alone; 1024x768: every size)
    k1_want = {"k1 ai": 2 * 2 * len(F.band_groups(H, W, 2)),
               "k1 2": 2 * len(F.band_groups(h2, w2, 2)),
               "k1 4": 4 * len(F.band_groups(h2, w2, 4))}
    print(f"K1 band launches: {W}x{H} AI, 2 frames over 2 bands "
          f"{out['k1 ai']}; {w2}x{h2} RA I picture over 2 and 4 bands "
          f"{out['k1 2']}, {out['k1 4']}", flush=True)
    if any(out[k] != v for k, v in k1_want.items()):
        raise AssertionError(f"K1 band launches not one per band per group: "
                             f"{ {k: out[k] for k in k1_want} } against "
                             f"{k1_want}")
    if out["ai"] != whole["ai"]:
        raise AssertionError("banded AI bytes differ from the unbanded")
    for n in (2, 4):
        if out[n] != whole["ra"]:
            raise AssertionError(f"RA over {n} bands differs from unbanded")
        if out[f"inter{n}"] != 8:
            raise AssertionError(f"RA over {n} bands: {out[f'inter{n}']} "
                                 "banded inter plans, not 8")
    print(f"banded {W}x{H} AI (2 bands) bytes {[len(a) for a in out['ai']]} "
          f"equal unbanded, {secs['ai']:.3f} s (unbanded "
          f"{secs['whole ai']:.3f} s); {w2}x{h2} RA GOP8 over 2 and 4 bands "
          f"equal unbanded, 8 banded B plans each, {secs[2]:.3f} / "
          f"{secs[4]:.3f} s (unbanded {secs['whole ra']:.3f} s)  [{CARD}]",
          flush=True)
    _decode_check(out["ai"], 2, f"banded AI {W}x{H}")
    _decode_check(out[2], 9, f"banded RA {w2}x{h2}")
    return counts


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

    CARD = _card_line()
    print(CARD, flush=True)
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    print(f"device {name}  torch {torch.__version__}  cuda "
          f"{torch.version.cuda}", flush=True)
    path, secs = K.build()
    print(f"kernels built in {secs:.1f} s: {os.path.relpath(path, ROOT)}  "
          f"[{CARD}]", flush=True)
    for line in _ptxas(K.resource_usage(), ("ref_multi_kernel",
                                            "size_rd_kernel",
                                            "cand_rd_kernel",
                                            "analysis_kernel",
                                            "me_argmin_kernel",
                                            "me_refine_kernel",
                                            "frac_refine_kernel",
                                            "subpel_kernel",
                                            "cu_rd_kernel",
                                            "uni_select_all_kernel",
                                            "plan_pre_kernel",
                                            "plan_ctu_kernel",
                                            "emit_inter_kernel")):
        print(line, flush=True)
    print("dynamic shared memory per CTA (bytes): " + json.dumps(
        K.dynamic_smem()), flush=True)
    if native.get_lib() is None or native.get_dsp() is None:
        raise AssertionError("native commit engine did not build")

    t0 = time.perf_counter()
    # the content of the 8-bit 1080p recipes (each codes a prefix of RA's)
    from hm16_2_tpu_torch.tools import stream_digest as S
    frames = S.make_frames(S.RECIPES["RA"])
    print(f"frames {W}x{H} made in {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")
    stats = check_kernels(frames[0], dev)
    check_inter_kernels(frames[1:6], dev, stats=stats)
    check_b_kernels(frames[:5], dev, stats=stats)
    check_me_frame(frames[1:6], dev, stats=stats)
    check_me_frame(frames[4:6], dev, stats=stats, nref=1)
    # the row-banded kernels: K1's band mode at 1080p (s = 4, the one size
    # the banding rule splits there), K2's analysis mode on every 1080p
    # block, K1's (every size, one group) and K5's band modes at 1024x768
    # (HM class F) over 2 and 4 bands
    check_band_kernels(frames[:1], dev, stats=stats, me=False)
    xga = _frames(1024, 768, 9)
    check_band_kernels(xga[:5], dev, stats=stats, analysis=())
    # K5 and K7 on the inputs their invariants rest on, and a flat 1080p
    check_me_edges(dev)
    # K6 and K8 likewise
    check_k6_k8_edges(dev)
    # K4 and K7's list picks likewise
    check_k4_picks_edges(dev)
    report_k6_k8(stats, torch.from_numpy(np.stack(
        [frames[k][0] for k in (4, 3, 2, 1)]).astype("int32")).to(dev))
    # K2 and K3 likewise, and their time by case
    check_intra_edges(dev)
    # K1 likewise
    check_k1_edges(dev)
    report_k2_k3(stats)

    # all-intra: warm-up frame, then a timed 3-frame encode_stream
    from hm16_2_tpu_torch.encode.intra_rd import fetch_plan
    warm = S.port_encoder(dev)(S.config(S.RECIPES["AI"]))
    list(warm.encode_stream(frames[3:4]))
    planes = [p.astype("int32") for p in frames[3]]
    t0 = time.perf_counter()
    for _ in range(5):
        fetch_plan(warm._submit_plan(planes), H, W)
    print(f"frame plan alone (upload, kernels, packed plan back): "
          f"{(time.perf_counter() - t0) / 5 * 1e3:.3f} ms per frame  "
          f"[{CARD}]", flush=True)
    ai = S.RECIPES["AI"]
    aus, ai_counts = ai_phase(ai, frames[:ai.frames], dev)
    print(f"AI launches per frame: plan_dp {ai_counts['plan_dp'] / ai.frames}"
          f", ref_buffers {ai_counts['ref_buffers'] / ai.frames}", flush=True)
    if (ai_counts["plan_dp"], ai_counts["ref_buffers"]) != (2 * ai.frames,
                                                            ai.frames):
        raise AssertionError("AI: K4 not 2 launches per frame or K1 not 1")
    _pinned("AI", frames[:ai.frames], aus)

    # low-delay P: IDR + one GOP of four P pictures
    ldp = S.RECIPES["LDP"]
    ldp_aus, ldp_counts = ldp_phase(ldp, frames[:ldp.frames], dev)
    _decode_check(ldp_aus, ldp.frames, "LDP")
    _pinned("LDP", frames[:ldp.frames], ldp_aus)

    # random access: IDR + one GOP of eight B pictures
    ra = S.RECIPES["RA"]
    ra_aus, ra_counts = ra_phase(ra, frames[:ra.frames], dev)
    _decode_check(ra_aus, ra.frames, "RA")
    _pinned("RA", frames[:ra.frames], ra_aus)

    # the per-CU inter search: IDR + one P picture without a fused plan (its
    # host search takes about a minute per 1080p P picture)
    fb = S.RECIPES["per-CU search"]
    fb_aus, fb_counts = fallback_phase(fb, frames[:fb.frames], dev)
    _decode_check(fb_aus, fb.frames, "per-CU search")
    _pinned("per-CU search", frames[:fb.frames], fb_aus)

    # Main10: AI and RA at 1080p on 10-bit content
    t0 = time.perf_counter()
    main10 = main10_phase(dev)
    print(f"Main10 phase: {time.perf_counter() - t0:.1f} s  [{CARD}]",
          flush=True)

    # rate control, delta_qp_rd and field coding at 1080p and 1920x1088
    t0 = time.perf_counter()
    new = {f"RC{' CTU' * ctu}": rc_phase(frames[:5], dev, ctu)[1]
           for ctu in (False, True)}
    new.update(dqp_phase(frames[:5], dev))
    new.update(field_phase(dev))
    print(f"rate control, delta_qp_rd and field phases: "
          f"{time.perf_counter() - t0:.1f} s  [{CARD}]", flush=True)

    t0 = time.perf_counter()
    small_checks(dev)
    print(f"small card-against-CPU checks: {time.perf_counter() - t0:.1f} s"
          f"  [{CARD}]", flush=True)
    cli_counts = cli_phase()
    band_counts = banded_phase(frames, xga, dev)

    unbanded = {"AI": ai_counts, "LDP": ldp_counts, "RA": ra_counts,
                "per-CU search": fb_counts, "CLI": cli_counts, **main10,
                **new}
    for label, c in unbanded.items():
        if any(c[k] for k in BAND):
            raise AssertionError(f"{label} launched a band kernel: "
                                 f"{[k for k in BAND if c[k]]}")
    print("band kernels launched on the banded path only", flush=True)

    loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "hm16_2_tpu" or m.startswith("hm16_2_tpu.")]
    if loaded:
        raise AssertionError(f"modules of jax or the JAX package loaded: "
                             f"{loaded[:5]}")
    print("neither jax nor the JAX package imported", flush=True)
    print(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s  [{CARD}]",
          flush=True)

    runs = (ai_counts, ldp_counts, ra_counts, fb_counts, band_counts,
            *main10.values(), *new.values())
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

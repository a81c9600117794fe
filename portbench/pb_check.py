"""The check that decides `correct`: the encoder's output against the plain
reference in `ref/hevcref` (a frozen copy of plain PyTorch and numpy code;
nothing of the package under test is imported here).

For each sampled picture the reference
- works out from the configuration file alone what the picture has to
  carry (IDR, CRA or neither, slice type, slice QP, the POCs of both active
  reference lists, the decoded-picture hash) and what the parameter sets
  have to state (size, bit depth, SAO, deblocking and its offsets,
  transform skip, tiles, wavefront, bypass), and counts every difference;
- decodes the encoder's access units with its own decoder and compares
  every decoded sample with the encoder's reconstruction and with the
  picture's decoded-picture-hash SEI (the configuration states MD5);
- plans the picture again with its plain versions of the frame plans (K1-K8),
  from the benchmark's own source frame, the QP, lambda and reference lists
  it works out from the configuration, its own decoded reference pictures
  and the motion prior it derives from its own decoded motion field, and
  compares every entry of the packed plan with the one the encoder fetched;
- checks that the decoded picture codes every planned part at the planned
  CU depth.

Every number is a count of differences, each with the limit 0.
"""

from __future__ import annotations

import contextlib
import copy
import os
import random
import sys

import numpy as np
import torch

_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ref")
if _REF not in sys.path:
    sys.path.insert(0, _REF)

from hevcref.bitstream.bitio import (                     # noqa: E402
    split_annexb, strip_emulation_prevention)
from hevcref.common.tables import CHROMA_QP_SCALE         # noqa: E402
from hevcref.decode.mvpred import RefCtx                  # noqa: E402
from hevcref.decode.top import Decoder, parse_sei_rbsp    # noqa: E402
from hevcref.encode import inter_plan, intra_rd           # noqa: E402
from hevcref.headers import params as P                   # noqa: E402

LIMITS = {"params_mismatch": 0, "plan_mismatch": 0, "plan_not_followed": 0, "recon_mismatch": 0,
          "hash_mismatch": 0, "undecodable": 0}
_PARAM_SETS = (P.NAL_VPS, P.NAL_SPS, P.NAL_PPS)


def _nal_type(nal):
    return (nal[0] >> 1) & 63


@contextlib.contextmanager
def lowered_precision():
    """The control: the plans' float32 cost arithmetic rounded to bfloat16
    (the nearest precision below the configuration's float32)."""
    orig = intra_rd._fma32

    def fma_bf16(a, b, c):
        return orig(a, b, c).to(torch.bfloat16).to(torch.float32)

    intra_rd._fma32 = inter_plan._fma32 = fma_bf16
    try:
        yield
    finally:
        intra_rd._fma32 = inter_plan._fma32 = orig


def _prior(dpic, poc, h, w):
    """The motion prior a picture leaves for the next plan: its list-0
    motion at 8x8, in quarter-pel x16 per POC unit (zero where intra)."""
    h8, w8 = h // 8, w // 8
    mvq = dpic.mv[0][: h8 * 2: 2, : w8 * 2: 2]
    rpoc = dpic.ref_poc[0][: h8 * 2: 2, : w8 * 2: 2]
    d = poc - rpoc.astype(np.int64)
    valid = (rpoc > -(10 ** 8)) & (d != 0)
    dsafe = np.where(valid, d, 1).astype(np.float64)
    return np.where(
        valid[:, :, None],
        np.rint(np.stack([mvq[:, :, 1], mvq[:, :, 0]], axis=-1)
                * 16.0 / dsafe[:, :, None]).astype(np.int64),
        0).astype(np.int32)


class Expect:
    """What the configuration fixes about one picture."""

    def __init__(self, poc, kind, slice_type, qp, l0, l1, slot):
        self.poc, self.kind, self.slice_type, self.qp = poc, kind, \
            slice_type, qp
        self.l0, self.l1, self.slot = l0, l1, slot


_TYPES = {"I": P.I_SLICE, "P": P.P_SLICE, "B": P.B_SLICE}


class Rules:
    """What the configuration alone fixes about each picture: its coding
    order, whether it is an IDR or a CRA, its slice type and QP (the base
    QP plus its GOP entry's offset), and its two active reference lists.

    The lists follow HEVC from the GOP table: a picture's reference
    picture set is its entry's references that are held (coded earlier,
    kept by the previous picture's set, and for a picture that follows a
    CRA in output order, not before the CRA); a CRA keeps what its leading
    pictures reference.  List 0 is the held earlier pictures, closest
    first, then the later ones; list 1 the later, then the earlier; each
    holds the entry's number of active pictures, at most the set's size."""

    def __init__(self, enc_cfg):
        self.cfg = enc_cfg
        self.qp = int(enc_cfg["qp"])
        table = enc_cfg.get("gop_table")
        self.table = table or None
        self.gop = {s["poc"]: s for s in table} if table else None
        self.gsize = len(table) if table else 0
        self.ip = int(enc_cfg["intra_period"])
        if self.gop is None and self.ip != 1:
            raise ValueError("the check knows GOP tables and all-intra only")
        if self.gop is not None and self.ip > 1 and \
                int(enc_cfg.get("decoding_refresh_type", 1)) != 1:
            raise ValueError("the check knows CRA refreshes only")
        self._memo = {}

    def slot(self, poc):
        return self.gop[(poc - 1) % self.gsize + 1]

    def intra_alpha(self, kind):
        if self.gop is None or kind == "IDR":
            return 0.57
        return 0.57 * (1.0 - min(0.5, 0.05 * (self.gsize - 1)))

    def coding_order(self, n):
        if self.gop is None:
            return list(range(n))
        order, g = [0], 0
        while len(order) < n:
            order += [g * self.gsize + s["poc"] for s in self.table]
            g += 1
        return order[:n]

    def _qp(self, off):
        return int(np.clip(self.qp + off, 0, 51))

    def expect(self, n):
        """{poc: Expect} for the first n pictures in coding order."""
        if n in self._memo:
            return self._memo[n]
        out, kept, last_irap = {}, set(), 0
        for p in self.coding_order(n):
            if self.gop is None or p == 0:
                out[p] = Expect(p, "IDR", P.I_SLICE, self.qp, [], [], None)
                kept, last_irap = {p}, p
                continue
            s = self.slot(p)
            if s["poc"] == self.gsize and self.ip > 1 and p % self.ip == 0 \
                    and self.cfg.get("gop") != "ld":
                out[p] = Expect(p, "CRA", P.I_SLICE, self._qp(s["qpoff"]),
                                [], [], s)
                lead = {p - self.gsize + t["poc"] + d for t in self.table
                        if t["poc"] != self.gsize for d in t["refs"]}
                kept, last_irap = {q for q in lead if q < p} & kept | {p}, p
                continue
            held = [p + d for d in s["refs"] if p + d in kept
                    and (p < last_irap or p + d >= last_irap)]
            before = sorted((q for q in held if q < p), reverse=True)
            after = sorted(q for q in held if q > p)
            n_act = max(1, min(int(s.get("n_active", 2)), len(held))) \
                if held else 0
            st = _TYPES[s.get("type", "B")]
            l0 = (before + after)[:n_act]
            l1 = (after + before)[:n_act] if st == P.B_SLICE else []
            out[p] = Expect(p, "", st, self._qp(s["qpoff"]), l0, l1, s)
            kept = set(held) | {p}
        self._memo[n] = out
        return out

    def param_sets(self, sps, pps):
        """(name, stated, expected) of every parameter-set field the
        configuration fixes."""
        c = self.cfg
        bd = int(c.get("bit_depth", 8))
        tiles = int(c.get("tile_cols", 1)) * int(c.get("tile_rows", 1)) > 1
        return [
            ("width", sps.pic_width, int(c["width"])),
            ("height", sps.pic_height, int(c["height"])),
            ("chroma_format_idc", sps.chroma_format_idc, 1),
            ("bit_depth_luma", sps.bit_depth_luma, bd),
            ("bit_depth_chroma", sps.bit_depth_chroma, bd),
            ("sao_enabled", sps.sao_enabled, int(bool(c["sao"]))),
            ("pcm_enabled", sps.pcm_enabled, int(bool(c.get("pcm")))),
            ("scaling_list_enabled", sps.scaling_list_enabled,
             int(bool(c.get("scaling_list")))),
            ("transform_skip_enabled", pps.transform_skip_enabled,
             int(bool(c["transform_skip"]))),
            ("transquant_bypass_enabled", pps.transquant_bypass_enabled,
             int(bool(c.get("transquant_bypass")))),
            ("entropy_coding_sync", pps.entropy_coding_sync,
             int(bool(c.get("wpp")))),
            ("tiles_enabled", pps.tiles_enabled, int(tiles)),
            ("cb_qp_offset", pps.cb_qp_offset, 0),
            ("cr_qp_offset", pps.cr_qp_offset, 0),
        ]

    def slice_fields(self, sh, nal_type, e, hash_method):
        """(name, stated, expected) of every slice field the configuration
        fixes for the picture e."""
        kind = "IDR" if P.is_idr(nal_type) else \
            "CRA" if P.is_cra(nal_type) else ""
        c = self.cfg
        on = bool(c["deblock"])
        got_db = (int(not sh.deblocking_filter_disabled),
                  sh.beta_offset_div2 if on else 0,
                  sh.tc_offset_div2 if on else 0)
        want_db = (int(on), int(c.get("deblock_beta_offset", 0)) if on else 0,
                   int(c.get("deblock_tc_offset", 0)) if on else 0)
        return [
            ("random access point", kind, e.kind),
            ("slice type", sh.slice_type, e.slice_type),
            ("slice QP", sh.qp, e.qp),
            ("list 0", signalled_list(sh, 0), e.l0),
            ("list 1", signalled_list(sh, 1), e.l1),
            ("deblocking", got_db, want_db),
            ("picture hash", hash_method, int(c.get("hash_type", 0))),
        ]

    def dispatched_early(self, order, i, cra):
        """Whether order[i]'s plan was dispatched while order[i - 1]
        committed: the two sit in one GOP, neither is the CRA, and
        order[i] does not reference order[i - 1]."""
        if self.gop is None or i == 0:
            return False
        p, q = order[i], order[i - 1]
        if (p - 1) // self.gsize != (q - 1) // self.gsize or q == 0:
            return False
        if p in cra or q in cra:
            return False
        return all(p + d != q for d in self.slot(p)["refs"])


def signalled_list(sh, lx):
    """The POCs of the slice's list lx as its reference picture set and its
    active count state them (HEVC 8.3.4; None where a list modification or
    long-term pictures are present, which the configurations never ask)."""
    n = int(sh.num_ref_idx[lx]) if sh.slice_type != P.I_SLICE else 0
    if lx == 1 and sh.slice_type != P.B_SLICE:
        n = 0
    if n == 0:
        return []
    if sh.ref_pic_list_modification[lx] is not None or sh.lt_poc:
        return None
    rps = sh.rps
    used = [d for d, u in zip(rps.delta_poc, rps.used) if u] if rps else []
    before = [sh.poc + d for d in sorted((d for d in used if d < 0),
                                          reverse=True)]
    after = [sh.poc + d for d in sorted(d for d in used if d > 0)]
    cur = before + after if lx == 0 else after + before
    return [cur[i % len(cur)] for i in range(n)] if cur else None


class Reference:
    def __init__(self, enc_cfg, device, control=False):
        self.rules = Rules(enc_cfg)
        self.device = device
        self.control = control

    def _intra_plan(self, planes, sps, pps, qp, kind):
        lam = self.rules.intra_alpha(kind) * 2.0 ** ((qp - 12) / 3.0)
        cqps = []
        for off in (pps.cb_qp_offset, pps.cr_qp_offset):
            base = int(np.clip(qp + off, 0, 57))
            cqps.append(int(CHROMA_QP_SCALE[sps.chroma_format_idc][base])
                        + 6 * (sps.bit_depth_chroma - 8))
        base = int(np.clip(qp + pps.cb_qp_offset, 0, 57))
        cqp = int(CHROMA_QP_SCALE[sps.chroma_format_idc][base])
        cw = 2.0 ** ((qp - cqp) / 3.0)
        planes = [np.ascontiguousarray(p, dtype=np.int32) for p in planes]
        fut = intra_rd.submit_plan(planes, sps, qp + 6 * (sps.bit_depth_luma
                                                          - 8),
                                   lam, cw, cqps, self.device)
        return _host(fut)

    def _inter_plan(self, luma, sh, ref_lists, prior):
        lam = self.rules.slot(sh.poc)["qpfac"] * 2.0 ** ((sh.qp - 12) / 3.0)
        fut = inter_plan.submit_plan(
            np.ascontiguousarray(luma, dtype=np.int32), sh.sps, sh,
            RefCtx(sh, ref_lists), prior, float(lam), float(np.sqrt(lam)),
            self.device)
        return _host(fut)

    def plan(self, *args, intra):
        if not self.control:
            return (self._intra_plan if intra else self._inter_plan)(*args)
        with lowered_precision():
            return (self._intra_plan if intra else self._inter_plan)(*args)


def _host(fut):
    if fut is None:
        return None
    if fut.event is not None:
        fut.event.synchronize()
    return fut.host.numpy().copy()


def _not_followed(plan, dpic, slice_type):
    """Parts the plan covers whose decoded CU depth is not the planned one
    (the packed plans' channel 0 is the depth; the cover flag is bit 1 of
    channel 6 in an intra plan, bit 0 of channel 1 in an inter plan)."""
    if plan is None:
        return 0
    cov = (plan[6] & 2) != 0 if slice_type == P.I_SLICE else \
        (plan[1] & 1) != 0
    h4, w4 = plan.shape[1:]
    return int(np.count_nonzero(dpic.depth[:h4, :w4][cov] != plan[0][cov]))


def _diff(a, b):
    if a is None or b is None:
        return 0 if a is None and b is None else 1
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int(np.count_nonzero(a != b))


def _psnr(a, b, bit_depth):
    d = np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)
    mse = float(np.mean(d * d))
    peak = float((1 << bit_depth) - 1)
    return 99.99 if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _hash_method(nals):
    """The method of the AU's decoded-picture-hash SEI, None without one."""
    for n in nals:
        if _nal_type(n) in (P.NAL_SEI_PREFIX, P.NAL_SEI_SUFFIX):
            for ptype, payload in parse_sei_rbsp(
                    strip_emulation_prevention(n[2:])):
                if ptype == 132:
                    return payload[0]
    return None


def choose(kind, rules, order, window, pics, seed, n_plan):
    """The chains of pictures to decode (each in coding order) and the
    pictures whose plans are checked, drawn from the seed among the
    pictures of the window."""
    rnd = random.Random(int(seed))
    if kind == "independent":
        # intra pictures stand alone: the largest AU and a seeded sample
        pool = sorted(window)
        largest = max(pool, key=lambda p: (len(pics[p]["au"]), -p))
        rest = [p for p in pool if p != largest]
        pick = [largest] + rnd.sample(rest, min(n_plan - 1, len(rest)))
        return [[p] for p in sorted(pick)], set(pick)
    if kind != "gop_chain":
        raise ValueError(f"unknown check kind {kind!r}")
    # a GOP opens with its anchor; the drawn GOP's first n_plan + 1
    # pictures are judged, after every picture that they reference,
    # directly or through others, by the configuration's lists
    exp = rules.expect(len(order))
    idx = {p: i for i, p in enumerate(rules.coding_order(len(order)))}
    anchors = [p for p in window if exp[p].slot is not None
               and exp[p].slot["poc"] == rules.gsize]
    if not anchors:
        raise RuntimeError("the window holds no whole GOP")
    a = sorted(anchors)[rnd.randrange(len(anchors))]
    head = [p for p in order[order.index(a):] if p in window][:n_plan + 1]
    need, todo = set(head), list(head)
    while todo:
        e = exp[todo.pop()]
        for q in e.l0 + e.l1:
            if q not in need:
                need.add(q)
                todo.append(q)
    chain = sorted(need, key=idx.__getitem__)
    planned = set(head[1:]) | {p for p in chain if exp[p].kind}
    return [chain], planned


def check(cfg, frames, pics, order, window, seed, device, control=False):
    """Returns (numbers {name: value}, failed pictures, lines to print).

    cfg: the configuration file's dict with the traffic's qp; pics: poc ->
    the recorder's record (au, recon, plan, slice_type); order: coding order
    of every coded picture; window: the POCs counted in the window.
    control=True puts the control in the encoder's place for the plans:
    the reference's plans computed in bfloat16 are compared with its own."""
    ck = cfg["check"]
    enc_cfg = dict(cfg["encoder"], qp=cfg["qp"], width=cfg["width"],
                   height=cfg["height"])
    ref = Reference(enc_cfg, device)
    chains, planned = choose(ck["kind"], ref.rules, order, set(window), pics,
                             seed, int(ck["plan_pictures"]))
    judge = _Judge(ref, Reference(enc_cfg, device, control=True)
                   if control else None, frames, pics, order, planned)
    want = ref.rules.coding_order(len(order))
    off = [i for i, (a, b) in enumerate(zip(order, want)) if a != b]
    if off:
        judge.count_params(order[off[0]], 1, f"coding order {order} is not "
                           f"the configuration's {want}")
    for chain in chains:
        judge.decode_chain(chain)
    judge.lines.append(
        f"checked pictures: decoded {sorted(p for c in chains for p in c)}, "
        f"plans {sorted(planned)}")
    return judge.nums, judge.failed, judge.lines


class _Judge:
    def __init__(self, ref, lowered, frames, pics, order, planned):
        self.ref, self.lowered = ref, lowered
        self.rules = ref.rules
        self.exp = ref.rules.expect(len(order))
        self.frames, self.pics, self.order = frames, pics, order
        self.planned = planned
        self.params = [n for n in split_annexb(pics[order[0]]["au"])
                       if _nal_type(n) in _PARAM_SETS]
        self.nums = dict.fromkeys(LIMITS, 0)
        self.failed, self.lines = set(), []
        self._sets_checked = False

    def _count(self, p, name, n, what):
        if n:
            self.nums[name] += n
            self.lines.append(f"poc {p}: {n} {what}")
            self.failed.add(p)

    def count_params(self, p, n, what):
        self._count(p, "params_mismatch", n, what)

    def _fields(self, p, fields):
        for name, got, want in fields:
            if got != want:
                self.count_params(p, 1, f"{name} {got!r}, the configuration "
                                  f"states {want!r}")

    def decode_chain(self, chain):
        """Decode the chain's AUs in order with a fresh decoder, judging
        each picture."""
        dec = Decoder()
        for n in self.params:
            dec.decode_nal(n)
        decoded = {}
        for p in chain:
            nals = [n for n in split_annexb(self.pics[p]["au"])
                    if _nal_type(n) not in _PARAM_SETS]
            last_vcl = max(i for i, n in enumerate(nals)
                           if _nal_type(n) <= 31)
            e = self.exp[p]
            try:
                for i, n in enumerate(nals):
                    dec.decode_nal(n)
                    if i == last_vcl:
                        dpic, nal_type = dec.cur_pic, _nal_type(n)
                        sh = dpic.slices[0]
                        lists = [[dec.dpb.get(q) for q in e.l0],
                                 [dec.dpb.get(q) for q in e.l1]]
                dec._finish_picture()
            except Exception as exc:      # a stream the reference rejects
                self._count(p, "undecodable", 1,
                            f"failure of the reference decoder: {exc!r}")
                return
            if not self._sets_checked:
                self._sets_checked = True
                self._fields(p, self.rules.param_sets(sh.sps, sh.pps))
            self._fields(p, self.rules.slice_fields(sh, nal_type, e,
                                                    _hash_method(nals)))
            out = dec.outputs[-1]
            decoded[p] = dec.dpb.get(out.poc)
            src = self.frames[p]
            self.lines.append(
                f"poc {p}: {len(self.pics[p]['au']) * 8} bits, PSNR "
                + " / ".join(f"{_psnr(a, b, sh.sps.bit_depth_luma):.4f}"
                             for a, b in zip(out.planes, src)) + " dB")
            self._count(p, "recon_mismatch", sum(
                _diff(a, b) for a, b in zip(out.planes, self.pics[p]["recon"])),
                "reconstructed samples differ from the reference decoder's")
            self._count(p, "hash_mismatch", int(out.hash_ok is not True),
                        f"decoded picture hash not matched ({out.hash_ok})")
            plan = self.pics[p].get("plan")
            self._count(p, "plan_not_followed",
                        _not_followed(plan, dpic, sh.slice_type),
                        "planned 4x4 parts were coded at another CU depth")
            if p in self.planned:
                self._plan(p, sh, e, lists, decoded, plan)

    def _plan(self, p, sh, e, lists, decoded, plan):
        """The reference's plan from the configuration's QP, lambda and
        lists over its own decoded pictures, against the encoder's."""
        if e.slice_type == P.I_SLICE:
            args = (self.frames[p], sh.sps, sh.pps, e.qp, e.kind)
        elif any(r is None for r in lists[0] + lists[1]):
            self._count(p, "plan_mismatch", max(1, _diff(plan, 0)),
                        "a reference the configuration names was not kept")
            return
        else:
            cra = {q for q, x in self.exp.items() if x.kind == "CRA"}
            i = self.order.index(p)
            early = self.rules.dispatched_early(self.order, i, cra)
            src = self.order[i - 2] if early else self.order[i - 1]
            prior = _prior(decoded[src], src, sh.sps.pic_height,
                           sh.sps.pic_width)
            sh = copy.copy(sh)
            sh.qp, sh.slice_type = e.qp, e.slice_type
            sh.num_ref_idx = [len(e.l0), len(e.l1)]
            args = (self.frames[p][0], sh, lists, prior)
        intra = e.slice_type == P.I_SLICE
        want = self.ref.plan(*args, intra=intra)
        got = plan if self.lowered is None else \
            self.lowered.plan(*args, intra=intra)
        self._count(p, "plan_mismatch", _diff(got, want),
                    "plan entries differ from the reference's")

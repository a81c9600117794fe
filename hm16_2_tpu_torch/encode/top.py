"""Encoder top level of the port: the reference's encoder with its frame
plans computed by PyTorch and the hand-written CUDA kernels.

`Encoder` and `CtuSearch` subclass the reference's classes
(hm16_2_tpu/encode/top.py), whose host work (CU commit through the native
engine, deblocking, SAO, CABAC, headers, hash SEI) has no JAX in it.  They
override only what reaches a JAX module: the plan submission, the per-frame
`_encode_one` (which builds `CtuSearch` by name and plans at its top; a copy
with those call sites pointed here), the pipelined dispatch of the next
picture's P or B plan, and the fallback search's 35-mode SATD analysis.

Ported: all-intra; low-delay P with HM's GOP-4 table and its low-delay B
flush tail; flat-QP IPPP through `encode_frame`; random access (`gop="ra8"`,
HM's hierarchical-B GOP 8, with the pipelined plans of pictures 3, 6 and 7
of each GOP); `gop_table`s of P and B entries.  Rate control, field coding,
delta_qp_rd, the inter ME fallback (a P or B slice without a plan) and the
host-only search switches raise NotImplementedError; nothing falls back to
another path.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from hm16_2_tpu.bitstream.bitio import (
    BitWriter, count_emulation_prevention, make_nal, write_annexb)
from hm16_2_tpu.bitstream.cabac import CabacEncoder, ContextSet
from hm16_2_tpu.decode.mvpred import MvPredictor, RefCtx
from hm16_2_tpu.decode.picture import PictureState
from hm16_2_tpu.decode.refpics import RefPicture, build_ref_lists
from hm16_2_tpu.decode.top import picture_md5
from hm16_2_tpu.encode import top as _ref
from hm16_2_tpu.encode.ctu_enc import CtuEncoder
from hm16_2_tpu.encode.top import EncoderConfig
from hm16_2_tpu.headers import write as W
from hm16_2_tpu.headers.params import (
    I_SLICE, NAL_IDR_N_LP, NAL_IDR_W_RADL, NAL_TRAIL_R, P_SLICE, is_irap)
from hm16_2_tpu.ops import intra_ref
from hm16_2_tpu_torch.encode import inter_plan, intra_rd
from hm16_2_tpu_torch.ops import analysis


def _unported(cfg) -> list[str]:
    """The options of `cfg` that leave the ported paths."""
    out = []
    if cfg.target_bps:
        out.append("rate control")
    if getattr(cfg, "field_coding", False):
        out.append("field coding")
    if getattr(cfg, "delta_qp_rd", 0):
        out.append("delta_qp_rd")
    return out


class Encoder(_ref.Encoder):
    """HEVC encoder whose frame plans (I, P and B pictures) run on
    `device`."""

    def __init__(self, cfg: EncoderConfig, device: torch.device):
        if not isinstance(device, torch.device):
            raise TypeError(f"device must be a torch.device, got {device!r}")
        unported = _unported(cfg)
        if unported:
            raise NotImplementedError(
                "not ported to the PyTorch port: " + ", ".join(unported))
        super().__init__(cfg)
        self.device = device

    def _submit_plan(self, planes):
        """Enqueue the intra frame plan on the device (AI fast path: fixed
        slice QP, no rate control) so the card plans while the host commits
        the previous frame."""
        from hm16_2_tpu.common.tables import CHROMA_QP_SCALE
        cfg, sps, pps = self.cfg, self.sps, self.pps
        qp = cfg.qp
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        qp_luma = qp + 6 * (sps.bit_depth_luma - 8)
        cqps = []
        for off in (pps.cb_qp_offset, pps.cr_qp_offset):
            base = int(np.clip(qp + off, 0, 57))
            cqps.append(int(CHROMA_QP_SCALE[sps.chroma_format_idc][base])
                        + 6 * (sps.bit_depth_chroma - 8))
        if len(planes) > 1:
            base = int(np.clip(qp + pps.cb_qp_offset, 0, 57))
            cqp = int(CHROMA_QP_SCALE[sps.chroma_format_idc][base])
        else:
            cqp = qp
        cw = 2.0 ** ((qp - cqp) / 3.0)
        return intra_rd.submit_plan(planes, sps, qp_luma, lam, cw, cqps,
                                    self.device)

    def _encode_one(self, planes, poc, sh, qp_factor=None,
                    rc_lam=None, plan_packed=None, lam_mult=1.0,
                    trial=False) -> bytes:
        cfg, sps, pps = self.cfg, self.sps, self.pps
        _st = self.stage_ms

        def _tick(key, t0):
            _st[key] = _st.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        is_idr = sh.nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)
        if is_idr:
            self.dpb.clear()
            self._lt_anchor = poc
        elif sh.rps is not None:
            # DPB marking: the decoder drops pictures absent from the RPS
            # (long-term pictures referenced by this slice survive too)
            keep = {poc + d for d in sh.rps.delta_poc} | \
                set(getattr(sh, "lt_poc", ()) or ())
            for p in [p for p in self.dpb.pics if p not in keep]:
                del self.dpb.pics[p]
        sh.poc = poc
        sh.sps, sh.pps = sps, pps
        sh.deblocking_filter_disabled = pps.deblocking_filter_disabled
        sh.beta_offset_div2 = pps.beta_offset_div2
        sh.tc_offset_div2 = pps.tc_offset_div2

        pic = PictureState(sps, pps)
        pic.poc = poc
        if cfg.transquant_bypass:
            # CUTransquantBypassFlagForce: every CU lossless; the emitter
            # reads pic.tqb for cu_transquant_bypass_flag and the TU coders
            # take the bypass branch
            pic.tqb[:] = 1
        if pps.cu_qp_delta_enabled:
            # whole-frame plan commits bypass decide_ctu's per-CTU QP
            # pre-mark; the emitter and QG reconciliation read pic.qp
            pic.qp[:] = sh.qp
        pic.slices.append(sh)
        # multi-slice: equal CTU runs in tile-scan order (HM SliceMode 1,
        # TEncSlice.cpp:1097 calculateBoundingCtuTsAddrForSlice)
        n_ctus_total = pic.w_ctbs * pic.h_ctbs
        n_slices = max(1, min(getattr(cfg, "slices", 1), n_ctus_total))
        if n_slices > 1:
            assert len(pic.tiles.col_bounds) == 2 and \
                len(pic.tiles.row_bounds) == 2, \
                "multi-slice encode supports single-tile only"
        if n_slices > 1 and pps.entropy_coding_sync:
            # WPP x slices: slice segments start at CTU-row boundaries so
            # every row is a whole substream of exactly one slice
            # (TEncSlice conformance check on WaveFrontSynchro + slices)
            n_slices = min(n_slices, pic.h_ctbs)
        import copy as _copy
        slice_bounds = []
        shs = [sh]
        if n_slices > 1 and pps.entropy_coding_sync:
            rows_per = (pic.h_ctbs + n_slices - 1) // n_slices
            cuts = list(range(0, pic.h_ctbs, rows_per)) + [pic.h_ctbs]
            slice_bounds = [(r0 * pic.w_ctbs, r1 * pic.w_ctbs)
                            for r0, r1 in zip(cuts[:-1], cuts[1:])]
            n_slices = len(slice_bounds)
            for i, (startc, _) in enumerate(slice_bounds):
                if i > 0:
                    shi = _copy.copy(sh)
                    shi.first_slice_in_pic = 0
                    shi.segment_address = startc
                    pic.slices.append(shi)
                    shs.append(shi)
        else:
            per_slice = (n_ctus_total + n_slices - 1) // n_slices
            startc = 0
            for i in range(n_slices):
                if startc >= n_ctus_total:
                    break       # ceil division can leave trailing empties
                endc = min(n_ctus_total, startc + per_slice)
                if i > 0:
                    shi = _copy.copy(sh)
                    shi.first_slice_in_pic = 0
                    shi.segment_address = startc
                    pic.slices.append(shi)
                    shs.append(shi)
                slice_bounds.append((startc, endc))
                startc = endc
        sh.first_slice_in_pic = 1
        sh.segment_address = 0
        # prefill the per-part slice map (commit no longer writes it; the
        # decode-order availability rules read it during both passes)
        dep_slices = bool(getattr(cfg, "dependent_slices", False)) and \
            n_slices > 1 and not pps.entropy_coding_sync
        if dep_slices:
            for shi in shs[1:]:
                shi.dependent_slice_segment = 1
        parts_per = pic.ctb // 4
        for i, (ts0, ts1) in enumerate(slice_bounds):
            # dependent slice segments all belong to ONE slice: in-picture
            # prediction crosses their boundaries, so they share id 0
            sid = 0 if dep_slices else i
            for ts in range(ts0, ts1):
                rs_ = int(pic.tiles.ctu_ts_to_rs[ts])
                cx_, cy_ = rs_ % pic.w_ctbs, rs_ // pic.w_ctbs
                pic.slice_id[cy_ * parts_per:(cy_ + 1) * parts_per,
                             cx_ * parts_per:(cx_ + 1) * parts_per] = sid

        self.last_qp = sh.qp
        search = CtuSearch(pic, sh, planes, rdo=cfg.rdo, qp_factor=qp_factor,
                           sbd=cfg.sbd, rrsp=cfg.rrsp, lam_override=rc_lam,
                           der=cfg.der, rdoq=cfg.rdoq, lam_mult=lam_mult)
        search.device = self.device
        # frame-level batched intra decision on the device; HM16_EXACT_RD=1
        # falls back to the sequential context-exact trial-encode search
        import os
        if sh.slice_type == I_SLICE and cfg.rdo and \
                not os.environ.get("HM16_EXACT_RD"):
            from hm16_2_tpu.common.tables import CHROMA_QP_SCALE
            t0 = time.perf_counter()
            if plan_packed is not None:
                # pipelined path: the plan was enqueued before the previous
                # frame's commit started
                search.plan = intra_rd.fetch_plan(plan_packed, sps.pic_height,
                                                  sps.pic_width)
            else:
                qp_luma = sh.qp + 6 * (sps.bit_depth_luma - 8)
                cqps = []
                for off in (pps.cb_qp_offset, pps.cr_qp_offset):
                    base = int(np.clip(sh.qp + off, 0, 57))
                    cqps.append(
                        int(CHROMA_QP_SCALE[sps.chroma_format_idc][base])
                        + 6 * (sps.bit_depth_chroma - 8))
                search.plan = intra_rd.plan_frame(
                    planes, sps, qp_luma, search.lam,
                    getattr(search, "chroma_weight", 1.0), cqps, self.device)
            _tick("plan", t0)
        if sh.slice_type != I_SLICE:
            ref_lists = build_ref_lists(sh, self.dpb)
            if pps.weighted_pred and sh.slice_type == P_SLICE:
                from hm16_2_tpu.encode.wp_analysis import estimate_wp
                estimate_wp(sh, planes, ref_lists, sps, pps)
            rc = RefCtx(sh, ref_lists)
            search.mvp = MvPredictor(pic, rc, 0)
            search.cenc.mvp = search.mvp
            if plan_packed is not None:
                # pipelined path: the plan was enqueued while the previous
                # picture committed
                t0 = time.perf_counter()
                search.plan = plan_packed()
                _tick("plan", t0)
            if search.plan is None and cfg.rdo:
                for var in ("HM16_NO_INTER_PLAN", "HM16_EXACT_RD"):
                    if os.environ.get(var):
                        raise NotImplementedError(
                            f"{var}: the host-only inter search is not "
                            "ported")
                t0 = time.perf_counter()
                search.plan = inter_plan.plan_frame(
                    planes[0], sps, sh, rc, self._prev_mv8,
                    float(search.lam), float(np.sqrt(search.lam)),
                    self.device)
                _tick("plan", t0)
                if search.plan is None:
                    raise NotImplementedError(
                        "a P or B slice without a plan would take the inter "
                        "ME fallback (inter_me), which is not ported")
        # pass 1: mode decisions + reconstruction (TEncSlice::compressSlice).
        # Planned I-slices commit the whole frame in ONE native call (the
        # C++ engine walks every CTU, border CTUs via implicit splits);
        # anything it can't handle resumes per-CTU on the host.
        n_ctus = pic.w_ctbs * pic.h_ctbs
        aq_off = None
        if cfg.aq:
            from hm16_2_tpu.encode.preanalysis import aq_offsets
            aq_off = aq_offsets(np.asarray(planes[0]), pic.ctb,
                                sps.pic_height, sps.pic_width,
                                cfg.aq_strength)
        # SliceMode 2 (TEncSlice.cpp:526): close a slice when its exact
        # counted VCL bits exceed the byte budget; the overflowing CTU is
        # re-decided as the first CTU of the next slice so every
        # prediction/merge availability matches the final slice map
        byte_mode = (getattr(cfg, "slice_bytes", 0) > 0 and n_slices == 1
                     and not pps.entropy_coding_sync and not cfg.aq
                     and self.rc is None
                     and int(pic.tiles.tile_of_ctu.max()) == 0)
        if byte_mode:
            qp_cl = min(max(sh.qp, 0), 51)
            count_ctx = ContextSet()
            count_ctx.reset(sh.slice_type, qp_cl)
            acc_bits = 0.0
            slice_cuts = [0]
            # the cached native CTU-commit engine is single-slice (and
            # rewrites slice_id); a cut mid-pass must never re-enter it
            search._cctx = False
        t_commit = time.perf_counter()
        start_ts = 0
        if search.plan is not None and aq_off is None and \
                sh.slice_type == I_SLICE and not byte_mode:
            cctx = search._commit_ctx()
            if cctx is not None:
                import ctypes

                from hm16_2_tpu import native
                rc = native.get_dsp().commit_plan_frame(ctypes.byref(cctx))
                start_ts = n_ctus if rc == 0 else rc - 1
        slice_of_ts = np.zeros(n_ctus, dtype=np.int32)
        for i, (ts0, ts1) in enumerate(slice_bounds):
            slice_of_ts[ts0:ts1] = i
        # CTU-level rate control (LCULevelRC, TEncSlice.cpp:765-887):
        # per-CTU target bpp -> model lambda/QP before the search, actual
        # bits fed back after it.  The bit feedback is the context-exact
        # CABAC counter over the committed CTU tree.
        ctu_rc = (self.rc is not None and self.rc.lcu_rc
                  and sh.slice_type != I_SLICE and cfg.rdo
                  and int(pic.tiles.tile_of_ctu.max()) == 0)
        parts_rc = pic.ctb // 4
        for ts in range(start_ts, n_ctus):
            rs = int(pic.tiles.ctu_ts_to_rs[ts])
            cx, cy = rs % pic.w_ctbs, rs // pic.w_ctbs
            search.cenc.slice_idx = int(slice_of_ts[ts])
            if ctu_rc:
                rc_qp, rc_lam = self.rc.ctu_begin(rs)
                search.set_ctu_qp(rc_qp, rc_lam)
                pre_ctx = search.rd_ctx.copy()
            elif aq_off is not None:
                search.set_ctu_qp(sh.qp + int(aq_off[cy, cx]))
            if byte_mode:
                slice_of_ts[ts] = len(slice_cuts) - 1
                search.cenc.slice_idx = int(slice_of_ts[ts])
            search.decide_ctu(cx, cy)
            if byte_mode:
                bits = search._count_cu_bits(
                    cx * parts_per, cy * parts_per, pic.log2_ctb,
                    count_ctx)
                if ts > slice_cuts[-1] and \
                        acc_bits + bits > cfg.slice_bytes * 8:
                    slice_cuts.append(ts)
                    nsl = len(slice_cuts) - 1
                    slice_of_ts[ts:] = nsl
                    # register the new slice segment NOW: the length of
                    # pic.slices gates the single-slice fast availability
                    # paths, which must turn slice-aware from this CTU on
                    shi = _copy.copy(sh)
                    shi.first_slice_in_pic = 0
                    shi.segment_address = ts
                    pic.slices.append(shi)
                    shs.append(shi)
                    for t2 in range(ts, n_ctus):
                        rs2 = int(pic.tiles.ctu_ts_to_rs[t2])
                        cx2, cy2 = rs2 % pic.w_ctbs, rs2 // pic.w_ctbs
                        pic.slice_id[
                            cy2 * parts_per:(cy2 + 1) * parts_per,
                            cx2 * parts_per:(cx2 + 1) * parts_per] = nsl
                    search.cenc.slice_idx = nsl
                    search.decide_ctu(cx, cy)
                    count_ctx = ContextSet()
                    count_ctx.reset(sh.slice_type, qp_cl)
                    acc_bits = search._count_cu_bits(
                        cx * parts_per, cy * parts_per, pic.log2_ctb,
                        count_ctx)
                else:
                    acc_bits += bits
            if ctu_rc:
                bits = search._count_cu_bits(
                    cx * parts_rc, cy * parts_rc, pic.log2_ctb, pre_ctx)
                sl = (slice(cy * parts_rc,
                            min((cy + 1) * parts_rc, pic.h // 4)),
                      slice(cx * parts_rc,
                            min((cx + 1) * parts_rc, pic.w // 4)))
                all_skip = bool(np.all(pic.skip[sl]))
                self.rc.ctu_update(rs, max(int(bits + 0.5), 1),
                                   None if all_skip else rc_qp, rc_lam)
        if byte_mode and len(slice_cuts) > 1:
            slice_bounds = [(a, b) for a, b in
                            zip(slice_cuts, slice_cuts[1:] + [n_ctus])]
            n_slices = len(slice_bounds)
        if aq_off is not None or ctu_rc:
            self._reconcile_group_qps(pic, sh)
        _tick("commit", t_commit)
        t_filt = time.perf_counter()

        # deblock, then SAO parameter estimation on the deblocked recon.
        # PCM/lossless samples must survive the in-loop filters exactly as
        # in the decoder (xPCMRestoration) — snapshot now, restore after SAO
        from hm16_2_tpu.decode.loopfilter import (
            restore_lossless_samples, snapshot_lossless_samples)
        lossless_saved = snapshot_lossless_samples(pic)
        use_sao = bool(sps.sao_enabled)
        if not sh.deblocking_filter_disabled:
            from hm16_2_tpu.ops.deblock_ref import deblock_picture
            deblock_picture(pic)
        if use_sao:
            from hm16_2_tpu.encode.sao_enc import estimate_sao
            lam = getattr(search, "lam", None)
            if lam is None:
                lam = 0.68 * 2.0 ** ((sh.qp - 12) / 3.0)
            # picture-level early termination (SAO_ENCODING_RATE,
            # TEncSampleAdaptiveOffset::decidePicParams): when the
            # previous picture of this temporal level enabled SAO on
            # fewer than 75% (luma) / 50% (chroma) of its CTUs, skip the
            # component for this picture entirely — the per-CTU syntax
            # of a mostly-off SAO costs real bits on near-skip B frames
            tid = int(getattr(sh, "temporal_id", 0) or 0)
            hist = getattr(self, "_sao_rate", None)
            if hist is None:
                hist = self._sao_rate = {}
            prev_l, prev_c = hist.get(tid, (1.0, 1.0))
            en_l = prev_l >= 0.75 or sh.slice_type == I_SLICE
            en_c = (prev_c >= 0.50 or sh.slice_type == I_SLICE) and \
                pic.num_comps > 1
            for s_ in pic.slices:
                s_.sao_luma = 1 if en_l else 0
                s_.sao_chroma = 1 if en_c else 0
            if en_l or en_c:
                estimate_sao(pic, search.orig, lam, luma=en_l,
                             chroma=en_c)
                n_ctu = pic.w_ctbs * pic.h_ctbs
                on_l = float((pic.sao_mode[:, 0] != 0).sum()) / n_ctu
                on_c = float((pic.sao_mode[:, 1] != 0).sum()) / n_ctu \
                    if pic.num_comps > 1 else 0.0
                # slice-level all-off: signalling "off" per CTU is never
                # cheaper than clearing the slice flag
                if en_l and on_l == 0.0:
                    for s_ in pic.slices:
                        s_.sao_luma = 0
                if en_c and on_c == 0.0:
                    for s_ in pic.slices:
                        s_.sao_chroma = 0
                hist[tid] = (on_l if en_l else prev_l,
                             on_c if en_c else prev_c)
        _tick("filters", t_filt)
        t_emit = time.perf_counter()

        if n_slices == 1:
            # pass 2: final bitstream (TEncSlice::encodeSlice) — one CABAC
            # substream per tile and, with WPP, per CTU row within the tile;
            # contexts reset at tile starts and sync from the saved state after
            # the 2nd CTU of the row above for WPP (TEncSlice.cpp:910-1183)
            enc = CtuEncoder(pic, sh, 0)
            wpp = bool(pps.entropy_coding_sync)
            tiles = pic.tiles
            ctx = ContextSet()
            ctx.reset(sh.slice_type, sh.qp)
            ce_ctx = self._build_ctu_enc_ctx(pic, sh, enc)
            total_bins = 0
            datas = []
            sbw = cab = None
            wpp_saved = None
            prev_tile = None

            def _syn_avail(nx, ny, cx, cy):
                if nx < 0 or ny < 0:
                    return False
                return tiles.tile_of_ctu[cy, cx] == tiles.tile_of_ctu[ny, nx]

            for ts in range(n_ctus):
                rs = int(tiles.ctu_ts_to_rs[ts])
                cx, cy = rs % pic.w_ctbs, rs // pic.w_ctbs
                tile_id = int(tiles.tile_of_ctu[cy, cx])
                tile_x0 = max(b for b in tiles.col_bounds if b <= cx)
                new_tile = prev_tile is not None and tile_id != prev_tile
                row_start = wpp and cx == tile_x0 and prev_tile is not None \
                    and not new_tile
                if cab is None or new_tile or row_start:
                    if cab is not None:
                        cab.encode_bin_trm(1)        # end_of_subset_one_bit
                        cab.finish()
                        total_bins += cab.bins
                        sbw.u(1, 1)
                        sbw.align_zero()
                        datas.append(sbw.get_bytes())
                        if new_tile:
                            ctx.reset(sh.slice_type, sh.qp)
                            wpp_saved = None
                        elif wpp_saved is not None:
                            ctx.load(wpp_saved)
                        else:
                            ctx.reset(sh.slice_type, sh.qp)
                    sbw = BitWriter()
                    cab = CabacEncoder(sbw, ctx)
                    enc.attach(cab)
                prev_tile = tile_id
                if use_sao and (enc.sh.sao_luma or enc.sh.sao_chroma):
                    enc.enc_sao(rs, _syn_avail(cx - 1, cy, cx, cy),
                                _syn_avail(cx, cy - 1, cx, cy))
                if ce_ctx is None or not self._native_encode_ctu(
                        enc, cab, ce_ctx, cx, cy, ts == n_ctus - 1):
                    enc.encode_ctu(cx, cy, last_in_slice=(ts == n_ctus - 1))
                if wpp and cx == tile_x0 + 1:
                    wpp_saved = ctx.copy()
            cab.finish()
            total_bins += cab.bins
            sbw.u(1, 1)              # stop bit after final terminate
            sbw.align_zero()
            datas.append(sbw.get_bytes())

            # entry points count escaped bytes; each substream starts and ends
            # byte-aligned on a non-zero byte so per-substream EPB counts are
            # exact (TEncSlice.cpp:1067, countStartCodeEmulations)
            sh.entry_point_offsets = [len(d) + count_emulation_prevention(d)
                                      for d in datas[:-1]]
            bw = BitWriter()
            W.write_slice_header(bw, sh, sps, pps)
            hdr_bits = len(bw.get_bytes()) * 8
            slice_nals = [make_nal(sh.nal_type,
                                   bw.get_bytes() + b"".join(datas),
                                   temporal_id=sh.temporal_id)]

        else:
            slice_nals, total_bins, hdr_bits = self._emit_multi_slices(
                pic, shs, slice_bounds, use_sao)
        _tick("emit", t_emit)
        t_fin = time.perf_counter()

        # cabac_zero_words stuffing (spec 7.4.3.10; TEncGOP.cpp:1622-1660):
        # BinCountsInNalUnits must not exceed (32/3)*NumBytesInVclNalUnits
        # + RawMinCuBits*PicSizeInMinCbsY/32
        log2swsh = {0: 0, 1: 2, 2: 1, 3: 0}[sps.chroma_format_idc]
        pad_w = (sps.pic_width + 3) // 4 * 4
        pad_h = (sps.pic_height + 3) // 4 * 4
        bdc = sps.bit_depth_chroma if pic.num_comps > 1 else 0
        raw_bits = pad_w * pad_h * (sps.bit_depth_luma
                                    + 2 * (bdc >> log2swsh))
        vcl_bytes = sum(len(nal) for nal in slice_nals)
        threshold = (32 // 3) * vcl_bytes + raw_bits // 32
        if total_bins >= threshold:
            target = ((total_bins - raw_bits // 32) * 3 + 31) // 32
            add = target - vcl_bytes
            if add > 0:
                n_words = (add + 2) // 3
                slice_nals[-1] = slice_nals[-1] + b"\x00\x00\x03" * n_words

        if use_sao:
            from hm16_2_tpu.ops.sao_ref import sao_picture
            sao_picture(pic)
        restore_lossless_samples(pic, lossless_saved)

        bds = [sps.bit_depth_luma] + [sps.bit_depth_chroma] * (pic.num_comps - 1)
        recon = [pic.crop_output(c) for c in range(pic.num_comps)]
        from hm16_2_tpu.decode.top import picture_checksum, picture_crc
        hash_fn = (picture_md5, picture_crc,
                   picture_checksum)[cfg.hash_type]
        digests = hash_fn(recon, bds)
        sei_nal = W.write_hash_sei(digests, cfg.hash_type)

        nals = []
        if self.frames_coded == 0:
            nals += [W.write_vps(self.vps), W.write_sps(sps), W.write_pps(pps)]
            if cfg.sei_timing:
                nals.append(W.write_active_parameter_sets_sei(0, sps.sps_id))
        irap = is_irap(sh.nal_type)
        if cfg.sei_buffering_period and (irap or self.frames_coded == 0):
            # buffering period at every IRAP (TEncGOP: bufferingPeriodSEI
            # on RAP access units); restarts the cpb removal-delay clock
            nals.append(W.write_buffering_period_sei(sps, sps.sps_id))
            self._cpb_anchor = self.frames_coded
        if (cfg.sei_recovery_point and irap) or \
                getattr(sh, "recovery_i", False):
            nals.append(W.write_recovery_point_sei(0, 1, 0))
        if irap or self.frames_coded == 0:
            # persistence-scoped display SEIs accompany each IRAP
            # (SEIwrite.cpp; headers/sei.py writers)
            from hm16_2_tpu.headers import sei as SEI
            if cfg.sei_frame_packing >= 0:
                nals.append(SEI.write_frame_packing(cfg.sei_frame_packing))
            if cfg.sei_display_orientation >= 0:
                nals.append(SEI.write_display_orientation(
                    cfg.sei_display_orientation))
            if cfg.sei_mastering_display:
                nals.append(SEI.write_mastering_display())
            if cfg.sei_tone_mapping:
                nals.append(SEI.write_tone_mapping(
                    coded_bit_depth=sps.bit_depth_luma,
                    target_bit_depth=8,
                    max_value=(1 << sps.bit_depth_luma) - 1))
        if cfg.sei_region_refresh and irap:
            from hm16_2_tpu.headers import sei as SEI
            nals.append(SEI.write_region_refresh(1))
        if cfg.sei_temporal_level0:
            from hm16_2_tpu.headers import sei as SEI
            if irap:
                self._irap_id = getattr(self, "_irap_id", -1) + 1
            elif sh.temporal_id == 0:
                self._tl0_idx = getattr(self, "_tl0_idx", 0) + 1
            nals.append(SEI.write_temporal_level0_index(
                getattr(self, "_tl0_idx", 0), getattr(self, "_irap_id", 0)))
        if cfg.sei_time_code:
            from hm16_2_tpu.headers import sei as SEI
            fr = max(int(cfg.frame_rate or 30), 1)
            t = poc // fr
            nals.append(SEI.write_time_code(
                poc % fr, t % 60, (t // 60) % 60, (t // 3600) % 24))
        if cfg.sei_timing:
            if sps.vui_hrd_present:
                anchor = getattr(self, "_cpb_anchor", 0)
                nals.append(W.write_pic_timing_sei(
                    self._cur_pic_struct(poc), sps,
                    au_cpb_removal_delay=self.frames_coded - anchor + 1,
                    pic_dpb_output_delay=int(sps.num_reorder_pics[0]
                                             + poc - self.frames_coded)))
            else:
                nals.append(W.write_pic_timing_sei(
                    self._cur_pic_struct(poc)))
        nals += slice_nals + [sei_nal]
        _tick("finish", t_fin)
        if trial:
            # precompress trial: report cost, leave encoder state alone
            sse = 0.0
            for c in range(pic.num_comps):
                sx, sy = pic.comp_shift[c]
                o = search.orig[c][: sps.pic_height >> sy,
                                   : sps.pic_width >> sx]
                r = pic.rec[c][: sps.pic_height >> sy,
                               : sps.pic_width >> sx]
                d = (np.asarray(o) - r).astype(np.float64).ravel()
                wgt = 1.0 if c == 0 else getattr(search, "chroma_weight",
                                                 1.0)
                sse += wgt * float(np.dot(d, d))
            au = write_annexb(nals)
            self._trial_cost = (sse, len(au) * 8.0)
            return au
        self.frames_coded += 1
        self.last_recon = recon
        # retain reference picture (coded-size planes, motion for deblock/BS)
        ref_planes = []
        for c in range(pic.num_comps):
            sx, sy = pic.comp_shift[c]
            ref_planes.append(pic.rec[c][: sps.pic_height >> sy,
                                         : sps.pic_width >> sx].copy())
        # RRSP depth history: keep the colocated reference's depth plane
        # ("grandfather" view for pictures that will reference this one)
        col_depth = None
        if not is_idr and getattr(search, "mvp", None) is not None and \
                search.mvp.rc.ref_lists[0]:
            col_depth = search.mvp.rc.ref_lists[0][0].depth
        self.dpb.add(RefPicture(poc=poc, rec=ref_planes, mv=pic.mv.copy(),
                                ref_idx=pic.ref_idx.copy(),
                                ref_poc=pic.ref_poc.copy(),
                                pred_mode=pic.pred_mode.copy(),
                                depth=pic.depth.copy(),
                                col_depth=col_depth,
                                is_intra=sh.slice_type == I_SLICE))
        # motion-field prior for the next frame's device ME plan,
        # POC-NORMALIZED (q-pel x16 per POC unit): the plan scales it by
        # each target reference's signed POC distance, so RA hierarchy
        # levels with different distances/directions all get a correctly
        # signed and scaled prior (like TMVP's dist_scale_factor)
        h8, w8 = sps.pic_height // 8, sps.pic_width // 8
        mvq = pic.mv[0][: h8 * 2: 2, : w8 * 2: 2]          # (h8, w8, 2) q-pel
        rpoc = pic.ref_poc[0][: h8 * 2: 2, : w8 * 2: 2]
        d = poc - rpoc.astype(np.int64)
        valid = (rpoc > -(10 ** 8)) & (d != 0)
        dsafe = np.where(valid, d, 1).astype(np.float64)
        self._prev_mv8 = np.where(
            valid[:, :, None],
            np.rint(np.stack([mvq[:, :, 1], mvq[:, :, 0]], axis=-1)
                    * 16.0 / dsafe[:, :, None]).astype(np.int64),
            0).astype(np.int32)

        au = write_annexb(nals)
        self.bits_per_frame.append(len(au) * 8)
        if self.rc is not None:
            # feed back only VCL NAL bits (TEncRateCtrl uses the slice
            # bits; VPS/SPS/PPS/SEI would inflate the first frames) and
            # the measured slice-header bits for the xEstPicHeaderBits
            # proxy
            vcl_bits = sum(len(n) for n in slice_nals) * 8
            self.rc.update_after_picture(vcl_bits, hdr_bits)
        return au

    def _predispatch_ra(self, planes, poc, slot, nal_type=NAL_TRAIL_R):
        """Enqueue the next picture's P or B plan while the current picture
        commits, when every reference of the next picture is already
        committed (the reference's conditions, top.py:915-950; in RA GOP 8
        coding order, pictures 3, 6 and 7).  The plan prices with the
        motion prior of the picture before the current one.  Returns
        (sh, plan_fetch) or None; errors propagate."""
        cfg = self.cfg
        if (self.rc is not None or not cfg.rdo or not self.gop_table
                or getattr(cfg, "delta_qp_rd", 0)
                or os.environ.get("HM16_NO_INTER_PLAN")
                or os.environ.get("HM16_EXACT_RD")
                or os.environ.get("HM16_NO_PLAN_PIPELINE")):
            return None
        sh = self._ra_slice_header(poc, slot, nal_type)
        sh.poc = poc             # the plan prices by POC distances
        if self.pps.weighted_pred and sh.slice_type == P_SLICE:
            return None          # WP estimation mutates sh per picture
        rc = RefCtx(sh, build_ref_lists(sh, self.dpb))
        alpha, mult = self._lambda_args(sh, slot)
        lam = alpha * 2.0 ** ((sh.qp - 12) / 3.0) * mult
        fetch = inter_plan.plan_frame(
            planes[0], self.sps, sh, rc, self._prev_mv8, float(lam),
            float(np.sqrt(lam)), self.device, fetch=False)
        if fetch is None:
            return None
        return sh, fetch


class CtuSearch(_ref.CtuSearch):
    """The reference's per-CTU search with its device analysis on the
    port.  `device` is set by the encoder that builds the search."""

    device: torch.device

    def _premodes(self, log2):
        """Frame-level 35-mode SATD argmin for all aligned blocks of one
        size, on original-pixel references (K1 + K2 in SATD-only mode)."""
        cache = getattr(self, "_premode_cache", None)
        if cache is None:
            cache = self._premode_cache = {}
        if log2 in cache:
            return cache[log2]
        s = 1 << log2
        yo = self.orig[0]
        hh, ww = yo.shape
        nby, nbx = hh // s, ww // s
        if nby == 0 or nbx == 0:
            cache[log2] = np.zeros((0, 0), dtype=np.int32)
            return cache[log2]
        bd = self.bit_depth[0]
        plane = torch.from_numpy(np.ascontiguousarray(yo, dtype=np.int32)) \
            .to(self.device)
        bufs, blocks = intra_rd.ref_buffers(
            plane, s, bd, bool(self.sps.strong_intra_smoothing), hh, ww)
        best = intra_rd.premodes(bufs, blocks, s, bd)
        cache[log2] = best.cpu().numpy().reshape(nby, nbx)
        return cache[log2]

    def _search_luma_mode_recon(self, px, py, log2) -> int:
        """Per-CU sweep with reconstructed references (fallback)."""
        size = 1 << log2
        x0, y0 = px * 4, py * 4
        orig = self.orig[0][y0:y0 + size, x0:x0 + size].astype(np.int64)
        top, left = self._refs_for(px, py, log2, 0)
        top_f, left_f = intra_ref.filter_reference_samples(
            top, left, size, self.bit_depth[0],
            bool(self.sps.strong_intra_smoothing))
        buf_u = np.concatenate([left[1:][::-1], top]).astype(np.int64)
        buf_f = np.concatenate([left_f[1:][::-1], top_f]).astype(np.int64)
        preds = analysis.predict_all_modes_np(buf_u, buf_f, size, True,
                                              self.bit_depth[0])
        costs = analysis.satd_all_np(orig[None] - preds)
        return int(np.argmin(costs))

"""CTU syntax encoding: emits the CABAC bin stream for decided CTUs.

Exact dual of hm16_2_tpu_torch.decode.ctu_dec (reference TEncSbac.cpp:423-1716,
TEncCu::xEncodeCU :1185, TEncEntropy::xEncodeTransform).  Subclasses the
decoder's SliceDecoder to reuse every context-derivation helper — encoder
and decoder share one source of truth for context indices, guaranteeing
the bin sequence the decoder will parse.

The picture arrays (depth / modes / cbf / coeff planes) must already be
filled by the search before encode_ctu is called.
"""

from __future__ import annotations

import numpy as np

from hm16_2_tpu_torch.bitstream.cabac import CabacCounter, CabacEncoder
from hm16_2_tpu_torch.common.tables import (
    GROUP_IDX, MIN_IN_GROUP, SCAN_VER, get_scan)
from hm16_2_tpu_torch.decode.ctu_dec import (
    C1FLAG_NUMBER, CBF_CTX_START, COEF_REMAIN_BIN_REDUCTION, CTX_SET_START,
    SBH_THRESHOLD, SIG_CTX_CHANNEL_OFFSET, SIG_CTX_SET_START,
    NON_DIAG_8x8_CTX_OFFSET, SliceDecoder)
from hm16_2_tpu_torch.decode.picture import MODE_INTRA, SIZE_2Nx2N, SIZE_NxN
from hm16_2_tpu_torch.headers.params import I_SLICE
from hm16_2_tpu_torch.ops.intra_ref import DC_IDX, DM_CHROMA_IDX, HOR_IDX, PLANAR_IDX, VER_IDX


class CtuEncoder(SliceDecoder):
    """Syntax emitter. self.enc is the CabacEncoder; self.ctx shared."""

    # dQP group state defaults (encode_ctu resets per CTU; the RD bit
    # counter may enter _enc_cu at sub-CTU depths directly)
    dqp_enabled = False
    cur_dqp_coded = True

    def attach(self, cabac_enc: CabacEncoder):
        self.enc = cabac_enc
        self.ctx = cabac_enc.ctx

    # ------------------------------------------------------------------

    def enc_sao(self, ctu_rs: int, left_avail: bool, above_avail: bool):
        """SAO parameter syntax, dual of parse_sao (TEncSbac.cpp:1530-1716)."""
        pic, e, c = self.pic, self.enc, self.ctx
        sao_enabled = [self.sh.sao_luma, self.sh.sao_chroma,
                       self.sh.sao_chroma]
        merge = int(getattr(pic, "sao_merge", np.zeros(1))[ctu_rs]) \
            if hasattr(pic, "sao_merge") else 0
        if left_avail:
            e.encode_bin(1 if merge == 1 else 0, c.idx("sao_merge"))
        if above_avail and merge != 1:
            e.encode_bin(1 if merge == 2 else 0, c.idx("sao_merge"))
        if merge:
            return
        for comp in range(pic.num_comps):
            if not sao_enabled[comp]:
                continue
            mode = int(pic.sao_mode[ctu_rs, comp])
            t = int(pic.sao_type[ctu_rs, comp])
            if comp <= 1:
                if mode == 0:
                    e.encode_bin(0, c.idx("sao_type"))
                    continue
                e.encode_bin(1, c.idx("sao_type"))
                e.encode_bin_ep(0 if t == 4 else 1)
            elif mode == 0:
                continue
            bd = self.bit_depth[comp]
            max_offset = (1 << (min(bd, 10) - 5)) - 1
            offs4 = [int(v) for v in pic.sao_offsets[ctu_rs, comp]]
            if t == 4:                 # BO: magnitudes, then signs, then band
                for o in offs4:
                    self._enc_sao_max_uvlc(abs(o), max_offset)
                for o in offs4:
                    if o:
                        e.encode_bin_ep(1 if o < 0 else 0)
                e.encode_bins_ep(int(pic.sao_band[ctu_rs, comp]), 5)
            else:                      # EO: cat 1/2 positive, 3/4 negated
                for m in (offs4[0], offs4[1], -offs4[2], -offs4[3]):
                    self._enc_sao_max_uvlc(m, max_offset)
                if comp <= 1:
                    e.encode_bins_ep(t, 2)

    def _enc_sao_max_uvlc(self, v, max_symbol):
        e = self.enc
        if max_symbol == 0:
            return
        e.encode_bin_ep(1 if v > 0 else 0)
        if v > 0:
            for _ in range(v - 1):
                e.encode_bin_ep(1)
            if v < max_symbol:
                e.encode_bin_ep(0)

    def encode_ctu(self, ctu_x: int, ctu_y: int, last_in_slice: bool):
        pic = self.pic
        parts = pic.ctb // 4
        px, py = ctu_x * parts, ctu_y * parts
        self.dqp_enabled = False
        self._enc_cu(px, py, pic.log2_ctb, 0)
        self.enc.encode_bin_trm(1 if last_in_slice else 0)

    def _enc_cu(self, px, py, log2, depth):
        pic, e, c = self.pic, self.enc, self.ctx
        sps, pps = self.sps, self.pps
        boundary = not self._cu_inside_pic(px, py, log2)
        split = int(pic.depth[py, px]) > depth
        if not boundary:
            if log2 > sps.log2_min_cb:
                e.encode_bin(1 if split else 0,
                             c.idx("split_flag", self._ctx_split(px, py, depth)))
            else:
                split = False
        if pps.cu_qp_delta_enabled and \
                log2 == sps.log2_ctb - pps.diff_cu_qp_delta_depth:
            self.dqp_enabled = True
            self.qp_for_pred = self.last_coded_qp
            self.cur_dqp_coded = False
        if split or boundary:
            half = 1 << (log2 - 3)
            for sub in range(4):
                sx = px + (sub & 1) * half
                sy = py + (sub >> 1) * half
                if sx * 4 < pic.w and sy * 4 < pic.h:
                    self._enc_cu(sx, sy, log2 - 1, depth + 1)
            return
        if pps.cu_qp_delta_enabled and \
                log2 >= sps.log2_ctb - pps.diff_cu_qp_delta_depth:
            self.dqp_enabled = True
            self.qp_for_pred = self.last_coded_qp
            self.cur_dqp_coded = False

        if pps.transquant_bypass_enabled:
            e.encode_bin(int(pic.tqb[py, px]), c.idx("cu_transquant_bypass"))
        if self.sh.slice_type != I_SLICE:
            skip = int(pic.skip[py, px])
            e.encode_bin(skip, c.idx("skip_flag", self._ctx_skip(px, py)))
            if skip:
                self._enc_merge_index(int(pic.mvp_idx[0, py, px]))
                return
            is_intra = pic.pred_mode[py, px] == 1
            e.encode_bin(1 if is_intra else 0, c.idx("pred_mode"))
            if not is_intra:
                self._enc_inter_cu(px, py, log2)
                return
        # pred mode implicit intra on I slices
        part_size = int(pic.part_size[py, px])
        if log2 == sps.log2_min_cb:
            e.encode_bin(1 if part_size == SIZE_2Nx2N else 0, c.idx("part_size"))
        if sps.pcm_enabled and part_size == SIZE_2Nx2N and \
                sps.log2_min_pcm_cb <= log2 <= sps.log2_max_pcm_cb:
            ipcm = int(pic.ipcm[py, px])
            e.encode_bin_trm(ipcm)
            if ipcm:
                self._emit_pcm_samples(px, py, log2)
                return        # a PCM CU codes no prediction/transform tree
        self._enc_intra_dirs(px, py, log2, part_size)
        self._enc_tu_tree_root(px, py, log2, part_size)

    def _emit_pcm_samples(self, px, py, log2):
        """pcm_sample emission, dual of _parse_pcm (TEncSbac::codeIPCMInfo
        TEncSbac.cpp:1025, TEncBinCABAC::encodePCMAlignBits): flush +
        byte-align the arithmetic engine, write the raw samples, restart.
        The committed reconstruction already holds sample << (bd - pbd)."""
        e, sps, pic = self.enc, self.sps, self.pic
        size = 1 << log2
        x0, y0 = px * 4, py * 4
        bds = [sps.bit_depth_luma, sps.bit_depth_chroma,
               sps.bit_depth_chroma]
        pcm_bds = [sps.pcm_bit_depth_luma, sps.pcm_bit_depth_chroma,
                   sps.pcm_bit_depth_chroma]
        if not hasattr(e, "bw"):      # RD counting pass: raw bits only
            total = sum(((size >> pic.comp_shift[c][0])
                         * (size >> pic.comp_shift[c][1])) * pcm_bds[c]
                        for c in range(pic.num_comps))
            e.encode_bins_ep(0, total)
            return
        e.finish()                    # pcm alignment (stop bit + zeros)
        e.bw.u(1, 1)
        e.bw.align_zero()
        for comp in range(pic.num_comps):
            sx, sy = pic.comp_shift[comp]
            w, h = size >> sx, size >> sy
            cx0, cy0 = x0 >> sx, y0 >> sy
            pbd, bd = pcm_bds[comp], bds[comp]
            block = pic.rec[comp][cy0:cy0 + h, cx0:cx0 + w] >> (bd - pbd)
            for row in np.asarray(block):
                for v in row:
                    e.bw.u(int(v), pbd)
        e.start()                     # TEncBinCABAC::resetBac

    # ------------------------------------------------------------------
    # inter CU syntax (2Nx2N only in the round-1 encoder)
    # ------------------------------------------------------------------

    def _enc_merge_index(self, merge_idx):
        e, c = self.enc, self.ctx
        max_cand = self.sh.max_num_merge_cand
        if max_cand <= 1:
            return
        for i in range(min(merge_idx + 1, max_cand - 1)):
            b = 1 if i < merge_idx else 0
            if i == 0:
                e.encode_bin(b, c.idx("merge_idx"))
            else:
                e.encode_bin_ep(b)

    def _enc_inter_part_size(self, mode, log2):
        """Dual of _parse_inter_part_size incl. the AMP suffix (9.3.3.6:
        ctx bin 3 = symmetric flag, then one bypass bin picking the
        asymmetric variant)."""
        e, c, sps = self.enc, self.ctx, self.sps
        max_bits = 2
        if log2 == sps.log2_min_cb and log2 > 3:
            max_bits = 3
        base = mode if mode <= 3 else (1 if mode in (4, 5) else 2)
        for ui in range(min(base + 1, max_bits)):
            e.encode_bin(1 if ui == base else 0, c.idx("part_size", ui))
        amp = sps.amp_enabled and \
            (sps.log2_ctb - log2) < (sps.log2_ctb - sps.log2_min_cb)
        if amp and base in (1, 2):
            if mode <= 3:
                e.encode_bin(1, c.idx("part_size", 3))   # symmetric
            else:
                e.encode_bin(0, c.idx("part_size", 3))
                e.encode_bin_ep(1 if mode in (5, 7) else 0)

    def _enc_inter_cu(self, px, py, log2):
        pic, e, c = self.pic, self.enc, self.ctx
        sh = self.sh
        part_size = int(pic.part_size[py, px])
        self._enc_inter_part_size(part_size, log2)
        rects = self.pu_rects(px, py, log2, part_size)
        for pu_idx, (x, y, w, h) in enumerate(rects):
            ppx, ppy = x // 4, y // 4
            merged = int(pic.merge_flag[ppy, ppx])
            e.encode_bin(merged, c.idx("merge_flag"))
            if merged:
                self._enc_merge_index(int(pic.mvp_idx[0, ppy, ppx]))
                continue
            inter_dir = int(pic.inter_dir[ppy, ppx])
            if sh.slice_type == 0:         # B: code inter_pred_idc
                ctx_inc = int(pic.depth[py, px])
                if part_size == SIZE_2Nx2N or (1 << log2) != 8:
                    e.encode_bin(1 if inter_dir == 3 else 0,
                                 c.idx("inter_dir", ctx_inc))
                if inter_dir != 3:
                    e.encode_bin(1 if inter_dir == 2 else 0,
                                 c.idx("inter_dir", 4))
            for lx in range(2 if sh.slice_type == 0 else 1):
                if sh.num_ref_idx[lx] <= 0:
                    continue
                if not ((inter_dir >> lx) & 1):
                    continue
                self._enc_ref_idx(lx, int(pic.ref_idx[lx, ppy, ppx]))
                if not (sh.mvd_l1_zero and lx == 1 and inter_dir == 3):
                    self._enc_mvd((int(pic.mvd[lx, ppy, ppx, 0]),
                                   int(pic.mvd[lx, ppy, ppx, 1])))
                mvp_idx = int(pic.mvp_idx[lx, ppy, ppx])
                e.encode_bin(mvp_idx, c.idx("mvp_idx"))
        # root cbf
        merged0 = int(pic.merge_flag[py, px])
        cbfs = [self._cbf_at(comp, px, py, 0) for comp in range(pic.num_comps)]
        root = 1 if any(cbfs) else 0
        if not (part_size == SIZE_2Nx2N and merged0):
            e.encode_bin(root, c.idx("qt_root_cbf"))
        if root:
            cu = type("CU", (), {})()
            cu.px, cu.py, cu.log2 = px, py, log2
            cu.pred_mode = 0
            cu.part_size = part_size
            cu.qp = int(self.pic.qp[py, px])
            cu.tqb = int(self.pic.tqb[py, px])
            self.cu = cu
            self._enc_tu_tree(cu, px, py, log2, 0)

    def _enc_ref_idx(self, lx, ref):
        e, c = self.enc, self.ctx
        num_ref = self.sh.num_ref_idx[lx]
        if num_ref <= 1:
            return
        e.encode_bin(1 if ref > 0 else 0, c.idx("ref_pic"))
        if ref > 0:
            # (ref-1) ones then a zero, truncated at num_ref-2 bins
            for ui in range(num_ref - 2):
                b = 1 if ui < ref - 1 else 0
                if ui == 0:
                    e.encode_bin(b, c.idx("ref_pic", 1))
                else:
                    e.encode_bin_ep(b)
                if not b:
                    break

    def _enc_mvd(self, mvd):
        e, c = self.enc, self.ctx
        hor, ver = mvd
        ah, av = abs(hor), abs(ver)
        e.encode_bin(1 if ah > 0 else 0, c.idx("mvd"))
        e.encode_bin(1 if av > 0 else 0, c.idx("mvd"))
        if ah > 0:
            e.encode_bin(1 if ah > 1 else 0, c.idx("mvd", 1))
        if av > 0:
            e.encode_bin(1 if av > 1 else 0, c.idx("mvd", 1))
        if ah > 0:
            if ah > 1:
                self._enc_ep_exgolomb(ah - 2, 1)
            e.encode_bin_ep(1 if hor < 0 else 0)
        if av > 0:
            if av > 1:
                self._enc_ep_exgolomb(av - 2, 1)
            e.encode_bin_ep(1 if ver < 0 else 0)

    def _enc_ep_exgolomb(self, symbol, count):
        """xWriteEpExGolomb dual."""
        e = self.enc
        while symbol >= (1 << count):
            e.encode_bin_ep(1)
            symbol -= 1 << count
            count += 1
        e.encode_bin_ep(0)
        if count:
            e.encode_bins_ep(symbol, count)

    def _enc_intra_dirs(self, px, py, log2, part_size):
        pic, e, c = self.pic, self.enc, self.ctx
        n_parts = 4 if part_size == SIZE_NxN else 1
        half = 1 << (log2 - 3)
        offs = [(0, 0)] if n_parts == 1 else [(0, 0), (half, 0), (0, half), (half, half)]
        modes = [int(pic.intra_luma[py + oy, px + ox]) for ox, oy in offs]
        # two passes like the decoder: first all mpm flags, then idx/rem
        preds_list = []
        flags = []
        for j, (ox, oy) in enumerate(offs):
            preds = self._intra_mpm(px + ox, py + oy)
            preds_list.append(preds)
            flags.append(modes[j] in preds)
            e.encode_bin(1 if flags[j] else 0, c.idx("intra_pred_mode"))
            # note: decoder's MPM uses neighbor state before this PU's mode is
            # marked; mark progressively in the second pass below
        for j, (ox, oy) in enumerate(offs):
            preds = preds_list[j]
            mode = modes[j]
            if flags[j]:
                idx = preds.index(mode)
                if idx == 0:
                    e.encode_bin_ep(0)
                else:
                    e.encode_bin_ep(1)
                    e.encode_bin_ep(idx - 1)
            else:
                rem = mode
                for p in sorted(preds, reverse=True):
                    if rem > p:
                        rem -= 1
                e.encode_bins_ep(rem, 5)

        # chroma: one mode per CU, except 4:4:4 intra NxN which carries
        # one per PU (mirrors _parse_intra_dirs)
        n_chroma = 4 if (n_parts == 4 and
                         self.sps.chroma_format_idc == 3) else 1
        for j in range(n_chroma):
            ox, oy = offs[j]
            chroma_mode = int(pic.intra_chroma[py + oy, px + ox])
            if chroma_mode == DM_CHROMA_IDX:
                e.encode_bin(0, c.idx("chroma_pred_mode"))
            else:
                e.encode_bin(1, c.idx("chroma_pred_mode"))
                allowed = [PLANAR_IDX, VER_IDX, HOR_IDX, DC_IDX,
                           DM_CHROMA_IDX]
                luma0 = modes[j]
                for i in range(4):
                    if luma0 == allowed[i]:
                        allowed[i] = 34
                        break
                e.encode_bins_ep(allowed.index(chroma_mode), 2)

    # ------------------------------------------------------------------
    # MPM parity note: the decoder derives MPM from picture arrays that, for
    # PUs inside the same CU, are already filled when it parses PU j>0 (it
    # writes modes immediately).  Our pic arrays are fully filled, and the
    # only MPM neighbors (left/above of each PU's corner) are always earlier
    # in coding order, so states agree.
    # ------------------------------------------------------------------

    def _enc_dqp(self, cu):
        """cu_qp_delta_abs/sign (dual of _parse_dqp; TEncSbac codeDeltaQP:
        unary-max 5 + EG0 remainder + sign)."""
        e, c = self.enc, self.ctx
        dqp = int(cu.qp) - self.qp_for_pred
        v = abs(dqp)
        if v == 0:
            e.encode_bin(0, c.idx("dqp", 0))
        else:
            e.encode_bin(1, c.idx("dqp", 0))
            for i in range(1, 5):
                if i < v:
                    e.encode_bin(1, c.idx("dqp", 1))
                else:
                    e.encode_bin(0, c.idx("dqp", 1))
                    break
            if v >= 5:
                self._enc_ep_exgolomb(v - 5, 0)
            e.encode_bin_ep(1 if dqp < 0 else 0)
        self.last_coded_qp = int(cu.qp)
        self.cur_dqp_coded = True

    def _enc_tu_tree_root(self, px, py, log2, part_size):
        cu = type("CU", (), {})()
        cu.px, cu.py, cu.log2 = px, py, log2
        cu.pred_mode = MODE_INTRA
        cu.part_size = part_size
        cu.qp = int(self.pic.qp[py, px])
        cu.tqb = int(self.pic.tqb[py, px])
        self._min_tu_log2_cu_val = None
        self.cu = cu
        self._enc_tu_tree(cu, px, py, log2, 0)

    def _min_tu_log2(self, cu):
        sps = self.sps
        max_depth = sps.max_tr_hierarchy_depth_intra \
            if cu.pred_mode == MODE_INTRA else sps.max_tr_hierarchy_depth_inter
        intra_split = 1 if (cu.part_size == SIZE_NxN and
                            cu.pred_mode == MODE_INTRA) else 0
        if cu.log2 < sps.log2_min_tb + max_depth - 1 + intra_split:
            return sps.log2_min_tb
        return min(cu.log2 - (max_depth - 1 + intra_split), sps.log2_max_tb)

    def _enc_tu_tree(self, cu, px, py, log2, tr_depth):
        pic, e, c = self.pic, self.enc, self.ctx
        sps = self.sps
        chroma_ok = pic.num_comps > 1
        chroma_here = chroma_ok and (log2 > 2 or sps.chroma_format_idc == 3)
        min_tu = self._min_tu_log2(cu)

        subdiv = int(pic.tr_idx[py, px]) > tr_depth
        if cu.part_size == SIZE_NxN and tr_depth == 0:
            pass          # inferred 1
        elif log2 > sps.log2_max_tb:
            pass          # inferred 1
        elif log2 == sps.log2_min_tb:
            pass          # inferred 0
        elif log2 == min_tu:
            pass          # inferred 0
        else:
            e.encode_bin(1 if subdiv else 0, c.idx("trans_subdiv", 5 - log2))

        n = 1 << (log2 - 2)
        is422 = chroma_ok and sps.chroma_format_idc == 2
        if chroma_here:
            # 4:2:2: when this TU cannot quad-split its chroma further
            # (leaf, or 8x8 luma about to split to 4x4), TWO cbf bins are
            # sent — one per square sub-TU half (TDecSbac.cpp:993-1092;
            # dual of decode/ctu_dec.py _parse_tu_tree)
            two = is422 and (not subdiv or log2 == 3)
            sub_depth = tr_depth + (2 if (subdiv and log2 == 3) else 1)
            for comp in (1, 2):
                parent = self._cbf_at(comp, px, py, tr_depth - 1) if tr_depth else 1
                if parent:
                    if two:
                        for sub in range(2):
                            v = self._cbf_at(comp, px,
                                             py + sub * max(n >> 1, 1),
                                             sub_depth)
                            e.encode_bin(v, c.idx(
                                "qt_cbf", CBF_CTX_START[1] + tr_depth))
                    else:
                        v = self._cbf_at(comp, px, py, tr_depth)
                        e.encode_bin(v, c.idx("qt_cbf", CBF_CTX_START[1] + tr_depth))

        if subdiv:
            half = 1 << (log2 - 3)
            for sub in range(4):
                self._enc_tu_tree(cu, px + (sub & 1) * half,
                                  py + (sub >> 1) * half, log2 - 1, tr_depth + 1)
            return

        cbf_y = self._cbf_at(0, px, py, tr_depth)
        if cu.pred_mode == MODE_INTRA or tr_depth != 0 or \
                self._cbf_at(1, px, py, tr_depth) or self._cbf_at(2, px, py, tr_depth):
            ctx_inc = 1 if tr_depth == 0 else 0
            e.encode_bin(cbf_y, c.idx("qt_cbf", CBF_CTX_START[0] + ctx_inc))

        cbf_cb = cbf_cr = 0
        if chroma_ok:
            if log2 == 2 and not chroma_here:
                # 4:2:0/4:2:2: the 4x4 luma quad shares one chroma TU
                cbf_cb = self._cbf_at(1, px & ~1, py & ~1, tr_depth - 1)
                cbf_cr = self._cbf_at(2, px & ~1, py & ~1, tr_depth - 1)
            else:
                cbf_cb = self._cbf_at(1, px, py, tr_depth)
                cbf_cr = self._cbf_at(2, px, py, tr_depth)
        is_chroma_holder = chroma_here or (
            chroma_ok and log2 == 2 and (px % 2 == 1) and (py % 2 == 1))
        if cbf_y or cbf_cb or cbf_cr:
            if self.pps.cu_qp_delta_enabled and self.dqp_enabled and \
                    not self.cur_dqp_coded:
                self._enc_dqp(cu)
            if cbf_y:
                self._enc_residual(cu, px, py, log2, 0)
            if chroma_ok:
                if chroma_here:
                    if is422:
                        # two square sub-TUs, own cbf each (sub-flags one
                        # depth below — TDecEntropy.cpp:549)
                        for comp in ((1, 2) if (cbf_cb or cbf_cr) else ()):
                            for sub in range(2):
                                if self._cbf_at(comp, px,
                                                py + sub * max(n >> 1, 1),
                                                tr_depth + 1):
                                    self._enc_residual(cu, px, py, log2,
                                                       comp, sub422=sub)
                    else:
                        for comp, cbf_c in ((1, cbf_cb), (2, cbf_cr)):
                            if cbf_y:
                                self._enc_ccp(cu, px, py, comp)
                            if cbf_c:
                                self._enc_residual(cu, px, py, log2, comp)
                elif log2 == 2 and is_chroma_holder:
                    bx, by = px - 1, py - 1
                    if is422:
                        # parent 8x8's two 4x4 chroma sub-TUs; sub-flags
                        # at parent depth + 2
                        for comp in (1, 2):
                            for sub in range(2):
                                if self._cbf_at(comp, bx, by + sub,
                                                tr_depth + 1):
                                    self._enc_residual(cu, bx, by, 3, comp,
                                                       sub422=sub)
                    else:
                        if cbf_cb:
                            self._enc_residual(cu, bx, by, 3, 1)
                        if cbf_cr:
                            self._enc_residual(cu, bx, by, 3, 2)

    def _enc_ccp(self, cu, px, py, comp):
        """Cross-component prediction alpha write (TEncSbac dual of
        decode _parse_ccp, TDecSbac.cpp:847-896): flag, magnitude-1 flag,
        truncated-unary(2) of log2|alpha|-1, sign."""
        pps, pic, e, c = self.pps, self.pic, self.enc, self.ctx
        if not pps.cross_component_prediction_enabled:
            return
        if cu.pred_mode == MODE_INTRA and \
                int(pic.intra_chroma[py, px]) != DM_CHROMA_IDX:
            return
        alpha = int(pic.ccp_alpha[comp][py, px])
        base = 5 if comp == 2 else 0
        e.encode_bin(1 if alpha else 0, c.idx("cross_comp", base))
        if alpha:
            symbol = abs(alpha).bit_length() - 1   # 1,2,4,8 -> 0..3
            e.encode_bin(1 if symbol > 0 else 0,
                         c.idx("cross_comp", base + 1))
            if symbol > 0:
                # xWriteUnaryMaxSymbol(symbol-1, max=2), ctx base+2/+3
                v = symbol - 1
                e.encode_bin(1 if v else 0, c.idx("cross_comp", base + 2))
                if v:
                    code_last = 2 > v
                    for _ in range(v - 1):
                        e.encode_bin(1, c.idx("cross_comp", base + 3))
                    if code_last:
                        e.encode_bin(0, c.idx("cross_comp", base + 3))
            e.encode_bin(1 if alpha < 0 else 0,
                         c.idx("cross_comp", base + 4))

    def _cbf_at(self, comp, px, py, tr_depth):
        if tr_depth < 0:
            return 1
        return (int(self.pic.cbf[comp][py, px]) >> tr_depth) & 1

    # ------------------------------------------------------------------

    def _enc_residual(self, cu, px, py, log2, comp, sub422=None):
        """codeCoeffNxN dual (TEncSbac.cpp:1172-1529).  sub422 selects the
        upper (0) / lower (1) square sub-TU of a 4:2:2 double-high chroma
        block; TU-state markers (tskip) live in the matching part half."""
        pic, e, c = self.pic, self.enc, self.ctx
        sps, pps = self.sps, self.pps
        sx, sy = pic.comp_shift[comp]
        mpy = py
        if comp == 0:
            w = 1 << log2
            x0, y0 = px * 4, py * 4
        else:
            w = (1 << log2) >> sx
            x0, y0 = (px * 4) >> sx, (py * 4) >> sy
            if sub422 is not None:
                y0 += sub422 * w
                mpy = py + sub422 * max((1 << (log2 - 2)) >> 1, 1)
        h = w
        log2w = w.bit_length() - 1
        chan = 0 if comp == 0 else 1

        coeffs = pic.coeff[comp][y0:y0 + h, x0:x0 + w].astype(np.int64).ravel()
        be_valid = bool(pps.sign_data_hiding) and not cu.tqb

        if pps.transform_skip_enabled and not cu.tqb and \
                log2w <= pps.log2_max_transform_skip_block_size:
            e.encode_bin(int(pic.tskip[comp][mpy, px]),
                         c.idx("transform_skip", chan))

        scan_type = self._scan_type(cu, px, py, log2, comp)
        ts = int(pic.tskip[comp][mpy, px])
        if sps.implicit_rdpcm and cu.pred_mode == MODE_INTRA and \
                (ts or cu.tqb):
            # sign hiding is off when implicit RDPCM engages
            # (TDecSbac/TEncSbac residual dual; decode _parse_residual)
            m = int(pic.intra_luma[py, px]) if comp == 0 else \
                self._chroma_final_mode(cu, px, py)
            if m in (HOR_IDX, VER_IDX):
                be_valid = False
        if self._try_native_enc_residual(cu, comp, w, coeffs, scan_type, ts,
                                         be_valid):
            return
        scan = get_scan(w, h, scan_type, grouped=True)
        scan_cg = get_scan(max(w // 4, 1), max(h // 4, 1), scan_type, grouped=False)
        wg, hg = w // 4, h // 4

        single_ctx = bool(sps.transform_skip_context) and (cu.tqb or ts)
        if single_ctx:
            first_sig_ctx = SIG_CTX_SET_START[chan][3]
        elif w == 4:
            first_sig_ctx = SIG_CTX_SET_START[chan][0]
        elif w == 8:
            first_sig_ctx = SIG_CTX_SET_START[chan][1]
            if scan_type != 0:
                first_sig_ctx += NON_DIAG_8x8_CTX_OFFSET[chan]
        else:
            first_sig_ctx = SIG_CTX_SET_START[chan][2]

        # locate last significant in scan order
        sig_in_scan = coeffs[scan] != 0
        assert sig_in_scan.any(), "residual encode called with all-zero block"
        scan_pos_last = int(np.nonzero(sig_in_scan)[0][-1])
        blk_pos_last = int(scan[scan_pos_last])
        last_x = blk_pos_last & (w - 1)
        last_y = blk_pos_last >> log2w
        self._enc_last_xy(last_x, last_y, w, h, comp, scan_type)

        sig_cg = np.zeros(wg * hg, dtype=np.int64)
        for subset in range(scan_pos_last >> 4, -1, -1):
            cg_blk = int(scan_cg[subset])
            lo = subset << 4
            hi = min(scan_pos_last, (subset << 4) + 15)
            if np.any(coeffs[scan[lo:hi + 1]] != 0):
                sig_cg[cg_blk] = 1
        # first and last groups are inferred significant (never coded):
        # the decoder parses their sig maps even when empty
        sig_cg[int(scan_cg[scan_pos_last >> 4])] = 1
        sig_cg[int(scan_cg[0])] = 1

        last_scan_set = scan_pos_last >> 4
        c1 = 1
        use_rice_adaptation = bool(sps.persistent_rice_adaptation)
        align_bypass = bool(sps.cabac_bypass_alignment)
        extended_precision = bool(sps.extended_precision)
        rice_stat_idx = self._golomb_rice_stat_index(comp, ts or cu.tqb)

        scan_pos_sig = scan_pos_last
        for subset in range(last_scan_set, -1, -1):
            sub_pos = subset << 4
            go_rice = int(self.golomb_rice_stats[rice_stat_idx] // 4) \
                if use_rice_adaptation else 0
            update_rice = use_rice_adaptation
            num_nonzero = 0
            last_nz = -1
            first_nz = 16
            escape_present = False
            pos = []
            vals = []

            if scan_pos_sig == scan_pos_last:
                last_nz = first_nz = scan_pos_sig
                pos.append(blk_pos_last)
                vals.append(int(coeffs[blk_pos_last]))
                num_nonzero = 1
                scan_pos_sig -= 1

            cg_blk = int(scan_cg[subset])
            cg_y, cg_x = cg_blk // wg, cg_blk % wg
            if subset not in (last_scan_set, 0):
                ctx_sig = self._sig_cg_ctx(sig_cg, cg_x, cg_y, wg, hg)
                e.encode_bin(int(sig_cg[cg_blk]),
                             c.idx("sig_cg", 2 * (1 if chan else 0) + ctx_sig))

            pattern = self._pattern_sig_ctx(sig_cg, cg_x, cg_y, wg, hg)
            while scan_pos_sig >= sub_pos:
                blk = int(scan[scan_pos_sig])
                sig = 1 if coeffs[blk] != 0 else 0
                if sig_cg[cg_blk]:
                    if scan_pos_sig > sub_pos or subset == 0 or num_nonzero:
                        ctx_sig = self._sig_ctx(pattern, scan, scan_pos_sig,
                                                log2w, log2w, chan,
                                                first_sig_ctx, single_ctx)
                        e.encode_bin(sig,
                                     c.idx("sig", SIG_CTX_CHANNEL_OFFSET[chan] + ctx_sig))
                    # else inferred 1
                if sig:
                    pos.append(blk)
                    vals.append(int(coeffs[blk]))
                    num_nonzero += 1
                    if last_nz == -1:
                        last_nz = scan_pos_sig
                    first_nz = scan_pos_sig
                scan_pos_sig -= 1

            if num_nonzero <= 0:
                continue
            sign_hidden = (last_nz - first_nz) >= SBH_THRESHOLD
            ctx_set = CTX_SET_START[chan] + \
                (2 if (chan == 0 and subset > 0) else 0) + (1 if c1 == 0 else 0)
            c1 = 1
            abs_vals = [abs(v) for v in vals]
            num_c1 = min(num_nonzero, C1FLAG_NUMBER)
            first_c2_idx = -1
            for idx in range(num_c1):
                b = 1 if abs_vals[idx] > 1 else 0
                e.encode_bin(b, c.idx("one", 4 * ctx_set + c1))
                if b:
                    c1 = 0
                    if first_c2_idx == -1:
                        first_c2_idx = idx
                    else:
                        escape_present = True
                elif 0 < c1 < 3:
                    c1 += 1
            if c1 == 0 and first_c2_idx != -1:
                b = 1 if abs_vals[first_c2_idx] > 2 else 0
                e.encode_bin(b, c.idx("abs", ctx_set))
                if b:
                    escape_present = True
            escape_present = escape_present or (num_nonzero > C1FLAG_NUMBER)

            if escape_present and align_bypass:
                e.align()

            signs = 0
            n_signs = num_nonzero - 1 if (sign_hidden and be_valid) else num_nonzero
            for idx in range(n_signs):
                signs = (signs << 1) | (1 if vals[idx] < 0 else 0)
            e.encode_bins_ep(signs, n_signs)

            first_coeff2 = 1
            if escape_present:
                for idx in range(num_nonzero):
                    base_level = (2 + first_coeff2) if idx < C1FLAG_NUMBER else 1
                    if abs_vals[idx] >= base_level:
                        level = abs_vals[idx] - base_level
                        self._enc_coef_remain(level, go_rice, extended_precision, chan)
                        if abs_vals[idx] > (3 << go_rice):
                            go_rice = go_rice + 1 if use_rice_adaptation \
                                else min(go_rice + 1, 4)
                        if update_rice:
                            init_rice = int(self.golomb_rice_stats[rice_stat_idx] // 4)
                            if level >= (3 << init_rice):
                                self.golomb_rice_stats[rice_stat_idx] += 1
                            elif 2 * level < (1 << init_rice) and \
                                    self.golomb_rice_stats[rice_stat_idx] > 0:
                                self.golomb_rice_stats[rice_stat_idx] -= 1
                            update_rice = False
                    if abs_vals[idx] >= 2:
                        first_coeff2 = 0

    def _try_native_enc_residual(self, cu, comp, w, coeffs, scan_type, ts,
                                 be_valid) -> bool:
        from hm16_2_tpu_torch import native
        lib = native.get_lib()
        if lib is None:
            return False
        import ctypes
        e = self.enc
        counting = isinstance(e, CabacCounter)
        # persistent state struct + output buffer (ctypes Structure
        # construction and np.zeros were per-call hot spots)
        st = getattr(self, "_nat_st", None)
        if st is None:
            st = self._nat_st = native.EncState()
            self._nat_out = np.zeros(4 * 32 * 32 + 64, dtype=np.uint8)
            self._nat_out_ptr = self._nat_out.ctypes.data
        out = self._nat_out
        st.out = self._nat_out_ptr
        st.n = 0
        if counting:
            st.low = 0
            st.range_ = 510
            st.bits_left = 23
            st.num_buffered = 0
            st.buffered_byte = 0xFF
            st.counting = 1
            st.frac_bits = 0
        else:
            if e.bw.held_bits:
                return False   # CABAC data is always byte-aligned in the writer
            st.low = e.low
            st.range_ = e.range
            st.bits_left = e.bits_left
            st.num_buffered = e.num_buffered
            st.buffered_byte = e.buffered_byte
            st.counting = 0
            st.frac_bits = 0
        st.bins = 0
        params = self._res_params(cu, w.bit_length() - 1, comp, scan_type,
                                  ts, be_valid)
        scan, scan_cg = self._scan32(w, scan_type)
        if coeffs.dtype == np.int32 and coeffs.flags.c_contiguous:
            c32 = coeffs
        else:
            c32 = np.ascontiguousarray(coeffs, dtype=np.int32)
        ctx_state = self.ctx.state
        ctx_ptr = getattr(self.ctx, "_state_ptr", None)
        if ctx_ptr is None:
            ctx_ptr = self.ctx._state_ptr = ctx_state.ctypes.data
        rc = lib.encode_residual(
            ctypes.byref(st), ctx_ptr, ctypes.byref(params),
            scan.ctypes.data, scan_cg.ctypes.data, c32.ctypes.data,
            self.golomb_rice_stats.ctypes.data)
        if rc != 0:
            return False
        if counting:
            e.frac_bits += int(st.frac_bits)
            return True
        e.bins += int(st.bins)
        if st.n:
            e.bw.buf.extend(out[:st.n].tobytes())
        e.low = int(st.low)
        e.range = int(st.range_)
        e.bits_left = int(st.bits_left)
        e.num_buffered = int(st.num_buffered)
        e.buffered_byte = int(st.buffered_byte)
        return True

    def _enc_last_xy(self, last_x, last_y, w, h, comp, scan_type):
        e, c = self.enc, self.ctx
        chan = 0 if comp == 0 else 1
        if scan_type == SCAN_VER:
            last_x, last_y = last_y, last_x
            w, h = h, w
        cw = w.bit_length() - 3
        ch = h.bit_length() - 3
        if chan == 0:
            off_x = cw * 3 + ((cw + 1) >> 2)
            off_y = ch * 3 + ((ch + 1) >> 2)
            shift_x = (cw + 3) >> 2
            shift_y = (ch + 3) >> 2
        else:
            off_x = off_y = 0
            shift_x, shift_y = cw, ch
        base = 0 if chan == 0 else 15
        gx = int(GROUP_IDX[last_x])
        gy = int(GROUP_IDX[last_y])
        for i in range(gx):
            e.encode_bin(1, c.idx("last", base + off_x + (i >> shift_x)))
        if gx < int(GROUP_IDX[w - 1]):
            e.encode_bin(0, c.idx("last", base + off_x + (gx >> shift_x)))
        for i in range(gy):
            e.encode_bin(1, c.idx("last_y", base + off_y + (i >> shift_y)))
        if gy < int(GROUP_IDX[h - 1]):
            e.encode_bin(0, c.idx("last_y", base + off_y + (gy >> shift_y)))
        if gx > 3:
            count = (gx - 2) >> 1
            suffix = last_x - int(MIN_IN_GROUP[gx])
            for i in range(count - 1, -1, -1):
                e.encode_bin_ep((suffix >> i) & 1)
        if gy > 3:
            count = (gy - 2) >> 1
            suffix = last_y - int(MIN_IN_GROUP[gy])
            for i in range(count - 1, -1, -1):
                e.encode_bin_ep((suffix >> i) & 1)

    def _enc_coef_remain(self, symbol, r_param, use_limited, chan):
        """xWriteCoefRemainExGolomb dual (TEncSbac.cpp:~1100)."""
        e = self.enc
        max_tr_dr = self.sps.max_tr_dynamic_range(chan == 1)
        code_number = symbol
        if code_number < (COEF_REMAIN_BIN_REDUCTION << r_param):
            length = code_number >> r_param
            e.encode_bins_ep((1 << (length + 1)) - 2, length + 1)
            e.encode_bins_ep(code_number % (1 << r_param), r_param)
        elif use_limited:
            max_prefix_len = 32 - (COEF_REMAIN_BIN_REDUCTION + max_tr_dr)
            prefix_len = 0
            code_value = (code_number >> r_param) - COEF_REMAIN_BIN_REDUCTION
            while prefix_len < max_prefix_len and \
                    code_value > ((2 << prefix_len) - 2):
                prefix_len += 1
            if prefix_len == max_prefix_len:
                suffix_len = max_tr_dr - r_param
            else:
                suffix_len = prefix_len
            suffix = code_number - (((1 << prefix_len) - 1 + COEF_REMAIN_BIN_REDUCTION) << r_param)
            total_prefix = COEF_REMAIN_BIN_REDUCTION + prefix_len + 1
            e.encode_bins_ep((1 << total_prefix) - 2, total_prefix)
            e.encode_bins_ep(suffix, suffix_len + r_param)
        else:
            length = r_param
            code_number -= COEF_REMAIN_BIN_REDUCTION << r_param
            while code_number >= (1 << length):
                code_number -= (1 << length)
                length += 1
            prefix_ones = COEF_REMAIN_BIN_REDUCTION + length + 1 - r_param
            e.encode_bins_ep((1 << prefix_ones) - 2, prefix_ones)
            e.encode_bins_ep(code_number, length)

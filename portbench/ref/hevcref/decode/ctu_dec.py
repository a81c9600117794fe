"""CTU-level syntax decode + reconstruction.

Bit-exact dual of HM's TDecSbac (TDecSbac.cpp:366-1820), TDecCu
(TDecCu.cpp:180-805) and TDecEntropy::xDecodeTransform
(TDecEntropy.cpp:~380-560), restructured around dense picture arrays
(see hevcref.decode.picture) instead of recursive CU objects.

Parse fills per-part syntax arrays + planar coefficient buffers; recon
walks TUs in z-order calling the reference-exact ops kernels.
"""

from __future__ import annotations

import numpy as np

from hevcref.bitstream.cabac import CabacDecoder, ContextSet
from hevcref.common.tables import (
    GROUP_IDX, MIN_IN_GROUP, SCAN_DIAG, SCAN_HOR, SCAN_VER, get_scan)
from hevcref.decode.picture import (
    MODE_INTER, MODE_INTRA, PictureState, SIZE_2Nx2N, SIZE_NxN)
from hevcref.headers.params import B_SLICE, I_SLICE, P_SLICE, SliceHeader
from hevcref.ops import intra_ref, transforms_ref
from hevcref.ops.intra_ref import DC_IDX, DM_CHROMA_IDX, HOR_IDX, PLANAR_IDX, VER_IDX

# significance-map context layout (ContextTables.h:85-100)
SIG_CTX_SET_START = [[0, 9, 21, 27], [0, 9, 12, 15]]   # [chan][4x4,8x8,NxN,single]
SIG_CTX_CHANNEL_OFFSET = [0, 28]
NON_DIAG_8x8_CTX_OFFSET = [6, 0]
NOT_FIRST_GROUP_CTX_OFFSET = [3, 0]
CTX_SET_START = [0, 4]          # one/abs context set start per channel
CBF_CTX_START = [0, 5]
CTX_IND_MAP_4x4 = np.array([0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8])

CHROMA422_ANGLE_MAP = np.array(
    [0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18, 19, 20, 21, 22,
     23, 23, 24, 24, 25, 25, 26, 27, 27, 28, 28, 29, 29, 30, 31, DM_CHROMA_IDX])

C1FLAG_NUMBER = 8
SBH_THRESHOLD = 4
COEF_REMAIN_BIN_REDUCTION = 3


class CuState:
    """Per-CU scratch during parse."""
    __slots__ = ("px", "py", "log2", "depth", "pred_mode", "part_size",
                 "tqb", "qp", "intra_luma", "intra_chroma")


class SliceDecoder:
    def __init__(self, pic: PictureState, sh: SliceHeader, slice_idx: int):
        self.pic = pic
        self.sh = sh
        self.sps, self.pps = sh.sps, sh.pps
        self.slice_idx = slice_idx
        self.bit_depth = [self.sps.bit_depth_luma, self.sps.bit_depth_chroma,
                          self.sps.bit_depth_chroma]
        self.dec: CabacDecoder | None = None
        self.ctx: ContextSet | None = None
        # dqp state
        self.last_coded_qp = sh.qp
        self.qp_for_pred = sh.qp
        self.cur_dqp_coded = True
        self.golomb_rice_stats = np.zeros(4, dtype=np.int64)
        # wpp stored context
        self.wpp_ctx: ContextSet | None = None
        # optional syntax trace (list of event strings, Debug-component dual)
        self.trace: list | None = None

    def _tr(self, msg):
        if self.trace is not None:
            self.trace.append(msg)

    def _zidx(self, px, py):
        parts = self.pic.ctb // 4
        from hevcref.common.tables import RASTER_TO_ZSCAN_16
        return int(RASTER_TO_ZSCAN_16[(py % parts) * 16 + (px % parts)]) \
            if parts == 16 else -1

    # ------------------------------------------------------------------
    # entropy init
    # ------------------------------------------------------------------

    def init_contexts(self) -> ContextSet:
        st = self.sh.slice_type
        if self.sh.cabac_init_flag and st != I_SLICE:
            st = P_SLICE if st == B_SLICE else B_SLICE
        ctx = ContextSet(st, self.sh.qp)
        return ctx

    # ------------------------------------------------------------------
    # small binarizations (TDecSbac.cpp:207-300)
    # ------------------------------------------------------------------

    def read_unary_max(self, ctx_name, offs, ctx_offset, max_symbol):
        """xReadUnaryMaxSymbol (TDecSbac.cpp:209-243)"""
        d, c = self.dec, self.ctx
        if max_symbol == 0:
            return 0
        symbol = d.decode_bin(c.idx(ctx_name, offs))
        if symbol == 0 or max_symbol == 1:
            return symbol
        symbol = 0
        cont = 1
        while cont and symbol < max_symbol - 1:
            cont = d.decode_bin(c.idx(ctx_name, offs + ctx_offset))
            symbol += 1
        if cont and symbol == max_symbol - 1:
            symbol += 1
        return symbol

    def read_ep_exgolomb(self, count):
        """xReadEpExGolomb"""
        d = self.dec
        symbol = 0
        while d.decode_bin_ep():
            symbol += (1 << count)
            count += 1
        if count:
            bins = d.decode_bins_ep(count)
            symbol += bins
        return symbol

    def read_coef_remain(self, rice_param, use_limited, chan):
        """xReadCoefRemainExGolomb (TDecSbac.cpp:301-360)"""
        d = self.dec
        max_tr_dr = self.sps.max_tr_dynamic_range(chan == 1)
        prefix = 0
        if use_limited:
            longest = (32 - (COEF_REMAIN_BIN_REDUCTION + max_tr_dr)) + COEF_REMAIN_BIN_REDUCTION
            code = 1
            while code and prefix < longest:
                prefix += 1
                code = d.decode_bin_ep()
        else:
            code = 1
            while code:
                prefix += 1
                code = d.decode_bin_ep()
        code = 1 - code
        prefix -= code
        if prefix < COEF_REMAIN_BIN_REDUCTION:
            suffix = d.decode_bins_ep(rice_param) if rice_param else 0
            return (prefix << rice_param) + suffix
        if use_limited:
            max_prefix_len = 32 - (COEF_REMAIN_BIN_REDUCTION + max_tr_dr)
            prefix_len = prefix - COEF_REMAIN_BIN_REDUCTION
            suffix_len = (max_tr_dr - rice_param) if prefix_len == max_prefix_len \
                else prefix_len
            code_word = d.decode_bins_ep(suffix_len + rice_param)
            return code_word + ((((1 << prefix_len) - 1) + COEF_REMAIN_BIN_REDUCTION)
                                << rice_param)
        code_word = d.decode_bins_ep(prefix - COEF_REMAIN_BIN_REDUCTION + rice_param)
        return ((((1 << (prefix - COEF_REMAIN_BIN_REDUCTION))
                  + COEF_REMAIN_BIN_REDUCTION - 1) << rice_param) + code_word)

    # ------------------------------------------------------------------
    # SAO (TDecSbac.cpp:1600-1820)
    # ------------------------------------------------------------------

    def parse_sao(self, ctu_rs: int, left_avail: bool, above_avail: bool):
        pic, d, c = self.pic, self.dec, self.ctx
        n_comp = pic.num_comps
        sao_enabled = [self.sh.sao_luma, self.sh.sao_chroma, self.sh.sao_chroma]
        is_left = is_above = False
        if left_avail:
            is_left = bool(d.decode_bin(c.idx("sao_merge")))
        if above_avail and not is_left:
            is_above = bool(d.decode_bin(c.idx("sao_merge")))
        if is_left or is_above:
            src = ctu_rs - 1 if is_left else ctu_rs - pic.w_ctbs
            for comp in range(n_comp):
                if sao_enabled[comp]:
                    pic.sao_mode[ctu_rs, comp] = pic.sao_mode[src, comp]
                    pic.sao_type[ctu_rs, comp] = pic.sao_type[src, comp]
                    pic.sao_offsets[ctu_rs, comp] = pic.sao_offsets[src, comp]
                    pic.sao_band[ctu_rs, comp] = pic.sao_band[src, comp]
                else:
                    pic.sao_mode[ctu_rs, comp] = 0
            return
        for comp in range(n_comp):
            if not sao_enabled[comp]:
                pic.sao_mode[ctu_rs, comp] = 0
                continue
            if comp <= 1:   # Y, or Cb = first of chroma channel
                type_sym = self._parse_sao_type_idx()
                if type_sym == 0:
                    mode, start_type = 0, 0
                elif type_sym == 1:
                    mode, start_type = 1, 4   # BO
                else:
                    mode, start_type = 1, 0   # EO (class added below)
            else:           # Cr follows Cb
                mode = int(pic.sao_mode[ctu_rs, 1])
                start_type = 4 if pic.sao_type[ctu_rs, 1] == 4 else 0
            pic.sao_mode[ctu_rs, comp] = mode
            if mode == 0:
                continue
            bd = self.bit_depth[comp]
            max_offset = (1 << (min(bd, 10) - 5)) - 1
            offsets = [self._parse_sao_max_uvlc(max_offset) for _ in range(4)]
            if start_type == 4:   # BO
                for i in range(4):
                    if offsets[i] and d.decode_bin_ep():
                        offsets[i] = -offsets[i]
                band = d.decode_bins_ep(5)
                pic.sao_type[ctu_rs, comp] = 4
                pic.sao_band[ctu_rs, comp] = band
                pic.sao_offsets[ctu_rs, comp] = offsets
            else:                  # EO
                if comp <= 1:
                    eo_class = d.decode_bins_ep(2)
                else:
                    eo_class = int(pic.sao_type[ctu_rs, 1])
                pic.sao_type[ctu_rs, comp] = eo_class
                pic.sao_offsets[ctu_rs, comp] = [offsets[0], offsets[1],
                                                 -offsets[2], -offsets[3]]

    def _parse_sao_type_idx(self):
        d, c = self.dec, self.ctx
        if not d.decode_bin(c.idx("sao_type")):
            return 0
        return 2 if d.decode_bin_ep() else 1

    def _parse_sao_max_uvlc(self, max_symbol):
        d = self.dec
        if max_symbol == 0 or not d.decode_bin_ep():
            return 0
        i = 1
        while d.decode_bin_ep():
            i += 1
            if i == max_symbol:
                break
        return i

    # ------------------------------------------------------------------
    # CTU / CU quadtree (TDecCu::xDecodeCU)
    # ------------------------------------------------------------------

    def decode_ctu(self, ctu_x: int, ctu_y: int) -> bool:
        """Parse one CTU's syntax. Returns end-of-slice flag."""
        pic = self.pic
        self.dqp_enabled = False
        self.end_of_slice = False
        px, py = ctu_x * (pic.ctb // 4), ctu_y * (pic.ctb // 4)
        self._decode_cu(px, py, pic.log2_ctb, 0)
        # end_of_slice_segment_flag (spec 7.3.8.1)
        self.end_of_slice = bool(self.dec.decode_bin_trm())
        return self.end_of_slice

    def _cu_inside_pic(self, px, py, log2):
        pic = self.pic
        return ((px * 4 + (1 << log2) <= pic.w) and
                (py * 4 + (1 << log2) <= pic.h))

    def _mark_parts(self, arr, px, py, log2, value):
        n = 1 << (log2 - 2)
        arr[py:py + n, px:px + n] = value

    def _decode_cu(self, px, py, log2, depth):
        pic, d, c = self.pic, self.dec, self.ctx
        sps, pps = self.sps, self.pps
        boundary = not self._cu_inside_pic(px, py, log2)
        max_depth_reached = log2 == sps.log2_min_cb
        split = True
        if not boundary:
            if not max_depth_reached:
                ctx_inc = self._ctx_split(px, py, depth)
                split = bool(d.decode_bin(c.idx("split_flag", ctx_inc)))
            else:
                split = False

        if pps.cu_qp_delta_enabled and \
                log2 == sps.log2_ctb - pps.diff_cu_qp_delta_depth:
            # quantization-group start (spec 7.3.8.4): IsCuQpDeltaCoded=0
            self.dqp_enabled = True
            self.qp_for_pred = self.last_coded_qp
            self.cur_dqp_coded = False

        if split:
            half = 1 << (log2 - 3)
            for sub in range(4):
                sx = px + (sub & 1) * half
                sy = py + (sub >> 1) * half
                if self.end_of_slice:
                    break
                if sx * 4 < pic.w and sy * 4 < pic.h:
                    self._decode_cu(sx, sy, log2 - 1, depth + 1)
            return

        if pps.cu_qp_delta_enabled and \
                log2 >= sps.log2_ctb - pps.diff_cu_qp_delta_depth:
            self.dqp_enabled = True
            self.qp_for_pred = self.last_coded_qp
            self.cur_dqp_coded = False

        cu = CuState()
        cu.px, cu.py, cu.log2, cu.depth = px, py, log2, depth
        cu.qp = self.qp_for_pred if pps.cu_qp_delta_enabled else self.sh.qp
        cu.tqb = 0

        if pps.transquant_bypass_enabled:
            cu.tqb = d.decode_bin(c.idx("cu_transquant_bypass"))

        skip = 0
        if self.sh.slice_type != I_SLICE:
            ctx_inc = self._ctx_skip(px, py)
            skip = d.decode_bin(c.idx("skip_flag", ctx_inc))
        if skip:
            self._decode_skip_cu(cu)
            self._finish_cu(cu)
            return

        cu.pred_mode = MODE_INTRA
        if self.sh.slice_type != I_SLICE:
            cu.pred_mode = MODE_INTRA if d.decode_bin(c.idx("pred_mode")) \
                else MODE_INTER
        cu.part_size = SIZE_2Nx2N
        if cu.pred_mode == MODE_INTRA:
            if log2 == sps.log2_min_cb:
                if not d.decode_bin(c.idx("part_size")):
                    cu.part_size = SIZE_NxN
        else:
            cu.part_size = self._parse_inter_part_size(log2)

        if cu.pred_mode == MODE_INTRA and cu.part_size == SIZE_2Nx2N \
                and sps.pcm_enabled and sps.log2_min_pcm_cb <= log2 <= sps.log2_max_pcm_cb:
            if d.decode_bin_trm():
                self._parse_pcm(cu)
                self._finish_cu(cu)
                return
        self._mark_parts(pic.ipcm, px, py, log2, 0)

        if cu.pred_mode == MODE_INTRA:
            self._parse_intra_dirs(cu)
        else:
            self._parse_inter_pus(cu)

        # write part arrays before residual (MPM of later CUs needs them;
        # residual ctx needs tqb/pred/part info)
        self._write_cu_parts(cu)
        self._parse_coeffs(cu)
        self._finish_cu(cu)

    def _finish_cu(self, cu):
        # end_of_slice_segment_flag is parsed once per CTU by decode_ctu
        self._mark_parts(self.pic.coded, cu.px, cu.py, cu.log2, True)

    def _write_cu_parts(self, cu):
        pic = self.pic
        px, py, log2 = cu.px, cu.py, cu.log2
        self._mark_parts(pic.depth, px, py, log2, cu.depth)
        self._mark_parts(pic.pred_mode, px, py, log2, cu.pred_mode)
        self._mark_parts(pic.part_size, px, py, log2, cu.part_size)
        self._mark_parts(pic.tqb, px, py, log2, cu.tqb)
        self._mark_parts(pic.qp, px, py, log2, cu.qp)
        self._mark_parts(pic.slice_id, px, py, log2, self.slice_idx)
        self._mark_parts(pic.skip, px, py, log2, 0)
        # decode-order availability is z-gated; coded can be marked CU-wide
        self._mark_parts(pic.coded, px, py, log2, True)

    # ---- context helpers ----

    def _ctx_split(self, px, py, depth):
        pic = self.pic
        ctx = 0
        for nx, ny in ((px - 1, py), (px, py - 1)):
            if self._neighbor_ok(nx, ny, px, py):
                ctx += 1 if pic.depth[ny, nx] > depth else 0
        return ctx

    def _ctx_skip(self, px, py):
        pic = self.pic
        ctx = 0
        for nx, ny in ((px - 1, py), (px, py - 1)):
            if self._neighbor_ok(nx, ny, px, py):
                ctx += int(pic.skip[ny, nx])
        return ctx

    def _neighbor_ok(self, nx, ny, px, py):
        """Parse-time left/above neighbor availability (same slice+tile,
        already coded)."""
        pic = self.pic
        if nx < 0 or ny < 0:
            return False
        if not pic.coded[ny, nx]:
            return False
        if pic.slice_id[ny, nx] != self.slice_idx:
            return False
        if pic.tile_of_part(nx, ny) != pic.tile_of_part(px, py):
            return False
        return True

    # ---- intra ----

    def _parse_intra_dirs(self, cu):
        pic, d, c = self.pic, self.dec, self.ctx
        n_parts = 4 if cu.part_size == SIZE_NxN else 1
        half = 1 << (cu.log2 - 3)
        offs = [(0, 0)] if n_parts == 1 else [(0, 0), (half, 0), (0, half), (half, half)]
        mpm_flags = [d.decode_bin(c.idx("intra_pred_mode")) for _ in range(n_parts)]
        modes = []
        for j in range(n_parts):
            ox, oy = offs[j]
            preds = self._intra_mpm(cu.px + ox, cu.py + oy)
            if mpm_flags[j]:
                sym = d.decode_bin_ep()
                if sym:
                    sym = d.decode_bin_ep() + 1
                mode = preds[sym]
            else:
                mode = d.decode_bins_ep(5)
                preds_sorted = sorted(preds)
                for p in preds_sorted:
                    mode += (mode >= p)
            modes.append(mode)
            # write immediately: next PU's MPM may reference this one
            sub_log2 = cu.log2 if n_parts == 1 else cu.log2 - 1
            self._mark_parts(pic.intra_luma, cu.px + ox, cu.py + oy, sub_log2, mode)
            self._mark_parts(pic.pred_mode, cu.px + ox, cu.py + oy, sub_log2, MODE_INTRA)
            self._mark_parts(pic.coded, cu.px + ox, cu.py + oy, sub_log2, True)
            self._mark_parts(pic.slice_id, cu.px + ox, cu.py + oy, sub_log2,
                             self.slice_idx)
        cu.intra_luma = modes

        # chroma: one mode per CU, except 4:4:4 intra NxN which carries one
        # per PU (spec 7.3.8.5; enable4ChromaPUsInIntraNxNCU)
        n_chroma = 4 if (n_parts == 4 and
                         self.sh.sps.chroma_format_idc == 3) else 1
        for j in range(n_chroma):
            sym = d.decode_bin(c.idx("chroma_pred_mode"))
            if sym == 0:
                chroma_mode = DM_CHROMA_IDX
            else:
                idx = d.decode_bins_ep(2)
                allowed = [PLANAR_IDX, VER_IDX, HOR_IDX, DC_IDX, DM_CHROMA_IDX]
                luma0 = modes[j]
                for i in range(4):
                    if luma0 == allowed[i]:
                        allowed[i] = 34
                        break
                chroma_mode = allowed[idx]
            if n_chroma == 1:
                cu.intra_chroma = chroma_mode
                self._mark_parts(pic.intra_chroma, cu.px, cu.py, cu.log2,
                                 chroma_mode)
            else:
                ox, oy = offs[j]
                cu.intra_chroma = chroma_mode if j == 0 else cu.intra_chroma
                self._mark_parts(pic.intra_chroma, cu.px + ox, cu.py + oy,
                                 cu.log2 - 1, chroma_mode)

    def _intra_mpm(self, px, py):
        """getIntraDirPredictor (TComDataCU.cpp; above must not cross CTU)."""
        pic = self.pic
        left_dir = DC_IDX
        if self._neighbor_ok(px - 1, py, px, py) and \
                pic.pred_mode[py, px - 1] == MODE_INTRA:
            left_dir = int(pic.intra_luma[py, px - 1])
        above_dir = DC_IDX
        parts = pic.ctb // 4
        if py % parts != 0 and self._neighbor_ok(px, py - 1, px, py) and \
                pic.pred_mode[py - 1, px] == MODE_INTRA:
            above_dir = int(pic.intra_luma[py - 1, px])
        if left_dir == above_dir:
            if left_dir > 1:
                return [left_dir, ((left_dir + 29) % 32) + 2,
                        ((left_dir - 1) % 32) + 2]
            return [PLANAR_IDX, DC_IDX, VER_IDX]
        third = PLANAR_IDX if (left_dir and above_dir) else \
            (VER_IDX if left_dir + above_dir < 2 else DC_IDX)
        return [left_dir, above_dir, third]

    def _parse_pcm(self, cu):
        """pcm_sample parsing + reconstruction (TDecSbac::parseIPCMInfo
        TDecSbac.cpp:366-405, TDecCu::xDecodePCMTexture TDecCu.cpp:732).

        After the terminating pcm_flag bin the encoder has flushed and
        byte-aligned the arithmetic coder, so the raw samples start exactly
        at the decoder's current byte position; afterwards the engine
        re-initialises from the next byte (TDecBinCABAC::start)."""
        pic, sps, d = self.pic, self.sh.sps, self.dec
        px, py, log2 = cu.px, cu.py, cu.log2
        size = 1 << log2
        x0, y0 = px * 4, py * 4
        fifo = d.fifo
        bitpos = 0
        data = fifo.data
        base = fifo.pos

        def read_bits(n):
            nonlocal bitpos
            end = bitpos + n
            v = 0
            while bitpos < end:
                byte = data[base + (bitpos >> 3)]
                take = min(8 - (bitpos & 7), end - bitpos)
                shift = 8 - (bitpos & 7) - take
                v = (v << take) | ((byte >> shift) & ((1 << take) - 1))
                bitpos += take
            return v

        bds = [sps.bit_depth_luma, sps.bit_depth_chroma, sps.bit_depth_chroma]
        pcm_bds = [sps.pcm_bit_depth_luma, sps.pcm_bit_depth_chroma,
                   sps.pcm_bit_depth_chroma]
        for comp in range(pic.num_comps):
            sx, sy = pic.comp_shift[comp]
            w, h = size >> sx, size >> sy
            cx0, cy0 = x0 >> sx, y0 >> sy
            pbd, bd = pcm_bds[comp], bds[comp]
            samples = np.empty((h, w), dtype=np.int32)
            for yy in range(h):
                for xx in range(w):
                    samples[yy, xx] = read_bits(pbd)
            pic.rec[comp][cy0:cy0 + h, cx0:cx0 + w] = samples << (bd - pbd)
            pic.coeff[comp][cy0:cy0 + h, cx0:cx0 + w] = 0
        assert bitpos % 8 == 0, "PCM payload is byte-aligned by construction"
        fifo.pos = base + (bitpos >> 3)

        # re-initialise the arithmetic engine (TDecBinCABAC::start)
        d.range = 510
        d.bits_needed = -8
        d.value = (fifo.read_byte() << 8) | fifo.read_byte()

        # commit part fields (intra DC defaults keep later MPM derivation
        # identical to HM's initCtu defaults)
        self._mark_parts(pic.depth, px, py, log2, cu.depth)
        self._mark_parts(pic.pred_mode, px, py, log2, MODE_INTRA)
        self._mark_parts(pic.part_size, px, py, log2, SIZE_2Nx2N)
        self._mark_parts(pic.tqb, px, py, log2, cu.tqb)
        self._mark_parts(pic.qp, px, py, log2, cu.qp)
        self._mark_parts(pic.slice_id, px, py, log2, self.slice_idx)
        self._mark_parts(pic.skip, px, py, log2, 0)
        self._mark_parts(pic.ipcm, px, py, log2, 1)
        self._mark_parts(pic.intra_luma, px, py, log2, DC_IDX)
        self._mark_parts(pic.intra_chroma, px, py, log2, DM_CHROMA_IDX)
        self._mark_parts(pic.tr_idx, px, py, log2, 0)
        for comp in range(3):
            self._mark_parts(pic.cbf[comp], px, py, log2, 0)

    # ------------------------------------------------------------------
    # Inter CUs (TDecSbac::parsePartSize inter branch, TDecEntropy::
    # decodePUWise, TDecCu skip path)
    # ------------------------------------------------------------------

    PU_GEOMETRY = {
        0: [(0, 0, 4, 4)],                             # 2Nx2N (quarters of 4)
        1: [(0, 0, 4, 2), (0, 2, 4, 2)],               # 2NxN
        2: [(0, 0, 2, 4), (2, 0, 2, 4)],               # Nx2N
        3: [(0, 0, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (2, 2, 2, 2)],  # NxN
        4: [(0, 0, 4, 1), (0, 1, 4, 3)],               # 2NxnU
        5: [(0, 0, 4, 3), (0, 3, 4, 1)],               # 2NxnD
        6: [(0, 0, 1, 4), (1, 0, 3, 4)],               # nLx2N
        7: [(0, 0, 3, 4), (3, 0, 1, 4)],               # nRx2N
    }

    def pu_rects(self, px, py, log2, part_size):
        """PU rectangles in luma pixels for a CU."""
        s = 1 << log2
        q = s // 4
        return [(px * 4 + ox * q, py * 4 + oy * q, w * q, h * q)
                for (ox, oy, w, h) in self.PU_GEOMETRY[part_size]]

    def _parse_inter_part_size(self, log2):
        d, c, sps = self.dec, self.ctx, self.sps
        depth = sps.log2_ctb - log2
        max_bits = 2
        at_min = log2 == sps.log2_min_cb
        if at_min and log2 > 3:
            max_bits = 3
        mode = 0
        for ui in range(max_bits):
            if d.decode_bin(c.idx("part_size", ui)):
                break
            mode += 1
        amp = sps.amp_enabled and depth < (sps.log2_ctb - sps.log2_min_cb)
        if amp and mode in (1, 2):
            if not d.decode_bin(c.idx("part_size", 3)):
                sub = d.decode_bin_ep()
                if mode == 1:
                    mode = 5 if sub else 4      # 2NxnD : 2NxnU
                else:
                    mode = 7 if sub else 6      # nRx2N : nLx2N
        return mode

    def _decode_skip_cu(self, cu):
        pic, d, c = self.pic, self.dec, self.ctx
        cu.part_size = SIZE_2Nx2N
        cu.pred_mode = MODE_INTER
        merge_idx = self._parse_merge_index()
        self._write_cu_parts(cu)   # neighbors need our slice id for MER checks
        x, y, s = cu.px * 4, cu.py * 4, 1 << cu.log2
        cands = self.mvp.merge_candidates(x, y, s, s, 0, SIZE_2Nx2N,
                                          cu.px, cu.py, merge_idx)
        inter_dir, m0, m1 = cands[merge_idx]
        n = 1 << (cu.log2 - 2)
        pic.skip[cu.py:cu.py + n, cu.px:cu.px + n] = 1
        pic.merge_flag[cu.py:cu.py + n, cu.px:cu.px + n] = 1
        self._commit_pu_motion(cu.px, cu.py, n, n, inter_dir, m0, m1)
        pic.tr_idx[cu.py:cu.py + n, cu.px:cu.px + n] = 0
        for comp in range(pic.num_comps):
            pic.cbf[comp][cu.py:cu.py + n, cu.px:cu.px + n] = 0

    def _parse_merge_index(self):
        d, c = self.dec, self.ctx
        max_cand = self.sh.max_num_merge_cand
        idx = 0
        if max_cand > 1:
            while idx < max_cand - 1:
                if idx == 0:
                    b = d.decode_bin(c.idx("merge_idx"))
                else:
                    b = d.decode_bin_ep()
                if not b:
                    break
                idx += 1
        return idx

    def _commit_pu_motion(self, ppx, ppy, pw_parts, ph_parts, inter_dir, m0, m1):
        pic = self.pic
        pic.inter_dir[ppy:ppy + ph_parts, ppx:ppx + pw_parts] = inter_dir
        for lx, m in ((0, m0), (1, m1)):
            ref, mv = (m if (inter_dir >> lx) & 1 else (-1, (0, 0)))
            pic.ref_idx[lx, ppy:ppy + ph_parts, ppx:ppx + pw_parts] = ref
            pic.mv[lx, ppy:ppy + ph_parts, ppx:ppx + pw_parts, 0] = mv[0]
            pic.mv[lx, ppy:ppy + ph_parts, ppx:ppx + pw_parts, 1] = mv[1]
            poc = self.mvp.rc.ref_poc(lx, ref) if ref >= 0 else -(10 ** 9)
            pic.ref_poc[lx, ppy:ppy + ph_parts, ppx:ppx + pw_parts] = poc

    def _parse_inter_pus(self, cu):
        pic, d, c = self.pic, self.dec, self.ctx
        sh = self.sh
        self._write_cu_parts(cu)
        rects = self.pu_rects(cu.px, cu.py, cu.log2, cu.part_size)
        n = 1 << (cu.log2 - 2)
        pic.merge_flag[cu.py:cu.py + n, cu.px:cu.px + n] = 0
        shared_list = None
        plevel_on = self.pps.log2_parallel_merge_level > 2 and \
            cu.part_size != SIZE_2Nx2N and (1 << cu.log2) <= 8
        for pu_idx, (x, y, w, h) in enumerate(rects):
            ppx, ppy = x // 4, y // 4
            pwp, php = max(w // 4, 1), max(h // 4, 1)
            merge = d.decode_bin(c.idx("merge_flag"))
            if merge:
                merge_idx = self._parse_merge_index()
                if plevel_on:
                    if shared_list is None:
                        shared_list = self.mvp.merge_candidates(
                            cu.px * 4, cu.py * 4, 1 << cu.log2, 1 << cu.log2,
                            0, SIZE_2Nx2N, cu.px, cu.py)
                    cands = shared_list
                else:
                    cands = self.mvp.merge_candidates(
                        x, y, w, h, pu_idx, cu.part_size, cu.px, cu.py,
                        merge_idx)
                inter_dir, m0, m1 = cands[merge_idx]
                pic.merge_flag[ppy:ppy + php, ppx:ppx + pwp] = 1
            else:
                inter_dir = self._parse_inter_dir(cu, x, y, w, h)
                mvs = [(-1, (0, 0)), (-1, (0, 0))]
                mvds = [(0, 0), (0, 0)]
                for lx in range(2):
                    if sh.num_ref_idx[lx] <= 0 or not ((inter_dir >> lx) & 1):
                        continue
                    ref_idx = self._parse_ref_idx(lx)
                    mvds[lx] = self._parse_mvd(lx, inter_dir)
                    mvp_idx = self.read_unary_max("mvp_idx", 0, 1, 1)
                    cands = self.mvp.amvp_candidates(x, y, w, h, lx, ref_idx)
                    mv = (cands[mvp_idx][0] + mvds[lx][0],
                          cands[mvp_idx][1] + mvds[lx][1])
                    mvs[lx] = (ref_idx, mv)
                m0, m1 = mvs
            # bi-pred restriction for small PUs (8x8 CU, non-2Nx2N)
            if inter_dir == 3 and (1 << cu.log2) == 8 and (w < 8 or h < 8):
                inter_dir = 1
                m1 = (-1, (0, 0))
            self._commit_pu_motion(ppx, ppy, pwp, php, inter_dir, m0, m1)

    def _parse_inter_dir(self, cu, x, y, w, h):
        d, c = self.dec, self.ctx
        if self.sh.slice_type != B_SLICE:
            return 1
        ctx_inc = int(self.pic.depth[cu.py, cu.px])
        sym = 0
        # first bin skipped only for non-2Nx2N PUs of 8x8 CUs (parseInterDir
        # checks the CU height, not the PU height)
        if cu.part_size == SIZE_2Nx2N or (1 << cu.log2) != 8:
            sym = d.decode_bin(c.idx("inter_dir", ctx_inc))
        if sym:
            return 3
        return 2 if d.decode_bin(c.idx("inter_dir", 4)) else 1

    def _parse_ref_idx(self, lx):
        d, c = self.dec, self.ctx
        num_ref = self.sh.num_ref_idx[lx]
        if num_ref <= 1:
            return 0
        if not d.decode_bin(c.idx("ref_pic")):
            return 0
        ref = 0
        for ui in range(num_ref - 2):
            b = d.decode_bin(c.idx("ref_pic", 1)) if ui == 0 else d.decode_bin_ep()
            if not b:
                break
            ref += 1
        return ref + 1

    def _parse_mvd(self, lx, inter_dir):
        d, c = self.dec, self.ctx
        if self.sh.mvd_l1_zero and lx == 1 and inter_dir == 3:
            return (0, 0)
        hor_gr0 = d.decode_bin(c.idx("mvd"))
        ver_gr0 = d.decode_bin(c.idx("mvd"))
        hor, ver = hor_gr0, ver_gr0
        if hor_gr0:
            hor += d.decode_bin(c.idx("mvd", 1))
        if ver_gr0:
            ver += d.decode_bin(c.idx("mvd", 1))
        if hor_gr0:
            if hor == 2:
                hor += self.read_ep_exgolomb(1)
            if d.decode_bin_ep():
                hor = -hor
        if ver_gr0:
            if ver == 2:
                ver += self.read_ep_exgolomb(1)
            if d.decode_bin_ep():
                ver = -ver
        return (hor, ver)

    # ------------------------------------------------------------------
    # TU tree (TDecEntropy::xDecodeTransform)
    # ------------------------------------------------------------------

    def _parse_coeffs(self, cu):
        d, c = self.dec, self.ctx
        pic = self.pic
        if cu.pred_mode != MODE_INTRA:
            n = 1 << (cu.log2 - 2)
            merged = bool(pic.merge_flag[cu.py, cu.px])
            root_cbf = 1
            if not (cu.part_size == SIZE_2Nx2N and merged):
                root_cbf = d.decode_bin(c.idx("qt_root_cbf"))
            if not root_cbf:
                pic.tr_idx[cu.py:cu.py + n, cu.px:cu.px + n] = 0
                for comp in range(pic.num_comps):
                    pic.cbf[comp][cu.py:cu.py + n, cu.px:cu.px + n] = 0
                return
        self._min_tu_log2_cu = self._quadtree_tu_min_log2(cu)
        n = 1 << (cu.log2 - 2)
        self._cbf_scratch = {comp: np.zeros((6, n, n), dtype=np.uint8)
                             for comp in range(3)}
        self._parse_tu_tree(cu, cu.px, cu.py, cu.log2, 0)
        # store per-part cbf masks
        pic = self.pic
        for comp in range(self.pic.num_comps):
            mask = np.zeros((n, n), dtype=np.uint8)
            for dep in range(6):
                mask |= (self._cbf_scratch[comp][dep] << dep)
            pic.cbf[comp][cu.py:cu.py + n, cu.px:cu.px + n] = mask

    def _quadtree_tu_min_log2(self, cu):
        sps = self.sps
        max_depth = sps.max_tr_hierarchy_depth_intra if cu.pred_mode == MODE_INTRA \
            else sps.max_tr_hierarchy_depth_inter
        intra_split = 1 if (cu.pred_mode == MODE_INTRA and cu.part_size == SIZE_NxN) else 0
        inter_split = 1 if (max_depth == 1 and cu.pred_mode == MODE_INTER
                            and cu.part_size != SIZE_2Nx2N) else 0
        if cu.log2 < sps.log2_min_tb + max_depth - 1 + inter_split + intra_split:
            return sps.log2_min_tb
        v = cu.log2 - (max_depth - 1 + inter_split + intra_split)
        return min(v, sps.log2_max_tb)

    def _parse_tu_tree(self, cu, px, py, log2, tr_depth):
        """transform_tree (spec 7.3.8.8)."""
        pic, d, c = self.pic, self.dec, self.ctx
        sps = self.sps
        chroma_ok = pic.num_comps > 1
        # chroma coded at this level if chroma block >= 4x4
        chroma_here = chroma_ok and (log2 > 2 or sps.chroma_format_idc == 3)

        if cu.pred_mode == MODE_INTRA and cu.part_size == SIZE_NxN and \
                tr_depth == 0:
            subdiv = 1
        elif cu.pred_mode == MODE_INTER and \
                sps.max_tr_hierarchy_depth_inter == 1 and \
                cu.part_size != SIZE_2Nx2N and tr_depth == 0:
            subdiv = 1 if log2 > self._min_tu_log2_cu else 0
        elif log2 > sps.log2_max_tb:
            subdiv = 1
        elif log2 == sps.log2_min_tb:
            subdiv = 0
        elif log2 == self._min_tu_log2_cu:
            subdiv = 0
        else:
            subdiv = d.decode_bin(c.idx("trans_subdiv", 5 - log2))
            self._tr(f"subdiv {subdiv} ctx={5 - log2}")

        # chroma cbf parse (Cb then Cr), ctx = tr_depth.  In 4:2:2 the
        # chroma block of a luma TU is double-high (TComTU.h:48-162); when
        # this TU cannot quad-split its chroma further (leaf, or 8x8 luma
        # about to split to 4x4), TWO cbf bins are sent — one per square
        # sub-TU half (TDecSbac::parseQtCbf TDecSbac.cpp:993-1092).
        is422 = sps.chroma_format_idc == 2
        if chroma_here:
            two = is422 and (not subdiv or log2 == 3)
            # sub-flag storage depth (HM subTUDepth): leaf -> tr_depth+1,
            # 8x8-about-to-split -> tr_depth+2 (lowestTUDepth+1)
            sub_depth = tr_depth + (2 if (subdiv and log2 == 3) else 1)
            for comp in (1, 2):
                parent = self._get_cbf_scr(comp, cu, px, py, tr_depth - 1) \
                    if tr_depth else 1
                if parent:
                    if two:
                        n = 1 << (log2 - 2)
                        combined = 0
                        subv = []
                        for sub in range(2):
                            v = d.decode_bin(
                                c.idx("qt_cbf", CBF_CTX_START[1] + tr_depth))
                            self._tr(f"cbf {v} ctx={tr_depth} etype={comp} "
                                     f"part={self._zidx(px, py)}")
                            subv.append(v)
                            combined |= v
                        self._set_cbf_scr(comp, cu, px, py, log2, tr_depth,
                                          combined)
                        for sub in range(2):
                            self._set_cbf_half(comp, cu, px,
                                               py + sub * (n >> 1), n,
                                               sub_depth, subv[sub])
                    else:
                        v = d.decode_bin(
                            c.idx("qt_cbf", CBF_CTX_START[1] + tr_depth))
                        self._tr(f"cbf {v} ctx={tr_depth} etype={comp} part={self._zidx(px, py)}")
                        self._set_cbf_scr(comp, cu, px, py, log2, tr_depth, v)
                # else stays 0

        if subdiv:
            half = 1 << (log2 - 3)
            for sub in range(4):
                sx = px + (sub & 1) * half
                sy = py + (sub >> 1) * half
                self._parse_tu_tree(cu, sx, sy, log2 - 1, tr_depth + 1)
            # propagate chroma cbf: when log2-1 == 2 (children are 4x4 luma),
            # children inherited this level's chroma cbf; nothing to parse.
            return

        # luma cbf
        self._tr(f"trid part={self._zidx(px, py)} trdepth={tr_depth}")
        if cu.pred_mode == MODE_INTRA or tr_depth != 0 or \
                self._get_cbf_scr(1, cu, px, py, tr_depth) or \
                self._get_cbf_scr(2, cu, px, py, tr_depth):
            ctx_inc = 1 if tr_depth == 0 else 0
            cbf_y = d.decode_bin(c.idx("qt_cbf", CBF_CTX_START[0] + ctx_inc))
            self._tr(f"cbf {cbf_y} ctx={ctx_inc} etype=0 part={self._zidx(px, py)}")
        else:
            cbf_y = 1
        self._set_cbf_scr(0, cu, px, py, log2, tr_depth, cbf_y)
        self._mark_parts(pic.tr_idx, px, py, log2, tr_depth)

        # ---- transform_unit ----
        cbf_cb = self._get_cbf_scr(1, cu, px, py, tr_depth) if chroma_ok else 0
        cbf_cr = self._get_cbf_scr(2, cu, px, py, tr_depth) if chroma_ok else 0
        # with subsampled chroma, at log2==2 (4x4 luma TU) the chroma
        # residual is carried by the last (bottom-right) sub-TU of the 8x8
        # parent, using the parent's cbf; 4:4:4 chroma codes at every level
        subsampled = chroma_ok and pic.comp_shift[1][0] == 1
        is_chroma_holder = chroma_here or (
            subsampled and log2 == 2 and (px % 2 == 1) and (py % 2 == 1))
        if subsampled and log2 == 2:
            cbf_cb = self._get_cbf_scr(1, cu, px & ~1, py & ~1, tr_depth - 1)
            cbf_cr = self._get_cbf_scr(2, cu, px & ~1, py & ~1, tr_depth - 1)

        any_cbf = cbf_y or ((cbf_cb or cbf_cr) if chroma_ok else 0)
        if any_cbf:
            if self.pps.cu_qp_delta_enabled and self.dqp_enabled and \
                    not self.cur_dqp_coded:
                self._parse_dqp(cu)
            if cbf_y:
                self._parse_residual(cu, px, py, log2, 0)
            if chroma_ok:
                if chroma_here:
                    n = 1 << (log2 - 2)
                    for comp, cbf_c in ((1, cbf_cb), (2, cbf_cr)):
                        if is422:
                            # two square sub-TUs, own cbf each (sub-flags
                            # live one depth below, TDecEntropy.cpp:549)
                            for sub in range(2):
                                if self._get_cbf_scr(comp, cu, px,
                                                     py + sub * (n >> 1),
                                                     tr_depth + 1):
                                    self._parse_residual(cu, px, py, log2,
                                                         comp, sub422=sub)
                        else:
                            if cbf_y:
                                self._parse_ccp(cu, px, py, log2, comp)
                            if cbf_c:
                                self._parse_residual(cu, px, py, log2, comp)
                elif log2 == 2 and is_chroma_holder:
                    bx, by = px - 1, py - 1
                    if is422:
                        # parent 8x8's two 4x4 chroma sub-TUs; sub-flags
                        # stored at this depth + 1 (parent subTUDepth)
                        for comp in (1, 2):
                            for sub in range(2):
                                if self._get_cbf_scr(comp, cu, bx, by + sub,
                                                     tr_depth + 1):
                                    self._parse_residual(cu, bx, by, 3, comp,
                                                         sub422=sub)
                    else:
                        if cbf_cb:
                            self._parse_residual(cu, bx, by, 3, 1)
                        if cbf_cr:
                            self._parse_residual(cu, bx, by, 3, 2)

    def _get_cbf_scr(self, comp, cu, px, py, tr_depth):
        if tr_depth < 0:
            return 1
        rx, ry = (px - cu.px), (py - cu.py)
        return int(self._cbf_scratch[comp][tr_depth, ry, rx])

    def _set_cbf_scr(self, comp, cu, px, py, log2, tr_depth, v):
        rx, ry = (px - cu.px), (py - cu.py)
        n = 1 << (log2 - 2)
        # store at this depth and propagate down for child lookups
        for dep in range(tr_depth, 6):
            self._cbf_scratch[comp][dep, ry:ry + n, rx:rx + n] = v

    def _set_cbf_half(self, comp, cu, px, py, n, depth, v):
        """4:2:2 per-sub-TU cbf: half-height region (n wide, n/2 high parts)
        at the sub-TU storage depth (parseQtCbf setCbfPartRange)."""
        rx, ry = (px - cu.px), (py - cu.py)
        for dep in range(depth, 6):
            self._cbf_scratch[comp][dep, ry:ry + (n >> 1), rx:rx + n] = v

    def _parse_ccp(self, cu, px, py, log2, comp):
        """Cross-component prediction alpha (TDecSbac.cpp:847-896)."""
        pic, d, c = self.pic, self.dec, self.ctx
        if not self.pps.cross_component_prediction_enabled:
            return
        is_intra = cu.pred_mode == MODE_INTRA
        if is_intra and int(pic.intra_chroma[py, px]) != DM_CHROMA_IDX:
            return
        base = 5 if comp == 2 else 0
        alpha = 0
        if d.decode_bin(c.idx("cross_comp", base)):
            symbol = 0
            if d.decode_bin(c.idx("cross_comp", base + 1)):
                symbol = self.read_unary_max("cross_comp", base + 2, 1, 2) + 1
            sign = d.decode_bin(c.idx("cross_comp", base + 4))
            alpha = -(1 << symbol) if sign else (1 << symbol)
        self._tr(f"ccp {comp} {alpha}")
        n = 1 << (log2 - 2)
        pic.ccp_alpha[comp][py:py + n, px:px + n] = alpha

    def _parse_explicit_rdpcm(self, cu, px, py, log2, comp, mh=None):
        """parseExplicitRdpcmMode (TDecSbac.cpp:1847-1880)."""
        pic, d, c = self.pic, self.dec, self.ctx
        chan = 0 if comp == 0 else 1
        n = 1 << (log2 - 2)
        if mh is None:
            mh = n
        if d.decode_bin(c.idx("rdpcm_flag", chan)):
            mode = 1 if d.decode_bin(c.idx("rdpcm_dir", chan)) else 0
            # 0 = horizontal, 1 = vertical (RDPCM_HOR/VER)
            pic.rdpcm_mode[comp][py:py + mh, px:px + n] = mode
        else:
            pic.rdpcm_mode[comp][py:py + mh, px:px + n] = -1

    def _parse_dqp(self, cu):
        d, c = self.dec, self.ctx
        dqp = self.read_unary_max("dqp", 0, 1, 5)
        if dqp >= 5:
            dqp += self.read_ep_exgolomb(0)
        if dqp > 0:
            if d.decode_bin_ep():
                dqp = -dqp
        qp_bd = 6 * (self.bit_depth[0] - 8)
        if dqp != 0:
            qp = ((self.qp_for_pred + dqp + 52 + 2 * qp_bd) % (52 + qp_bd)) - qp_bd
        else:
            qp = self.qp_for_pred
        cu.qp = qp
        self.last_coded_qp = qp
        # subsequent CUs of this quantization group use the coded QP
        # (CuQpDeltaVal applies to the rest of the group, spec 7.4.9.10)
        self.qp_for_pred = qp
        self.cur_dqp_coded = True
        self._mark_parts(self.pic.qp, cu.px, cu.py, cu.log2, qp)

    # ------------------------------------------------------------------
    # residual_coding (TDecSbac::parseCoeffNxN)
    # ------------------------------------------------------------------

    def _scan_type(self, cu, px, py, log2, comp):
        """getCoefScanIdx (TComDataCU.cpp): mode-dependent coefficient scan
        for intra TUs whose component block is at most 8x8."""
        if cu.pred_mode != MODE_INTRA:
            return SCAN_DIAG
        pic = self.pic
        sx, sy = pic.comp_shift[comp]
        w = (1 << log2) if comp == 0 else ((1 << log2) >> sx)
        # MDCS size limit is component-scaled (8 luma, 8>>shift chroma)
        max_w = 8 >> (sx if comp else 0)
        max_h = 8 >> (sy if comp else 0)
        if w > max_w or w > max_h:
            return SCAN_DIAG
        if comp == 0:
            mode = int(pic.intra_luma[py, px])
        else:
            mode = self._chroma_final_mode(cu, px, py)
        if abs(mode - VER_IDX) <= 4:
            return SCAN_HOR
        if abs(mode - HOR_IDX) <= 4:
            return SCAN_VER
        return SCAN_DIAG

    def _dm_luma_mode(self, cu, px, py):
        """Luma mode of the PU corresponding to a chroma block at (px,py)."""
        return int(self.pic.intra_luma[py, px])

    def _parse_residual(self, cu, px, py, log2, comp, sub422=None):
        """parseCoeffNxN for a square TU of this component.

        (px, py) are luma part coords of the TU origin; for chroma the block
        covers the subsampled area.  sub422 selects the upper (0) / lower (1)
        square sub-TU of a 4:2:2 double-high chroma TU.
        """
        pic, d, c = self.pic, self.dec, self.ctx
        sps, pps = self.sps, self.pps
        sx, sy = pic.comp_shift[comp]
        if comp == 0:
            w = 1 << log2
            x0, y0 = px * 4, py * 4
        else:
            w = (1 << log2) >> sx
            x0, y0 = (px * 4) >> sx, (py * 4) >> sy
        h = w
        # part-marking region (tskip / rdpcm state): half-height for a
        # 4:2:2 sub-TU so each square block keeps its own flags
        mn = 1 << (log2 - 2)
        mpy, mh = py, mn
        if sub422 is not None:
            y0 += sub422 * w
            mpy, mh = py + sub422 * (mn >> 1), mn >> 1
        log2w = w.bit_length() - 1
        chan = 0 if comp == 0 else 1
        extended_precision = bool(sps.extended_precision)

        self._tr(f"coeff etype={comp} w={w} part={self._zidx(px, py)}")
        from hevcref.bitstream import cabac as _cab
        if _cab.STATS is not None:
            _cab.STATS.scope = f"{'y' if comp == 0 else 'c'}{w}x{h}"
        be_valid = bool(pps.sign_data_hiding)
        if cu.tqb:
            be_valid = False
            if cu.pred_mode != MODE_INTRA and sps.explicit_rdpcm:
                self._parse_explicit_rdpcm(cu, px, mpy, log2, comp, mh)

        # transform skip flag
        if pps.transform_skip_enabled and not cu.tqb and \
                log2w <= pps.log2_max_transform_skip_block_size:
            ts = d.decode_bin(c.idx("transform_skip", chan))
            self._tr(f"ts {ts}")
            n = 1 << (log2 - 2)
            pic.tskip[comp][mpy:mpy + mh, px:px + n] = ts
            if ts and cu.pred_mode != MODE_INTRA and sps.explicit_rdpcm:
                self._parse_explicit_rdpcm(cu, px, mpy, log2, comp, mh)
                if pic.rdpcm_mode[comp][mpy, px] != -1:
                    be_valid = False
        else:
            ts = 0

        if cu.pred_mode == MODE_INTRA and sps.implicit_rdpcm:
            mode = int(pic.intra_luma[py, px]) if comp == 0 else \
                self._chroma_final_mode(cu, px, py)
            if ts and mode in (HOR_IDX, VER_IDX):
                be_valid = False

        scan_type = self._scan_type(cu, px, py, log2, comp)
        if self._try_native_residual(cu, px, py, log2, comp, w, x0, y0,
                                     scan_type, ts, be_valid):
            return
        scan = get_scan(w, h, scan_type, grouped=True)
        scan_cg = get_scan(max(w // 4, 1), max(h // 4, 1), scan_type, grouped=False)
        wg, hg = w // 4, h // 4

        # significance ctx parameters
        single_ctx = bool(sps.transform_skip_context) and (cu.tqb or ts)
        if single_ctx:
            first_sig_ctx = SIG_CTX_SET_START[chan][3]
        elif w == 4:
            first_sig_ctx = SIG_CTX_SET_START[chan][0]
        elif w == 8:
            first_sig_ctx = SIG_CTX_SET_START[chan][1]
            if scan_type != SCAN_DIAG:
                first_sig_ctx += NON_DIAG_8x8_CTX_OFFSET[chan]
        else:
            first_sig_ctx = SIG_CTX_SET_START[chan][2]

        # last significant position
        last_x, last_y = self._parse_last_xy(w, h, comp, scan_type)
        self._tr(f"lastxy {last_x} {last_y}")
        blk_pos_last = last_x + (last_y << log2w)

        coeffs = np.zeros(w * h, dtype=np.int64)
        scan_pos_last = int(np.nonzero(scan == blk_pos_last)[0][0])

        sig_cg = np.zeros(wg * hg, dtype=np.int64)
        last_scan_set = scan_pos_last >> 4
        c1 = 1
        use_rice_adaptation = bool(sps.persistent_rice_adaptation)
        align_bypass = bool(sps.cabac_bypass_alignment)
        rice_stat_idx = self._golomb_rice_stat_index(comp, ts or cu.tqb)

        scan_pos_sig = scan_pos_last
        for subset in range(last_scan_set, -1, -1):
            sub_pos = subset << 4
            go_rice = int(self.golomb_rice_stats[rice_stat_idx] // 4) \
                if use_rice_adaptation else 0
            update_rice = use_rice_adaptation
            num_nonzero = 0
            last_nz_in_cg = -1
            first_nz_in_cg = 16
            escape_present = False
            pos = []

            if scan_pos_sig == scan_pos_last:
                last_nz_in_cg = first_nz_in_cg = scan_pos_sig
                scan_pos_sig -= 1
                pos.append(blk_pos_last)
                num_nonzero = 1

            cg_blk = int(scan_cg[subset])
            cg_y, cg_x = cg_blk // wg, cg_blk % wg
            if subset in (last_scan_set, 0):
                sig_cg[cg_blk] = 1
            else:
                ctx_sig = self._sig_cg_ctx(sig_cg, cg_x, cg_y, wg, hg)
                sig_cg[cg_blk] = d.decode_bin(
                    c.idx("sig_cg", 2 * (1 if chan else 0) + ctx_sig))

            pattern = self._pattern_sig_ctx(sig_cg, cg_x, cg_y, wg, hg)
            while scan_pos_sig >= sub_pos:
                blk = int(scan[scan_pos_sig])
                sig = 0
                if sig_cg[cg_blk]:
                    if scan_pos_sig > sub_pos or subset == 0 or num_nonzero:
                        ctx_sig = self._sig_ctx(pattern, scan, scan_pos_sig,
                                                log2w, log2w, chan,
                                                first_sig_ctx, single_ctx)
                        sig = d.decode_bin(
                            c.idx("sig", SIG_CTX_CHANNEL_OFFSET[chan] + ctx_sig))
                    else:
                        sig = 1
                if sig:
                    pos.append(blk)
                    num_nonzero += 1
                    if last_nz_in_cg == -1:
                        last_nz_in_cg = scan_pos_sig
                    first_nz_in_cg = scan_pos_sig
                scan_pos_sig -= 1

            if num_nonzero <= 0:
                continue
            sign_hidden = (last_nz_in_cg - first_nz_in_cg) >= SBH_THRESHOLD
            ctx_set = CTX_SET_START[chan] + \
                (2 if (chan == 0 and subset > 0) else 0) + (1 if c1 == 0 else 0)
            c1 = 1
            abs_coeff = [1] * num_nonzero
            num_c1 = min(num_nonzero, C1FLAG_NUMBER)
            first_c2_idx = -1
            for idx in range(num_c1):
                b = d.decode_bin(c.idx("one", 4 * ctx_set + c1))
                if b:
                    c1 = 0
                    if first_c2_idx == -1:
                        first_c2_idx = idx
                    else:
                        escape_present = True
                elif 0 < c1 < 3:
                    c1 += 1
                abs_coeff[idx] = b + 1
            if c1 == 0 and first_c2_idx != -1:
                b = d.decode_bin(c.idx("abs", ctx_set))
                abs_coeff[first_c2_idx] = b + 2
                if b:
                    escape_present = True
            escape_present = escape_present or (num_nonzero > C1FLAG_NUMBER)

            if escape_present and align_bypass:
                d.align()

            if sign_hidden and be_valid:
                signs = d.decode_bins_ep(num_nonzero - 1)
                n_signs = num_nonzero - 1
            else:
                signs = d.decode_bins_ep(num_nonzero)
                n_signs = num_nonzero

            first_coeff2 = 1
            if escape_present:
                for idx in range(num_nonzero):
                    base_level = (2 + first_coeff2) if idx < C1FLAG_NUMBER else 1
                    if abs_coeff[idx] == base_level:
                        level = self.read_coef_remain(go_rice, extended_precision, chan)
                        self._tr(f"esc {level} {go_rice}")
                        abs_coeff[idx] = level + base_level
                        if abs_coeff[idx] > (3 << go_rice):
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
                    if abs_coeff[idx] >= 2:
                        first_coeff2 = 0

            abs_sum = sum(abs_coeff)
            sign_bit_pos = n_signs - 1
            for idx in range(num_nonzero):
                val = abs_coeff[idx]
                if idx == num_nonzero - 1 and sign_hidden and be_valid:
                    if abs_sum & 1:
                        val = -val
                else:
                    if (signs >> sign_bit_pos) & 1:
                        val = -val
                    sign_bit_pos -= 1
                coeffs[pos[idx]] = val

        pic.coeff[comp][y0:y0 + h, x0:x0 + w] = coeffs.reshape(h, w)

        if _cab.STATS is not None:
            _cab.STATS.scope = None

    def _golomb_rice_stat_index(self, comp, ts_or_tqb):
        # rTu.getGolombRiceStatisticsIndex: 2*isChroma + isTSorBypass
        return 2 * (0 if comp == 0 else 1) + (1 if ts_or_tqb else 0)

    # ------------------------------------------------------------------
    # native residual path
    # ------------------------------------------------------------------

    _scan32_cache: dict = {}

    @classmethod
    def _scan32(cls, w, scan_type):
        key = (w, scan_type)
        if key not in cls._scan32_cache:
            cls._scan32_cache[key] = (
                np.ascontiguousarray(get_scan(w, w, scan_type, True), np.int32),
                np.ascontiguousarray(
                    get_scan(max(w // 4, 1), max(w // 4, 1), scan_type, False),
                    np.int32))
        return cls._scan32_cache[key]

    def _res_params(self, cu, log2w, comp, scan_type, ts, be_valid):
        from hevcref.bitstream.cabac import CTX_OFFSET
        from hevcref.native import ResParams
        sps = self.sps
        chan = 0 if comp == 0 else 1
        w = 1 << log2w
        single = bool(sps.transform_skip_context) and (cu.tqb or ts)
        if single:
            first_sig = SIG_CTX_SET_START[chan][3]
        elif w == 4:
            first_sig = SIG_CTX_SET_START[chan][0]
        elif w == 8:
            first_sig = SIG_CTX_SET_START[chan][1]
            if scan_type != SCAN_DIAG:
                first_sig += NON_DIAG_8x8_CTX_OFFSET[chan]
        else:
            first_sig = SIG_CTX_SET_START[chan][2]
        cw = w.bit_length() - 3
        if chan == 0:
            off = cw * 3 + ((cw + 1) >> 2)
            shift = (cw + 3) >> 2
        else:
            off = 0
            shift = cw
        base = 0 if chan == 0 else 15
        return ResParams(
            width=w, chan=chan, scan_type=scan_type,
            first_sig_ctx=first_sig, single_ctx=1 if single else 0,
            be_valid=1 if be_valid else 0,
            use_rice_adaptation=1 if sps.persistent_rice_adaptation else 0,
            align_bypass=1 if sps.cabac_bypass_alignment else 0,
            use_limited_prefix=1 if sps.extended_precision else 0,
            max_tr_dynamic_range=sps.max_tr_dynamic_range(comp != 0),
            rice_stat_idx=self._golomb_rice_stat_index(comp, bool(ts) or bool(cu.tqb)),
            ctx_last_x=CTX_OFFSET["last"] + base,
            ctx_last_y=CTX_OFFSET["last_y"] + base,
            ctx_sig_cg=CTX_OFFSET["sig_cg"] + 2 * chan,
            ctx_sig=CTX_OFFSET["sig"] + SIG_CTX_CHANNEL_OFFSET[chan],
            ctx_one=CTX_OFFSET["one"], ctx_abs=CTX_OFFSET["abs"],
            ctx_set_start=CTX_SET_START[chan],
            off_x=off, off_y=off, shift_x=shift, shift_y=shift)

    def _try_native_residual(self, cu, px, py, log2, comp, w, x0, y0,
                             scan_type, ts, be_valid) -> bool:
        from hevcref.bitstream import cabac as _cabac
        if self.trace is not None or _cabac.STATS is not None:
            return False
        from hevcref import native
        lib = native.get_lib()
        if lib is None:
            return False
        import ctypes
        d = self.dec
        st = native.DecState(
            buf=ctypes.cast(ctypes.c_char_p(d.fifo.data), ctypes.c_void_p),
            pos=d.fifo.pos, len=len(d.fifo.data), range_=d.range,
            value=d.value, bits_needed=d.bits_needed)
        params = self._res_params(cu, w.bit_length() - 1, comp, scan_type,
                                  ts, be_valid)
        scan, scan_cg = self._scan32(w, scan_type)
        coeffs = np.zeros(w * w, dtype=np.int32)
        ctx = self.ctx.state
        rc = lib.decode_residual(
            ctypes.byref(st), ctx.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(params),
            scan.ctypes.data_as(ctypes.c_void_p),
            scan_cg.ctypes.data_as(ctypes.c_void_p),
            coeffs.ctypes.data_as(ctypes.c_void_p),
            self.golomb_rice_stats.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            return False
        d.fifo.pos = st.pos
        d.range = st.range_
        d.value = st.value
        d.bits_needed = st.bits_needed
        self.pic.coeff[comp][y0:y0 + w, x0:x0 + w] = coeffs.reshape(w, w)
        return True

    def _chroma_final_mode(self, cu, px, py):
        mode = int(self.pic.intra_chroma[py, px])
        if mode == DM_CHROMA_IDX:
            mode = self._dm_luma_mode(cu, px, py)
        if self.sps.chroma_format_idc == 2:
            mode = int(CHROMA422_ANGLE_MAP[mode])
        return mode

    def _parse_last_xy(self, w, h, comp, scan_type):
        d, c = self.dec, self.ctx
        chan = 0 if comp == 0 else 1
        if scan_type == SCAN_VER:
            w, h = h, w
        cw = w.bit_length() - 3   # g_aucConvertToBit
        ch = h.bit_length() - 3
        if chan == 0:
            off_x = cw * 3 + ((cw + 1) >> 2)
            off_y = ch * 3 + ((ch + 1) >> 2)
            shift_x = (cw + 3) >> 2
            shift_y = (ch + 3) >> 2
        else:
            off_x = off_y = 0
            shift_x, shift_y = cw, ch
        base = 0 if chan == 0 else 15   # per-channel offset within each set
        last_x = 0
        while last_x < GROUP_IDX[w - 1]:
            if not d.decode_bin(c.idx("last", base + off_x + (last_x >> shift_x))):
                break
            last_x += 1
        last_y = 0
        while last_y < GROUP_IDX[h - 1]:
            if not d.decode_bin(c.idx("last_y", base + off_y + (last_y >> shift_y))):
                break
            last_y += 1
        if last_x > 3:
            count = (last_x - 2) >> 1
            tmp = 0
            for i in range(count - 1, -1, -1):
                tmp += d.decode_bin_ep() << i
            last_x = int(MIN_IN_GROUP[last_x]) + tmp
        if last_y > 3:
            count = (last_y - 2) >> 1
            tmp = 0
            for i in range(count - 1, -1, -1):
                tmp += d.decode_bin_ep() << i
            last_y = int(MIN_IN_GROUP[last_y]) + tmp
        if scan_type == SCAN_VER:
            last_x, last_y = last_y, last_x
        return last_x, last_y

    # ------------------------------------------------------------------
    # Reconstruction (TDecCu::xDecompressCU / xReconIntraQT / xIntraRecBlk)
    # ------------------------------------------------------------------

    def reconstruct_ctu(self, ctu_x: int, ctu_y: int):
        pic = self.pic
        parts = pic.ctb // 4
        px0, py0 = ctu_x * parts, ctu_y * parts
        self._recon_cu_tree(px0, py0, pic.log2_ctb)

    def _recon_cu_tree(self, px, py, log2):
        pic = self.pic
        if px * 4 >= pic.w or py * 4 >= pic.h:
            return
        depth_here = int(pic.depth[py, px])
        cur_depth = pic.log2_ctb - log2
        if depth_here > cur_depth or not self._cu_inside_pic(px, py, log2):
            half = 1 << (log2 - 3)
            for sub in range(4):
                self._recon_cu_tree(px + (sub & 1) * half,
                                    py + (sub >> 1) * half, log2 - 1)
            return
        if pic.ipcm[py, px]:
            return                  # PCM samples were written at parse time
        if pic.pred_mode[py, px] == MODE_INTRA:
            self._recon_intra_cu(px, py, log2)
        else:
            self._recon_inter_cu(px, py, log2)

    def _recon_inter_cu(self, px, py, log2):
        """xReconInter: full-CU motion compensation, then inverse-RQT
        residual accumulation with one final clip."""
        pic = self.pic
        size = 1 << log2
        preds = self.inter_pred_cu(px, py, log2)

        # residual accumulation over the TU tree
        if self.pps.cross_component_prediction_enabled:
            self._ccp_luma_resi = np.zeros((size, size), dtype=np.int64)
            self._ccp_origin = (px * 4, py * 4)
        for comp in range(pic.num_comps):
            sx, sy = pic.comp_shift[comp]
            x0, y0 = (px * 4) >> sx, (py * 4) >> sy
            resi = np.zeros_like(preds[comp])
            self._accum_inter_resi(px, py, px, py, log2, 0, comp, resi,
                                   x0, y0)
            if self.pps.cross_component_prediction_enabled and comp == 0:
                self._ccp_luma_resi[:, :] = resi
            bd = self.bit_depth[comp]
            pic.rec[comp][y0:y0 + preds[comp].shape[0],
                          x0:x0 + preds[comp].shape[1]] = np.clip(
                preds[comp] + resi, 0, (1 << bd) - 1)

    def inter_pred_cu(self, px, py, log2):
        """Motion-compensated prediction planes for a whole inter CU
        (per-PU MC incl. weighted prediction, bi averaging, and the
        identical-motion collapse) from the committed picture arrays.
        Shared by decode reconstruction and the encoder search."""
        from hevcref.ops import interp_ref
        pic, sps = self.pic, self.sps
        size = 1 << log2
        part_size = int(pic.part_size[py, px])
        rects = self.pu_rects(px, py, log2, part_size)
        preds = []
        for comp in range(pic.num_comps):
            sx, sy = pic.comp_shift[comp]
            preds.append(np.zeros((size >> sy, size >> sx), dtype=np.int64))
        wp_active = (self.sh.slice_type == P_SLICE and self.pps.weighted_pred) or \
            (self.sh.slice_type == B_SLICE and self.pps.weighted_bipred)
        for (x, y, w, h) in rects:
            ppx, ppy = x // 4, y // 4
            inter_dir = int(pic.inter_dir[ppy, ppx])
            bi = inter_dir == 3
            # identical-motion check (xCheckIdenticalMotion)
            if bi and self.sh.slice_type == B_SLICE and not self.pps.weighted_bipred:
                r0 = int(pic.ref_idx[0, ppy, ppx])
                r1 = int(pic.ref_idx[1, ppy, ppx])
                if r0 >= 0 and r1 >= 0 and \
                        self.mvp.rc.ref_poc(0, r0) == self.mvp.rc.ref_poc(1, r1) and \
                        (pic.mv[0, ppy, ppx] == pic.mv[1, ppy, ppx]).all():
                    bi = False
                    inter_dir = 1
            keep = bi or wp_active
            partial = []
            ref_idxs = [-1, -1]
            for lx in range(2):
                if not ((inter_dir >> lx) & 1):
                    partial.append(None)
                    continue
                ref_idx = int(pic.ref_idx[lx, ppy, ppx])
                ref_idxs[lx] = ref_idx
                ref_pic = self.mvp.rc.ref_lists[lx][ref_idx]
                mvx = int(pic.mv[lx, ppy, ppx, 0])
                mvy = int(pic.mv[lx, ppy, ppx, 1])
                comps = []
                for comp in range(pic.num_comps):
                    sx, sy = pic.comp_shift[comp]
                    blk = interp_ref.mc_block(
                        ref_pic.rec[comp], x >> sx, y >> sy, w >> sx, h >> sy,
                        mvx, mvy, 2 + sx, 2 + sy, comp == 0,
                        self.bit_depth[comp], keep_precision=keep)
                    comps.append(blk)
                partial.append(comps)
            for comp in range(pic.num_comps):
                sx, sy = pic.comp_shift[comp]
                ox, oy = (x - px * 4) >> sx, (y - py * 4) >> sy
                if wp_active:
                    blk = self._weighted_pred(partial, ref_idxs, comp, bi)
                elif bi:
                    blk = interp_ref.bi_average(partial[0][comp], partial[1][comp],
                                                self.bit_depth[comp])
                else:
                    blk = partial[0][comp] if partial[0] is not None else partial[1][comp]
                preds[comp][oy:oy + (h >> sy), ox:ox + (w >> sx)] = blk
        return preds

    def _weighted_pred(self, partial, ref_idxs, comp, bi):
        """Explicit weighted prediction (TComWeightPrediction.cpp:44-195)."""
        from hevcref.ops.interp_ref import IF_INTERNAL_OFFS, IF_INTERNAL_PREC
        bd = self.bit_depth[comp]
        hp = bool(self.sps.high_precision_offsets)
        off_scale = 1 if hp else (1 << (bd - 8))
        shift_num = max(2, IF_INTERNAL_PREC - bd)
        max_val = (1 << bd) - 1
        sh = self.sh
        if bi:
            w0p = sh.pred_weights[(0, ref_idxs[0], comp)]
            w1p = sh.pred_weights[(1, ref_idxs[1], comp)]
            denom = w0p.log2_denom
            shift = denom + 1 + shift_num
            offset = (w0p.offset + w1p.offset) * off_scale
            round_ = 1 << (shift - 1) if shift > 0 else 0
            p0 = partial[0][comp] + IF_INTERNAL_OFFS
            p1 = partial[1][comp] + IF_INTERNAL_OFFS
            val = (w0p.weight * p0 + w1p.weight * p1 + round_
                   + (offset << (shift - 1))) >> shift
            return np.clip(val, 0, max_val)
        lx = 0 if partial[0] is not None else 1
        wp = sh.pred_weights[(lx, ref_idxs[lx], comp)]
        shift = wp.log2_denom + shift_num
        round_ = 1 << (shift - 1) if shift > 0 else 0
        p0 = partial[lx][comp] + IF_INTERNAL_OFFS
        val = ((wp.weight * p0 + round_) >> shift) + wp.offset * off_scale
        return np.clip(val, 0, max_val)

    def _accum_inter_resi(self, cu_px, cu_py, px, py, log2, tr_depth, comp,
                          resi, base_x, base_y):
        pic = self.pic
        is422 = comp > 0 and self.sps.chroma_format_idc == 2
        if int(pic.tr_idx[py, px]) > tr_depth:
            if comp > 0 and log2 == 3 and pic.comp_shift[comp][0] == 1:
                if is422:
                    for sub in range(2):
                        self._add_tu_resi(px, py, log2, tr_depth + 2, comp,
                                          resi, base_x, base_y, sub422=sub)
                else:
                    self._add_tu_resi(px, py, log2, tr_depth + 1, comp, resi,
                                      base_x, base_y, chroma_from_parent=True)
                return
            half = 1 << (log2 - 3)
            for sub in range(4):
                self._accum_inter_resi(cu_px, cu_py, px + (sub & 1) * half,
                                       py + (sub >> 1) * half, log2 - 1,
                                       tr_depth + 1, comp, resi, base_x, base_y)
            return
        if is422:
            for sub in range(2):
                self._add_tu_resi(px, py, log2, tr_depth + 1, comp, resi,
                                  base_x, base_y, sub422=sub)
        else:
            self._add_tu_resi(px, py, log2, tr_depth, comp, resi, base_x,
                              base_y)

    def _add_tu_resi(self, px, py, log2, tr_depth, comp, resi, base_x, base_y,
                     chroma_from_parent=False, sub422=None):
        pic = self.pic
        sx, sy = pic.comp_shift[comp]
        anchor_py = py
        if comp == 0:
            size = 1 << log2
            x0, y0 = px * 4, py * 4
        else:
            size = (1 << log2) >> sx
            x0, y0 = (px * 4) >> sx, (py * 4) >> sy
            if sub422 is not None:
                y0 += sub422 * size
                anchor_py = py + sub422 * max((1 << (log2 - 2)) >> 1, 1)
        cbf_depth = tr_depth - (1 if chroma_from_parent else 0)
        cbf = (int(pic.cbf[comp][anchor_py, px]) >> cbf_depth) & 1
        blk = None
        if cbf:
            levels = pic.coeff[comp][y0:y0 + size, x0:x0 + size]
            blk = self._inv_transform_block(levels, px, anchor_py, comp,
                                            self.bit_depth[comp])
        if comp > 0 and self.pps.cross_component_prediction_enabled:
            alpha = int(pic.ccp_alpha[comp][py, px])
            if alpha:
                ox, oy = self._ccp_origin
                lresi = self._ccp_luma_resi[y0 - oy:y0 - oy + size,
                                            x0 - ox:x0 - ox + size]
                term = (alpha * lresi) >> 3
                blk = term if blk is None else blk + term
        if blk is not None:
            resi[y0 - base_y:y0 - base_y + size,
                 x0 - base_x:x0 - base_x + size] += blk

    def _recon_intra_cu(self, cu_px, cu_py, cu_log2):
        # luma TU walk, then chroma TU walk (channel recon is independent;
        # 4:4:4 CCP reads the luma residual captured during the luma pass)
        if self.pps.cross_component_prediction_enabled:
            s = 1 << cu_log2
            self._ccp_luma_resi = np.zeros((s, s), dtype=np.int64)
            self._ccp_origin = (cu_px * 4, cu_py * 4)
        self._recon_tu_tree(cu_px, cu_py, cu_px, cu_py, cu_log2, 0, comp=0)
        if self.pic.num_comps > 1:
            self._recon_tu_tree(cu_px, cu_py, cu_px, cu_py, cu_log2, 0, comp=1)
            self._recon_tu_tree(cu_px, cu_py, cu_px, cu_py, cu_log2, 0, comp=2)

    def _recon_tu_tree(self, cu_px, cu_py, px, py, log2, tr_depth, comp):
        pic = self.pic
        is422 = comp > 0 and self.sps.chroma_format_idc == 2
        if int(pic.tr_idx[py, px]) > tr_depth:
            if comp > 0 and log2 == 3 and pic.comp_shift[comp][0] == 1:
                # subsampled chroma stays at the 8x8 parent (luma children
                # are 4x4); 4:2:2 codes it as two square 4x4 sub-TUs
                if is422:
                    for sub in range(2):
                        self._recon_intra_tu(cu_px, cu_py, px, py, log2,
                                             tr_depth + 2, comp, sub422=sub)
                else:
                    self._recon_intra_tu(cu_px, cu_py, px, py, log2,
                                         tr_depth + 1, comp,
                                         chroma_from_parent=True)
                return
            half = 1 << (log2 - 3)
            for sub in range(4):
                self._recon_tu_tree(cu_px, cu_py, px + (sub & 1) * half,
                                    py + (sub >> 1) * half, log2 - 1,
                                    tr_depth + 1, comp)
            return
        if is422:
            for sub in range(2):
                self._recon_intra_tu(cu_px, cu_py, px, py, log2,
                                     tr_depth + 1, comp, sub422=sub)
        else:
            self._recon_intra_tu(cu_px, cu_py, px, py, log2, tr_depth, comp)

    def _tu_qp(self, px, py, comp):
        """QpParam (TComTrQuant.cpp:~100): luma/chroma QP derivation."""
        sps, pps, sh = self.sps, self.pps, self.sh
        qpy = int(self.pic.qp[py, px])
        if comp == 0:
            bd_offset = 6 * (sps.bit_depth_luma - 8)
            return qpy + bd_offset
        bd_offset = 6 * (sps.bit_depth_chroma - 8)
        off = (pps.cb_qp_offset + sh.cb_qp_offset) if comp == 1 else \
            (pps.cr_qp_offset + sh.cr_qp_offset)
        base = int(np.clip(qpy + off, -bd_offset, 57))
        if base < 0:
            return base + bd_offset
        from hevcref.common.tables import CHROMA_QP_SCALE
        return int(CHROMA_QP_SCALE[sps.chroma_format_idc][base]) + bd_offset

    def _recon_intra_tu(self, cu_px, cu_py, px, py, log2, tr_depth, comp,
                        chroma_from_parent=False, sub422=None):
        pic, sps = self.pic, self.sps
        sx, sy = pic.comp_shift[comp]
        anchor_py = py
        if comp == 0:
            size = 1 << log2
            x0, y0 = px * 4, py * 4
            mode = int(pic.intra_luma[py, px])
            bd = sps.bit_depth_luma
        else:
            size = (1 << log2) >> sx
            x0, y0 = (px * 4) >> sx, (py * 4) >> sy
            mode = self._chroma_final_mode_for_recon(px, py)
            bd = sps.bit_depth_chroma
            if sub422 is not None:
                # square sub-TU of the double-high 4:2:2 chroma block; the
                # lower half anchors at the TU's lower luma parts so its
                # top neighbours (the upper half) count as available
                y0 += sub422 * size
                anchor_py = py + sub422 * max((1 << (log2 - 2)) >> 1, 1)
        rec = pic.rec[comp]
        is_luma = comp == 0

        # reference sample assembly with availability
        unit_w = 4 >> (sx if comp else 0)
        unit_h = 4 >> (sy if comp else 0)
        constrained = bool(self.pps.constrained_intra_pred)

        blk_parts = max((1 << log2) >> 2, 1)   # TU span in luma parts
        blk_parts_h = blk_parts if sub422 is None else \
            max(blk_parts >> 1, 1)

        def avail(ax, ay):
            # ax, ay in this component's plane coords (may be -1)
            if ax < 0 or ay < 0:
                return False
            lx, ly = ax << (sx if comp else 0), ay << (sy if comp else 0)
            npx, npy = lx // 4, ly // 4
            return pic.part_available(npx, npy, px, anchor_py, constrained,
                                      blk_parts, blk_parts_h)

        top, left = intra_ref.fill_reference_samples(
            rec, x0, y0, size, unit_w, unit_h, avail, bd)
        use_filter = intra_ref.should_filter(
            mode, size, is_luma, sps.chroma_format_idc,
            bool(sps.intra_smoothing_disabled))
        if use_filter:
            # strong bilinear smoothing is LUMA-ONLY (TComPattern.cpp:196
            # isLuma(chType) gate); 4:4:4 chroma gets only [1 2 1]
            top, left = intra_ref.filter_reference_samples(
                top, left, size, bd,
                bool(sps.strong_intra_smoothing) and is_luma)
        pred = intra_ref.predict_intra(mode, top, left, size, bd, is_luma,
                                       enable_edge_filters=True)

        # residual
        cbf_depth = tr_depth - (1 if chroma_from_parent else 0)
        cbf = (int(pic.cbf[comp][anchor_py, px]) >> cbf_depth) & 1
        if cbf:
            levels = pic.coeff[comp][y0:y0 + size, x0:x0 + size]
            resi = self._inv_transform_block(levels, px, anchor_py, comp, bd)
        else:
            resi = np.zeros((size, size), dtype=np.int64)
        if self.pps.cross_component_prediction_enabled:
            ox, oy = self._ccp_origin
            if comp == 0:
                self._ccp_luma_resi[y0 - oy:y0 - oy + size,
                                    x0 - ox:x0 - ox + size] = resi
            else:
                alpha = int(pic.ccp_alpha[comp][py, px])
                if alpha:
                    lresi = self._ccp_luma_resi[y0 - oy:y0 - oy + size,
                                                x0 - ox:x0 - ox + size]
                    resi = resi + ((alpha * lresi) >> 3)
        rec[y0:y0 + size, x0:x0 + size] = np.clip(
            pred + resi, 0, (1 << bd) - 1)

    def _chroma_final_mode_for_recon(self, px, py):
        pic = self.pic
        mode = int(pic.intra_chroma[py, px])
        if mode == DM_CHROMA_IDX:
            mode = int(pic.intra_luma[py, px])
        if self.sps.chroma_format_idc == 2:
            mode = int(CHROMA422_ANGLE_MAP[mode])
        return mode

    def _rdpcm_mode_of(self, px, py, comp):
        """Effective RDPCM mode (0=hor, 1=ver, -1=off) for a TS/bypass TU."""
        pic, sps = self.pic, self.sps
        if pic.pred_mode[py, px] == MODE_INTRA:
            if not sps.implicit_rdpcm:
                return -1
            mode = int(pic.intra_luma[py, px]) if comp == 0 else \
                self._chroma_final_mode_for_recon(px, py)
            if mode == HOR_IDX:
                return 0
            if mode == VER_IDX:
                return 1
            return -1
        if not sps.explicit_rdpcm:
            return -1
        return int(pic.rdpcm_mode[comp][py, px])

    @staticmethod
    def _apply_rdpcm(resi, mode):
        if mode == 0:     # horizontal: cumulative sum along x
            return np.cumsum(resi, axis=1)
        if mode == 1:
            return np.cumsum(resi, axis=0)
        return resi

    def _inv_transform_block(self, levels, px, py, comp, bd):
        """invTransformNxN: dequant + inverse DCT/DST, transform-skip or
        transquant bypass, with RExt residual rotation and RDPCM."""
        pic, sps = self.pic, self.sps
        size = levels.shape[0]
        log2_tr = size.bit_length() - 1
        # rotation only applies to 4x4 INTRA non-transformed blocks
        # (TComTU::isNonTransformedResidualRotated, TComTU.cpp:227)
        rotate = bool(sps.transform_skip_rotation) and size == 4 and \
            pic.pred_mode[py, px] == MODE_INTRA
        if pic.tqb[py, px]:
            r = levels.astype(np.int64)
            if rotate:
                r = r[::-1, ::-1].copy()
            return self._apply_rdpcm(r, self._rdpcm_mode_of(px, py, comp))
        qp = self._tu_qp(px, py, comp)
        max_dr = sps.max_tr_dynamic_range(comp != 0)
        scaling = None
        if sps.scaling_list_enabled:
            scaling = self._scaling_list_for(comp, log2_tr, px, py)
        deq = transforms_ref.dequant(levels, qp, bd, log2_tr, scaling,
                                     bool(pic.tskip[comp][py, px]), max_dr)
        if pic.tskip[comp][py, px]:
            r = transforms_ref.inverse_transform_skip(
                deq[::-1, ::-1] if rotate else deq, bd, max_dr)
            return self._apply_rdpcm(r, self._rdpcm_mode_of(px, py, comp))
        use_dst = (comp == 0 and size == 4 and
                   pic.pred_mode[py, px] == MODE_INTRA)
        return transforms_ref.inverse_transform(deq, bd, use_dst, max_dr)

    def _scaling_list_for(self, comp, log2_tr, px, py):
        """Per-coefficient scaling matrix for this TU (flat, raster order).

        HM xSetScalingListDec/processScalingListDec: >=16x16 lists are coded
        as 8x8 + DC and up-sampled by pixel repetition.
        """
        size_id = log2_tr - 2
        is_intra = self.pic.pred_mode[py, px] == MODE_INTRA
        list_id = (0 if is_intra else 3) + comp
        key = (size_id, list_id)
        cache = getattr(self, "_sl_cache", None)
        if cache is None:
            cache = self._sl_cache = {}
        if key in cache:
            return cache[key]
        sl = None
        if self.pps.scaling_list_present:
            sl = self.pps.scaling_list
        elif self.sps.scaling_list_present:
            sl = self.sps.scaling_list
        from hevcref.headers.params import default_scaling_list_coeffs
        if sl is not None and (size_id, list_id) in sl.lists:
            coefs = sl.lists[(size_id, list_id)]
            dc = sl.dc.get((size_id, list_id), 16)
        else:
            coefs = default_scaling_list_coeffs(size_id, list_id)
            dc = 16
        size = 1 << log2_tr
        if size_id <= 1:
            mat = coefs.reshape(size, size).copy()
        else:
            ratio = size // 8
            base = coefs.reshape(8, 8)
            mat = np.repeat(np.repeat(base, ratio, 0), ratio, 1).copy()
            mat[0, 0] = dc
        flat = mat.astype(np.int64).ravel()
        cache[key] = flat
        return flat

    @staticmethod
    def _sig_cg_ctx(sig_cg, cgx, cgy, wg, hg):
        right = sig_cg[cgy * wg + cgx + 1] if cgx < wg - 1 else 0
        lower = sig_cg[(cgy + 1) * wg + cgx] if cgy < hg - 1 else 0
        return 1 if (right + lower) else 0

    @staticmethod
    def _pattern_sig_ctx(sig_cg, cgx, cgy, wg, hg):
        if wg <= 1 and hg <= 1:
            return 0
        right = int(sig_cg[cgy * wg + cgx + 1] != 0) if cgx < wg - 1 else 0
        lower = int(sig_cg[(cgy + 1) * wg + cgx] != 0) if cgy < hg - 1 else 0
        return right + (lower << 1)

    @staticmethod
    def _sig_ctx(pattern, scan, scan_pos, log2w, log2h, chan, first_ctx, single):
        if single:
            return SIG_CTX_SET_START[chan][3]
        raster = int(scan[scan_pos])
        pos_y = raster >> log2w
        pos_x = raster - (pos_y << log2w)
        if pos_x + pos_y == 0:
            return 0
        if log2w == 2 and log2h == 2:
            offset = int(CTX_IND_MAP_4x4[4 * pos_y + pos_x])
        else:
            if pattern == 0:
                pxs = pos_x & 3
                pys = pos_y & 3
                total = pxs + pys
                cnt = 0 if total >= 3 else (1 if total >= 1 else 2)
            elif pattern == 1:
                pys = pos_y & 3
                cnt = 0 if pys >= 2 else (1 if pys >= 1 else 2)
            elif pattern == 2:
                pxs = pos_x & 3
                cnt = 0 if pxs >= 2 else (1 if pxs >= 1 else 2)
            else:
                cnt = 2
            not_first_group = (pos_x >> 2) + (pos_y >> 2) > 0
            offset = (NOT_FIRST_GROUP_CTX_OFFSET[chan] if not_first_group else 0) + cnt
        return first_ctx + offset

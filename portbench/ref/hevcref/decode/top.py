"""Top-level decoder: NAL dispatch, slice decoding, hash verification.

Dual of HM TDecTop.cpp:687 (NAL dispatch) / TDecSlice.cpp:69-253 (CTU loop) /
TDecGop.cpp:207-260 (decoded-picture-hash check).  Single-picture DPB logic
for now (AI); full RPS-driven DPB lands with the inter stage.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from hevcref.bitstream.bitio import (
    BitReader, split_annexb, strip_emulation_prevention,
    strip_emulation_prevention_pos)
from hevcref.bitstream.cabac import ByteFifo, CabacDecoder
from hevcref.decode.ctu_dec import SliceDecoder
from hevcref.decode.mvpred import MvPredictor, RefCtx
from hevcref.decode.picture import PictureState
from hevcref.decode.loopfilter import apply_loop_filters
from hevcref.decode.refpics import DPB, RefPicture, build_ref_lists
from hevcref.headers import params as P
from hevcref.headers.parse import (
    parse_pps, parse_slice_header, parse_sps, parse_vps)


@dataclass
class DecodedPicture:
    poc: int
    planes: list
    hash_ok: bool | None = None


@dataclass
class SEIHash:
    method: int = 0
    digests: list = field(default_factory=list)


def parse_sei_rbsp(rbsp: bytes) -> list[tuple[int, bytes]]:
    """SEI message list: (payload_type, payload_bytes)."""
    out = []
    br = BitReader(rbsp)
    while True:
        ptype = 0
        b = br.u(8)
        while b == 255:
            ptype += 255
            b = br.u(8)
        ptype += b
        psize = 0
        b = br.u(8)
        while b == 255:
            psize += 255
            b = br.u(8)
        psize += b
        start = br.pos // 8
        payload = rbsp[start:start + psize]
        out.append((ptype, payload))
        br.pos = (start + psize) * 8
        if br.bits_left() <= 8:
            break
    return out


def parse_picture_hash_sei(payload: bytes) -> SEIHash:
    method = payload[0]
    digests = []
    pos = 1
    n = 16 if method == 0 else (2 if method == 1 else 4)
    while pos + n <= len(payload):
        digests.append(payload[pos:pos + n])
        pos += n
    return SEIHash(method, digests)


def picture_md5(planes, bit_depths) -> list[bytes]:
    """Per-plane MD5 (TComPicYuvMD5.cpp:127: LE bytes per sample)."""
    out = []
    for plane, bd in zip(planes, bit_depths):
        m = hashlib.md5()
        data = np.ascontiguousarray(plane, dtype=np.uint8 if bd <= 8
                                    else np.uint16)
        m.update(data.tobytes())   # numpy LE on this platform
        out.append(m.digest())
    return out


def picture_crc(planes, bit_depths) -> list[bytes]:
    """Per-plane CRC-16/CCITT (TComPicYuvMD5.cpp:149 compCRC).

    HM shifts sample bits in at the register LSB and flushes 16 zero bits:
    algebraically CRC = (M(x)*x^16 + 0xFFFF*x^(n+16)) mod g, which equals
    the MSB-first table CRC (binascii.crc_hqx) over the sample bytes
    low-byte-first with init 0x1D0F (= 0xFFFF*x^16 mod g)."""
    import binascii
    out = []
    for plane, bd in zip(planes, bit_depths):
        data = np.ascontiguousarray(plane, dtype=np.uint8 if bd <= 8
                                    else np.dtype("<u2"))
        crc = binascii.crc_hqx(data.tobytes(), 0x1D0F)
        out.append(bytes([(crc >> 8) & 0xFF, crc & 0xFF]))
    return out


def picture_checksum(planes, bit_depths) -> list[bytes]:
    """Per-plane position-xor checksum (TComPicYuvMD5.cpp:~183
    compChecksum): sum over samples of (byte ^ xor_mask) mod 2^32 where
    xor_mask = (x&0xff)^(y&0xff)^(x>>8)^(y>>8)."""
    out = []
    for plane, bd in zip(planes, bit_depths):
        p = np.asarray(plane, dtype=np.uint32)
        h, w = p.shape
        xs = np.arange(w, dtype=np.uint32)
        ys = np.arange(h, dtype=np.uint32)
        mask = ((xs & 0xFF) ^ (xs >> 8))[None, :] ^ \
               ((ys & 0xFF) ^ (ys >> 8))[:, None]
        total = int(((p & 0xFF) ^ mask).sum(dtype=np.uint64))
        if bd > 8:
            total += int(((p >> 8) ^ mask).sum(dtype=np.uint64))
        total &= 0xFFFFFFFF
        out.append(total.to_bytes(4, "big"))
    return out


class Decoder:
    def __init__(self):
        self.sps_map: dict[int, P.SPS] = {}
        self.pps_map: dict[int, P.PPS] = {}
        self.prev_tid0_poc = 0
        self.cur_pic: PictureState | None = None
        self.pending_hash: SEIHash | None = None
        self.outputs: list[DecodedPicture] = []
        self.hash_failures = 0
        self.dpb = DPB()
        # random-access skip (TDecTop::isRandomAccessSkipPicture): when the
        # stream starts at a CRA/BLA, its RASL leading pictures reference
        # pictures before the random-access point and must be dropped
        self._seen_irap = False
        self._skip_rasl = False
        self._last_vcl_skipped = False
        # C.5.2 output-order bumping state
        self._reorder: list[DecodedPicture] = []
        self.display: list[DecodedPicture] = []
        # dependent slice segments: owner slice index + saved CABAC state
        self._slice_owner_idx = 0
        self._dss_ctx = None

    # ------------------------------------------------------------------

    def decode_stream(self, data: bytes) -> list[DecodedPicture]:
        for nal in split_annexb(data):
            self.decode_nal(nal)
        self.flush()
        return self.outputs

    def flush(self):
        """End-of-stream: finish the open picture and drain the reorder
        buffer in POC order (TAppDecTop::xFlushOutput)."""
        self._finish_picture()
        for dp in sorted(self._reorder, key=lambda d: d.poc):
            self.display.append(dp)
        self._reorder.clear()

    def decode_nal(self, nal: bytes):
        nal_type = (nal[0] >> 1) & 63
        temporal_id = (nal[1] & 7) - 1
        rbsp, ep_pos = strip_emulation_prevention_pos(nal[2:])
        if nal_type == P.NAL_VPS:
            parse_vps(BitReader(rbsp))
        elif nal_type == P.NAL_SPS:
            s = parse_sps(BitReader(rbsp))
            self.sps_map[s.sps_id] = s
        elif nal_type == P.NAL_PPS:
            p = parse_pps(BitReader(rbsp))
            self.pps_map[p.pps_id] = p
        elif nal_type in (P.NAL_SEI_PREFIX, P.NAL_SEI_SUFFIX):
            for ptype, payload in parse_sei_rbsp(rbsp):
                if ptype == 132:  # decoded picture hash
                    if self._last_vcl_skipped:
                        continue         # hash of a skipped (RASL) picture
                    self.pending_hash = parse_picture_hash_sei(payload)
                    self._check_hash()
        elif nal_type <= 31:   # VCL
            self._decode_slice(nal_type, temporal_id, rbsp, ep_pos)

    # ------------------------------------------------------------------

    def _decode_slice(self, nal_type, temporal_id, rbsp, ep_pos=None):
        br = BitReader(rbsp)
        sh = parse_slice_header(br, nal_type, temporal_id, self.sps_map,
                                self.pps_map, self.prev_tid0_poc,
                                ep_byte_positions=ep_pos)
        if not self._seen_irap:
            if not P.is_irap(nal_type):
                self._last_vcl_skipped = True
                return                       # broken leading data pre-IRAP
            self._seen_irap = True
            if P.is_cra(nal_type) or P.is_bla(nal_type):
                self._skip_rasl = True       # drop this IRAP's RASLs
        if self._skip_rasl and P.is_rasl(nal_type):
            self._last_vcl_skipped = True
            return
        if not P.is_rasl(nal_type) and not P.is_irap(nal_type):
            self._skip_rasl = False
        self._last_vcl_skipped = False
        if sh.first_slice_in_pic:
            self._finish_picture()
            if P.is_idr(nal_type):
                self.dpb.clear()
            self.cur_pic = PictureState(sh.sps, sh.pps)
            self.cur_pic.poc = sh.poc
            self.cur_pic.temporal_id = temporal_id
            self.cur_pic.is_irap = P.is_irap(nal_type)
        pic = self.cur_pic
        if sh.dependent_slice_segment:
            # dependent slice segment (7.4.7.1): every field the short
            # header doesn't carry is inherited from the preceding slice
            # segment; in-picture prediction continues across the boundary
            import copy as _copy
            prev = pic.slices[-1]
            inh = _copy.copy(prev)
            inh.first_slice_in_pic = 0
            inh.dependent_slice_segment = 1
            inh.segment_address = sh.segment_address
            inh.entry_point_offsets = sh.entry_point_offsets
            inh.nal_type = sh.nal_type
            sh = inh
        pic.slices.append(sh)
        if temporal_id == 0 and not P.is_rasl(nal_type) and \
                not P.is_radl(nal_type) and P.is_reference_nal(nal_type):
            self.prev_tid0_poc = sh.poc

        slice_idx = len(pic.slices) - 1
        if sh.dependent_slice_segment:
            # segments of one slice share the owner's index so intra/merge
            # availability and SAO merge cross dependent boundaries
            slice_idx = self._slice_owner_idx
        else:
            self._slice_owner_idx = slice_idx
        sd = SliceDecoder(pic, sh, slice_idx)
        ref_lists = build_ref_lists(sh, self.dpb)
        rc = RefCtx(sh, ref_lists)
        sd.mvp = MvPredictor(pic, rc, slice_idx)
        data_start = br.pos // 8

        # substream starts: entry-point offsets are already converted to
        # unescaped sizes by the header parser (TDecGop.cpp:122)
        wpp = bool(sh.pps.entropy_coding_sync)
        starts = [data_start]
        for size in sh.entry_point_offsets:
            starts.append(starts[-1] + size)

        if sh.dependent_slice_segment and self._dss_ctx is not None:
            # CABAC contexts continue from the end of the previous slice
            # segment (9.3.1 TableStateIdxDs; HM
            # m_lastSliceSegmentEndContextState)
            sd.ctx = self._dss_ctx.copy()
        else:
            sd.ctx = sd.init_contexts()
        sd.dec = CabacDecoder(ByteFifo(rbsp, starts[0]), sd.ctx)

        tiles = pic.tiles
        w_ctbs = pic.w_ctbs
        n_ctus = w_ctbs * pic.h_ctbs
        ctu_ts = sh.segment_address       # tile-scan CTB address (7.4.7.1)
        sub_idx = 0
        wpp_saved = None         # ctx after 2nd CTU of the row (TDecSlice:212)
        prev_tile = None
        while ctu_ts < n_ctus:
            ctu_rs = int(tiles.ctu_ts_to_rs[ctu_ts])
            cx, cy = ctu_rs % w_ctbs, ctu_rs // w_ctbs
            tile_id = int(tiles.tile_of_ctu[cy, cx])
            tile_x0 = max(b for b in tiles.col_bounds if b <= cx)
            new_tile = prev_tile is not None and tile_id != prev_tile
            row_start = wpp and cx == tile_x0 and prev_tile is not None \
                and not new_tile
            if new_tile or row_start:
                # next substream; WPP loads the saved top-right state,
                # tiles reset (TDecSlice.cpp:134-165)
                sub_idx += 1
                if sub_idx < len(starts):
                    sd.dec = CabacDecoder(ByteFifo(rbsp, starts[sub_idx]),
                                          sd.ctx)
                if new_tile:
                    sd.ctx.load(sd.init_contexts())
                    wpp_saved = None
                elif wpp_saved is not None:
                    sd.ctx.load(wpp_saved)
                else:
                    sd.ctx.load(sd.init_contexts())
            prev_tile = tile_id
            if sh.sps.sao_enabled and (sh.sao_luma or sh.sao_chroma):
                left_ok = cx > 0 and self._ctu_same_slice_tile(pic, ctu_rs, ctu_rs - 1, slice_idx)
                above_ok = cy > 0 and self._ctu_same_slice_tile(pic, ctu_rs, ctu_rs - w_ctbs, slice_idx)
                sd.parse_sao(ctu_rs, left_ok, above_ok)
            end = sd.decode_ctu(cx, cy)
            sd.reconstruct_ctu(cx, cy)
            if wpp and cx == tile_x0 + 1:
                wpp_saved = sd.ctx.copy()
            ctu_ts += 1
            if end:
                break
        if sh.pps.dependent_slice_segments_enabled:
            self._dss_ctx = sd.ctx.copy()

    @staticmethod
    def _ctu_same_slice_tile(pic, cur_rs, other_rs, slice_idx):
        parts = pic.ctb // 4
        ox, oy = (other_rs % pic.w_ctbs) * parts, (other_rs // pic.w_ctbs) * parts
        if not pic.coded[oy, ox]:
            return False
        if pic.slice_id[oy, ox] != slice_idx:
            return False
        return pic.tiles.tile_of_ctu.flat[other_rs] == \
            pic.tiles.tile_of_ctu.flat[cur_rs]

    # ------------------------------------------------------------------

    def _finish_picture(self):
        if self.cur_pic is None:
            return
        pic = self.cur_pic
        apply_loop_filters(pic)
        bds = [pic.sps.bit_depth_luma] + \
            [pic.sps.bit_depth_chroma] * (pic.num_comps - 1)
        planes = [pic.crop_output(c) for c in range(pic.num_comps)]
        self.outputs.append(DecodedPicture(pic.poc, planes))
        # retain for reference: coded-size planes (MC border-replicates from
        # the true picture edge, not the CTU padding)
        sps = pic.sps
        ref_planes = []
        for c in range(pic.num_comps):
            sx, sy = pic.comp_shift[c]
            ref_planes.append(pic.rec[c][: sps.pic_height >> sy,
                                         : sps.pic_width >> sx].copy())
        self.dpb.add(RefPicture(
            poc=pic.poc, rec=ref_planes, mv=pic.mv.copy(),
            ref_idx=pic.ref_idx.copy(), ref_poc=pic.ref_poc.copy(),
            pred_mode=pic.pred_mode.copy(),
            is_b_slice=any(s.slice_type == P.B_SLICE for s in pic.slices)))
        self.cur_pic = None
        self._check_hash()
        # C.5.2 bumping: emit in POC order once the reorder buffer exceeds
        # the SPS reorder allowance (TAppDecTop::xWriteOutput)
        self._reorder.append(self.outputs[-1])
        reorder_max = sps.num_reorder_pics[-1] if sps.num_reorder_pics else 0
        while len(self._reorder) > reorder_max:
            nxt = min(self._reorder, key=lambda d: d.poc)
            self._reorder.remove(nxt)
            self.display.append(nxt)

    def _check_hash(self):
        if self.pending_hash is None or not self.outputs:
            return
        dp = self.outputs[-1]
        if dp.hash_ok is not None:
            return
        pic_bds = [8] * len(dp.planes)
        # bit depths from the active SPS of the last picture
        sps = next(iter(self.sps_map.values()))
        pic_bds = [sps.bit_depth_luma] + [sps.bit_depth_chroma] * (len(dp.planes) - 1)
        fn = (picture_md5, picture_crc,
              picture_checksum)[self.pending_hash.method]
        ours = fn(dp.planes, pic_bds)
        dp.hash_ok = ours == self.pending_hash.digests
        if dp.hash_ok is False:
            self.hash_failures += 1
        self.pending_hash = None

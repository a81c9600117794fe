"""Picture-level decode state.

TPU-first data model: instead of HM's per-CTU TComDataCU objects with
neighbor pointers (TComDataCU.h:86-141), all per-4x4-part syntax state lives
in dense picture-wide numpy arrays indexed [part_y, part_x].  Neighbor
queries become array reads; availability (spec 6.4.1) is a pure function of
z-scan coding order, slice id and tile id.  This layout is exactly what the
batched TPU reconstruction kernels consume.
"""

from __future__ import annotations

import numpy as np

from hevcref.common.tables import RASTER_TO_ZSCAN_16, ZSCAN_TO_RASTER_16
from hevcref.headers.params import PPS, SPS, SliceHeader

MODE_INTER, MODE_INTRA = 0, 1
SIZE_2Nx2N, SIZE_2NxN, SIZE_Nx2N, SIZE_NxN = 0, 1, 2, 3
SIZE_2NxnU, SIZE_2NxnD, SIZE_nLx2N, SIZE_nRx2N = 4, 5, 6, 7


class Tiles:
    """Tile partitioning (TComPicSym::initTiles / xInitTiles)."""

    def __init__(self, sps: SPS, pps: PPS):
        w_ctbs, h_ctbs = sps.pic_width_in_ctbs, sps.pic_height_in_ctbs
        nc, nr = pps.num_tile_cols, pps.num_tile_rows
        if pps.uniform_spacing:
            col_bounds = [(i * w_ctbs) // nc for i in range(nc + 1)]
            row_bounds = [(i * h_ctbs) // nr for i in range(nr + 1)]
        else:
            cw = list(pps.tile_col_widths)
            cw.append(w_ctbs - sum(cw))
            rh = list(pps.tile_row_heights)
            rh.append(h_ctbs - sum(rh))
            col_bounds = np.concatenate([[0], np.cumsum(cw)]).tolist()
            row_bounds = np.concatenate([[0], np.cumsum(rh)]).tolist()
        self.col_bounds, self.row_bounds = col_bounds, row_bounds
        self.w_ctbs, self.h_ctbs = w_ctbs, h_ctbs
        # tile id per CTU (raster)
        self.tile_of_ctu = np.zeros((h_ctbs, w_ctbs), dtype=np.int32)
        for ty in range(nr):
            for tx in range(nc):
                self.tile_of_ctu[row_bounds[ty]:row_bounds[ty + 1],
                                 col_bounds[tx]:col_bounds[tx + 1]] = ty * nc + tx
        # CTU tile-scan order (raster within tile, tiles in raster order)
        order = []
        for ty in range(nr):
            for tx in range(nc):
                for y in range(row_bounds[ty], row_bounds[ty + 1]):
                    for x in range(col_bounds[tx], col_bounds[tx + 1]):
                        order.append(y * w_ctbs + x)
        self.ctu_ts_to_rs = np.array(order, dtype=np.int64)
        self.ctu_rs_to_ts = np.zeros_like(self.ctu_ts_to_rs)
        self.ctu_rs_to_ts[self.ctu_ts_to_rs] = np.arange(len(order))


class PictureState:
    """All decode-side state for one picture."""

    def __init__(self, sps: SPS, pps: PPS):
        self.sps, self.pps = sps, pps
        self.w, self.h = sps.pic_width, sps.pic_height
        self.ctb = sps.ctb_size
        self.log2_ctb = sps.log2_ctb
        self.w_ctbs = sps.pic_width_in_ctbs
        self.h_ctbs = sps.pic_height_in_ctbs
        # 4x4 part grid covering the padded (CTU-aligned) picture
        self.pw = self.w_ctbs * (self.ctb // 4)
        self.ph = self.h_ctbs * (self.ctb // 4)
        shp = (self.ph, self.pw)
        self.depth = np.zeros(shp, dtype=np.int8)
        self.part_size = np.zeros(shp, dtype=np.int8)
        self.pred_mode = np.zeros(shp, dtype=np.int8)
        self.skip = np.zeros(shp, dtype=np.int8)
        self.merge_flag = np.zeros(shp, dtype=np.int8)
        self.tqb = np.zeros(shp, dtype=np.int8)
        self.ipcm = np.zeros(shp, dtype=np.int8)
        self.intra_luma = np.zeros(shp, dtype=np.int16)
        self.intra_chroma = np.zeros(shp, dtype=np.int16)
        self.qp = np.zeros(shp, dtype=np.int16)
        self.slice_id = np.full(shp, -1, dtype=np.int32)
        self.coded = np.zeros(shp, dtype=bool)
        self.cbf = {c: np.zeros(shp, dtype=np.uint8) for c in range(3)}
        self.tr_idx = np.zeros(shp, dtype=np.int8)
        self.tskip = {c: np.zeros(shp, dtype=np.int8) for c in range(3)}
        # RExt: cross-component prediction alphas, explicit RDPCM modes
        self.ccp_alpha = {c: np.zeros(shp, dtype=np.int8) for c in (1, 2)}
        self.rdpcm_mode = {c: np.full(shp, -1, dtype=np.int8) for c in range(3)}
        # inter fields
        self.inter_dir = np.zeros(shp, dtype=np.int8)
        self.mv = np.zeros((2,) + shp + (2,), dtype=np.int32)      # [list][py][px][xy]
        self.ref_idx = np.full((2,) + shp, -1, dtype=np.int8)
        self.mvp_idx = np.zeros((2,) + shp, dtype=np.int8)
        # POC of the picture referenced by each part (INT_MIN when none)
        self.ref_poc = np.full((2,) + shp, -(10 ** 9), dtype=np.int32)
        # encode-side: signalled MV differences (decoder ignores)
        self.mvd = np.zeros((2,) + shp + (2,), dtype=np.int32)

        self.tiles = Tiles(sps, pps)
        csx, csy = sps.chroma_shift_x, sps.chroma_shift_y
        self.comp_shift = [(0, 0), (csx, csy), (csx, csy)]
        self.num_comps = 1 if sps.chroma_format_idc == 0 else 3
        # planes are CTU-aligned padded; cropped on output
        pad_w, pad_h = self.pw * 4, self.ph * 4
        self.rec = []
        self.coeff = []
        for c in range(self.num_comps):
            sx, sy = self.comp_shift[c]
            self.rec.append(np.zeros((pad_h >> sy, pad_w >> sx), dtype=np.int32))
            self.coeff.append(np.zeros((pad_h >> sy, pad_w >> sx), dtype=np.int32))
        # SAO parameters per CTU: mode/type/offsets/band per component
        n_ctu = self.w_ctbs * self.h_ctbs
        self.sao_mode = np.zeros((n_ctu, 3), dtype=np.int8)    # 0 off,1 new,2 merge-resolved
        self.sao_type = np.zeros((n_ctu, 3), dtype=np.int8)    # 0..3 EO class, 4=BO
        self.sao_offsets = np.zeros((n_ctu, 3, 4), dtype=np.int32)
        self.sao_band = np.zeros((n_ctu, 3), dtype=np.int32)
        # POC / metadata filled by top-level
        self.poc = 0
        self.temporal_id = 0
        self.slices: list[SliceHeader] = []
        self.is_reference = True
        self.is_irap = False
        self.output_flag = True
        self.prev_tid0_poc = 0

    # ---- coordinate helpers ----

    def part_z_global(self, px: int, py: int) -> int:
        """Global coding-order index of the 4x4 part at part coords."""
        parts = self.ctb // 4
        cx, cy = px // parts, py // parts
        ts = int(self.tiles.ctu_rs_to_ts[cy * self.w_ctbs + cx])
        z = int(RASTER_TO_ZSCAN_16[(py % parts) * 16 + (px % parts)]) \
            if parts == 16 else self._z_small(px % parts, py % parts, parts)
        return ts * parts * parts + z

    @staticmethod
    def _z_small(x, y, parts):
        """Morton/Z interleave for CTB sizes below 64 (parts < 16)."""
        z = 0
        for i in range(parts.bit_length() - 1):
            z |= ((x >> i) & 1) << (2 * i) | ((y >> i) & 1) << (2 * i + 1)
        return z

    def tile_of_part(self, px: int, py: int) -> int:
        parts = self.ctb // 4
        return int(self.tiles.tile_of_ctu[py // parts, px // parts])

    def part_available(self, px: int, py: int, cur_px: int, cur_py: int,
                       constrained_intra: bool = False,
                       blk_w: int = 1, blk_h: int = 1) -> bool:
        """Availability of part (px,py) for a block whose top-left part is
        (cur_px, cur_py) spanning blk_w x blk_h parts.

        Decode-order is compared against the block's corner part nearest the
        neighbor (HM anchors neighbor fetches at the PU/TU corner part:
        getPULeft(LB), getPUAboveRight(RT), ... TComDataCU.cpp:1040-1350);
        left/above-of-corner are then always earlier in z-order, while
        below-left/above-right get the exact z-precedence rule."""
        if px < 0 or py < 0 or px >= self.pw or py >= self.ph:
            return False
        # padded region beyond true picture bounds is never available
        if px * 4 >= self.w or py * 4 >= self.h:
            return False
        if not self.coded[py, px]:
            return False
        if self.slice_id[py, px] != self.slice_id[cur_py, cur_px]:
            return False
        if self.tile_of_part(px, py) != self.tile_of_part(cur_px, cur_py):
            return False
        ax = min(max(px, cur_px), cur_px + blk_w - 1)
        ay = min(max(py, cur_py), cur_py + blk_h - 1)
        if self.part_z_global(px, py) >= self.part_z_global(ax, ay):
            return False
        if constrained_intra and self.pred_mode[py, px] != MODE_INTRA:
            return False
        return True

    def crop_output(self, comp: int) -> np.ndarray:
        sx, sy = self.comp_shift[comp]
        l, r, t, b = self.sps.conformance_window  # in luma sample units
        plane = self.rec[comp][: self.h >> sy, : self.w >> sx]
        if any(self.sps.conformance_window):
            plane = plane[t >> sy: (self.h - b) >> sy,
                          l >> sx: (self.w - r) >> sx]
        return plane

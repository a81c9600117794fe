"""Encoder top level (TEncTop/TEncSlice/TEncCu analogue), All-Intra first.

Round-1 search: per-CTU batched intra mode decision — for each CU, all 35
prediction modes are evaluated (SATD cost on original-minus-prediction) and
the best is committed: forward transform, quantization, bit-exact
reconstruction (shared with the decoder), then CABAC syntax emission via
CtuEncoder.  The batched candidate evaluation is the seam where the
JAX/Pallas analysis kernels plug in (hm16_2_tpu_torch.ops.analysis).

Reference parity anchors: TEncCu.cpp:466 (xCompressCU), TEncSearch.cpp:2289
(estIntraPredQT), TEncSlice.cpp:640/910 (compress/encodeSlice),
TEncGOP.cpp:1666 (hash SEI).
"""

from __future__ import annotations

import os

import time

import numpy as np

from hm16_2_tpu_torch import trace as _trace
from hm16_2_tpu_torch.bitstream.bitio import (
    BitWriter, count_emulation_prevention, make_nal, write_annexb)
from hm16_2_tpu_torch.bitstream.cabac import CabacCounter, CabacEncoder, ContextSet
from hm16_2_tpu_torch.decode.loopfilter import apply_loop_filters
from hm16_2_tpu_torch.decode.mvpred import MvPredictor, RefCtx
from hm16_2_tpu_torch.decode.picture import (
    MODE_INTER, MODE_INTRA, PictureState, SIZE_2Nx2N, SIZE_2NxN,
    SIZE_Nx2N, SIZE_NxN)
from hm16_2_tpu_torch.decode.refpics import DPB, RefPicture, build_ref_lists
from hm16_2_tpu_torch.decode.top import picture_md5
from hm16_2_tpu_torch.encode.ctu_enc import CtuEncoder
from hm16_2_tpu_torch.headers import write as W
from hm16_2_tpu_torch.headers.params import (
    B_SLICE, I_SLICE, P_SLICE, NAL_CRA, NAL_IDR_N_LP, NAL_IDR_W_RADL,
    NAL_RADL_N, NAL_RADL_R, NAL_RASL_R, NAL_TRAIL_R, NAL_TSA_R, PPS, SPS,
    ShortTermRPS,
    SliceHeader, VPS, is_irap)
from hm16_2_tpu_torch.ops import interp_ref, intra_ref, transforms_ref
from hm16_2_tpu_torch.ops.intra_ref import DM_CHROMA_IDX
from hm16_2_tpu_torch.ops.satd import satd_block


class EncoderConfig:
    def __init__(self, width, height, qp=32, bit_depth=8, chroma_format=1,
                 intra_period=1, deblock=True, sao=True, rdo=True,
                 rdoq=True, gop="ld", sbd=True, rrsp=False,
                 target_bps=None, frame_rate=30, total_frames=0,
                 wpp=False, tile_cols=1, tile_rows=1, der=16, hash_type=0,
                 gop_table=None, weighted_pred=False, slices=1,
                 sei_timing=False, transform_skip=False,
                 aq=False, aq_strength=1.0, rc_ctu=False,
                 scaling_list=0, scaling_list_file=None,
                 sei_buffering_period=False, sei_recovery_point=False,
                 sei_frame_packing=-1, sei_display_orientation=-1,
                 sei_temporal_level0=False, sei_region_refresh=False,
                 sei_time_code=False, sei_mastering_display=False,
                 sei_tone_mapping=False, field_coding=False,
                 top_field_first=True, decoding_refresh_type=1,
                 dependent_slices=False, transquant_bypass=False,
                 pcm=False, pcm_log2_min=3, pcm_log2_max=5,
                 pcm_loop_filter_disabled=True, rext_tools=False,
                 cross_component_prediction=False, delta_qp_rd=0,
                 long_term_ref=False, deblock_beta_offset=0,
                 deblock_tc_offset=0, intra_smoothing_disabled=False,
                 level=0.0, tier_high=False):
        self.width, self.height = width, height
        self.qp = qp
        self.bit_depth = bit_depth
        self.chroma_format = chroma_format
        self.intra_period = intra_period
        self.deblock = deblock
        self.sao = sao
        self.rdo = rdo
        self.rdoq = rdoq             # rate-distortion optimized quant
        self.gop = gop               # "ld" (IPPP) or "ra8" (hierarchical B)
        self.sbd = sbd               # fork's similarity-based fast CU depths
        self.rrsp = rrsp             # fork's reduced-region partitioning
        self.target_bps = target_bps  # R-lambda rate control when set
        self.frame_rate = frame_rate
        self.total_frames = total_frames
        self.wpp = wpp               # entropy_coding_sync (one substream/row)
        self.tile_cols = tile_cols
        self.tile_rows = tile_rows
        self.der = der               # SBD strip parameter R (8/16/32/64)
        self.weighted_pred = weighted_pred   # slice WP (P slices)
        self.slices = slices         # slices per picture (equal CTU runs)
        self.sei_timing = sei_timing  # VUI timing + APS/pic-timing SEI
        self.transform_skip = transform_skip  # 4x4 TU tskip eval
        self.aq = aq                 # TM5 adaptive QP (per-CTU dQP)
        self.aq_strength = aq_strength
        self.scaling_list = scaling_list   # 0 off / 1 default / 2 file
        self.scaling_list_file = scaling_list_file
        self.sei_buffering_period = sei_buffering_period  # HRD + BP SEI
        self.sei_recovery_point = sei_recovery_point
        # display / info SEI suite (SEIwrite.cpp; headers/sei.py)
        self.sei_frame_packing = sei_frame_packing    # -1 off, else type
        self.sei_display_orientation = sei_display_orientation  # -1/angle
        self.sei_temporal_level0 = sei_temporal_level0
        self.sei_region_refresh = sei_region_refresh
        self.sei_time_code = sei_time_code
        self.sei_mastering_display = sei_mastering_display
        self.sei_tone_mapping = sei_tone_mapping
        self.slice_bytes = 0     # SliceMode 2: max bytes per slice
        # field coding (TEncGOP::compressGOP isField path,
        # TEncGOP.cpp:2370): the stream codes each field as a picture of
        # half height; width/height here stay FRAME dimensions
        self.field_coding = field_coding
        self.top_field_first = top_field_first
        # 1: CRA + RASL leading pictures, 2: IDR, 3: recovery-point I
        # (TRAIL_R I slice + recovery point SEI, no RAP)
        self.decoding_refresh_type = decoding_refresh_type
        self.dependent_slices = dependent_slices  # slices 2..N dependent
        # lossless: every CU coded with cu_transquant_bypass_flag = 1
        # (HM TransquantBypassEnableFlag + CUTransquantBypassFlagForce)
        self.transquant_bypass = transquant_bypass
        self.pcm = pcm               # IPCM mode search (PCMEnabledFlag)
        self.pcm_log2_min = pcm_log2_min
        self.pcm_log2_max = pcm_log2_max
        # high-throughput-RExt tool set (encoder_intra_high_throughput_
        # rext.cfg): residual rotation, TS single-significance context,
        # implicit/explicit RDPCM, persistent Golomb-Rice adaptation,
        # CABAC bypass alignment, HT-RExt profile signalling
        self.rext_tools = rext_tools
        # RExt cross-component prediction (4:4:4 only): per-TU alpha
        # predicting the chroma residual from the reconstructed luma
        # residual (TComTrQuant.cpp:3290)
        self.cross_component_prediction = cross_component_prediction
        # slice-level multi-QP optimization (HM DeltaQpRD /
        # TEncSlice::precompressSlice): trial-encode each picture at
        # qp-n..qp+n and keep the cheapest by SSE + lambda * bits
        self.delta_qp_rd = delta_qp_rd
        # keep the last IDR/anchor picture as a LONG-TERM reference in
        # every low-delay P slice (a golden frame; TEncGOP.cpp:2582
        # long-term handling + slice-header LT signalling)
        self.long_term_ref = long_term_ref
        # PPS-signalled deblocking offsets (LoopFilterBetaOffset_div2 /
        # LoopFilterTcOffset_div2 with LoopFilterOffsetInPPS semantics)
        self.deblock_beta_offset = deblock_beta_offset
        self.deblock_tc_offset = deblock_tc_offset
        # RExt IntraReferenceSmoothing=0 (sps_range_extension flag)
        self.intra_smoothing_disabled = intra_smoothing_disabled
        self.level = level           # general_level_idc = level * 30
        self.tier_high = tier_high
        self.pcm_loop_filter_disabled = pcm_loop_filter_disabled
        self.rc_ctu = rc_ctu         # CTU-level R-lambda RC (LCULevelRC)
        self.hash_type = hash_type   # decoded-picture-hash SEI: 0 MD5 / 1 CRC / 2 checksum
        # explicit GOPEntry table (TEncCfg.h:49-88) parsed from the cfg
        # file's FrameN lines; overrides the built-in ld/ra8 structures
        self.gop_table = gop_table
        self.log2_ctb = 6
        self.log2_min_cb = 3
        self.log2_min_tb = 2
        self.log2_max_tb = 5
        self.fixed_cu_log2 = 4       # 16x16 CUs (round-1 fixed partitioning)


# Random-access GOP-8 hierarchical-B structure (coding order within one GOP;
# mirrors the JCT-VC common-test-condition table in
# cfg/encoder_randomaccess_main.cfg:24-32 of the reference).
RA8_GOP = [
    dict(poc=8, qpoff=1, qpfac=0.442,  refs=(-8, -16), depth=0),
    dict(poc=4, qpoff=2, qpfac=0.3536, refs=(-4, 4), depth=1),
    dict(poc=2, qpoff=3, qpfac=0.3536, refs=(-2, 2, 6), depth=2),
    dict(poc=1, qpoff=4, qpfac=0.68,   refs=(-1, 1, 3, 7), depth=3),
    dict(poc=3, qpoff=4, qpfac=0.68,   refs=(-1, -3, 1, 5), depth=3),
    dict(poc=6, qpoff=3, qpfac=0.3536, refs=(-2, -6, 2), depth=2),
    dict(poc=5, qpoff=4, qpfac=0.68,   refs=(-1, -5, 1, 3), depth=3),
    dict(poc=7, qpoff=4, qpfac=0.68,   refs=(-1, -7, 1), depth=3),
]

# Low-delay P GOP-4 structure: per-slot QP offsets/factors and 4-reference
# RPS sets mirroring cfg/encoder_lowdelay_P_main.cfg:23-27 of the reference
LDP_GOP = [
    dict(poc=1, qpoff=5, qpfac=0.4624, refs=(-1, -5, -9, -13), type="P",
         n_active=4, depth=2),
    dict(poc=2, qpoff=4, qpfac=0.4624, refs=(-1, -2, -6, -10), type="P",
         n_active=4, depth=1),
    dict(poc=3, qpoff=5, qpfac=0.4624, refs=(-1, -3, -7, -11), type="P",
         n_active=4, depth=2),
    dict(poc=4, qpoff=1, qpfac=0.578,  refs=(-1, -4, -8, -12), type="P",
         n_active=4, depth=0),
]


def build_sps_pps(cfg: EncoderConfig):
    sps = SPS()
    if getattr(cfg, "rext_tools", False):
        sps.ptl = W.rext_profile_ptl(cfg.bit_depth, cfg.chroma_format,
                                     intra_only=True, high_throughput=True)
        sps.transform_skip_rotation = 1
        sps.transform_skip_context = 1
        sps.implicit_rdpcm = 1
        sps.explicit_rdpcm = 1
        sps.persistent_rice_adaptation = 1
        sps.cabac_bypass_alignment = 1
    elif cfg.chroma_format == 1 and cfg.bit_depth <= 10:
        sps.ptl = W.main_profile_ptl(cfg.bit_depth > 8)
    else:
        # 4:0:0 / 4:2:2 / 4:4:4 / >10-bit: a named Main-RExt profile
        sps.ptl = W.rext_profile_ptl(cfg.bit_depth, cfg.chroma_format,
                                     intra_only=cfg.intra_period == 1)
    sps.pic_width, sps.pic_height = cfg.width, cfg.height
    sps.chroma_format_idc = cfg.chroma_format
    sps.bit_depth_luma = sps.bit_depth_chroma = cfg.bit_depth
    sps.log2_ctb = cfg.log2_ctb
    sps.log2_min_cb = cfg.log2_min_cb
    sps.log2_min_tb = cfg.log2_min_tb
    sps.log2_max_tb = cfg.log2_max_tb
    sps.max_tr_hierarchy_depth_inter = 3
    sps.max_tr_hierarchy_depth_intra = 3
    sps.amp_enabled = 1
    sps.sao_enabled = 1 if cfg.sao else 0
    sps.temporal_mvp_enabled = 1      # TMVP (shared derivation w/ decoder)
    sps.strong_intra_smoothing = 1
    if cfg.gop == "ra8":
        # four temporal sub-layers (GOP-8 hierarchy depths double as
        # temporal ids, TEncGOP's tid derivation); per-layer ordering
        # info replicates the top layer (legal: non-decreasing)
        sps.max_sub_layers = 4
        sps.temporal_id_nesting = 1
        sps.max_dec_pic_buffering = [9] * 4
        sps.num_reorder_pics = [7] * 4
        sps.max_latency_increase = [0] * 4
    else:
        sps.max_dec_pic_buffering = [5]
        sps.num_reorder_pics = [0]
        sps.max_latency_increase = [0]
    sps.rps_list = []
    if cfg.intra_period != 1:
        sps.rps_list = [ShortTermRPS(num_negative=1, num_positive=0,
                                     delta_poc=[-1], used=[1])]

    pps = PPS()
    pps.init_qp = 26
    pps.sign_data_hiding = 1
    pps.loop_filter_across_slices = 1
    pps.entropy_coding_sync = 1 if cfg.wpp else 0
    if cfg.weighted_pred:
        pps.weighted_pred = 1
    if cfg.transform_skip:
        pps.transform_skip_enabled = 1
    if getattr(cfg, "long_term_ref", False):
        sps.long_term_ref_pics_present = 1
    if getattr(cfg, "intra_smoothing_disabled", False):
        sps.intra_smoothing_disabled = 1
    lv = float(getattr(cfg, "level", 0.0) or 0.0)
    if not lv:
        # derive the minimum level from the picture size and rate the
        # way TEncTop leaves it to the user (Table A.6 sample limits)
        luma_ps = cfg.width * cfg.height
        for cand, max_ps in ((2.0, 122880), (2.1, 245760), (3.0, 552960),
                             (3.1, 983040), (4.0, 2228224),
                             (4.1, 2228224), (5.0, 8912896),
                             (5.1, 8912896), (6.0, 35651584)):
            if luma_ps <= max_ps:
                lv = cand
                break
        else:
            lv = 6.2
    sps.ptl.level_idc = int(round(lv * 30))
    sps.ptl.tier_flag = 1 if getattr(cfg, "tier_high", False) else 0
    if getattr(cfg, "cross_component_prediction", False) and \
            cfg.chroma_format == 3:
        pps.cross_component_prediction_enabled = 1
    if cfg.aq or (cfg.rc_ctu and cfg.target_bps):
        pps.cu_qp_delta_enabled = 1
        pps.diff_cu_qp_delta_depth = 0
    if cfg.sei_timing:
        sps.vui_present = 1
        sps.vui_num_units_in_tick = 1
        sps.vui_time_scale = cfg.frame_rate
        sps.vui_frame_field_info = 1
    if cfg.sei_buffering_period:
        # HRD parameters in the VUI (TEncTop::xSetHrdParameters): nominal
        # rate from rate control when on, else a generous resolution-based
        # default; CPB sized for one second at the nominal rate
        sps.vui_present = 1
        sps.vui_num_units_in_tick = 1
        sps.vui_time_scale = cfg.frame_rate
        sps.vui_hrd_present = 1
        rate = cfg.target_bps or max(
            cfg.width * cfg.height * cfg.frame_rate // 10, 1 << 16)
        sps.hrd_bit_rate = int(rate)
        sps.hrd_cpb_size = int(rate)
    if cfg.scaling_list:
        sps.scaling_list_enabled = 1
        if cfg.scaling_list == 2:
            from hm16_2_tpu_torch.headers.params import parse_scaling_list_file
            sps.scaling_list_present = 1
            sps.scaling_list = parse_scaling_list_file(cfg.scaling_list_file)
    if cfg.dependent_slices and cfg.slices > 1:
        pps.dependent_slice_segments_enabled = 1
    if cfg.transquant_bypass:
        pps.transquant_bypass_enabled = 1
    if cfg.pcm:
        sps.pcm_enabled = 1
        sps.pcm_bit_depth_luma = sps.bit_depth_luma
        sps.pcm_bit_depth_chroma = sps.bit_depth_chroma
        sps.log2_min_pcm_cb = cfg.pcm_log2_min
        sps.log2_max_pcm_cb = cfg.pcm_log2_max
        sps.pcm_loop_filter_disabled = 1 if cfg.pcm_loop_filter_disabled \
            else 0
    if cfg.tile_cols > 1 or cfg.tile_rows > 1:
        pps.tiles_enabled = 1
        pps.num_tile_cols = cfg.tile_cols
        pps.num_tile_rows = cfg.tile_rows
        pps.uniform_spacing = 1
    if not cfg.deblock:
        pps.deblocking_filter_control_present = 1
        pps.deblocking_filter_disabled = 1
    elif getattr(cfg, "deblock_beta_offset", 0) or \
            getattr(cfg, "deblock_tc_offset", 0):
        pps.deblocking_filter_control_present = 1
        pps.beta_offset_div2 = cfg.deblock_beta_offset
        pps.tc_offset_div2 = cfg.deblock_tc_offset
    return sps, pps


class Encoder:
    def __init__(self, cfg: EncoderConfig, device):
        """HEVC encoder whose device work (the I, P and B frame plans, the
        fallback's frame ME and 35-mode analysis) runs on `device`, a
        torch.device: the CUDA kernels on a CUDA device, their plain
        PyTorch versions on the CPU."""
        import torch
        if not isinstance(device, torch.device):
            raise TypeError(f"device must be a torch.device, got {device!r}")
        self.device = device
        self.field_coding = bool(getattr(cfg, "field_coding", False))
        if self.field_coding:
            assert cfg.height % 2 == 0, "field coding needs even height"
            cfg.height //= 2          # pictures are fields
        if getattr(cfg, "rext_tools", False) and cfg.intra_period != 1:
            raise NotImplementedError(
                "rext_tools (HT-RExt) is all-intra only: explicit inter "
                "RDPCM search/emission is not implemented")
        if getattr(cfg, "cross_component_prediction", False) and \
                cfg.intra_period != 1:
            raise NotImplementedError(
                "cross-component prediction encode is all-intra only")
        # cumulative per-stage wall-time (ms) across encoded frames:
        # plan (device dispatch+fetch) / commit (host CU walk) /
        # filters (deblock+SAO) / emit (pass-2 CABAC) / finish
        self.stage_ms = {}
        self.cfg = cfg
        self.sps, self.pps = build_sps_pps(cfg)
        self.vps = VPS(ptl=self.sps.ptl)
        if self.sps.max_sub_layers > 1:
            self.vps.max_sub_layers = self.sps.max_sub_layers
            self.vps.temporal_id_nesting = 1
            self.vps.max_dec_pic_buffering = \
                list(self.sps.max_dec_pic_buffering)
            self.vps.num_reorder_pics = list(self.sps.num_reorder_pics)
            self.vps.max_latency_increase = \
                list(self.sps.max_latency_increase)
        self.frames_coded = 0
        self.bits_per_frame = []
        self.dpb = DPB()
        self._reorder = {}
        self._next_coded = 0
        self._gop_start = 0
        self.last_ira = 0            # POC of the last CRA/IDR coded
        # active GOP structure (cfg table wins over the built-ins)
        if cfg.gop_table:
            self.gop_table = cfg.gop_table
        elif cfg.gop == "ra8":
            self.gop_table = RA8_GOP
        elif cfg.gop == "ld" and cfg.intra_period == 0:
            # low-delay with the HM cfg's QP ladder + 4-ref RPS sets
            # (push_frame API; encode_frame keeps the flat-QP 1-ref path)
            self.gop_table = LDP_GOP
        else:
            self.gop_table = None
        self._reordered = self.gop_table is not None and any(
            s["poc"] != i + 1 for i, s in enumerate(self.gop_table))
        self._prev_mv8 = None    # (h//8, w//8, 2) full-pel (dy, dx) prior
        self.rc = None
        if cfg.target_bps:
            from hm16_2_tpu_torch.encode.ratectrl import RateCtrl
            assert cfg.total_frames > 0, \
                "rate control needs the frame count for budget allocation"
            self.rc = RateCtrl(cfg.target_bps, cfg.frame_rate,
                               cfg.total_frames, cfg.width, cfg.height,
                               gop_kind="ra8" if cfg.gop == "ra8" else "ld1",
                               lcu_rc=cfg.rc_ctu, ctb=1 << cfg.log2_ctb)

    @_trace.entry
    def encode_frame(self, planes: list[np.ndarray], poc: int,
                     _plan=None) -> bytes:
        """Encode one frame (IDR at intra-period boundaries, else LD-P)."""
        cfg, sps = self.cfg, self.sps
        is_idr = cfg.intra_period == 1 or \
            (cfg.intra_period > 0 and poc % cfg.intra_period == 0) or \
            self.frames_coded == 0
        sh = SliceHeader()
        if is_idr:
            sh.nal_type = NAL_IDR_W_RADL
            sh.slice_type = I_SLICE
        else:
            sh.nal_type = NAL_TRAIL_R
            sh.slice_type = P_SLICE
            sh.rps_idx = 0
            sh.rps = sps.rps_list[0]
            sh.num_ref_idx = [1, 0]
            anchor = getattr(self, "_lt_anchor", 0)
            if self.cfg.long_term_ref and poc >= anchor + 2 and \
                    self.dpb.get(anchor) is not None:
                # the anchor survives as a long-term 'golden' reference
                sh.lt_poc = [anchor]
                sh.lt_used = [1]
                sh.lt_msb_present = [1]
                sh.num_ref_idx = [2, 0]
            sh.max_num_merge_cand = 5
            sh.temporal_mvp_enabled = 1
            sh.collocated_from_l0 = 1
            sh.collocated_ref_idx = 0
        sh.qp = cfg.qp
        rc_lam = self._rc_begin(planes, sh, 0)
        return self._encode_one_multi_qp(planes, poc, sh, rc_lam=rc_lam,
                                         plan_packed=_plan)

    def _cur_pic_struct(self, poc) -> int:
        """pic_struct for the pic-timing SEI (D.3.3): 1 top / 2 bottom
        field in coded order under field coding, else 0 (frame)."""
        if not self.field_coding:
            return 0
        first_top = self.cfg.top_field_first
        is_first = poc % 2 == 0
        return 1 if (is_first == first_top) else 2

    def _submit_plan(self, planes):
        """Enqueue the intra frame plan on the device (AI fast path: fixed
        slice QP, no rate control) so the card plans while the host commits
        the previous frame."""
        from hm16_2_tpu_torch.common.tables import CHROMA_QP_SCALE
        from hm16_2_tpu_torch.encode import intra_rd
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

    @_trace.stepped
    def encode_stream(self, frames):
        """Encode an iterable of frames, yielding one Annex-B AU each.

        All-intra with fixed QP runs PIPELINED: frame N+1's plan program
        is dispatched to the accelerator before the host starts frame N's
        commit/CABAC, hiding the device time entirely (the TPU dual of
        TAppEncTop's read-encode loop, TAppEncTop.cpp:449-482)."""
        if self.field_coding:
            # split every frame into top/bottom fields, each coded as its
            # own picture with the matching pic_struct in pic-timing SEI
            from hm16_2_tpu_torch.io.yuv import split_fields
            def _fields(fr):
                for planes in fr:
                    top, bot = split_fields(planes)
                    first, second = (top, bot) if self.cfg.top_field_first \
                        else (bot, top)
                    yield first
                    yield second
            frames = _fields(frames)
            self.sps.vui_field_seq = 1
        pipelined = (self.cfg.intra_period == 1 and self.rc is None
                     and self.cfg.rdo and self.gop_table is None
                     and not self.field_coding
                     and not getattr(self.cfg, "delta_qp_rd", 0))
        if not pipelined:
            for poc, planes in enumerate(frames):
                for au in self.push_frame(planes, poc):
                    yield au
            for au in self.flush():
                yield au
            return
        pend = None                      # (planes, poc, submitted plan)
        for poc, planes in enumerate(frames):
            planes = [np.ascontiguousarray(p, dtype=np.int32)
                      for p in planes]
            dispatch = _trace.ON and _trace.open("plan.dispatch", poc)
            fut = self._submit_plan(planes)
            dispatch and _trace.close(dispatch)
            if pend is not None:
                yield self.encode_frame(pend[0], pend[1], _plan=pend[2])
            pend = (planes, poc, fut)
        if pend is not None:
            yield self.encode_frame(pend[0], pend[1], _plan=pend[2])

    def _build_ctu_enc_ctx(self, pic, sh, enc):
        """CtuEncCtx for the native pass-2 CTU syntax emitter, or None when
        its preconditions don't hold (the Python emitter then runs)."""
        import ctypes
        import os

        from hm16_2_tpu_torch import native
        sps, pps = self.sps, self.pps
        lib = native.get_lib()
        if (lib is None or sh.slice_type != I_SLICE
                or sps.chroma_format_idc not in (0, 1)
                or pps.transquant_bypass_enabled
                or pps.transform_skip_enabled or sps.pcm_enabled
                or sps.persistent_rice_adaptation
                or sps.cabac_bypass_alignment or sps.implicit_rdpcm
                or len(pic.tiles.col_bounds) != 2     # neighbor availability
                or len(pic.tiles.row_bounds) != 2     # is single-slice/tile
                or len(pic.slices) != 1               # only
                or pps.cu_qp_delta_enabled            # dQP: host emitter
                or os.environ.get("HM16_NO_CTU_SYNTAX")):
            return None
        from hm16_2_tpu_torch.bitstream.cabac import CTX_OFFSET
        from hm16_2_tpu_torch.decode.picture import MODE_INTRA, SIZE_2Nx2N
        from hm16_2_tpu_torch.ops.intra_ref import DM_CHROMA_IDX
        C = native.CtuEncCtx()
        C.pic_w, C.pic_h = pic.w, pic.h
        C.parts_w = pic.pw
        C.ctb_log2 = pic.log2_ctb
        C.num_comps = pic.num_comps
        C.chroma_fmt = sps.chroma_format_idc
        C.log2_min_cb = sps.log2_min_cb
        C.log2_min_tb = sps.log2_min_tb
        C.log2_max_tb = sps.log2_max_tb
        C.max_tr_depth_intra = sps.max_tr_hierarchy_depth_intra
        C.pcm_enabled = 0
        C.size_2nx2n = SIZE_2Nx2N
        C.mode_intra = MODE_INTRA
        C.dm_chroma_idx = DM_CHROMA_IDX
        C.ctx_split = CTX_OFFSET["split_flag"]
        C.ctx_part_size = CTX_OFFSET["part_size"]
        C.ctx_intra_mode = CTX_OFFSET["intra_pred_mode"]
        C.ctx_chroma_mode = CTX_OFFSET["chroma_pred_mode"]
        C.ctx_subdiv = CTX_OFFSET["trans_subdiv"]
        C.ctx_qt_cbf = CTX_OFFSET["qt_cbf"]
        C.coded = pic.coded.ctypes.data
        C.depth = pic.depth.ctypes.data
        C.part_size = pic.part_size.ctypes.data
        C.pred_mode = pic.pred_mode.ctypes.data
        C.intra_luma = pic.intra_luma.ctypes.data
        C.intra_chroma = pic.intra_chroma.ctypes.data
        for c in range(3):
            C.cbf[c] = pic.cbf[c].ctypes.data
        C.tr_idx = pic.tr_idx.ctypes.data
        for c in range(pic.num_comps):
            C.coeff[c] = pic.coeff[c].ctypes.data
            C.coeff_stride[c] = pic.coeff[c].shape[1]
        keep = []
        cu = type("CU", (), {})()
        cu.tqb = 0
        cu.pred_mode = MODE_INTRA
        be_valid = bool(pps.sign_data_hiding)
        for w in (4, 8, 16, 32):
            log2w = w.bit_length() - 1
            for st_ in ((0, 1, 2) if w <= 8 else (0,)):
                ti = (log2w - 2) * 3 + st_
                scan, scan_cg = type(enc)._scan32(w, st_)
                keep.append((scan, scan_cg))
                C.scan[ti] = scan.ctypes.data
                C.scan_cg[ti] = scan_cg.ctypes.data
                for chan, comp in ((0, 0), (1, 1)):
                    if chan == 1 and w > 16:
                        continue
                    p = enc._res_params(cu, log2w, comp, st_, 0, be_valid)
                    keep.append(p)
                    C.res_params[chan * 12 + ti] = ctypes.addressof(p)
        # chroma w=16 diag (used by 32x32 CUs) when luma filled only w<=8
        C.rice_stats = enc.golomb_rice_stats.ctypes.data
        st = native.EncState()
        out = np.zeros(1 << 20, dtype=np.uint8)
        keep.append(out)
        return (C, keep, st, out)

    def _native_encode_ctu(self, enc, cab, ce, cx, cy, last) -> bool:
        import ctypes

        from hm16_2_tpu_torch import native
        lib = native.get_lib()
        e = cab
        if e.bw.held_bits:
            return False
        C, keep, st, out = ce
        st.out = out.ctypes.data
        st.n = 0
        st.low = e.low
        st.range_ = e.range
        st.bits_left = e.bits_left
        st.num_buffered = e.num_buffered
        st.buffered_byte = e.buffered_byte
        st.counting = 0
        st.frac_bits = 0
        st.bins = 0
        ctx_state = enc.ctx.state
        rc = lib.encode_ctu_syntax(
            ctypes.byref(st), ctx_state.ctypes.data, ctypes.byref(C),
            cx, cy, 1 if last else 0)
        if rc != 0:
            return False
        e.bins += int(st.bins)
        if st.n:
            e.bw.buf.extend(out[:st.n].tobytes())
        e.low = int(st.low)
        e.range = int(st.range_)
        e.bits_left = int(st.bits_left)
        e.num_buffered = int(st.num_buffered)
        e.buffered_byte = int(st.buffered_byte)
        return True

    def _reconcile_group_qps(self, pic, sh):
        """Rewrite pic.qp to the decoder's view: within each quantization
        group (CTU at diff_cu_qp_delta_depth 0), CUs decoded BEFORE the
        first coded residual carry the predicted QP (CuQpDeltaVal still
        0), the rest carry the group's coded QP; groups with no residual
        never signal a delta at all (QP feeds deblocking strength)."""
        parts = pic.ctb // 4
        pred = sh.qp
        n_ctus = pic.w_ctbs * pic.h_ctbs
        cur_slice = 0

        def cu_cbf(px, py, n):
            for c in range(pic.num_comps):
                if np.any(pic.cbf[c][py:py + n, px:px + n]):
                    return True
            return False

        for ts in range(n_ctus):
            rs = int(pic.tiles.ctu_ts_to_rs[ts])
            cx, cy = rs % pic.w_ctbs, rs // pic.w_ctbs
            px0, py0 = cx * parts, cy * parts
            # decoders reset qPY_PREV to SliceQpY at every slice segment
            # start (7.4.7.1) — including DEPENDENT segments, whose
            # slice_id matches the owner's; detect starts by address
            for si, s_ in enumerate(pic.slices):
                if si != cur_slice and s_.segment_address == ts:
                    cur_slice = si
                    pred = s_.qp
                    break
            intended = int(pic.qp[py0, px0])
            state = {"seen": False}

            def walk(px, py, log2):
                if px * 4 >= pic.w or py * 4 >= pic.h:
                    return
                size = 1 << log2
                inside = (px * 4 + size <= pic.w and
                          py * 4 + size <= pic.h)
                split = (not inside) or                     int(pic.depth[py, px]) > pic.log2_ctb - log2
                if split and log2 > 3:
                    half = 1 << (log2 - 3)
                    for sub in range(4):
                        walk(px + (sub & 1) * half,
                             py + (sub >> 1) * half, log2 - 1)
                    return
                n = size // 4
                if not state["seen"] and not cu_cbf(px, py, n):
                    pic.qp[py:py + n, px:px + n] = pred
                else:
                    state["seen"] = True
                    pic.qp[py:py + n, px:px + n] = intended

            walk(px0, py0, pic.log2_ctb)
            if state["seen"]:
                pred = intended

    def _emit_multi_slices(self, pic, shs, slice_bounds, use_sao):
        """Final bitstream pass for multi-slice pictures: one independent
        slice segment (own CABAC engine + contexts, own header with
        segment address) per CTU run (TEncSlice::encodeSlice +
        calculateBoundingCtuTsAddrForSlice semantics)."""
        sps, pps = self.sps, self.pps
        tiles = pic.tiles
        parts = pic.ctb // 4
        nals = []
        total_bins = 0
        hdr_bits = 0

        def slice_at(cx, cy):
            return int(pic.slice_id[cy * parts, cx * parts])

        wpp = bool(pps.entropy_coding_sync)
        dep = any(s.dependent_slice_segment for s in shs)
        dss_ctx = None          # CABAC state at the end of the previous
        #                         segment (9.3.1 TableStateIdxDs)
        for si, (ts0, ts1) in enumerate(slice_bounds):
            sh = shs[si]
            enc = CtuEncoder(pic, sh, 0 if dep else si)
            ctx = ContextSet()
            if sh.dependent_slice_segment and dss_ctx is not None:
                ctx.load(dss_ctx)
            else:
                ctx.reset(sh.slice_type, sh.qp)
            datas = []
            sbw = cab = None
            wpp_saved = None     # per-slice: the cross-slice candidate is
            #                      never available (other slice), so each
            #                      slice's first row fresh-inits
            for ts in range(ts0, ts1):
                rs = int(tiles.ctu_ts_to_rs[ts])
                cx, cy = rs % pic.w_ctbs, rs // pic.w_ctbs
                row_start = wpp and cx == 0 and ts > ts0
                if cab is None or row_start:
                    if cab is not None:
                        cab.encode_bin_trm(1)    # end_of_subset_one_bit
                        cab.finish()
                        total_bins += cab.bins
                        sbw.u(1, 1)
                        sbw.align_zero()
                        datas.append(sbw.get_bytes())
                        if wpp_saved is not None:
                            ctx.load(wpp_saved)
                        else:
                            ctx.reset(sh.slice_type, sh.qp)
                    sbw = BitWriter()
                    cab = CabacEncoder(sbw, ctx)
                    enc.attach(cab)
                if use_sao and (enc.sh.sao_luma or enc.sh.sao_chroma):
                    own = 0 if dep else si
                    left_ok = cx > 0 and slice_at(cx - 1, cy) == own
                    above_ok = cy > 0 and slice_at(cx, cy - 1) == own
                    enc.enc_sao(rs, left_ok, above_ok)
                enc.encode_ctu(cx, cy, last_in_slice=(ts == ts1 - 1))
                if wpp and cx == 1:
                    wpp_saved = ctx.copy()
            if dep:
                dss_ctx = ctx.copy()
            cab.finish()
            total_bins += cab.bins
            sbw.u(1, 1)
            sbw.align_zero()
            datas.append(sbw.get_bytes())
            sh.entry_point_offsets = [
                len(d) + count_emulation_prevention(d) for d in datas[:-1]]
            bw = BitWriter()
            W.write_slice_header(bw, sh, sps, pps)
            hdr_bits += len(bw.get_bytes()) * 8
            nals.append(make_nal(sh.nal_type,
                                 bw.get_bytes() + b"".join(datas),
                                 temporal_id=sh.temporal_id))
        return nals, total_bins, hdr_bits

    def _rc_begin(self, planes, sh, gop_id):
        """Picture-level rate control (TEncGOP.cpp:1068-1119): target bits
        -> lambda -> slice QP; returns the SSE-domain lambda or None."""
        if self.rc is None:
            return None
        from hm16_2_tpu_torch.encode.ratectrl import frame_intra_cost
        is_i = sh.slice_type == I_SLICE
        cost = frame_intra_cost(np.asarray(planes[0])) if is_i else None
        qp, lam = self.rc.begin_picture(gop_id, is_i, cost)
        sh.qp = qp
        return lam

    # ---- random-access (hierarchical-B) push API ----

    @_trace.entry
    def push_frame(self, planes: list[np.ndarray], poc: int) -> list[bytes]:
        """Buffer a display-order frame; returns any AUs that became
        codable, in coding (bitstream) order."""
        if self.gop_table is None:
            return [self.encode_frame(planes, poc)]
        self._reorder[poc] = planes
        return self._drain(False)

    @_trace.entry
    def flush(self) -> list[bytes]:
        if self.gop_table is None:
            return []
        return self._drain(True)

    def _drain(self, final: bool) -> list[bytes]:
        aus = []
        buf = self._reorder
        while True:
            if self._next_coded == 0:
                if 0 not in buf:
                    break
                sh = SliceHeader()
                sh.nal_type = NAL_IDR_W_RADL
                sh.slice_type = I_SLICE
                sh.qp = self.cfg.qp
                if self.rc is not None:
                    self.rc.begin_gop(1)
                pl0 = buf.pop(0)
                rc_lam = self._rc_begin(pl0, sh, 0)
                aus.append(self._encode_one_multi_qp(pl0, 0, sh,
                                                     rc_lam=rc_lam))
                self._next_coded = 1
                self._gop_start = 0
                continue
            table = self.gop_table
            gsize = len(table)
            gop_pocs = [self._gop_start + s["poc"] for s in table]
            if all(p in buf for p in gop_pocs):
                if self.rc is not None:
                    self.rc.begin_gop(gsize)
                # periodic CRA refresh (DecodingRefreshType 1,
                # TEncGOP.cpp:2462-2512): the GOP's depth-0 picture at an
                # intra-period boundary is coded as a CRA I picture; the
                # GOP's remaining pictures precede it in output order and
                # become its RASL leading pictures
                ip = self.cfg.intra_period
                cra_poc = None
                if ip and ip > 1 and self.cfg.gop != "ld":
                    top = self._gop_start + gsize
                    if top % ip == 0 and top > 0:
                        cra_poc = top
                order = [(gop_id, slot, self._gop_start + slot["poc"])
                         for gop_id, slot in enumerate(table)]
                pending = None       # (poc, (sh, plan_fetch))
                for i, (gop_id, slot, p) in enumerate(order):
                    if p == cra_poc:
                        pending = None   # CRA moves last_ira: don't carry
                        aus.append(self._encode_cra(
                            buf.pop(p), p, slot, gop_id,
                            recovery=self.cfg.decoding_refresh_type == 3))
                        continue
                    nal = NAL_TRAIL_R
                    if self.last_ira > 0 and p < self.last_ira:
                        # leading picture: RADL when it references only
                        # the IRAP / other RADLs (decodable after a
                        # tune-in), else RASL (TEncGOP getNalUnitType,
                        # TEncGOP.cpp:2462-2512)
                        nal_of = getattr(self, "_nal_of", {})
                        radl = all(
                            p + d >= self.last_ira
                            or nal_of.get(p + d) in (NAL_RADL_R,
                                                     NAL_RADL_N)
                            for d in slot["refs"]
                            if self.dpb.get(p + d) is not None)
                        nal = NAL_RADL_R if radl else NAL_RASL_R
                    pre = pending[1] if pending and pending[0] == p \
                        else None
                    pending = None
                    # sibling overlap: dispatch the NEXT picture's plan
                    # before this one's host commit when it does not
                    # reference this picture (and no CRA intervenes)
                    if i + 1 < len(order):
                        g2, s2, p2 = order[i + 1]
                        if p2 != cra_poc and \
                                all(p2 + d != p for d in s2["refs"]):
                            if self.last_ira > 0 and p2 < self.last_ira:
                                nal_of2 = getattr(self, "_nal_of", {})
                                radl2 = all(
                                    p2 + d >= self.last_ira
                                    or nal_of2.get(p2 + d) in
                                    (NAL_RADL_R, NAL_RADL_N)
                                    for d in s2["refs"]
                                    if self.dpb.get(p2 + d) is not None)
                                n2 = NAL_RADL_R if radl2 else NAL_RASL_R
                            else:
                                n2 = NAL_TRAIL_R
                            pd = self._predispatch_ra(buf[p2], p2, s2, n2)
                            if pd is not None:
                                pending = (p2, pd)
                    aus.append(self._encode_ra_picture(buf.pop(p), p, slot,
                                                       gop_id, nal_type=nal,
                                                       pre=pre))
                    if not hasattr(self, "_nal_of"):
                        self._nal_of = {}
                    self._nal_of[p] = nal
                self._gop_start += gsize
                self._next_coded = self._gop_start + 1
                continue
            if final and buf:
                # tail: code remaining frames in display order, low-delay B
                for p in sorted(buf):
                    slot = dict(poc=0, qpoff=4, qpfac=0.68, refs=(-1,))
                    aus.append(self._encode_ra_picture(buf.pop(p), p, slot))
                continue
            break
        return aus

    def _encode_cra(self, planes, poc, slot, gop_id=0,
                    recovery=False) -> bytes:
        """Clean-random-access I picture: POC continues, DPB keeps the
        pictures its RASL leading pictures will reference (RPS entries
        with used_by_curr = 0, TEncGOP's CRA RPS construction).
        recovery=True codes the refresh as DecodingRefreshType 3: a
        TRAIL_R I slice with a recovery point SEI instead of a RAP, so
        no pictures become RASL and tune-in uses the SEI."""
        sh = SliceHeader()
        sh.nal_type = NAL_TRAIL_R if recovery else NAL_CRA
        sh.slice_type = I_SLICE
        sh.recovery_i = recovery
        sh.qp = int(np.clip(self.cfg.qp + slot["qpoff"], 0, 51))
        gsize = len(self.gop_table)
        pre = sorted({s["poc"] + d - gsize for s in self.gop_table
                      for d in s["refs"]
                      if s["poc"] != gsize and s["poc"] + d <= 0},
                     reverse=True)
        pre = [d for d in pre if self.dpb.get(poc + d) is not None]
        sh.rps_idx = -1
        sh.rps = ShortTermRPS(num_negative=len(pre), num_positive=0,
                              delta_poc=pre, used=[0] * len(pre))
        if not recovery:
            self.last_ira = poc
        rc_lam = self._rc_begin(planes, sh, gop_id)
        alpha, mult = self._lambda_args(sh, slot)
        return self._encode_one_multi_qp(planes, poc, sh, qp_factor=alpha,
                                         rc_lam=rc_lam, lam_mult=mult)

    def _encode_ra_picture(self, planes, poc, slot, gop_id=0,
                           nal_type=NAL_TRAIL_R, pre=None) -> bytes:
        """pre: (sh, plan_fetch) from _predispatch_ra — the slice header
        was already built and the fused inter plan is in flight on the
        device while the previous picture was committing."""
        if pre is not None:
            sh, plan_fetch = pre
            rc_lam = self._rc_begin(planes, sh, gop_id)
            alpha, mult = self._lambda_args(sh, slot)
            return self._encode_one_multi_qp(
                planes, poc, sh, qp_factor=alpha, rc_lam=rc_lam,
                lam_mult=mult, plan_packed=plan_fetch)
        sh = self._ra_slice_header(poc, slot, nal_type)
        rc_lam = self._rc_begin(planes, sh, gop_id)
        alpha, mult = self._lambda_args(sh, slot)
        return self._encode_one_multi_qp(planes, poc, sh, qp_factor=alpha,
                                         rc_lam=rc_lam, lam_mult=mult)

    def _predispatch_ra(self, planes, poc, slot, nal_type=NAL_TRAIL_R):
        """Dispatch the fused inter plan for a picture whose references
        are ALL already committed, so the device computes it while the
        host commits the current picture — the hierarchical-B sibling
        analogue of the AI pipeline (in RA GOP8 coding order, pictures
        3, 6 and 7 are independent of their predecessors 1, 3 and 5).
        Returns (sh, plan_fetch) for _encode_ra_picture, or None.
        The motion prior is one picture staler than on the serial path
        (the current picture's motion is not committed yet) — a
        search-guidance difference only.  Errors propagate: nothing falls
        back to the serial plan because the device failed."""
        import os
        cfg = self.cfg
        if (self.rc is not None or not cfg.rdo or not self.gop_table
                or getattr(cfg, "delta_qp_rd", 0)
                or os.environ.get("HM16_NO_INTER_PLAN")
                or os.environ.get("HM16_EXACT_RD")
                or os.environ.get("HM16_NO_PLAN_PIPELINE")):
            return None
        sh = self._ra_slice_header(poc, slot, nal_type)
        sh.poc = poc             # plan_frame prices by POC distances
        if self.pps.weighted_pred and sh.slice_type == P_SLICE:
            return None          # WP estimation mutates sh per-frame
        dispatch = _trace.ON and _trace.open("plan.dispatch", poc)
        ref_lists = build_ref_lists(sh, self.dpb)
        rc = RefCtx(sh, ref_lists)
        alpha, mult = self._lambda_args(sh, slot)
        lam = alpha * 2.0 ** ((sh.qp - 12) / 3.0) * mult
        from hm16_2_tpu_torch.encode import inter_plan
        fetch = inter_plan.plan_frame(
            planes[0], self.sps, sh, rc, self._prev_mv8,
            float(lam), float(np.sqrt(lam)), self.device, fetch=False)
        dispatch and _trace.close(dispatch)
        if fetch is None:
            return None
        return sh, fetch

    def _ra_slice_header(self, poc, slot, nal_type=NAL_TRAIL_R):
        sh = SliceHeader()
        sh.nal_type = nal_type
        sh.slice_type = B_SLICE
        sh.qp = int(np.clip(self.cfg.qp + slot["qpoff"], 0, 51))
        sh.temporal_id = int(slot.get("tid", slot.get("depth", 0)))
        # trailing pictures after a CRA must not reference pictures that
        # precede it (they are absent after a tune-in); RASL leading
        # pictures may
        is_rasl = nal_type == NAL_RASL_R
        min_ref = -(10 ** 9) if (is_rasl or poc <= self.last_ira) \
            else self.last_ira
        neg = sorted([d for d in slot["refs"] if d < 0 and
                      poc + d >= min_ref and
                      self.dpb.get(poc + d) is not None], reverse=True)
        pos = sorted([d for d in slot["refs"] if d > 0 and
                      self.dpb.get(poc + d) is not None])
        sh.rps_idx = -1
        sh.rps = ShortTermRPS(num_negative=len(neg), num_positive=len(pos),
                              delta_poc=neg + pos,
                              used=[1] * (len(neg) + len(pos)))
        total = len(neg) + len(pos)
        n_act = min(slot.get("n_active", 2), total)
        sh.num_ref_idx = [max(1, min(n_act, total))] * 2 if total else [0, 0]
        sh.slice_type = B_SLICE if slot.get("type", "B") == "B" else P_SLICE
        if sh.slice_type == P_SLICE:
            sh.num_ref_idx[1] = 0
        sh.max_num_merge_cand = 5
        # TSA derivation (TEncGOP.cpp:2462-2512): a trailing picture
        # whose references all sit in lower sub-layers is a valid
        # temporal up-switch point
        if nal_type == NAL_TRAIL_R and sh.temporal_id > 0:
            tid_of = getattr(self, "_tid_of", {})
            if all(tid_of.get(poc + d, 0) < sh.temporal_id
                   for d in (neg + pos)):
                sh.nal_type = NAL_TSA_R
        if not hasattr(self, "_tid_of"):
            self._tid_of = {}
        self._tid_of[poc] = sh.temporal_id
        if total:
            sh.temporal_mvp_enabled = 1
            # B slices take the collocated picture from L1 (the future
            # anchor, always inter-coded).  With col from L0 the level-1
            # B's collocated picture is the intra anchor, TMVP returns
            # nothing, and the merge lists lose every temporal/bi
            # candidate (HM: TEncSlice colFromL0Flag per GOP entry).
            sh.collocated_from_l0 = 0 if sh.slice_type == B_SLICE else 1
            sh.collocated_ref_idx = 0
        return sh

    def _lambda_args(self, sh, slot=None):
        """HM initEncSlice lambda derivation (TEncSlice.cpp:109-198):
        GOP-entry QP factor, the I-slice 0.57*dLambda_scale factor, and
        the Clip3(2,4,(qp-12)/6) multiplier for hierarchy depth > 0."""
        num_b = len(self.gop_table) - 1 if self.gop_table else 0
        lam_scale = 1.0 - min(0.5, 0.05 * num_b)
        if sh.slice_type == I_SLICE:
            return 0.57 * lam_scale, 1.0
        qp_factor = slot["qpfac"] if slot else 0.4624
        # HM multiplies lambda by Clip3(2,4,(qp-12)/6) at hierarchy depth
        # > 0 (TEncSlice.cpp:166-171, the JM "B_SLICE && layer != 0"
        # rule).  Measured here: it buys RA (hierarchical B) a large skip
        # density win but LOSES ~2.7% LDP BD-rate on P slices, so it is
        # applied to B slices only.
        # (measured: the multiplier loses BD-rate for BOTH P and B here —
        # this encoder's SATD-driven decisions degrade at large lambda)
        import os
        if os.environ.get("HM16_BMULT") and slot and \
                sh.slice_type == B_SLICE and \
                int(slot.get("depth", slot.get("tid", 0)) or 0) > 0:
            return qp_factor, min(4.0, max(2.0, (sh.qp - 12) / 6.0))
        return qp_factor, 1.0

    def _encode_one_multi_qp(self, planes, poc, sh, **kw) -> bytes:
        """DeltaQpRD (TEncSlice::precompressSlice, TEncSlice.cpp:526):
        trial-encode the picture at 2n+1 QPs around the slice QP, pick
        the best by SSE + lambda * actual AU bits, then run the real
        encode at the winner.  Off (n=0) routes straight through."""
        n = int(getattr(self.cfg, "delta_qp_rd", 0) or 0)
        if not n or self.rc is not None:
            return self._encode_one(planes, poc, sh, **kw)
        base_qp = sh.qp
        alpha = kw.get("qp_factor") or \
            (0.57 if sh.slice_type == I_SLICE else 0.68)
        lam = alpha * 2.0 ** ((base_qp - 12) / 3.0) * kw.get("lam_mult",
                                                             1.0)
        best = None
        for dq in range(-n, n + 1):
            sh.qp = int(np.clip(base_qp + dq, 0, 51))
            self._encode_one(planes, poc, sh, trial=True, **kw)
            sse, bits = self._trial_cost
            cost = sse + lam * bits
            if best is None or cost < best[0]:
                best = (cost, dq)
        sh.qp = int(np.clip(base_qp + best[1], 0, 51))
        au = self._encode_one(planes, poc, sh, **kw)
        sh.qp = base_qp
        return au

    def _encode_one(self, planes, poc, sh, qp_factor=None,
                    rc_lam=None, plan_packed=None, lam_mult=1.0,
                    trial=False) -> bytes:
        cfg, sps, pps = self.cfg, self.sps, self.pps
        _st = self.stage_ms
        span = _trace.ON and not trial and _trace.open("picture", poc)

        def _tick(key, t0):
            _st[key] = _trace.stage_end(_st.get(key, 0.0), t0, span, key)
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
            from hm16_2_tpu_torch.common.tables import CHROMA_QP_SCALE
            from hm16_2_tpu_torch.encode import intra_rd
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
                dispatch = span and _trace.open("plan.dispatch", poc)
                search.plan = intra_rd.plan_frame(
                    planes, sps, qp_luma, search.lam,
                    getattr(search, "chroma_weight", 1.0), cqps, self.device)
                dispatch and _trace.close(dispatch)   # ended by its fetch
            _tick("plan", t0)
        if sh.slice_type != I_SLICE:
            ref_lists = build_ref_lists(sh, self.dpb)
            if pps.weighted_pred and sh.slice_type == P_SLICE:
                from hm16_2_tpu_torch.encode.wp_analysis import estimate_wp
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
            if search.plan is None and cfg.rdo \
                    and not os.environ.get("HM16_NO_INTER_PLAN") \
                    and not os.environ.get("HM16_EXACT_RD"):
                # fused inter frame plan: ME + subpel + merge/AMVP/bi
                # pricing + residual RD + quadtree DP on the device
                # (inter_plan._plan_device); host commit maps onto exact
                # candidate lists
                from hm16_2_tpu_torch.encode import inter_plan
                t0 = time.perf_counter()
                dispatch = span and _trace.open("plan.dispatch", poc)
                search.plan = inter_plan.plan_frame(
                    planes[0], sps, sh, rc, self._prev_mv8,
                    float(search.lam), float(np.sqrt(search.lam)),
                    self.device)
                dispatch and _trace.close(dispatch)   # ended by its fetch
                _tick("plan", t0)
            if search.plan is None and cfg.rdo and \
                    not os.environ.get("HM16_NO_ME_PLAN"):
                # frame-batched +-64 integer ME on the device (all refs x
                # CU sizes); prior = previous frame's motion field; the
                # per-CU search (SBD, RRSP, AMP) runs on the host
                from hm16_2_tpu_torch.encode import inter_me
                t0 = time.perf_counter()
                lam_sq = np.sqrt(0.85 * 2.0 ** ((sh.qp - 12) / 3.0))
                # the stored prior is POC-normalized (q-pel x16 / POC);
                # de-normalize to full-pel at the L0[0] distance for the
                # shared-prior fallback ME
                prior = self._prev_mv8
                if prior is not None and rc.ref_lists[0]:
                    d0 = sh.poc - rc.ref_lists[0][0].poc
                    prior = np.rint(prior.astype(np.float64) * d0 / 64.0) \
                        .astype(np.int32)
                dispatch = span and _trace.open("plan.dispatch", poc)
                fetch = inter_me.submit_me(
                    planes[0], rc.ref_lists, prior, lam_sq,
                    sps.pic_height, sps.pic_width, self.device)
                dispatch and _trace.close(dispatch)
                wait = span and _trace.wait_open()
                search.me_plan = fetch()
                wait and _trace.close(wait)
                _tick("plan", t0)
        # pass 1: mode decisions + reconstruction (TEncSlice::compressSlice).
        # Planned I-slices commit the whole frame in ONE native call (the
        # C++ engine walks every CTU, border CTUs via implicit splits);
        # anything it can't handle resumes per-CTU on the host.
        n_ctus = pic.w_ctbs * pic.h_ctbs
        aq_off = None
        if cfg.aq:
            from hm16_2_tpu_torch.encode.preanalysis import aq_offsets
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
        span and _trace.open("commit")       # closed by _tick("commit")
        start_ts = 0
        if search.plan is not None and aq_off is None and \
                sh.slice_type == I_SLICE and not byte_mode:
            cctx = search._commit_ctx()
            if cctx is not None:
                import ctypes

                from hm16_2_tpu_torch import native
                recon = span and _trace.open("commit.recon")
                rc = native.get_dsp().commit_plan_frame(ctypes.byref(cctx))
                start_ts = n_ctus if rc == 0 else rc - 1
                recon and _trace.close(recon, "commit.native_cus",
                                       _trace.cus_in_ts(pic, start_ts))
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
        from hm16_2_tpu_torch.decode.loopfilter import (
            restore_lossless_samples, snapshot_lossless_samples)
        lossless_saved = snapshot_lossless_samples(pic)
        use_sao = bool(sps.sao_enabled)
        if not sh.deblocking_filter_disabled:
            from hm16_2_tpu_torch.ops.deblock_ref import deblock_picture
            deblock_picture(pic)
        span and _trace.split(span, "filters.deblock", t_filt)
        if use_sao:
            from hm16_2_tpu_torch.encode.sao_enc import estimate_sao
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
                    span and _trace.emit_python(span)
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
            span and _trace.emit_python(span, n_ctus)
        span and _trace.emit_end(span, n_ctus)
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
            from hm16_2_tpu_torch.ops.sao_ref import sao_picture
            sao_picture(pic)
        restore_lossless_samples(pic, lossless_saved)

        bds = [sps.bit_depth_luma] + [sps.bit_depth_chroma] * (pic.num_comps - 1)
        recon = [pic.crop_output(c) for c in range(pic.num_comps)]
        from hm16_2_tpu_torch.decode.top import picture_checksum, picture_crc
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
            from hm16_2_tpu_torch.headers import sei as SEI
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
            from hm16_2_tpu_torch.headers import sei as SEI
            nals.append(SEI.write_region_refresh(1))
        if cfg.sei_temporal_level0:
            from hm16_2_tpu_torch.headers import sei as SEI
            if irap:
                self._irap_id = getattr(self, "_irap_id", -1) + 1
            elif sh.temporal_id == 0:
                self._tl0_idx = getattr(self, "_tl0_idx", 0) + 1
            nals.append(SEI.write_temporal_level0_index(
                getattr(self, "_tl0_idx", 0), getattr(self, "_irap_id", 0)))
        if cfg.sei_time_code:
            from hm16_2_tpu_torch.headers import sei as SEI
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
        span and _trace.close(span)
        if self.rc is not None:
            # feed back only VCL NAL bits (TEncRateCtrl uses the slice
            # bits; VPS/SPS/PPS/SEI would inflate the first frames) and
            # the measured slice-header bits for the xEstPicHeaderBits
            # proxy
            vcl_bits = sum(len(n) for n in slice_nals) * 8
            self.rc.update_after_picture(vcl_bits, hdr_bits)
        return au


class CtuSearch:
    """Per-CTU mode decision + reconstruction (fills picture arrays)."""

    def __init__(self, pic: PictureState, sh: SliceHeader, orig_planes,
                 rdo: bool = True, qp_factor: float | None = None,
                 sbd: bool = False, rrsp: bool = False,
                 lam_override: float | None = None, der: int = 16,
                 rdoq: bool = True, lam_mult: float = 1.0):
        import os
        self.rdoq = rdoq and rdo and not os.environ.get("HM16_NO_RDOQ")
        self.pic = pic
        self.sh = sh
        self.sps, self.pps = sh.sps, sh.pps
        self.orig = orig_planes
        self.cu_log2 = 4
        self.bit_depth = [self.sps.bit_depth_luma, self.sps.bit_depth_chroma,
                          self.sps.bit_depth_chroma]
        self.rdo = rdo
        self.sbd = sbd
        self.rrsp = rrsp
        self.der = der
        self.plan = None             # frame-level batched intra plan (AI)
        self.cur_qp = sh.qp          # per-CTU QP (adaptive QP / CTU RC)
        self._base_lam = None
        self._allowed_depths = None
        self._rrsp_obj = None        # built lazily (needs ref lists)
        self._rrsp_ctu = None        # (check64, only_depth0) for current CTU
        self._rrsp_mask = None       # bool[3] quadrant reduced-depth mask
        self.cenc = CtuEncoder(pic, sh, 0)
        if rdo:
            # HM lambda model (TEncSlice::setUpLambda simplified): SSE-domain
            # lambda; chroma distortion weighted by the luma/chroma QP gap.
            qp = sh.qp
            alpha = qp_factor if qp_factor is not None else \
                (0.57 if sh.slice_type == I_SLICE else 0.68)
            self.lam = alpha * 2.0 ** ((qp - 12) / 3.0) * lam_mult
            if lam_override is not None:
                self.lam = lam_override     # rate-control lambda (resetQP)
            if pic.num_comps > 1:
                from hm16_2_tpu_torch.common.tables import CHROMA_QP_SCALE
                base = int(np.clip(qp + self.pps.cb_qp_offset, 0, 57))
                cqp = int(CHROMA_QP_SCALE[self.sps.chroma_format_idc][base])
            else:
                cqp = qp
            self.chroma_weight = 2.0 ** ((qp - cqp) / 3.0)
            self.rd_ctx = ContextSet()
            self.rd_ctx.reset(sh.slice_type, min(max(sh.qp, 0), 51))

    def set_ctu_qp(self, qp, lam=None):
        """Per-CTU QP + lambda rescale (adaptive QP / CTU-level RC).
        lam: exact SSE-domain lambda (CTU rate control supplies its own
        model lambda, TEncSlice.cpp:779-800); default rescales the slice
        lambda by the QP delta."""
        qp = int(np.clip(qp, 0, 51))
        if self._base_lam is None:
            self._base_lam = self.lam
        self.cur_qp = qp
        self.lam = lam if lam is not None else \
            self._base_lam * 2.0 ** ((qp - self.sh.qp) / 3.0)

    def decide_ctu(self, cx, cy):
        pic = self.pic
        parts = pic.ctb // 4
        if self.pps.cu_qp_delta_enabled:
            # whole-CTU QP pre-mark: inter commits and trial evaluations
            # read the TU QP from the part array
            pic.qp[cy * parts:(cy + 1) * parts,
                   cx * parts:(cx + 1) * parts] = self.cur_qp
        tr = _trace.ON
        if self.plan is not None:
            # native commit engine (handles border CTUs via implicit split)
            cctx = self._commit_ctx()
            if cctx is not None:
                import ctypes

                from hm16_2_tpu_torch import native
                recon = tr and _trace.open("commit.recon")
                if native.get_dsp().commit_plan_ctu(
                        ctypes.byref(cctx), cx, cy) == 0:
                    recon and _trace.close(recon, "commit.native_cus",
                                           _trace.ctu_cus(pic, cx, cy))
                    return
                recon and _trace.close(recon, "commit.native_refused_ctus")
            self._commit_plan_tree(cx * parts, cy * parts, pic.log2_ctb)
            return
        search = tr and _trace.open("commit.search")
        self._allowed_depths = None
        if self.sbd and self.sh.slice_type != I_SLICE and self.rdo:
            self._allowed_depths = self._sbd_allowed(cx, cy)
        self._rrsp_ctu = None
        self._rrsp_mask = None
        if self.rrsp and self.sh.slice_type != I_SLICE and self.rdo:
            mvp = getattr(self, "mvp", None)
            if mvp is not None and mvp.rc.ref_lists[0]:
                if self._rrsp_obj is None:
                    from hm16_2_tpu_torch.encode.rrsp import RRSP
                    self._rrsp_obj = RRSP(pic.depth,
                                          mvp.rc.ref_lists[0][0],
                                          self.sh.qp, pic.w, pic.h)
                self._rrsp_ctu = self._rrsp_obj.ctu_state(cx * pic.ctb,
                                                          cy * pic.ctb)
        if self.rdo:
            self._compress(cx * parts, cy * parts, pic.log2_ctb)
        else:
            self._decide_rec(cx * parts, cy * parts, pic.log2_ctb)
        search and _trace.close_search(search, _trace.ctu_cus(pic, cx, cy))

    # ------------------------------------------------------------------
    # SBD: similarity-based depth-range selection (the fork's encoder-only
    # fast CU partitioning, TEncCu.cpp:1903-2670).  Neighbor-CTU border
    # strips and the colocated CTU vote on which quadtree depths are worth
    # evaluating; the dense per-part depth arrays make the "adopted depth"
    # sampling a handful of numpy unique() calls instead of the reference's
    # hard-coded Z-order index tables (getAdoptedDepthsLeft :1903-1962).
    # ------------------------------------------------------------------

    def _sbd_allowed(self, cx, cy):
        """Allowed CU depth set for this CTU, or None for unrestricted
        (group-alpha empty / low similarity / boundary escape)."""
        pic = self.pic
        parts = pic.ctb // 4
        x0, y0 = cx * parts, cy * parts
        # boundary CTUs keep the full range (fork escape :928-933)
        if (x0 + parts) * 4 > pic.w or (y0 + parts) * 4 > pic.h:
            return None
        R = max(1, self.der // 4)     # border strip width in parts (DER)
        alpha, beta = set(), set()

        def sample(dst, arr, px0, py0, w, h):
            if px0 < 0 or py0 < 0 or px0 * 4 >= pic.w or py0 * 4 >= pic.h:
                return
            d = arr[py0:py0 + h, px0:px0 + w]
            dst.update(int(v) for v in np.unique(d) if v >= 0)

        # group alpha: left / above / above-left strips + colocated CTU
        # (buildGroupAlpha :2327)
        if cx > 0:
            sample(alpha, pic.depth, x0 - R, y0, R, parts)
        if cy > 0:
            sample(alpha, pic.depth, x0, y0 - R, parts, R)
        if cx > 0 and cy > 0:
            sample(alpha, pic.depth, x0 - R, y0 - R, R, R)
        col = None
        mvp = getattr(self, "mvp", None)
        if mvp is not None and mvp.rc.ref_lists[0]:
            col = mvp.rc.ref_lists[0][0].depth
        if col is not None:
            sample(alpha, col, x0, y0, parts, parts)
            # group beta: colocated's ring strips (buildGroupBeta :2375)
            sample(beta, col, x0 - R, y0, R, parts)
            sample(beta, col, x0, y0 - R, parts, R)
            sample(beta, col, x0 + parts, y0, R, parts)
            sample(beta, col, x0, y0 + parts, parts, R)
        if cy > 0:
            sample(beta, pic.depth, x0 + parts, y0 - R, R, R)
        if not alpha:
            return None

        max_d = pic.log2_ctb - self.sps.log2_min_cb
        sim = len(alpha)              # getSimLevel :2415
        if sim == 1:                  # performHighSim :2462
            d = next(iter(alpha))
            allowed = {d}
            if beta and not beta.issubset(alpha):
                allowed |= {max(0, d - 1), min(max_d, d + 1)}
        elif sim == 2:                # performMediumHighSim :2506
            allowed = set(alpha)
            extra = beta - alpha
            if extra:
                allowed |= {min(max_d, max(alpha) + 1)}
        elif sim == 3:                # performMediumLowSim :2557
            allowed = set(alpha) | (beta & set(range(max_d + 1)))
        else:                         # performLowSim :2614 — all depths
            return None
        return allowed

    # ------------------------------------------------------------------
    # RD-optimized quadtree decision (TEncCu::xCompressCU analogue).
    #
    # Candidate CUs are trial-committed into the picture arrays, their rate
    # measured by replaying the exact CABAC syntax through a fractional-bit
    # counter seeded with the running context state (HM's FAST_BIT_EST /
    # RD-coder-state lattice, TEncTop m_pppcRDSbacCoder), and SSE distortion
    # taken on the reconstruction.  The loser's region state is rolled back.
    # ------------------------------------------------------------------

    _PART_FIELDS = ("depth", "part_size", "pred_mode", "skip", "merge_flag",
                    "tqb", "ipcm", "intra_luma", "intra_chroma", "qp",
                    "slice_id", "coded", "tr_idx", "inter_dir")

    def _snapshot(self, px, py, log2):
        pic = self.pic
        n = 1 << (log2 - 2)
        sl = np.s_[py:py + n, px:px + n]
        # I slices never touch motion or transform-skip state: skip those
        # copies (snapshot/restore is a per-trial-CU hot spot)
        intra_only = self.sh.slice_type == I_SLICE
        d = {
            "simple": {f: getattr(pic, f)[sl].copy()
                       for f in self._PART_FIELDS},
            "cbf": {c: pic.cbf[c][sl].copy() for c in range(3)},
            "tskip": None if intra_only else
                     {c: pic.tskip[c][sl].copy() for c in range(3)},
            "lead": None if intra_only else
                    {f: getattr(pic, f)[:, py:py + n, px:px + n].copy()
                     for f in ("ref_idx", "mvp_idx", "ref_poc", "mv", "mvd")},
        }
        x0, y0, size = px * 4, py * 4, 1 << log2
        planes = []
        for c in range(pic.num_comps):
            sx, sy = pic.comp_shift[c]
            rs = np.s_[y0 >> sy:(y0 + size) >> sy, x0 >> sx:(x0 + size) >> sx]
            planes.append((pic.rec[c][rs].copy(), pic.coeff[c][rs].copy()))
        d["planes"] = planes
        d["pos"] = (px, py, log2)
        return d

    def _restore(self, d):
        pic = self.pic
        px, py, log2 = d["pos"]
        n = 1 << (log2 - 2)
        sl = np.s_[py:py + n, px:px + n]
        for f, v in d["simple"].items():
            getattr(pic, f)[sl] = v
        for c in range(3):
            pic.cbf[c][sl] = d["cbf"][c]
        if d["tskip"] is not None:
            for c in range(3):
                pic.tskip[c][sl] = d["tskip"][c]
        if d["lead"] is not None:
            for f, v in d["lead"].items():
                getattr(pic, f)[:, py:py + n, px:px + n] = v
        x0, y0, size = px * 4, py * 4, 1 << log2
        for c in range(pic.num_comps):
            sx, sy = pic.comp_shift[c]
            rs = np.s_[y0 >> sy:(y0 + size) >> sy, x0 >> sx:(x0 + size) >> sx]
            pic.rec[c][rs] = d["planes"][c][0]
            pic.coeff[c][rs] = d["planes"][c][1]

    def _sse_region(self, px, py, log2):
        pic = self.pic
        x0, y0, size = px * 4, py * 4, 1 << log2
        tot = 0.0
        for c in range(pic.num_comps):
            sx, sy = pic.comp_shift[c]
            rs = np.s_[y0 >> sy:min((y0 + size) >> sy, self.orig[c].shape[0]),
                       x0 >> sx:min((x0 + size) >> sx, self.orig[c].shape[1])]
            diff = (self.orig[c][rs] - pic.rec[c][rs]).astype(np.float64)
            w = 1.0 if c == 0 else self.chroma_weight
            tot += w * float(np.dot(diff.ravel(), diff.ravel()))
        return tot

    def _count_cu_bits(self, px, py, log2, ctx):
        """Fractional bits to code this (committed) CU given ctx state."""
        ctr = CabacCounter(ctx)
        self.cenc.attach(ctr)
        self.cenc._enc_cu(px, py, log2, self.pic.log2_ctb - log2)
        return ctr.frac_bits / 32768.0

    def _compress(self, px, py, log2):
        """Recursive split-vs-leaf RD decision; leaves winner committed and
        self.rd_ctx holding the post-CU context state.  Returns RD cost."""
        pic, sps = self.pic, self.sps
        size = 1 << log2
        x0, y0 = px * 4, py * 4
        inside = (x0 + size <= pic.w) and (y0 + size <= pic.h)
        depth = pic.log2_ctb - log2
        allowed = self._allowed_depths
        deeper_ok = allowed is None or any(d > depth for d in allowed)
        leaf_ok = allowed is None or depth in allowed or not deeper_ok
        # RRSP gates: 64x64 voting at depth 0 (bRRSP/bOnlyDepth0,
        # TEncCu.cpp:483-536,598,940-951) and per-quadrant reduced-depth
        # masks below (:953-971) with boundary escapes
        if self._rrsp_ctu is not None:
            if depth == 0:
                check64, only0 = self._rrsp_ctu
                leaf_ok = leaf_ok and check64
                if only0 and inside:
                    deeper_ok = False
            elif self._rrsp_mask is not None:
                mask = self._rrsp_mask
                r_split = depth < 3 and bool(mask[depth:3].any())
                if not r_split and not inside and depth < 3:
                    mask[depth] = True          # boundary escape :944-967
                    r_split = True
                leaf_ok = leaf_ok and (bool(mask[depth - 1]) or not r_split)
                deeper_ok = deeper_ok and r_split
        cost_ns = np.inf
        ns_snap = ctx_ns = None
        pre_ctx = self.rd_ctx.copy()
        pre_snap = self._snapshot(px, py, log2)
        if inside and leaf_ok:
            if self._encode_cu(px, py, log2):
                ctx_ns = pre_ctx.copy()
                bits = self._count_cu_bits(px, py, log2, ctx_ns)
                cost_ns = self._sse_region(px, py, log2) + self.lam * bits
                if log2 == sps.log2_min_cb:
                    self.rd_ctx = ctx_ns
                    return cost_ns
                ns_snap = self._snapshot(px, py, log2)
            self._restore(pre_snap)

        # split candidate (pruned when SBD allows no deeper depth,
        # bSBDSplit gate TEncCu.cpp:916-935)
        if not deeper_ok and np.isfinite(cost_ns):
            self._restore(ns_snap)
            self.rd_ctx = ctx_ns
            return cost_ns
        self.rd_ctx = pre_ctx.copy()
        bits_split = 0.0
        if inside and log2 > sps.log2_min_cb:
            ctr = CabacCounter(self.rd_ctx)
            self.cenc.attach(ctr)
            ctr.encode_bin(1, self.rd_ctx.idx(
                "split_flag",
                self.cenc._ctx_split(px, py, pic.log2_ctb - log2)))
            bits_split = ctr.frac_bits / 32768.0
        cost_sp = self.lam * bits_split
        half = 1 << (log2 - 3)
        for sub in range(4):
            sx_ = px + (sub & 1) * half
            sy_ = py + (sub >> 1) * half
            if sx_ * 4 < pic.w and sy_ * 4 < pic.h:
                if self._rrsp_ctu is not None and depth == 0:
                    # per-32x32-quadrant mask, built after the previous
                    # quadrants committed their depths (TEncCu.cpp:992-1002)
                    self._rrsp_mask = self._rrsp_obj.quadrant_mask(
                        x0, y0, sub)
                cost_sp += self._compress(sx_, sy_, log2 - 1)

        if cost_ns <= cost_sp:
            self._restore(ns_snap)
            self.rd_ctx = ctx_ns
            return cost_ns
        return cost_sp

    def _decide_rec(self, px, py, log2):
        pic = self.pic
        if px * 4 >= pic.w or py * 4 >= pic.h:
            return
        inside = (px * 4 + (1 << log2) <= pic.w) and \
                 (py * 4 + (1 << log2) <= pic.h)
        if log2 > self.cu_log2 or not inside:
            assert log2 > self.sps.log2_min_cb or inside, \
                "picture dims must be multiples of the minimum CU size"
            half = 1 << (log2 - 3)
            for sub in range(4):
                self._decide_rec(px + (sub & 1) * half,
                                 py + (sub >> 1) * half, log2 - 1)
            return
        self._encode_cu(px, py, log2)

    # ------------------------------------------------------------------
    # plan-driven commit (stage 3 of the batched frame pipeline): walk the
    # DP-chosen quadtree in z-order and reconstruct each CU bit-exactly
    # with reconstructed-pixel references — no trial coding, no snapshots
    # ------------------------------------------------------------------

    def _commit_plan_tree(self, px, py, log2):
        pic, sps = self.pic, self.sps
        size = 1 << log2
        x0, y0 = px * 4, py * 4
        if x0 >= pic.w or y0 >= pic.h:
            return
        inside = (x0 + size <= pic.w) and (y0 + size <= pic.h)
        plan = self.plan
        depth = pic.log2_ctb - log2
        covered = inside and bool(plan.cov[py, px])
        tr = _trace.ON
        if covered and int(plan.depth[py, px]) == depth:
            if getattr(plan, "is_inter_plan", False) and \
                    plan.pred_inter[py, px]:
                cm = tr and _trace.open("commit.map")
                if self._commit_planned_inter(px, py, log2):
                    cm and _trace.close_map(cm, True)
                    return
                cm and _trace.close_map(cm, False)
                # infeasible planned motion: fall back to local search
                cs = tr and _trace.open("commit.search")
                if self._encode_cu(px, py, log2):
                    cs and _trace.close_search(cs, 1)
                    return
                cs and _trace.close_search(cs, 0)
            elif log2 == 3 and plan.nxn[py, px]:
                cr = tr and _trace.open("commit.recon")
                self._commit_nxn(px, py)
                cr and _trace.close(cr, "commit.python_cus")
                return
            else:
                cr = tr and _trace.open("commit.recon")
                self._commit_cu(px, py, log2, int(plan.mode[py, px]),
                                tusplit=bool(plan.tusplit[py, px]))
                cr and _trace.close(cr, "commit.python_cus")
                return
        if inside and not covered:
            # boundary-adjacent area the batched plan skipped: local search
            cs = tr and log2 <= sps.log2_max_tb and \
                _trace.open("commit.search")
            if log2 <= sps.log2_max_tb and self._encode_cu(px, py, log2):
                cs and _trace.close_search(cs, 1)
                return
            cs and _trace.close_search(cs, 0)
        if log2 <= sps.log2_min_cb:
            # last resort: 8x8 full search (cannot split further)
            cs = tr and _trace.open("commit.search")
            self._encode_cu(px, py, log2)
            cs and _trace.close_search(cs, 1)
            return
        half = 1 << (log2 - 3)
        for sub in range(4):
            self._commit_plan_tree(px + (sub & 1) * half,
                                   py + (sub >> 1) * half, log2 - 1)

    def _inter_ctx(self):
        """ctypes InterCtx for the native inter-commit engine, or None
        when its preconditions don't hold (WP, non-4:2:0 chroma,
        cu_qp_delta, >8 refs)."""
        ic = getattr(self, "_ictx", None)
        if ic is not False and ic is not None:
            return ic
        if ic is False:
            return None
        import ctypes
        import os

        from hm16_2_tpu_torch import native
        pic, sps, pps, sh = self.pic, self.sps, self.pps, self.sh
        lib = native.get_dsp()
        rc = self.mvp.rc if getattr(self, "mvp", None) is not None else None
        wp_active = (sh.slice_type == P_SLICE and pps.weighted_pred) or \
            (sh.slice_type == B_SLICE and pps.weighted_bipred)
        ok = (lib is not None and self.rdoq and rc is not None
              and sps.chroma_format_idc in (0, 1)
              and not wp_active
              and not pps.cu_qp_delta_enabled
              and not sps.scaling_list_enabled
              and not pps.transquant_bypass_enabled
              and all(len(l) <= 8 for l in rc.ref_lists)
              and not os.environ.get("HM16_NO_COMMIT_ENGINE"))
        if not ok:
            self._ictx = False
            return None
        I = native.InterCtx()
        I.pic_w, I.pic_h = pic.w, pic.h
        I.parts_w = pic.pw
        I.num_comps = pic.num_comps
        I.chroma_fmt = sps.chroma_format_idc
        I.max_tb_log2 = sps.log2_max_tb
        I.try_tusplit = 1
        I.allow_collapse = 1 if (sh.slice_type == B_SLICE
                                 and not pps.weighted_bipred) else 0
        I.lam = float(self.lam)
        I.chroma_weight = float(self.chroma_weight)
        for c in range(pic.num_comps):
            I.bd[c] = self.bit_depth[c]
        qpy = self.sh.qp
        I.qp_comp[0] = qpy + 6 * (sps.bit_depth_luma - 8)
        if pic.num_comps > 1:
            from hm16_2_tpu_torch.common.tables import CHROMA_QP_SCALE
            bd_off = 6 * (sps.bit_depth_chroma - 8)
            for comp in (1, 2):
                off = (pps.cb_qp_offset + sh.cb_qp_offset) if comp == 1 \
                    else (pps.cr_qp_offset + sh.cr_qp_offset)
                base = int(np.clip(qpy + off, -bd_off, 57))
                I.qp_comp[comp] = base + bd_off if base < 0 else \
                    int(CHROMA_QP_SCALE[sps.chroma_format_idc][base]) + bd_off
        for c in range(pic.num_comps):
            orig = self.orig[c]
            if orig.dtype != np.int32 or not orig.flags.c_contiguous:
                orig = np.ascontiguousarray(orig, dtype=np.int32)
                self.orig[c] = orig
            I.orig_p[c] = orig.ctypes.data
            I.rec_p[c] = pic.rec[c].ctypes.data
            I.coeff_p[c] = pic.coeff[c].ctypes.data
            I.orig_stride[c] = orig.shape[1]
            I.plane_stride[c] = pic.rec[c].shape[1]
        I.mv = pic.mv.ctypes.data
        I.mv_list_stride = pic.mv.shape[1] * pic.mv.shape[2] * 2
        I.ref_idx = pic.ref_idx.ctypes.data
        I.ri_list_stride = pic.ref_idx.shape[1] * pic.ref_idx.shape[2]
        I.inter_dir = pic.inter_dir.ctypes.data
        I.skip = pic.skip.ctypes.data
        I.merge_flag = pic.merge_flag.ctypes.data
        I.tr_idx = pic.tr_idx.ctypes.data
        for c in range(3):
            I.cbf[c] = pic.cbf[c].ctypes.data
        for lx in range(2):
            lst = rc.ref_lists[lx] if lx < len(rc.ref_lists) else []
            I.n_ref[lx] = len(lst)
            for ri, ref in enumerate(lst):
                I.ref_poc[lx * 8 + ri] = ref.poc
                for c in range(pic.num_comps):
                    plane = ref.rec[c]
                    idx = (lx * 8 + ri) * 3 + c
                    I.ref_pix[idx] = plane.ctypes.data
                    I.ref_stride[idx] = plane.strides[0] // 4
                    I.ref_h[idx] = plane.shape[0]
                    I.ref_w[idx] = plane.shape[1]
        for chan, comp in ((0, 0), (1, 1)):
            if comp >= pic.num_comps:
                break
            sizes = (4, 8, 16, 32) if chan == 0 else (4, 8, 16)
            for s in sizes:
                log2n = s.bit_length() - 1
                self._rdoq_blob(comp, s, 0, I.qp_comp[comp])
                blob = self._rdoq_blobs[(chan, s, 0, I.qp_comp[comp])][1]
                I.blobs[chan * 6 + log2n] = ctypes.addressof(blob)
        self._ictx_keep = self._fill_bits_kit(I)
        self._ictx = I
        return I

    def _cand_sse_batch(self, x0, y0, w, h, cand_list):
        """Weighted SSEs of many motion candidates over one PU rect in a
        single native call (ic_cand_sse_batch); python per-candidate
        fallback.  Entries are None when not compensable."""
        import os
        ic = None if os.environ.get("HM16_RERANK_LUMA_ONLY") \
            else self._inter_ctx()
        if ic is not None and cand_list:
            import ctypes

            from hm16_2_tpu_torch import native
            arr = np.zeros((len(cand_list), 8), np.int32)
            for i, (d, m0, m1) in enumerate(cand_list):
                arr[i, 0] = d
                if d & 1:
                    arr[i, 1] = m0[0]
                    arr[i, 2] = int(m0[1][0])
                    arr[i, 3] = int(m0[1][1])
                if d & 2:
                    arr[i, 4] = m1[0]
                    arr[i, 5] = int(m1[1][0])
                    arr[i, 6] = int(m1[1][1])
            out = np.zeros(len(cand_list), np.float64)
            rc_ = native.get_dsp().ic_cand_sse_batch(
                ctypes.byref(ic), x0, y0, w, h, x0 // 4, y0 // 4,
                arr.ctypes.data, len(cand_list), out.ctypes.data)
            if rc_ == 0:
                return [None if v < 0 else float(v) for v in out]
        return [self._cand_sse(x0, y0, w, h, c) for c in cand_list]

    def _cand_sse(self, x0, y0, w, h, cand):
        """Weighted multi-component SSE of one motion candidate's
        prediction vs the original (merge-RD pricing; HM prices full
        cost in TEncCu::xCheckRDCostMerge2Nx2N — the luma-only rank
        systematically skewed chroma-heavy picks).  Returns None when
        the candidate is not compensable."""
        import os
        pic = self.pic
        rc = self.mvp.rc
        inter_dir, m0, m1 = cand
        ic = None if os.environ.get("HM16_RERANK_LUMA_ONLY") \
            else self._inter_ctx()
        if ic is not None:
            # native path: write the candidate's motion into the PU
            # origin part, predict+SSE in one C call, restore
            import ctypes

            from hm16_2_tpu_torch import native
            ppx, ppy = x0 // 4, y0 // 4
            sd = (int(pic.inter_dir[ppy, ppx]),
                  int(pic.ref_idx[0][ppy, ppx]),
                  int(pic.ref_idx[1][ppy, ppx]),
                  pic.mv[0][ppy, ppx].copy(),
                  pic.mv[1][ppy, ppx].copy())
            pic.inter_dir[ppy, ppx] = inter_dir
            for lx, m in ((0, m0), (1, m1)):
                if (inter_dir >> lx) & 1:
                    pic.ref_idx[lx][ppy, ppx] = m[0]
                    pic.mv[lx][ppy, ppx] = m[1]
                else:
                    pic.ref_idx[lx][ppy, ppx] = -1
            v = native.get_dsp().ic_cand_sse(
                ctypes.byref(ic), x0, y0, w, h, ppx, ppy)
            pic.inter_dir[ppy, ppx] = sd[0]
            pic.ref_idx[0][ppy, ppx] = sd[1]
            pic.ref_idx[1][ppy, ppx] = sd[2]
            pic.mv[0][ppy, ppx] = sd[3]
            pic.mv[1][ppy, ppx] = sd[4]
            if v >= 0:
                return float(v)
        ncomp = 1 if os.environ.get("HM16_RERANK_LUMA_ONLY") \
            else pic.num_comps
        total = 0.0
        for comp in range(ncomp):
            sx, sy = pic.comp_shift[comp]
            cw, chh = w >> sx, h >> sy
            cx0, cy0 = x0 >> sx, y0 >> sy
            outs = [None, None]
            for lx, m in ((0, m0), (1, m1)):
                if not ((inter_dir >> lx) & 1):
                    continue
                r_idx, mvv = m
                if r_idx < 0 or r_idx >= len(rc.ref_lists[lx]):
                    return None
                outs[lx] = interp_ref.mc_block(
                    rc.ref_lists[lx][r_idx].rec[comp], cx0, cy0, cw, chh,
                    mvv[0], mvv[1], 2 + sx, 2 + sy, comp == 0,
                    self.bit_depth[comp], inter_dir == 3)
            if inter_dir == 3:
                pred = interp_ref.bi_average(outs[0], outs[1],
                                             self.bit_depth[comp])
            else:
                pred = outs[0] if outs[0] is not None else outs[1]
            if pred is None:
                return None
            o = self.orig[comp][cy0:cy0 + chh, cx0:cx0 + cw]
            d = (o - pred).astype(np.float64).ravel()
            wgt = 1.0 if comp == 0 else self.chroma_weight
            total += wgt * float(np.dot(d, d))
        return total

    def _commit_planned_inter(self, px, py, log2) -> bool:
        """Commit one inter CU decided by the fused frame plan
        (encode/inter_plan.py): map the planned motion onto the EXACT
        merge/AMVP candidate lists derived from committed neighbors, then
        run normative MC + residual coding.  Returns False when the
        planned motion cannot be signalled (caller falls back)."""
        pic, sh, plan = self.pic, self.sh, self.plan
        rc = self.mvp.rc
        size = 1 << log2
        x0, y0 = px * 4, py * 4
        n = size // 4
        sl = np.s_[py:py + n, px:px + n]
        part = int(plan.part[py, px])
        if part in (1, 2):
            return self._commit_planned_rect(px, py, log2, part)
        kind = int(plan.kind[py, px])
        dirv = int(plan.dir[py, px])
        skip_hint = bool(plan.skip_hint[py, px])
        mv = [(int(plan.mv[lx, py, px, 0]), int(plan.mv[lx, py, px, 1]))
              for lx in range(2)]                       # (x, y) q-pel
        active = [lx for lx in range(2) if (dirv >> lx) & 1]
        prefs = []
        for lx in active:
            r = int(plan.ref[lx, py, px])
            if r < 0 or r >= min(sh.num_ref_idx[lx],
                                 len(rc.ref_lists[lx])):
                return False
            prefs.append(r)

        pic.depth[sl] = pic.log2_ctb - log2
        pic.part_size[sl] = SIZE_2Nx2N
        pic.pred_mode[sl] = MODE_INTER
        pic.qp[sl] = self.cur_qp
        pic.coded[sl] = True
        pic.tr_idx[sl] = 0
        pic.merge_flag[sl] = 0
        pic.intra_luma[sl] = 0
        for lx in range(2):
            pic.ref_idx[lx][sl] = -1
            pic.mv[lx][sl] = 0
            pic.mvd[lx][sl] = 0
            pic.ref_poc[lx][sl] = -(10 ** 9)

        # exact merge list from committed neighbors (needed by both the
        # planned-merge mapping and the AMVP merge-representation check)
        cands = self.mvp.merge_candidates(
            x0, y0, size, size, 0, SIZE_2Nx2N, px, py)
        cands = cands[:sh.max_num_merge_cand]

        def _match_merge():
            """Index of the exact candidate identical to the planned
            motion (dir + per-list ref/mv), or None."""
            for i, (cd, m0, m1) in enumerate(cands):
                if cd != dirv:
                    continue
                ok = True
                for j, lx in enumerate(active):
                    m = (m0, m1)[lx]
                    if m[0] != prefs[j] or tuple(m[1]) != mv[lx]:
                        ok = False
                        break
                if ok:
                    return i
            return None

        # ---- unified SSE rerank: EVERY exact merge candidate AND the
        # planned motion signalled as AMVP compete on luma SSE + exact
        # signalling bits (TEncCu tests merge-2Nx2N and inter-2Nx2N as
        # sibling RD candidates; the plan's kind is a hint, not a
        # commitment).  SSE (not SATD) because these CUs are often
        # committed skip/zero-residual, where the candidate's prediction
        # IS the reconstruction (TEncCu::xCheckRDCostMerge2Nx2N). ----
        lam = self.lam
        nmerge = max(len(cands), 1)
        best = None                   # (cost, m_idx or None=planned AMVP)
        best_merge_c = None
        cand_sses = self._cand_sse_batch(x0, y0, size, size, cands)
        for i, (cand, sse) in enumerate(zip(cands, cand_sses)):
            if sse is None:
                continue
            bits = 1.0 + (i + 1 if i < nmerge - 1 else max(nmerge - 1, 1))
            c = sse + lam * bits
            if best_merge_c is None or c < best_merge_c[0]:
                best_merge_c = (c, i)
            if best is None or c < best[0]:
                best = (c, i)
        if _match_merge() is None:
            # price the planned (non-merge-representable) motion with its
            # exact min-MVD AMVP cost; it may predict far better than any
            # merge candidate (the AMVP escape), or far worse (repair)
            mpair = [(0, (0, 0)), (0, (0, 0))]
            for j, lx in enumerate(active):
                mpair[lx] = (prefs[j], mv[lx])
            sse_p = self._cand_sse(x0, y0, size, size,
                                   (dirv, mpair[0], mpair[1]))
            if sse_p is not None:
                bits = 3.0
                for j, lx in enumerate(active):
                    amvp = self.mvp.amvp_candidates(
                        x0, y0, size, size, lx, prefs[j])
                    bits += 1 + min(
                        self._mvd_bits((mv[lx][0] - amvp[k][0],
                                        mv[lx][1] - amvp[k][1]))
                        for k in range(2))
                    n_refs = min(sh.num_ref_idx[lx],
                                 len(rc.ref_lists[lx]))
                    if n_refs > 1:
                        bits += min(prefs[j] + 1, n_refs - 1)
                c = sse_p + lam * bits
                if best is None or c < best[0]:
                    best = (c, None)
        if best is None:
            return False

        def commit_choice(m_idx):
            """m_idx: merge candidate index, or None = planned AMVP."""
            if m_idx is not None:
                cd, m0, m1 = cands[m_idx]
                pic.merge_flag[sl] = 1
                pic.mvp_idx[0][sl] = m_idx
                pic.inter_dir[sl] = cd
                for lx2 in range(2):
                    pic.ref_idx[lx2][sl] = -1
                    pic.mv[lx2][sl] = 0
                    pic.mvd[lx2][sl] = 0
                    pic.ref_poc[lx2][sl] = -(10 ** 9)
                for lx2, m in ((0, m0), (1, m1)):
                    if not ((cd >> lx2) & 1):
                        continue
                    r_idx, mvc = m
                    pic.ref_idx[lx2][sl] = r_idx
                    pic.mv[lx2][sl] = mvc
                    pic.ref_poc[lx2][sl] = rc.ref_poc(lx2, r_idx)
                return self._commit_inter_residual_fast(px, py, log2, True,
                                                        skip_hint)
            pic.merge_flag[sl] = 0
            pic.inter_dir[sl] = dirv
            for j2, lx2 in enumerate(active):
                r_idx = prefs[j2]
                amvp = self.mvp.amvp_candidates(x0, y0, size, size, lx2,
                                                r_idx)
                mvq = mv[lx2]
                db = sorted((self._mvd_bits((mvq[0] - amvp[k][0],
                                             mvq[1] - amvp[k][1])), k)
                            for k in range(2))
                k = db[0][1]
                pic.ref_idx[lx2][sl] = r_idx
                pic.mv[lx2][sl] = mvq
                pic.mvd[lx2][sl] = (mvq[0] - amvp[k][0],
                                    mvq[1] - amvp[k][1])
                pic.mvp_idx[lx2][sl] = k
                pic.ref_poc[lx2][sl] = rc.ref_poc(lx2, r_idx)
            return self._commit_inter_residual_fast(px, py, log2, False,
                                                    skip_hint)

        sel = best[1]
        if sel is None and kind == 0:
            kind = 1                  # planned-merge motion coded as AMVP
        # optional true-RD tiebreak (TEncCu tests merge-2Nx2N and
        # inter-2Nx2N as full-RD siblings): when the zero-residual SSE
        # ranking puts the planned AMVP and the best merge candidate
        # close, commit BOTH with residual coding and pick by SSE +
        # exact context-counted CU bits.  Measured BD-neutral on the
        # bench clip (11.37 vs 11.26 RA 2QP probe) at ~15% commit cost,
        # so opt-in (HM16_KIND_RD=1)
        alt = None
        if sel is None and best_merge_c is not None and \
                best_merge_c[0] < 2.5 * max(best[0], 1.0):
            alt = best_merge_c[1]
        if alt is not None and os.environ.get("HM16_KIND_RD"):
            pre = self._snapshot(px, py, log2)
            best_rd = None
            win = None
            for cand_sel in (sel, alt):
                if not commit_choice(cand_sel):
                    self._restore(pre)
                    continue
                bits = self._count_cu_bits(px, py, log2,
                                           self.rd_ctx.copy())
                cost = self._sse_region(px, py, log2) + lam * bits
                if best_rd is None or cost < best_rd:
                    best_rd = cost
                    win = self._snapshot(px, py, log2)
                self._restore(pre)
            if win is None:
                return False
            self._restore(win)
            return True
        return commit_choice(sel)

    def _commit_planned_rect(self, px, py, log2, part) -> bool:
        """Commit one rect-partitioned inter CU decided by the fused
        plan: per PU (sequentially, so PU1's candidate lists see PU0's
        committed motion like TEncSearch's per-PU walk), map the planned
        uni motion onto the exact merge list or AMVP signalling, then
        run the normative per-PU MC + residual coding."""
        pic, sh, plan = self.pic, self.sh, self.plan
        rc = self.mvp.rc
        size = 1 << log2
        n = size // 4
        sl = np.s_[py:py + n, px:px + n]
        psize = SIZE_2NxN if part == 1 else SIZE_Nx2N
        lam = self.lam

        # validate both planned PUs before writing anything
        planned = []
        for pu_idx in range(2):
            dirv = int(plan.pu[pu_idx, 0, py, px])
            r_idx = int(plan.pu[pu_idx, 3, py, px])
            mvq = (int(plan.pu[pu_idx, 2, py, px]),
                   int(plan.pu[pu_idx, 1, py, px]))     # (x, y) q-pel
            lx = dirv - 1
            if lx not in (0, 1) or r_idx < 0 or \
                    r_idx >= min(sh.num_ref_idx[lx] if lx < 2 else 0,
                                 len(rc.ref_lists[lx])
                                 if lx < len(rc.ref_lists) else 0):
                return False
            planned.append((lx, r_idx, mvq))

        pic.depth[sl] = pic.log2_ctb - log2
        pic.part_size[sl] = psize
        pic.pred_mode[sl] = MODE_INTER
        pic.qp[sl] = self.cur_qp
        pic.coded[sl] = True
        pic.tr_idx[sl] = 0
        pic.merge_flag[sl] = 0
        pic.intra_luma[sl] = 0
        for lx in range(2):
            pic.ref_idx[lx][sl] = -1
            pic.mv[lx][sl] = 0
            pic.mvd[lx][sl] = 0
            pic.ref_poc[lx][sl] = -(10 ** 9)

        rects = self.cenc.pu_rects(px, py, log2, psize)
        for pu_idx, (x, y, w, h) in enumerate(rects):
            info = self._map_pu_motion(x, y, w, h, pu_idx, psize, px, py,
                                       planned[pu_idx], lam)
            if info is None:
                return False
            self._commit_pu_fields(x, y, w, h, info)
        return self._commit_inter_residual_fast(px, py, log2, False, False,
                                                psize=psize)

    def _map_pu_motion(self, x, y, w, h, pu_idx, psize, cu_px, cu_py,
                       planned, lam):
        """Choose one PU's final signalling: SSE rerank over the exact
        merge candidates vs the planned motion coded AMVP.  Returns a
        _commit_pu_fields info tag or None."""
        sh = self.sh
        rc = self.mvp.rc
        lx, r_idx, mvq = planned
        cands = self.mvp.merge_candidates(x, y, w, h, pu_idx, psize,
                                          cu_px, cu_py)
        cands = cands[:sh.max_num_merge_cand]
        nmerge = max(len(cands), 1)
        best = None
        matched = False
        for i, cand in enumerate(cands):
            cd, m0, m1 = cand
            sse = self._cand_sse(x, y, w, h, cand)
            if sse is None:
                continue
            if cd == (1 << lx):
                m = (m0, m1)[lx]
                if m[0] == r_idx and tuple(m[1]) == mvq:
                    matched = True
            bits = 1.0 + (i + 1 if i < nmerge - 1 else max(nmerge - 1, 1))
            c = sse + lam * bits
            if best is None or c < best[0]:
                best = (c, ("merge", i, cand))
        if not matched:
            mpair = (r_idx, mvq)
            sse_p = self._cand_sse(
                x, y, w, h, (1 << lx, mpair if lx == 0 else (0, (0, 0)),
                             mpair if lx == 1 else (0, (0, 0))))
            if sse_p is not None:
                amvp = self.mvp.amvp_candidates(x, y, w, h, lx, r_idx)
                db = sorted((self._mvd_bits((mvq[0] - amvp[k][0],
                                             mvq[1] - amvp[k][1])), k)
                            for k in range(2))
                bits = db[0][0] + 4.0
                n_refs = min(sh.num_ref_idx[lx], len(rc.ref_lists[lx]))
                if n_refs > 1:
                    bits += min(r_idx + 1, n_refs - 1)
                c = sse_p + lam * bits
                if best is None or c < best[0]:
                    k = db[0][1]
                    mvd = (mvq[0] - amvp[k][0], mvq[1] - amvp[k][1])
                    best = (c, ("uni", {lx: (r_idx, mvq, mvd, k)}))
        return best[1] if best is not None else None

    def _commit_inter_residual_fast(self, px, py, log2, is_merge,
                                    skip_hint, psize=SIZE_2Nx2N):
        """Native inter CU commit (dsp_core inter_commit_cu) with the
        Python _inter_residual_commit as fallback."""
        ic = self._inter_ctx()
        if ic is not None:
            import ctypes

            from hm16_2_tpu_torch import native
            recon = _trace.ON and _trace.open("commit.recon")
            if native.get_dsp().inter_commit_cu(
                    ctypes.byref(ic), px, py, log2, int(skip_hint),
                    int(is_merge), int(psize)) == 0:
                recon and _trace.close(recon, "commit.native_cus")
                return True
            recon and _trace.close(recon)
        _trace.ON and _trace.open("commit.recon", key="python")
        return self._inter_residual_commit(px, py, log2, is_merge,
                                           skip_hint)

    def _mark_cu_fields(self, px, py, log2, part_size):
        pic = self.pic
        n = (1 << log2) // 4
        sl = np.s_[py:py + n, px:px + n]
        pic.depth[sl] = pic.log2_ctb - log2
        pic.pred_mode[sl] = MODE_INTRA
        pic.part_size[sl] = part_size
        pic.qp[sl] = self.cur_qp
        # slice_id prefilled per CTU map at frame start
        pic.tr_idx[sl] = 0

    def _plan_chroma(self, px, py, luma_mode):
        """Resolve the planned chroma candidate: (stored syntax value,
        actual prediction mode).  Candidates: planar/ver/hor/dc with the
        34-substitution on collision, or DM (index 4).
        HM16_FORCE_CHROMA_MODE forces the decision (Debug.h
        ForceChromaMode dual): 0..3 = planar/ver/hor/dc, 4 = DM."""
        import os
        fc = os.environ.get("HM16_FORCE_CHROMA_MODE")
        if fc is not None:
            ci = int(fc)
        else:
            ci = 4 if self.plan is None else int(self.plan.cmode[py, px])
        if ci == 4:
            return DM_CHROMA_IDX, luma_mode
        base = (0, 26, 10, 1)[ci]
        stored = 34 if base == luma_mode else base
        return stored, stored

    def _commit_cu(self, px, py, log2, mode, tusplit=False):
        """Commit one planned intra 2Nx2N CU (TU == CU, or one shared-mode
        TU split — intra RQT level 1, xRecurIntraCodingQT split branch)."""
        pic = self.pic
        n = (1 << log2) // 4
        self._mark_cu_fields(px, py, log2, SIZE_2Nx2N)
        sl = np.s_[py:py + n, px:px + n]
        fl = os.environ.get("HM16_FORCE_LUMA_MODE")
        if fl is not None:
            # Debug.h ForceLumaMode dual: targeted debugging with a fixed
            # intra direction everywhere (>max-TB CUs keep their forced
            # TU split)
            mode = int(fl)
            if log2 <= self.sps.log2_max_tb:
                tusplit = False
        if not tusplit:
            r = None if fl is not None else \
                self._refine_mode(px, py, log2, mode)
            if r is not None:
                mode, cbf_y = r
            pic.intra_luma[sl] = mode
            cstored, cmode = self._plan_chroma(px, py, mode)
            pic.intra_chroma[sl] = cstored
            pic.coded[sl] = True
            if r is None:
                cbf_y = self._code_tu(px, py, log2, 0, mode)
            pic.cbf[0][sl] = cbf_y
            if pic.num_comps > 1:
                if self.sps.chroma_format_idc == 2:
                    # 4:2:2: two square chroma sub-TUs, cbf sub-flags one
                    # depth below the (tr_depth 0) TU
                    self._commit_chroma_422(px, py, log2, cmode, sub_bit=1)
                else:
                    pic.cbf[1][sl] = self._code_tu(px, py, log2, 1, cmode)
                    pic.cbf[2][sl] = self._code_tu(px, py, log2, 2, cmode)
            self._maybe_pcm(px, py, log2)
            return
        pic.intra_luma[sl] = mode
        cstored, cmode = self._plan_chroma(px, py, mode)
        pic.intra_chroma[sl] = cstored
        pic.tr_idx[sl] = 1
        pic.coded[sl] = False
        half = max(n // 2, 1)
        for sub in range(4):
            cx = px + (sub & 1) * half
            cy = py + (sub >> 1) * half
            csl = np.s_[cy:cy + half, cx:cx + half]
            cbf = self._code_tu(cx, cy, log2 - 1, 0, mode)
            pic.cbf[0][csl] = cbf << 1
            # mark the child's parts coded before its chroma commit: the
            # 4:2:2 lower sub-TU's top references live in the SAME child
            # (upper half), which the decoder's z-order availability
            # treats as available (part_available checks coded flags too)
            pic.coded[csl] = True
            if pic.num_comps > 1 and log2 > 3:
                # chroma splits with luma (child blocks are >= 4x4)
                if self.sps.chroma_format_idc == 2:
                    self._commit_chroma_422(cx, cy, log2 - 1, cmode,
                                            sub_bit=2, comb_bit=1)
                else:
                    cb = self._code_tu(cx, cy, log2 - 1, 1, cmode)
                    cr = self._code_tu(cx, cy, log2 - 1, 2, cmode)
                    pic.cbf[1][csl] = cb << 1
                    pic.cbf[2][csl] = cr << 1
        if pic.num_comps > 1:
            if log2 == 3:
                # chroma stays at the 8x8 parent (4:2:2: its two 4x4
                # sub-TUs, sub-flags at depth 2 — TDecEntropy.cpp:549)
                if self.sps.chroma_format_idc == 2:
                    self._commit_chroma_422(px, py, 3, cmode, sub_bit=2)
                else:
                    pic.cbf[1][sl] = self._code_tu(px, py, 3, 1, cmode)
                    pic.cbf[2][sl] = self._code_tu(px, py, 3, 2, cmode)
            else:
                # root chroma cbf = OR of the children (bit 0)
                for comp in (1, 2):
                    root = 1 if np.any(pic.cbf[comp][sl] & 2) else 0
                    pic.cbf[comp][sl] |= root

    def _commit_nxn(self, px, py):
        """Commit a planned intra NxN 8x8 CU: four 4x4 PUs with their own
        modes and TUs (coded z-order so each PU predicts from the previous
        PU's reconstruction), chroma as one 4x4 TU at the CU level."""
        pic, plan = self.pic, self.plan
        self._mark_cu_fields(px, py, 3, SIZE_NxN)
        sl = np.s_[py:py + 2, px:px + 2]
        pic.tr_idx[sl] = 1
        pic.coded[sl] = False
        is444 = pic.num_comps > 1 and self.sps.chroma_format_idc == 3
        fl = os.environ.get("HM16_FORCE_LUMA_MODE")
        for oy in range(2):
            for ox in range(2):
                mode = int(fl) if fl is not None else \
                    int(plan.mode[py + oy, px + ox])
                r = None if fl is not None else \
                    self._refine_mode(px + ox, py + oy, 2, mode)
                if r is not None:
                    mode, cbf = r
                    pic.intra_luma[py + oy, px + ox] = mode
                else:
                    pic.intra_luma[py + oy, px + ox] = mode
                    cbf = self._code_tu(px + ox, py + oy, 2, 0, mode)
                pic.cbf[0][py + oy, px + ox] = cbf << 1
                if is444:
                    # 4:4:4: chroma splits with luma — code this PU's
                    # chroma TU NOW so the next PU's chroma references
                    # match the decoder's z-order reconstruction
                    cstored, cmode = self._plan_chroma(
                        px, py, int(pic.intra_luma[py + oy, px + ox]))
                    pic.intra_chroma[py + oy, px + ox] = cstored
                    m = cmode if cstored != DM_CHROMA_IDX else \
                        int(pic.intra_luma[py + oy, px + ox])
                    for comp in (1, 2):
                        c_ = self._code_tu(px + ox, py + oy, 2, comp, m)
                        pic.cbf[comp][py + oy, px + ox] = c_ << 1
                pic.coded[py + oy, px + ox] = True
        if is444:
            for comp in (1, 2):
                if np.any(pic.cbf[comp][sl] & 2):
                    pic.cbf[comp][sl] |= 1
            self._maybe_pcm(px, py, 3)
            return
        cstored, cmode = self._plan_chroma(px, py,
                                           int(pic.intra_luma[py, px]))
        pic.intra_chroma[sl] = cstored
        if pic.num_comps > 1:
            if self.sps.chroma_format_idc == 2:
                self._commit_chroma_422(px, py, 3, cmode, sub_bit=2)
            else:
                pic.cbf[1][sl] = self._code_tu(px, py, 3, 1, cmode)
                pic.cbf[2][sl] = self._code_tu(px, py, 3, 2, cmode)
        # PCM competes with the NxN coding too (the override rewrites
        # part_size to 2Nx2N, which is what pcm_flag follows)
        self._maybe_pcm(px, py, 3)

    def _fill_bits_kit(self, C):
        """Exact-TU-bit kit for the native commit engines: decisions
        price residual bits by counting the REAL residual_coding syntax
        through cabac_core's counting encoder (TEncBinCABACCounter twin)
        with fresh slice-init contexts per TU, replacing the linear
        regression estimate.  Returns objects that must stay alive."""
        import ctypes
        import os

        from hm16_2_tpu_torch import native
        lib = native.get_lib()
        if lib is None or os.environ.get("HM16_NO_EXACT_BITS"):
            return []
        from hm16_2_tpu_torch.bitstream.cabac import ContextSet
        keep = []
        ctx = ContextSet()
        ctx.reset(self.sh.slice_type, min(max(self.sh.qp, 0), 51))
        keep.append(ctx.state)
        C.resenc = ctypes.cast(lib.encode_residual, ctypes.c_void_p)
        C.bits_ctx_init = ctx.state.ctypes.data
        C.bits_ctx_n = ctx.state.size
        enc = self.cenc
        cu = type("CU", (), {})()
        cu.tqb = 0
        cu.pred_mode = None
        be_valid = bool(self.pps.sign_data_hiding)
        for w in (4, 8, 16, 32):
            log2w = w.bit_length() - 1
            for st_ in ((0, 1, 2) if w <= 8 else (0,)):
                ti = (log2w - 2) * 3 + st_
                scan, scan_cg = type(enc)._scan32(w, st_)
                keep.append((scan, scan_cg))
                C.bits_scan[ti] = scan.ctypes.data
                C.bits_scan_cg[ti] = scan_cg.ctypes.data
                for chan, comp in ((0, 0), (1, 1)):
                    if chan == 1 and w > 16:
                        continue
                    if comp >= self.pic.num_comps:
                        continue
                    p = enc._res_params(cu, log2w, comp, st_, 0, be_valid)
                    keep.append(p)
                    C.bits_params[chan * 12 + ti] = ctypes.addressof(p)
        return keep

    def _commit_ctx(self):
        """ctypes CommitCtx for the native plan-commit engine, or None
        when the fast path's preconditions don't hold."""
        cctx = getattr(self, "_cctx", None)
        if cctx is not False and cctx is not None:
            return cctx
        if cctx is False:
            return None
        import ctypes
        import os

        from hm16_2_tpu_torch import native
        pic, sps, pps = self.pic, self.sps, self.pps
        lib = native.get_dsp()
        ok = (lib is not None and self.rdoq and self.plan is not None
              and not pps.constrained_intra_pred
              and not sps.scaling_list_enabled
              and not pps.transquant_bypass_enabled
              and not sps.pcm_enabled
              and sps.chroma_format_idc in (0, 1)
              and len(pic.tiles.col_bounds) == 2
              and len(pic.tiles.row_bounds) == 2
              and len(pic.slices) == 1
              # the native engine quantizes with the fixed slice QP; with
              # cu_qp_delta (AQ / CTU-level RC) the per-CTU QP must win
              and not pps.cu_qp_delta_enabled
              # the native walk is the INTRA plan commit; inter plans
              # commit through _commit_planned_inter on the host
              and self.sh.slice_type == I_SLICE
              # RExt HT tools (rotation/RDPCM/rice/alignment) live in the
              # Python TU coders only
              and not sps.transform_skip_rotation
              and not sps.implicit_rdpcm
              and not sps.persistent_rice_adaptation
              and not sps.cabac_bypass_alignment
              and not os.environ.get("HM16_NO_COMMIT_ENGINE"))
        if not ok:
            self._cctx = False
            return None
        from hm16_2_tpu_torch.decode.picture import (
            MODE_INTRA, SIZE_2Nx2N, SIZE_NxN)
        C = native.CommitCtx()
        C.pic_w, C.pic_h = pic.w, pic.h
        C.parts_w = pic.pw
        C.plan_w = self.plan.w4
        C.ctb_log2 = pic.log2_ctb
        C.num_comps = pic.num_comps
        C.chroma_fmt = sps.chroma_format_idc
        C.slice_qp = self.sh.qp
        C.strong_smoothing = 1 if sps.strong_intra_smoothing else 0
        C.smoothing_disabled = 1 if sps.intra_smoothing_disabled else 0
        C.mode_intra = MODE_INTRA
        C.size_2nx2n = SIZE_2Nx2N
        C.size_nxn = SIZE_NxN
        C.dm_chroma_idx = DM_CHROMA_IDX
        C.lam = float(self.lam)
        for c in range(pic.num_comps):
            C.bd[c] = self.bit_depth[c]
        # the qp part-array isn't filled yet at plan time: derive TU qps
        # from the slice qp directly (no dQP in the planned path)
        qpy = self.sh.qp
        C.qp_comp[0] = qpy + 6 * (sps.bit_depth_luma - 8)
        if pic.num_comps > 1:
            from hm16_2_tpu_torch.common.tables import CHROMA_QP_SCALE
            bd_off = 6 * (sps.bit_depth_chroma - 8)
            for comp in (1, 2):
                off = (pps.cb_qp_offset + self.sh.cb_qp_offset) if comp == 1 \
                    else (pps.cr_qp_offset + self.sh.cr_qp_offset)
                base = int(np.clip(qpy + off, -bd_off, 57))
                C.qp_comp[comp] = base + bd_off if base < 0 else \
                    int(CHROMA_QP_SCALE[sps.chroma_format_idc][base]) + bd_off
        keep = []
        for c in range(pic.num_comps):
            orig = self.orig[c]
            if orig.dtype != np.int32 or not orig.flags.c_contiguous:
                orig = np.ascontiguousarray(orig, dtype=np.int32)
                self.orig[c] = orig
            C.orig_p[c] = orig.ctypes.data
            C.rec_p[c] = pic.rec[c].ctypes.data
            C.coeff_p[c] = pic.coeff[c].ctypes.data
            C.orig_stride[c] = orig.shape[1]
            C.plane_stride[c] = pic.rec[c].shape[1]
            C.plane_h[c] = pic.rec[c].shape[0]
        assert pic.coded.dtype == np.bool_
        C.coded = pic.coded.ctypes.data
        C.depth = pic.depth.ctypes.data
        C.part_size = pic.part_size.ctypes.data
        C.pred_mode = pic.pred_mode.ctypes.data
        C.intra_luma = pic.intra_luma.ctypes.data
        C.intra_chroma = pic.intra_chroma.ctypes.data
        C.qp_arr = pic.qp.ctypes.data
        C.slice_id = pic.slice_id.ctypes.data
        C.tr_idx = pic.tr_idx.ctypes.data
        for c in range(3):
            C.cbf[c] = pic.cbf[c].ctypes.data
        plan = self.plan
        cands = np.ascontiguousarray(plan.cands)
        keep.append(cands)
        C.plan_depth = plan.depth.ctypes.data
        C.plan_nxn = plan.nxn.ctypes.data
        C.plan_mode = plan.mode.ctypes.data
        C.plan_tusplit = plan.tusplit.ctypes.data
        C.plan_cmode = plan.cmode.ctypes.data
        C.plan_cands = cands.ctypes.data
        # RDOQ blobs: [chan][log2n 0..5][scan 0..2]
        for chan, comp in ((0, 0), (1, 1)):
            if comp >= pic.num_comps:
                break
            sizes = (4, 8, 16, 32) if chan == 0 else (4, 8, 16)
            for s in sizes:
                log2n = s.bit_length() - 1
                scans = 3 if s <= (8 if chan == 0 else 4) else 1
                for sc in range(scans):
                    self._rdoq_blob(comp, s, sc, C.qp_comp[comp if chan == 0
                                                           else 1])
                    key = (chan, s, sc, C.qp_comp[comp if chan == 0 else 1])
                    blob = self._rdoq_blobs[key][1]
                    C.blobs[chan * 18 + log2n * 3 + sc] = \
                        ctypes.addressof(blob)
        keep += self._fill_bits_kit(C)
        self._cctx = C
        self._cctx_keep = keep
        return C

    # ------------------------------------------------------------------
    # commit-time candidate refinement: the batched plan ranks modes on
    # original-pixel references with estimated bits; here the top-3 RD
    # candidates are re-ranked against the true reconstructed references
    # and the true MPM signalling cost before the winner is committed
    # (the estIntraPredQT full-RD stage of HM, TEncSearch.cpp:2289, with
    # the candidate list supplied by the TPU plan)
    # ------------------------------------------------------------------

    @staticmethod
    def _res_bits_est(lvl) -> float:
        """Numpy twin of intra_rd._bits_estimate for one level block."""
        a = np.abs(lvl)
        nnz = int((a > 0).sum())
        if nnz == 0:
            return 0.8
        ys = np.nonzero(a.any(axis=1))[0]
        xs = np.nonzero(a.any(axis=0))[0]
        ly, lx = int(ys[-1]), int(xs[-1])
        nzc = max((lx + 1) * (ly + 1) - nnz, 0)
        esc = a[a > 1] - 1
        esc_bits = float((2.0 * np.ceil(np.log2(esc + 1.0)) + 1.0).sum()) \
            if esc.size else 0.0
        gt1 = int((a > 1).sum())
        lastpos = 2.0 * (np.log2(lx + 1.5) + np.log2(ly + 1.5)) + 2.0
        ncg = (lx // 4 + 1) * (ly // 4 + 1) - 1
        bits = (-0.089 * nzc + 3.798 * nnz - 0.648 * gt1 + 0.616 * esc_bits
                + 2.275 * lastpos + 1.173 * ncg - 12.817 + 1.0)
        return max(bits, 2.0)

    def _refine_mode(self, px, py, log2, planned_mode):
        """Re-rank this CU/PU's planned candidates on true references;
        commits the winner's luma TU and returns (mode, cbf), or None to
        fall back to the plain planned-mode commit."""
        plan = self.plan
        if plan is None:
            return None
        cands = plan.cands[py, px]
        uniq = []
        for m in cands:
            m = int(m)
            if m >= 0 and m not in uniq:
                uniq.append(m)
        if planned_mode not in uniq:
            uniq.insert(0, planned_mode)
        mpm = self.cenc._intra_mpm(px, py)
        # MPMs are nearly free to signal: always worth evaluating
        for m in mpm:
            if m not in uniq and len(uniq) < 5:
                uniq.append(m)
        if len(uniq) <= 1:
            return None
        size = 1 << log2
        scr = getattr(self, "_refine_scr", None)
        if scr is None:
            scr = self._refine_scr = {}
        bufs = scr.get(size)
        if bufs is None:
            bufs = scr[size] = (np.zeros((size, size), np.int32),
                                np.zeros((size, size), np.int32))
        rec_s, lvl_s = bufs
        x0, y0 = px * 4, py * 4
        orig = self.orig[0][y0:y0 + size, x0:x0 + size]
        best = None
        for mode in uniq:
            cbf = self._native_intra_code_tu(
                px, py, log2, 0, mode,
                out=(lvl_s.ctypes.data, size, rec_s.ctypes.data, size))
            if cbf < 0:
                return None          # native path unavailable
            d = (orig - rec_s).astype(np.float64).ravel()
            dist = float(np.dot(d, d))
            mb = (2.0, 3.0, 3.0)[mpm.index(mode)] if mode in mpm else 6.0
            bits = (self._res_bits_est(lvl_s) if cbf else 0.8) + mb
            cost = dist + self.lam * bits
            if best is None or cost < best[0]:
                best = (cost, mode)
        mode = best[1]
        cbf = self._native_intra_code_tu(px, py, log2, 0, mode)
        if cbf < 0:
            return None
        return mode, cbf

    def _encode_cu(self, px, py, log2):
        pic, sps = self.pic, self.sps
        size = 1 << log2
        x0, y0 = px * 4, py * 4
        depth = pic.log2_ctb - log2
        n = size // 4

        # commit CU-level part fields
        pic.depth[py:py + n, px:px + n] = depth
        pic.pred_mode[py:py + n, px:px + n] = MODE_INTRA
        pic.part_size[py:py + n, px:px + n] = SIZE_2Nx2N
        pic.qp[py:py + n, px:px + n] = self.cur_qp
        pic.coded[py:py + n, px:px + n] = True
        pic.tr_idx[py:py + n, px:px + n] = 0

        if self.sh.slice_type != I_SLICE:
            if self._try_inter_cu(px, py, log2):
                return True
            pic.pred_mode[py:py + n, px:px + n] = MODE_INTRA

        if log2 > sps.log2_max_tb:
            return False   # intra CU above max TB needs RQT split (unsupported)

        fl = os.environ.get("HM16_FORCE_LUMA_MODE")
        best_mode = int(fl) if fl is not None else \
            self._search_luma_mode(px, py, log2)
        pic.intra_luma[py:py + n, px:px + n] = best_mode
        pic.intra_chroma[py:py + n, px:px + n] = DM_CHROMA_IDX

        # transform + quant + recon per component (TU == CU)
        cbf_y = self._code_tu(px, py, log2, 0, best_mode)
        pic.cbf[0][py:py + n, px:px + n] = cbf_y          # tr_depth 0 bit
        if pic.num_comps > 1:
            chroma_mode = best_mode                        # DM
            cbf_cb = self._code_tu(px, py, log2, 1, chroma_mode)
            cbf_cr = self._code_tu(px, py, log2, 2, chroma_mode)
            pic.cbf[1][py:py + n, px:px + n] = cbf_cb
            pic.cbf[2][py:py + n, px:px + n] = cbf_cr
        self._maybe_pcm(px, py, log2)
        return True

    # ------------------------------------------------------------------
    # inter search (P slices, 2Nx2N merge/AMVP, integer-pel ME)
    # ------------------------------------------------------------------

    def _try_inter_cu(self, px, py, log2) -> bool:
        """Evaluate inter 2Nx2N (merge / per-list AMVP ME / bi-pred);
        commit and return True when chosen over the intra estimate.
        Reference: TEncSearch::predInterSearch (TEncSearch.cpp:3075),
        xMergeEstimation (:2987)."""
        pic, sh = self.pic, self.sh
        rc = self.mvp.rc
        is_b = sh.slice_type == B_SLICE
        size = 1 << log2
        x0, y0 = px * 4, py * 4
        n = size // 4
        orig = self.orig[0][y0:y0 + size, x0:x0 + size].astype(np.int64)
        lam = int(np.sqrt(0.85 * 2.0 ** ((sh.qp - 12) / 3.0)) + 0.5)

        best = None    # (cost, kind, payload)
        merge_best = None
        cands = self.mvp.merge_candidates(x0, y0, size, size, 0, SIZE_2Nx2N,
                                          px, py)
        for m_idx, cand in enumerate(cands[:sh.max_num_merge_cand]):
            pred = self._mc_luma_cand(x0, y0, size, cand)
            if pred is None:
                continue
            cost = satd_block(orig - pred) + lam * (m_idx + 1)
            if merge_best is None or cost < merge_best[0]:
                merge_best = (cost, (m_idx, cand))
            if best is None or cost < best[0]:
                best = (cost, "merge", (m_idx, cand))

        # per-list, per-reference motion estimation: integer full search
        # around the AMVP predictor (plus a zero-MV center on the nearest
        # reference), then half/quarter-pel refinement
        # (TEncSearch::xPatternSearchFracDIF; adaptive range per ref like
        # TEncSearch.cpp:3816's search-range scaling)
        uni = {}
        for lx in ((0, 1) if is_b else (0,)):
            if sh.num_ref_idx[lx] <= 0 or not rc.ref_lists[lx]:
                continue
            n_refs = min(sh.num_ref_idx[lx], len(rc.ref_lists[lx]))
            best_u = None
            for r_idx in range(n_refs):
                ref = rc.ref_lists[lx][r_idx]
                amvp = self.mvp.amvp_candidates(x0, y0, size, size, lx,
                                                r_idx)
                mv_int = None
                plan = getattr(self, "me_plan", None)
                if plan is not None:
                    mv_int = plan.lookup(lx, r_idx, size, x0, y0)
                if mv_int is not None:
                    # the plan MV is pure-SSD driven: also try the AMVP
                    # predictor center and keep the cheaper (SAD + the
                    # exact MVD bins both predictors can signal)
                    mv_p = (amvp[0][0] >> 2, amvp[0][1] >> 2)
                    if mv_p != mv_int:
                        def icost(mv):
                            pred = interp_ref.mc_block(
                                ref.rec[0], x0, y0, size, size, mv[0] * 4,
                                mv[1] * 4, 2, 2, True, self.bit_depth[0],
                                False)
                            b = min(self._mvd_bits((4 * mv[0] - amvp[k][0],
                                                    4 * mv[1] - amvp[k][1]))
                                    for k in range(2))
                            return satd_block(orig - pred) + lam * b
                        if icost(mv_p) < icost(mv_int):
                            mv_int = mv_p
                if mv_int is None:
                    rng = 8 if r_idx == 0 else 4
                    mv_int, sad = self._int_me(
                        orig, ref.rec[0], x0, y0, size,
                        (amvp[0][0] >> 2, amvp[0][1] >> 2), rng=rng)
                    if r_idx == 0 and (amvp[0][0] >> 2 or amvp[0][1] >> 2):
                        mv_z, sad_z = self._int_me(orig, ref.rec[0], x0, y0,
                                                   size, (0, 0), rng=rng)
                        if sad_z < sad:
                            mv_int = mv_z
                mv_q, satd_c = self._subpel_refine(orig, ref.rec[0], x0, y0,
                                                   mv_int, size)
                mvd_bits = []
                for k in range(2):
                    d = (mv_q[0] - amvp[k][0], mv_q[1] - amvp[k][1])
                    mvd_bits.append((self._mvd_bits(d), k, d))
                mvd_bits.sort()
                bits_k, mvp_idx, mvd = mvd_bits[0]
                # ref_idx signalling: truncated unary against n_refs
                bits_r = bits_k + (min(r_idx + 1, n_refs - 1) if n_refs > 1
                                   else 0)
                cost = satd_c + lam * (bits_r + 2 + (2 if is_b else 0))
                if best_u is None or cost < best_u[0]:
                    best_u = (cost, r_idx, mv_q, mvd, mvp_idx, bits_r)
            if best_u is None:
                continue
            uni[lx] = best_u
            cost, r_idx, mv_q, mvd, mvp_idx, _ = best_u
            if best is None or cost < best[0]:
                best = (cost, "uni", (lx, r_idx, mv_q, mvd, mvp_idx))
        if is_b and 0 in uni and 1 in uni:
            bd = self.bit_depth[0]
            u0, u1 = uni[0], uni[1]
            ref0 = rc.ref_lists[0][u0[1]].rec[0]
            ref1 = rc.ref_lists[1][u1[1]].rec[0]
            p0 = interp_ref.mc_block(ref0, x0, y0, size, size,
                                     u0[2][0], u0[2][1], 2, 2, True, bd,
                                     True)
            p1 = interp_ref.mc_block(ref1, x0, y0, size, size,
                                     u1[2][0], u1[2][1], 2, 2, True, bd,
                                     True)
            # one bi refinement round (TEncSearch.cpp:3260-3450's
            # iterative scheme, single iteration): re-search each list
            # against the other list's compensated residual target.
            # p0 is 14-bit internal with -IF_INTERNAL_OFFS folded in;
            # map back to the pixel domain before forming the target.
            shift_hp = interp_ref.IF_INTERNAL_PREC - bd
            tgt1 = 2 * orig - ((p0 + interp_ref.IF_INTERNAL_OFFS)
                               >> shift_hp)
            mv1, _ = self._subpel_refine(tgt1, ref1, x0, y0,
                                         (u1[2][0] >> 2, u1[2][1] >> 2),
                                         size)
            if mv1 != u1[2]:
                p1b = interp_ref.mc_block(ref1, x0, y0, size, size,
                                          mv1[0], mv1[1], 2, 2, True, bd,
                                          True)
                amvp1 = self.mvp.amvp_candidates(x0, y0, size, size, 1,
                                                 u1[1])
                db = [(self._mvd_bits((mv1[0] - amvp1[k][0],
                                       mv1[1] - amvp1[k][1])), k) for k
                      in range(2)]
                db.sort()
                u1 = (u1[0], u1[1], mv1,
                      (mv1[0] - amvp1[db[0][1]][0],
                       mv1[1] - amvp1[db[0][1]][1]), db[0][1],
                      db[0][0] + (u1[5] - self._mvd_bits(u1[3])))
                p1 = p1b
            bpred = interp_ref.bi_average(p0, p1, bd)
            cost = satd_block(orig - bpred) + lam * (u0[5] + u1[5] + 6)
            if best is None or cost < best[0]:
                best = (cost, "bi", None)
                uni[1] = u1

        # rectangular partitions 2NxN / Nx2N (TEncCu.cpp:702-812): two PUs
        # with independent merge/AMVP motion, PU1's candidates seeing PU0.
        # Search pass is full-pel/SATD only (fast); the winning partition
        # is re-evaluated with subpel refinement before commit.
        if best is not None and best[0] > lam * 16:
            pref = [0] + [u[1] for u in uni.values()]
            for psize in (SIZE_2NxN, SIZE_Nx2N):
                r = self._eval_partition(px, py, log2, psize, lam, is_b,
                                         fast=True, pref_refs=pref)
                if r is not None and r[0] < best[0]:
                    best = (r[0], "part", (psize, None))
            if best[1] == "part" and self.sps.amp_enabled and \
                    log2 > self.sps.log2_min_cb and \
                    not os.environ.get("HM16_NO_AMP"):
                # fast AMP (deriveTestModeAMP, TEncCu.cpp:1676-1712): try
                # only the asymmetric variants of the winning rectangular
                # direction, full-pel/SATD like the rect pass
                amp_modes = (4, 5) if best[2][0] == SIZE_2NxN else (6, 7)
                for am in amp_modes:
                    r = self._eval_partition(px, py, log2, am, lam, is_b,
                                             fast=True, pref_refs=pref)
                    if r is not None and r[0] < best[0]:
                        best = (r[0], "part", (am, None))
            if best[1] == "part":
                psize = best[2][0]
                r = self._eval_partition(px, py, log2, psize, lam, is_b,
                                         fast=False, pref_refs=pref)
                if r is None:
                    return False
                best = (r[0], "part", (psize, r[1]))
        if best is None:
            return False

        # compare against a cheap intra estimate (skipped for CUs larger
        # than the max TB: no intra alternative exists there)
        if log2 <= self.sps.log2_max_tb:
            intra_mode = self._search_luma_mode(px, py, log2)
            ipred = self._predict(px, py, log2, 0, intra_mode)
            if satd_block(orig - ipred) + lam * 24 <= best[0]:
                return False

        # ---- final selection among the kind winners by TRUE RD:
        # commit each candidate (motion + residual coding) and price it
        # with the context-exact CABAC counter over the committed syntax
        # (the SATD ranking above only picks the per-kind winners) ----
        entries = [(best[0], best[1], best[2])]
        if merge_best is not None and best[1] != "merge":
            entries.append((merge_best[0], "merge", merge_best[1]))
        if best[1] not in ("uni", "bi") and uni:
            lx_b = min(uni, key=lambda k: uni[k][0])
            entries.append((uni[lx_b][0], "uni",
                            (lx_b,) + uni[lx_b][1:5]))
        if best[1] != "bi" and is_b and 0 in uni and 1 in uni:
            entries.append((best[0] * 1.02, "bi", None))
        entries.sort(key=lambda t: t[0])
        entries = entries[:3]
        sl = np.s_[py:py + n, px:px + n]
        pre = self._snapshot(px, py, log2)
        best_rd = None
        win_snap = None
        for _, kind, payload in entries:
            if not self._commit_inter_candidate(px, py, log2, kind,
                                                payload, uni):
                self._restore(pre)
                continue
            bits = self._count_cu_bits(px, py, log2, self.rd_ctx.copy())
            cost = self._sse_region(px, py, log2) + self.lam * bits
            if best_rd is None or cost < best_rd:
                best_rd = cost
                win_snap = self._snapshot(px, py, log2)
            self._restore(pre)
        if win_snap is None:
            return False
        self._restore(win_snap)
        return True

    def _commit_inter_candidate(self, px, py, log2, kind, payload, uni):
        """Commit one inter candidate's motion + residual; returns True
        when feasible (large-CU zero-residual constraint met)."""
        pic, sh = self.pic, self.sh
        rc = self.mvp.rc
        size = 1 << log2
        x0, y0 = px * 4, py * 4
        n = size // 4
        sl = np.s_[py:py + n, px:px + n]
        pic.pred_mode[sl] = MODE_INTER
        pic.part_size[sl] = SIZE_2Nx2N
        pic.merge_flag[sl] = 0
        for lx in range(2):
            pic.ref_idx[lx][sl] = -1
            pic.mv[lx][sl] = 0
            pic.mvd[lx][sl] = 0
            pic.ref_poc[lx][sl] = -(10 ** 9)
        if kind == "part":
            psize, infos = payload
            pic.part_size[sl] = psize
            rects = self.cenc.pu_rects(px, py, log2, psize)
            for (xr, yr, wr, hr), info in zip(rects, infos):
                self._commit_pu_fields(xr, yr, wr, hr, info)
            inter_dir = None     # per-PU; pic.inter_dir already written
        elif kind == "merge":
            m_idx, (inter_dir, m0, m1) = payload
            pic.merge_flag[sl] = 1
            pic.mvp_idx[0][sl] = m_idx
            for lx, m in ((0, m0), (1, m1)):
                if not ((inter_dir >> lx) & 1):
                    continue
                r_idx, mv = m
                pic.ref_idx[lx][sl] = r_idx
                pic.mv[lx][sl] = mv
                pic.ref_poc[lx][sl] = rc.ref_poc(lx, r_idx)
        else:
            parts = ({payload[0]: payload[1:]} if kind == "uni"
                     else {0: uni[0][1:5], 1: uni[1][1:5]})
            inter_dir = sum(1 << lx for lx in parts)
            for lx, (r_idx, mv_q, mvd, mvp_idx) in parts.items():
                pic.ref_idx[lx][sl] = r_idx
                pic.mv[lx][sl] = mv_q
                pic.mvd[lx][sl] = mvd
                pic.mvp_idx[lx][sl] = mvp_idx
                pic.ref_poc[lx][sl] = rc.ref_poc(lx, r_idx)
        if inter_dir is not None:
            pic.inter_dir[sl] = inter_dir
        return self._inter_residual_commit(px, py, log2, kind == "merge")

    def _code_inter_tu422(self, comp, cx0, cy0, cs, qp, bd, cpred):
        """Inter chroma TU of a 4:2:2 CU: the double-high chroma block is
        coded as two square (cs x cs) sub-TUs stacked vertically
        (TComTU.h:48-162; decode dual _accum_inter_resi sub422).
        Returns (cbf_up, cbf_low)."""
        pic = self.pic
        log2_tr = cs.bit_length() - 1
        slm = self._scaling_for(comp, log2_tr, False)
        out = []
        for sub in range(2):
            ys = cy0 + sub * cs
            pr = cpred[sub * cs:(sub + 1) * cs]
            co = self.orig[comp][ys:ys + cs, cx0:cx0 + cs].astype(np.int64)
            fwd = transforms_ref.forward_transform(co - pr, bd, False)
            levels = transforms_ref.quant(fwd, qp, bd, log2_tr,
                                          is_intra=False,
                                          scaling_list_coeffs=slm)
            scan = self._sbh_scan(cs, comp, -1)
            if scan is not None and np.any(levels):
                levels = transforms_ref.sign_bit_hiding(
                    levels, fwd, qp, bd, log2_tr, scan, False)
            cbf = 1 if np.any(levels) else 0
            pic.coeff[comp][ys:ys + cs, cx0:cx0 + cs] = levels
            rec_resi = 0
            if cbf:
                deq = transforms_ref.dequant(levels, qp, bd, log2_tr, slm)
                rec_resi = transforms_ref.inverse_transform(deq, bd, False)
            pic.rec[comp][ys:ys + cs, cx0:cx0 + cs] = np.clip(
                pr + rec_resi, 0, (1 << bd) - 1)
            out.append(cbf)
        return out

    def _inter_residual_commit(self, px, py, log2, is_merge,
                               skip_hint=False):
        """MC + residual coding + zero-residual RD for an inter CU whose
        motion fields are already committed.  skip_hint is NOT trusted
        for the coding decision (the plan priced it with luma-only SSE
        and estimated bits, and merge repair may have changed the MV) —
        the true zero-vs-coded RD comparison below decides."""
        pic, sh = self.pic, self.sh
        size = 1 << log2
        x0, y0 = px * 4, py * 4
        n = size // 4
        sl = np.s_[py:py + n, px:px + n]

        # exact prediction through the shared decoder MC path (incl.
        # bi averaging and identical-motion collapse)
        preds = self.cenc.inter_pred_cu(px, py, log2)

        # residual per component (TU == CU; CUs above the max TB size are
        # only usable with an all-zero residual: skip / root-cbf-0)
        any_cbf = 0
        max_tb = 1 << self.sps.log2_max_tb
        is422 = self.sps.chroma_format_idc == 2
        if is422 and size > max_tb:
            return False     # 4:2:2 >max-TB inter CUs: unsupported shape
        for comp in range(pic.num_comps):
            sx, sy = pic.comp_shift[comp]
            cx0, cy0 = x0 >> sx, y0 >> sy
            cs = size >> sx
            qp = self._tu_qp(px, py, comp)
            bd = self.bit_depth[comp]
            cpred = preds[comp]
            if is422 and comp:
                # double-high chroma: two square sub-TUs, cbf sub-flags
                # one depth below (combined at bit 0, halves at bit 1 —
                # the leaf-TU convention _enc_tu_tree emits)
                half = max(n >> 1, 1)
                if self.pps.transquant_bypass_enabled and pic.tqb[py, px]:
                    c0 = self._code_tu_bypass(comp, cx0, cy0, cs,
                                              cpred[:cs])
                    c1 = self._code_tu_bypass(comp, cx0, cy0 + cs, cs,
                                              cpred[cs:])
                else:
                    c0, c1 = self._code_inter_tu422(comp, cx0, cy0, cs,
                                                    qp, bd, cpred)
                comb = c0 | c1
                pic.cbf[comp][py:py + half, px:px + n] = \
                    comb | (c0 << 1)
                pic.cbf[comp][py + half:py + n, px:px + n] = \
                    comb | (c1 << 1)
                any_cbf |= comb
                continue
            if self.pps.transquant_bypass_enabled and pic.tqb[py, px]:
                # lossless CU: residual coded directly; a >max-TB CU still
                # implicitly splits into four TUs per component, but the
                # samples are identical so only cbf granularity changes
                self._code_tu_bypass(comp, cx0, cy0, cs, cpred)
                if size > max_tb:
                    hn, hc = n // 2, cs // 2
                    kids = []
                    for q in range(4):
                        qsl = np.s_[py + (q >> 1) * hn:
                                    py + (q >> 1) * hn + hn,
                                    px + (q & 1) * hn:px + (q & 1) * hn + hn]
                        sub = pic.coeff[comp][
                            cy0 + (q >> 1) * hc:cy0 + (q >> 1) * hc + hc,
                            cx0 + (q & 1) * hc:cx0 + (q & 1) * hc + hc]
                        k = 1 if np.any(sub) else 0
                        kids.append(k)
                        v = k << 1
                        if comp == 0:
                            v |= k
                        pic.cbf[comp][qsl] = v
                    kcbf = 1 if any(kids) else 0
                    if comp:
                        pic.cbf[comp][sl] |= kcbf
                    elif kcbf:
                        pic.cbf[0][sl] |= 1
                    pic.tr_idx[sl] = 1
                    any_cbf |= kcbf
                else:
                    cbf = 1 if np.any(pic.coeff[comp][cy0:cy0 + cs,
                                                      cx0:cx0 + cs]) else 0
                    pic.cbf[comp][sl] = cbf
                    any_cbf |= cbf
                continue
            if size > max_tb:
                # CU above the max TB: the transform tree implicitly
                # splits, so code four max-TB TUs per component with
                # per-TU cbf (HM codes 64x64 inter CUs this way instead
                # of forcing an all-zero residual)
                hs = cs // 2
                log2h = hs.bit_length() - 1
                cbf = 0
                kids = []
                for q in range(4):
                    ty, tx = (q >> 1) * hs, (q & 1) * hs
                    k = self._native_code_tu(
                        comp, cx0 + tx, cy0 + ty, hs, log2h, bd, qp,
                        False, False, cpred[ty:ty + hs, tx:tx + hs])
                    if k < 0:
                        return False        # native core unavailable
                    kids.append(k)
                hn = n // 2
                for q in range(4):
                    qsl = np.s_[py + (q >> 1) * hn:py + (q >> 1) * hn + hn,
                                px + (q & 1) * hn:px + (q & 1) * hn + hn]
                    v = kids[q] << 1
                    if comp == 0:
                        v |= kids[q]        # origin-part root-cbf mirror
                    pic.cbf[comp][qsl] = v
                cbf = 1 if any(kids) else 0
                if comp:
                    # coded root chroma cbf at depth 0
                    pic.cbf[comp][sl] |= cbf
                else:
                    if cbf:
                        pic.cbf[0][sl] |= 1
                pic.tr_idx[sl] = 1
                any_cbf |= cbf
                continue
            else:
                log2_tr = cs.bit_length() - 1
                cbf = self._native_code_tu(comp, cx0, cy0, cs, log2_tr, bd,
                                           qp, False, False, cpred)
                if cbf < 0:
                    co = self.orig[comp][cy0:cy0 + cs,
                                         cx0:cx0 + cs].astype(np.int64)
                    fwd = transforms_ref.forward_transform(co - cpred, bd,
                                                           False)
                    slm = self._scaling_for(comp, log2_tr, False)
                    levels = transforms_ref.quant(fwd, qp, bd, log2_tr,
                                                  is_intra=False,
                                                  scaling_list_coeffs=slm)
                    scan = self._sbh_scan(cs, comp, -1)
                    if scan is not None and np.any(levels):
                        levels = transforms_ref.sign_bit_hiding(
                            levels, fwd, qp, bd, log2_tr, scan, False)
                    cbf = 1 if np.any(levels) else 0
                    pic.coeff[comp][cy0:cy0 + cs, cx0:cx0 + cs] = levels
                    rec_resi = 0
                    if cbf:
                        deq = transforms_ref.dequant(levels, qp, bd, log2_tr,
                                                     slm)
                        rec_resi = transforms_ref.inverse_transform(deq, bd,
                                                                    False)
                    pic.rec[comp][cy0:cy0 + cs, cx0:cx0 + cs] = np.clip(
                        cpred + rec_resi, 0, (1 << bd) - 1)
            pic.cbf[comp][sl] = cbf
            any_cbf |= cbf

        # inter TU quadtree, one level (xEstimateResidualQT full-vs-split,
        # TEncSearch.cpp:4680): try coding the residual as four half-size
        # TUs with per-TU cbf; adopt when the RD total (SSE + estimated
        # residual bits + subdiv/cbf flags) beats the whole-TU coding
        if any_cbf and log2 >= 4 and size <= max_tb and not is422:
            split_cbf = self._try_inter_tusplit(px, py, log2, preds)
            if split_cbf is not None:
                any_cbf = split_cbf

        # RD test of the zero-residual alternative (merge-skip /
        # rqt_root_cbf=0, TEncCu::xCheckDQP + TEncSearch residual-zero
        # path): at the higher hierarchy QPs the no-residual CU usually
        # wins, which is where HM's B frames get their skip density
        if any_cbf:
            dist_c = dist_z = 0.0
            bits_c = 1.0
            for comp in range(pic.num_comps):
                sx, sy = pic.comp_shift[comp]
                cx0, cy0 = x0 >> sx, y0 >> sy
                cw, ch = size >> sx, size >> sy
                w = 1.0 if comp == 0 else self.chroma_weight
                co = self.orig[comp][cy0:cy0 + ch, cx0:cx0 + cw]
                dc = (co - pic.rec[comp][cy0:cy0 + ch,
                                         cx0:cx0 + cw]).astype(np.float64)
                bdc = self.bit_depth[comp]
                pz = np.clip(preds[comp], 0, (1 << bdc) - 1)
                dz = (co - pz).astype(np.float64)
                dist_c += w * float(np.dot(dc.ravel(), dc.ravel()))
                dist_z += w * float(np.dot(dz.ravel(), dz.ravel()))
                lv = pic.coeff[comp][cy0:cy0 + ch, cx0:cx0 + cw]
                if np.any(lv):
                    if ch != cw:     # 4:2:2: per square sub-TU
                        for subl in (lv[:cw], lv[cw:]):
                            if np.any(subl):
                                bits_c += self._res_bits_est(subl)
                    else:
                        bits_c += self._res_bits_est(lv)
            if dist_z + self.lam * 1.0 < dist_c + self.lam * bits_c:
                for comp in range(pic.num_comps):
                    sx, sy = pic.comp_shift[comp]
                    cx0, cy0 = x0 >> sx, y0 >> sy
                    cw, ch = size >> sx, size >> sy
                    bdc = self.bit_depth[comp]
                    pic.coeff[comp][cy0:cy0 + ch, cx0:cx0 + cw] = 0
                    pic.rec[comp][cy0:cy0 + ch, cx0:cx0 + cw] = np.clip(
                        preds[comp], 0, (1 << bdc) - 1)
                    pic.cbf[comp][sl] = 0
                pic.tr_idx[sl] = 0
                any_cbf = 0

        pic.skip[sl] = 1 if (is_merge and not any_cbf) else 0
        return True

    def _try_inter_tusplit(self, px, py, log2, preds):
        """One-level inter TU split RD trial; returns the new any_cbf when
        the split is adopted, 0/1 when the whole TU is kept, or None when
        the trial could not run (native core unavailable)."""
        pic = self.pic
        lam = self.lam
        size = 1 << log2
        n = size // 4
        sl = np.s_[py:py + n, px:px + n]
        x0, y0 = px * 4, py * 4
        ncomp = pic.num_comps
        tot_w = 0.0
        snaps = []
        for comp in range(ncomp):
            sx, sy = pic.comp_shift[comp]
            cx0, cy0 = x0 >> sx, y0 >> sy
            cs = size >> sx
            wgt = 1.0 if comp == 0 else self.chroma_weight
            co = self.orig[comp][cy0:cy0 + cs, cx0:cx0 + cs]
            rec_w = pic.rec[comp][cy0:cy0 + cs, cx0:cx0 + cs].copy()
            coeff_w = pic.coeff[comp][cy0:cy0 + cs, cx0:cx0 + cs].copy()
            d = (co - rec_w).astype(np.float64)
            tot_w += wgt * float(np.dot(d.ravel(), d.ravel()))
            if np.any(coeff_w):
                tot_w += lam * self._res_bits_est(coeff_w)
            snaps.append((rec_w, coeff_w))
        tot_s = lam * 1.0                       # subdiv flag
        child = [[0] * 4 for _ in range(3)]
        hn = n // 2
        for comp in range(ncomp):
            sx, sy = pic.comp_shift[comp]
            cx0, cy0 = x0 >> sx, y0 >> sy
            cs = size >> sx
            hs = cs // 2
            wgt = 1.0 if comp == 0 else self.chroma_weight
            bd = self.bit_depth[comp]
            qp = self._tu_qp(px, py, comp)
            cpred = preds[comp]
            log2h = hs.bit_length() - 1
            for q in range(4):
                ty, tx = (q >> 1) * hs, (q & 1) * hs
                cbf = self._native_code_tu(
                    comp, cx0 + tx, cy0 + ty, hs, log2h, bd, qp, False,
                    False, cpred[ty:ty + hs, tx:tx + hs])
                if cbf < 0:
                    for c2 in range(ncomp):
                        sx2, sy2 = pic.comp_shift[c2]
                        cs2 = size >> sx2
                        cxx, cyy = x0 >> sx2, y0 >> sy2
                        pic.rec[c2][cyy:cyy + cs2, cxx:cxx + cs2] = \
                            snaps[c2][0]
                        pic.coeff[c2][cyy:cyy + cs2, cxx:cxx + cs2] = \
                            snaps[c2][1]
                    return None
                child[comp][q] = cbf
                tot_s += lam * 1.0              # per-TU cbf bin
                if cbf:
                    lv = pic.coeff[comp][cy0 + ty:cy0 + ty + hs,
                                         cx0 + tx:cx0 + tx + hs]
                    tot_s += lam * self._res_bits_est(lv)
            co = self.orig[comp][cy0:cy0 + cs, cx0:cx0 + cs]
            d = (co - pic.rec[comp][cy0:cy0 + cs, cx0:cx0 + cs]) \
                .astype(np.float64)
            tot_s += wgt * float(np.dot(d.ravel(), d.ravel()))
        if tot_s < tot_w:
            pic.tr_idx[sl] = 1
            any_cbf = 0
            for comp in range(ncomp):
                for q in range(4):
                    ty, tx = (q >> 1) * hn, (q & 1) * hn
                    qsl = np.s_[py + ty:py + ty + hn, px + tx:px + tx + hn]
                    v = child[comp][q] << 1
                    if comp == 0:
                        # bit 0 mirrors the child so the origin-part
                        # root-cbf check sees the residual (the depth-0
                        # luma cbf bin is never emitted under subdiv)
                        v |= child[comp][q]
                    pic.cbf[comp][qsl] = v
                    any_cbf |= child[comp][q]
                if comp and any(child[comp]):
                    pic.cbf[comp][sl] |= 1      # coded root chroma cbf
            # the luma origin part must reflect ANY child for root_cbf
            if any(child[0]):
                pic.cbf[0][sl] |= 1
            return 1 if any_cbf else 0
        for comp in range(ncomp):
            sx, sy = pic.comp_shift[comp]
            cx0, cy0 = x0 >> sx, y0 >> sy
            cs = size >> sx
            pic.rec[comp][cy0:cy0 + cs, cx0:cx0 + cs] = snaps[comp][0]
            pic.coeff[comp][cy0:cy0 + cs, cx0:cx0 + cs] = snaps[comp][1]
        return 1

    # ------------------------------------------------------------------
    # rectangular partitions (2NxN / Nx2N)
    # ------------------------------------------------------------------

    _MOTION_ARRAYS = ("pred_mode", "inter_dir", "merge_flag", "coded",
                      "slice_id", "part_size")
    _MOTION_ARRAYS_L = ("ref_idx", "mv", "ref_poc", "mvd", "mvp_idx")

    def _motion_snapshot(self, sl):
        pic = self.pic
        snap = {n: getattr(pic, n)[sl].copy() for n in self._MOTION_ARRAYS}
        for n in self._MOTION_ARRAYS_L:
            a = getattr(pic, n)
            snap[n] = a[(slice(None),) + sl].copy()
        return snap

    def _motion_restore(self, sl, snap):
        pic = self.pic
        for n in self._MOTION_ARRAYS:
            getattr(pic, n)[sl] = snap[n]
        for n in self._MOTION_ARRAYS_L:
            getattr(pic, n)[(slice(None),) + sl] = snap[n]

    def _commit_pu_fields(self, x, y, w, h, info):
        """Write one PU's motion into the picture arrays (kind-tagged info
        from _pu_best)."""
        pic = self.pic
        rc = self.mvp.rc
        ppx, ppy = x // 4, y // 4
        pwp, php = max(w // 4, 1), max(h // 4, 1)
        psl = np.s_[ppy:ppy + php, ppx:ppx + pwp]
        pic.pred_mode[psl] = MODE_INTER
        pic.coded[psl] = True
        for lx in range(2):
            pic.ref_idx[lx][psl] = -1
            pic.mv[lx][psl] = 0
            pic.mvd[lx][psl] = 0
            pic.ref_poc[lx][psl] = -(10 ** 9)
        if info[0] == "merge":
            _, m_idx, (inter_dir, m0, m1) = info
            pic.merge_flag[psl] = 1
            pic.mvp_idx[0][psl] = m_idx
            for lx, m in ((0, m0), (1, m1)):
                if not ((inter_dir >> lx) & 1):
                    continue
                r_idx, mv = m
                pic.ref_idx[lx][psl] = r_idx
                pic.mv[lx][psl] = mv
                pic.ref_poc[lx][psl] = rc.ref_poc(lx, r_idx)
        else:
            _, parts = info
            pic.merge_flag[psl] = 0
            inter_dir = sum(1 << lx for lx in parts)
            for lx, (r_idx, mv_q, mvd, mvp_idx) in parts.items():
                pic.ref_idx[lx][psl] = r_idx
                pic.mv[lx][psl] = mv_q
                pic.mvd[lx][psl] = mvd
                pic.mvp_idx[lx][psl] = mvp_idx
                pic.ref_poc[lx][psl] = rc.ref_poc(lx, r_idx)
        pic.inter_dir[psl] = inter_dir

    def _eval_partition(self, px, py, log2, psize, lam, is_b, fast=False,
                        pref_refs=None):
        """Trial both PUs of a rect partition (PU1's merge/AMVP candidates
        see PU0's committed motion, like the sequential reference search);
        the arrays are restored before returning.  Returns (cost, infos)."""
        pic = self.pic
        size = 1 << log2
        n = size // 4
        sl = np.s_[py:py + n, px:px + n]
        rects = self.cenc.pu_rects(px, py, log2, psize)
        snap = self._motion_snapshot(sl)
        infos = []
        # extra part-size bins vs 2Nx2N (rect: 1 ctx bin; AMP: + the
        # symmetric flag and the bypass variant bin)
        total = lam * (1.0 if psize < 4 else 3.0)
        try:
            for pu_idx, (x, y, w, h) in enumerate(rects):
                r = self._pu_best(px, py, log2, psize, pu_idx, x, y, w, h,
                                  lam, is_b, fast=fast, pref_refs=pref_refs)
                if r is None:
                    return None
                cost, info = r
                total += cost
                infos.append(info)
                self._commit_pu_fields(x, y, w, h, info)
        finally:
            self._motion_restore(sl, snap)
        return total, infos

    def _pu_best(self, cu_px, cu_py, log2, psize, pu_idx, x, y, w, h, lam,
                 is_b, fast=False, pref_refs=None):
        """Best merge / uni-pred decision for one PU (merge SATD ranking +
        per-ref AMVP ME seeded from the device plan's square children)."""
        pic, sh = self.pic, self.sh
        rc = self.mvp.rc
        size = 1 << log2
        orig = self.orig[0][y:y + h, x:x + w].astype(np.int64)
        small = size == 8           # bi-pred barred for 8x8 partitions
        best = None
        cands = self.mvp.merge_candidates(x, y, w, h, pu_idx, psize,
                                          cu_px, cu_py)
        for m_idx, cand in enumerate(cands[:sh.max_num_merge_cand]):
            inter_dir, m0, m1 = cand
            if inter_dir == 3 and small and (w < 8 or h < 8):
                cand = (1, m0, (-1, (0, 0)))   # decoder forces list 0
            pred = self._mc_luma_rect(x, y, w, h, cand)
            if pred is None:
                continue
            cost = satd_block(orig - pred) + lam * (m_idx + 1)
            if best is None or cost < best[0]:
                best = (cost, ("merge", m_idx, cand))
        plan = getattr(self, "me_plan", None)
        uni = {}
        for lx in ((0, 1) if is_b else (0,)):
            if sh.num_ref_idx[lx] <= 0 or not rc.ref_lists[lx]:
                continue
            n_refs = min(sh.num_ref_idx[lx], len(rc.ref_lists[lx]))
            ref_set = range(n_refs) if pref_refs is None else \
                sorted({r for r in pref_refs if r < n_refs})
            best_u = None
            for r_idx in ref_set:
                ref = rc.ref_lists[lx][r_idx]
                amvp = self.mvp.amvp_candidates(x, y, w, h, lx, r_idx)
                centers = [(amvp[0][0] >> 2, amvp[0][1] >> 2)]
                if plan is not None:
                    # largest plan grid size covering the PU (AMP rects
                    # have non-power-of-two short sides; grids exist for
                    # 8/16/32/64 only)
                    cs = max(8, 1 << (min(w, h).bit_length() - 1))
                    for ox in range(0, w, cs):
                        for oy in range(0, h, cs):
                            mvc = plan.lookup(lx, r_idx, cs, x + ox, y + oy)
                            if mvc is not None:
                                centers.append(mvc)
                bd = self.bit_depth[0]
                c_best = None
                for c in centers:
                    pred = interp_ref.mc_block(ref.rec[0], x, y, w, h,
                                               c[0] * 4, c[1] * 4, 2, 2,
                                               True, bd, False)
                    sc = satd_block(orig - pred)
                    if c_best is None or sc < c_best[0]:
                        c_best = (sc, c)
                if fast:
                    mv_q = (c_best[1][0] * 4, c_best[1][1] * 4)
                    satd_c = c_best[0]
                else:
                    mv_q, satd_c = self._subpel_refine(
                        orig, ref.rec[0], x, y, c_best[1], w, h)
                mvd_bits = []
                for k in range(2):
                    d = (mv_q[0] - amvp[k][0], mv_q[1] - amvp[k][1])
                    mvd_bits.append((self._mvd_bits(d), k, d))
                mvd_bits.sort()
                bits_k, mvp_idx, mvd = mvd_bits[0]
                bits_r = bits_k + (min(r_idx + 1, n_refs - 1) if n_refs > 1
                                   else 0)
                cost = satd_c + lam * (bits_r + 2 + (2 if is_b else 0))
                if best_u is None or cost < best_u[0]:
                    best_u = (cost, r_idx, mv_q, mvd, mvp_idx, bits_r)
            if best_u is None:
                continue
            uni[lx] = best_u
            cost, r_idx, mv_q, mvd, mvp_idx, _ = best_u
            if best is None or cost < best[0]:
                best = (cost, ("uni", {lx: (r_idx, mv_q, mvd, mvp_idx)}))
        # one-shot bi-pred from the per-list winners (barred for small PUs)
        if is_b and 0 in uni and 1 in uni and not (small and (w < 8 or h < 8)):
            bd = self.bit_depth[0]
            u0, u1 = uni[0], uni[1]
            p0 = interp_ref.mc_block(rc.ref_lists[0][u0[1]].rec[0], x, y,
                                     w, h, u0[2][0], u0[2][1], 2, 2,
                                     True, bd, True)
            p1 = interp_ref.mc_block(rc.ref_lists[1][u1[1]].rec[0], x, y,
                                     w, h, u1[2][0], u1[2][1], 2, 2,
                                     True, bd, True)
            bpred = interp_ref.bi_average(p0, p1, bd)
            cost = satd_block(orig - bpred) + lam * (u0[5] + u1[5] + 6)
            if best is None or cost < best[0]:
                best = (cost, ("uni", {0: u0[1:5], 1: u1[1:5]}))
        return best

    def _mc_luma_rect(self, x0, y0, w, h, cand):
        """Luma prediction for one merge candidate over a rect PU."""
        inter_dir, m0, m1 = cand
        rc = self.mvp.rc
        bd = self.bit_depth[0]
        outs = [None, None]
        for lx, m in ((0, m0), (1, m1)):
            if not ((inter_dir >> lx) & 1):
                continue
            r_idx, mv = m
            if r_idx < 0 or r_idx >= len(rc.ref_lists[lx]):
                return None
            outs[lx] = interp_ref.mc_block(
                rc.ref_lists[lx][r_idx].rec[0], x0, y0, w, h,
                mv[0], mv[1], 2, 2, True, bd, inter_dir == 3)
        if inter_dir == 3:
            return interp_ref.bi_average(outs[0], outs[1], bd)
        return outs[0] if outs[0] is not None else outs[1]

    def _mc_luma_cand(self, x0, y0, size, cand):
        """Approximate luma prediction for one merge candidate (ranking)."""
        inter_dir, m0, m1 = cand
        rc = self.mvp.rc
        bd = self.bit_depth[0]
        outs = [None, None]
        for lx, m in ((0, m0), (1, m1)):
            if not ((inter_dir >> lx) & 1):
                continue
            r_idx, mv = m
            if r_idx < 0 or r_idx >= len(rc.ref_lists[lx]):
                return None
            outs[lx] = interp_ref.mc_block(
                rc.ref_lists[lx][r_idx].rec[0], x0, y0, size, size,
                mv[0], mv[1], 2, 2, True, bd, inter_dir == 3)
        if inter_dir == 3:
            return interp_ref.bi_average(outs[0], outs[1], bd)
        return outs[0] if outs[0] is not None else outs[1]

    @staticmethod
    def _mvd_comp_bits(d):
        """Exact bin count of one MVD component (abs_mvd_greater0/1 +
        EG1 remainder + sign, TEncSbac::codeMvd)."""
        if d == 0:
            return 1
        a = abs(d)
        bits = 3                      # greater0, greater1, sign
        if a >= 2:
            sym = a - 2
            count = 1
            while sym >= (1 << count):
                sym -= 1 << count
                count += 1
                bits += 1
            bits += 1 + count
        return bits

    def _mvd_bits(self, d):
        return self._mvd_comp_bits(d[0]) + self._mvd_comp_bits(d[1])

    def _subpel_refine(self, orig, ref_plane, x0, y0, mv_int, w, h=None,
                       amvp=None, lam=0.0):
        """Half- then quarter-pel diamond refinement; SATD + (when the
        AMVP predictors are given) the exact MVD-bit cost, like
        xPatternSearchFracDIF's m_pcRdCost->getCost."""
        if h is None:
            h = w
        best_mv = (mv_int[0] * 4, mv_int[1] * 4)
        best = None
        seen = {}

        def cost(mv):
            if mv not in seen:
                pred = interp_ref.mc_block(ref_plane, x0, y0, w, h,
                                           mv[0], mv[1], 2, 2, True,
                                           self.bit_depth[0], False)
                sc = satd_block(orig - pred)
                c = sc
                if amvp is not None:
                    c += lam * min(
                        self._mvd_bits((mv[0] - amvp[k][0],
                                        mv[1] - amvp[k][1]))
                        for k in range(2))
                seen[mv] = (c, sc)
            return seen[mv][0]

        best = cost(best_mv)
        for step in (2, 1):
            center = best_mv
            for dy in (-step, 0, step):
                for dx in (-step, 0, step):
                    if dx == 0 and dy == 0:
                        continue
                    mv = (center[0] + dx, center[1] + dy)
                    c = cost(mv)
                    if c < best:
                        best, best_mv = c, mv
        return best_mv, seen[best_mv][1]

    def _int_me(self, orig, ref_plane, x0, y0, size, center, rng=8):
        """Integer full search +-rng around center (clamped); returns
        (mv_int, sad)."""
        ph, pw = ref_plane.shape
        cx = int(np.clip(center[0], -x0, pw - size - x0))
        cy = int(np.clip(center[1], -y0, ph - size - y0))
        best = None
        lo_x = max(-x0, cx - rng)
        hi_x = min(pw - size - x0, cx + rng)
        lo_y = max(-y0, cy - rng)
        hi_y = min(ph - size - y0, cy + rng)
        win = ref_plane[y0 + lo_y: y0 + hi_y + size,
                        x0 + lo_x: x0 + hi_x + size].astype(np.int64)
        from numpy.lib.stride_tricks import sliding_window_view
        views = sliding_window_view(win, (size, size))
        diffs = np.abs(views - orig[None, None]).sum(axis=(2, 3))
        iy, ix = np.unravel_index(np.argmin(diffs), diffs.shape)
        return (lo_x + int(ix), lo_y + int(iy)), int(diffs[iy, ix])

    def _refs_for(self, px, py, log2, comp):
        pic, sps = self.pic, self.sps
        sx, sy = pic.comp_shift[comp]
        size = (1 << log2) >> (sx if comp else 0)
        x0 = (px * 4) >> (sx if comp else 0)
        y0 = (py * 4) >> (sy if comp else 0)
        unit_w = 4 >> (sx if comp else 0)
        unit_h = 4 >> (sy if comp else 0)
        constrained = bool(self.pps.constrained_intra_pred)

        blk_parts = max((1 << log2) >> 2, 1)

        # fast path: single slice/tile, unconstrained intra — a neighbor
        # part outside the current block is available iff committed
        # (coded flags are maintained in z-order by the search)
        fast = (not constrained and
                len(pic.tiles.col_bounds) == 2 and
                len(pic.tiles.row_bounds) == 2 and
                len(pic.slices) == 1)

        if fast:
            def avail(ax, ay):
                if ax < 0 or ay < 0:
                    return False
                ppx = (ax << (sx if comp else 0)) >> 2
                ppy = (ay << (sy if comp else 0)) >> 2
                if ppx * 4 >= pic.w or ppy * 4 >= pic.h:
                    return False
                return bool(pic.coded[ppy, ppx])
        else:
            def avail(ax, ay):
                if ax < 0 or ay < 0:
                    return False
                lx, ly = ax << (sx if comp else 0), ay << (sy if comp else 0)
                return pic.part_available(lx // 4, ly // 4, px, py,
                                          constrained, blk_parts, blk_parts)

        return intra_ref.fill_reference_samples(
            pic.rec[comp], x0, y0, size, unit_w, unit_h, avail,
            self.bit_depth[comp])

    def _predict(self, px, py, log2, comp, mode):
        pic, sps = self.pic, self.sps
        sx, _ = pic.comp_shift[comp]
        size = (1 << log2) >> (sx if comp else 0)
        top, left = self._refs_for(px, py, log2, comp)
        if intra_ref.should_filter(mode, size, comp == 0, sps.chroma_format_idc,
                                   bool(sps.intra_smoothing_disabled)):
            # strong smoothing is luma-only (TComPattern.cpp:196)
            top, left = intra_ref.filter_reference_samples(
                top, left, size, self.bit_depth[comp],
                bool(sps.strong_intra_smoothing) and comp == 0)
        return intra_ref.predict_intra(mode, top, left, size,
                                       self.bit_depth[comp], comp == 0)

    def _premodes(self, log2):
        """Frame-level 35-mode SATD argmin for all aligned blocks of one
        size, on original-pixel references (K1 + K2 in SATD-only mode on a
        CUDA device, their plain versions on the CPU)."""
        cache = getattr(self, "_premode_cache", None)
        if cache is None:
            cache = self._premode_cache = {}
        if log2 in cache:
            return cache[log2]
        import torch

        from hm16_2_tpu_torch.encode import intra_rd
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

    def _search_luma_mode(self, px, py, log2) -> int:
        """35-mode SATD sweep via the batched gather-table kernel
        (estIntraPredQT analogue)."""
        pic = self.pic
        size = 1 << log2
        x0, y0 = px * 4, py * 4
        if x0 % size == 0 and y0 % size == 0:
            pm = self._premodes(log2)
            by, bx = y0 // size, x0 // size
            if by < pm.shape[0] and bx < pm.shape[1]:
                return int(pm[by, bx])
        return self._search_luma_mode_recon(px, py, log2)

    def _search_luma_mode_recon(self, px, py, log2) -> int:
        """Per-CU sweep with reconstructed references (fallback)."""
        from hm16_2_tpu_torch.ops import analysis
        pic = self.pic
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

    def _code_tu(self, px, py, log2, comp, mode) -> int:
        """Forward transform + quant + reconstruct one TU; returns cbf."""
        pic, sps = self.pic, self.sps
        sx, sy = pic.comp_shift[comp]
        size = (1 << log2) >> (sx if comp else 0)
        x0 = (px * 4) >> (sx if comp else 0)
        y0 = (py * 4) >> (sy if comp else 0)
        bd = self.bit_depth[comp]
        if self.pps.transquant_bypass_enabled and pic.tqb[py, px]:
            pred = self._predict(px, py, log2, comp, mode)
            return self._code_tu_bypass(comp, x0, y0, size, pred,
                                        mode=int(mode))
        if self.pps.transform_skip_enabled and \
                size <= (1 << self.pps.log2_max_transform_skip_block_size):
            return self._code_tu_with_tskip(px, py, log2, comp, mode, size,
                                            x0, y0, bd)
        cbf = self._native_intra_code_tu(px, py, log2, comp, mode)
        if cbf >= 0:
            return cbf
        pred = self._predict(px, py, log2, comp, mode)
        log2_tr = size.bit_length() - 1
        use_dst = (comp == 0 and size == 4)
        qp = self._tu_qp(px, py, comp)

        ccp = bool(self.pps.cross_component_prediction_enabled)
        if not ccp:
            cbf = self._native_code_tu(comp, x0, y0, size, log2_tr, bd, qp,
                                       use_dst, True, pred,
                                       mode_for_scan=mode)
            if cbf >= 0:
                return cbf

        orig = self.orig[comp][y0:y0 + size, x0:x0 + size].astype(np.int64)
        resi = orig - pred
        term = None
        if ccp and comp:
            resi, term = self._ccp_adjust(comp, px, py, x0, y0, size, resi)
        fwd = transforms_ref.forward_transform(resi, bd, use_dst)
        slm = self._scaling_for(comp, log2_tr, True)
        levels = transforms_ref.quant(fwd, qp, bd, log2_tr, is_intra=True,
                                      scaling_list_coeffs=slm)
        scan = self._sbh_scan(size, comp, int(mode))
        if scan is not None and np.any(levels):
            levels = transforms_ref.sign_bit_hiding(levels, fwd, qp, bd,
                                                    log2_tr, scan)
        cbf = 1 if np.any(levels) else 0
        pic.coeff[comp][y0:y0 + size, x0:x0 + size] = levels
        if cbf:
            deq = transforms_ref.dequant(levels, qp, bd, log2_tr, slm)
            rec_resi = transforms_ref.inverse_transform(deq, bd, use_dst)
        else:
            rec_resi = 0
        if ccp and comp == 0:
            self._ccp_capture_luma(x0, y0, size, rec_resi if cbf else 0)
        if term is not None:
            rec_resi = rec_resi + term
        pic.rec[comp][y0:y0 + size, x0:x0 + size] = np.clip(
            pred + rec_resi, 0, (1 << bd) - 1)
        return cbf

    def _code_tu_422(self, px, py, log2, comp, cmode):
        """4:2:2 chroma of one luma TU: the double-high chroma region is
        coded as two square sub-TUs stacked vertically (TComTU.h:48-162;
        parse/recon order mirrored from decode/ctu_dec.py, golden-verified
        against HM).  The lower sub-TU predicts from the upper's fresh
        reconstruction.  Marks tskip per half; returns (cbf_up, cbf_low)."""
        from hm16_2_tpu_torch.decode.ctu_dec import CHROMA422_ANGLE_MAP
        pic, sps, pps = self.pic, self.sps, self.pps
        cs = (1 << log2) >> 1
        x0, y0 = (px * 4) >> 1, py * 4
        bd = self.bit_depth[comp]
        pmode = int(CHROMA422_ANGLE_MAP[cmode])
        n = max((1 << log2) >> 2, 1)
        half_n = max(n >> 1, 1)
        constrained = bool(pps.constrained_intra_pred)
        qp = self._tu_qp(px, py, comp)
        log2_tr = cs.bit_length() - 1
        lam = getattr(self, "lam", 1.0)
        wgt = getattr(self, "chroma_weight", 1.0)
        tqb = pps.transquant_bypass_enabled and pic.tqb[py, px]
        try_ts = (not tqb and pps.transform_skip_enabled
                  and cs <= (1 << pps.log2_max_transform_skip_block_size))
        slm = self._scaling_for(comp, log2_tr, True)
        cbfs = []
        for sub in range(2):
            ys = y0 + sub * cs
            anchor_py = py + sub * half_n

            def avail(ax, ay, _a=anchor_py):
                if ax < 0 or ay < 0:
                    return False
                return pic.part_available((ax << 1) // 4, ay // 4, px, _a,
                                          constrained, n, half_n)

            top, left = intra_ref.fill_reference_samples(
                pic.rec[comp], x0, ys, cs, 2, 4, avail, bd)
            if intra_ref.should_filter(pmode, cs, False, 2,
                                       bool(sps.intra_smoothing_disabled)):
                # strong smoothing is luma-only (TComPattern.cpp:196)
                top, left = intra_ref.filter_reference_samples(
                    top, left, cs, bd, False)
            pred = intra_ref.predict_intra(pmode, top, left, cs, bd, False)
            orig = self.orig[comp][ys:ys + cs, x0:x0 + cs].astype(np.int64)
            resi = orig - pred
            rotate, rd_axis = self._rext_tu_flags(cs, comp, pmode)
            if tqb:
                lv = resi
                if rd_axis is not None:
                    lv = np.diff(resi, axis=rd_axis, prepend=0)
                if rotate:
                    lv = lv[::-1, ::-1]
                pic.coeff[comp][ys:ys + cs, x0:x0 + cs] = lv
                pic.rec[comp][ys:ys + cs, x0:x0 + cs] = orig
                cbfs.append(1 if np.any(lv) else 0)
                continue
            best = None
            for ts in ((0, 1) if try_ts else (0,)):
                if ts and rd_axis is not None:
                    lv_pix, rec_resi = self._ts_rdpcm_quant(
                        resi, qp, bd, log2_tr, slm, rd_axis)
                    levels = lv_pix[::-1, ::-1] if rotate else lv_pix
                    cbf = 1 if np.any(levels) else 0
                    rec = np.clip(pred + rec_resi, 0, (1 << bd) - 1)
                    d = (orig - rec).astype(np.float64)
                    bits = (self._res_bits_est(levels) if cbf else 0.8) \
                        + 1.0
                    cost = wgt * float(np.dot(d.ravel(), d.ravel())) \
                        + lam * bits
                    if best is None or cost < best[0]:
                        best = (cost, ts, cbf, levels, rec)
                    continue
                if ts:
                    src = resi[::-1, ::-1] if rotate else resi
                    tshift = transforms_ref.transform_shift(bd, log2_tr, 15)
                    fwd = (src << tshift) if tshift >= 0 else \
                        (src >> (-tshift))
                else:
                    fwd = transforms_ref.forward_transform(resi, bd, False)
                levels = transforms_ref.quant(fwd, qp, bd, log2_tr,
                                              is_intra=True,
                                              scaling_list_coeffs=slm)
                scan = self._sbh_scan(cs, comp, pmode)
                if scan is not None and np.any(levels):
                    levels = transforms_ref.sign_bit_hiding(
                        levels, fwd, qp, bd, log2_tr, scan)
                cbf = 1 if np.any(levels) else 0
                if cbf:
                    deq = transforms_ref.dequant(levels, qp, bd, log2_tr,
                                                 slm)
                    rec_resi = (
                        transforms_ref.inverse_transform_skip(deq, bd)
                        if ts else
                        transforms_ref.inverse_transform(deq, bd, False))
                    if ts and rotate:
                        rec_resi = rec_resi[::-1, ::-1]
                else:
                    rec_resi = 0
                rec = np.clip(pred + rec_resi, 0, (1 << bd) - 1)
                d = (orig - rec).astype(np.float64)
                bits = (self._res_bits_est(levels) if cbf else 0.8) + 1.0
                cost = wgt * float(np.dot(d.ravel(), d.ravel())) \
                    + lam * bits
                if best is None or cost < best[0]:
                    best = (cost, ts, cbf, levels, rec)
            _, ts, cbf, levels, rec = best
            pic.coeff[comp][ys:ys + cs, x0:x0 + cs] = levels
            pic.rec[comp][ys:ys + cs, x0:x0 + cs] = rec
            if try_ts:
                pic.tskip[comp][anchor_py:anchor_py + half_n,
                                px:px + n] = ts
            cbfs.append(cbf)
        return cbfs[0], cbfs[1]

    def _commit_chroma_422(self, px, py, log2, cmode, sub_bit, comb_bit=0):
        """Code both chroma components of a 4:2:2 CU/TU region and store
        cbf bits: combined at bit `comb_bit` over the whole region, the
        two sub-TU flags at bit `sub_bit` in the top/bottom part halves
        (mirrors decode/ctu_dec.py _set_cbf_half storage)."""
        pic = self.pic
        n = max((1 << log2) >> 2, 1)
        half = max(n >> 1, 1)
        for comp in (1, 2):
            pic.cbf[comp][py:py + n, px:px + n] = 0
            c0, c1 = self._code_tu_422(px, py, log2, comp, cmode)
            comb = (c0 | c1) << comb_bit
            top_sl = np.s_[py:py + half, px:px + n]
            bot_sl = np.s_[py + half:py + n, px:px + n]
            pic.cbf[comp][top_sl] |= comb | (c0 << sub_bit)
            pic.cbf[comp][bot_sl] |= comb | (c1 << sub_bit)

    def _maybe_pcm(self, px, py, log2):
        """IPCM mode check after a 2Nx2N intra CU commit (TEncSearch::
        IPCMSearch / TEncCu::xCheckIntraPCM): when the committed coding
        costs more than the raw samples, recode the CU as PCM.  With
        pcm bit depth == internal bit depth the PCM distortion is zero."""
        sps, pic = self.sps, self.pic
        if not sps.pcm_enabled or \
                not (sps.log2_min_pcm_cb <= log2 <= sps.log2_max_pcm_cb):
            return
        size = 1 << log2
        n = size // 4
        x0, y0 = px * 4, py * 4
        lam = getattr(self, "lam", 1.0)
        sse, bits, pcm_bits = 0.0, 4.0, 1.0     # mode bits vs pcm_flag
        for comp in range(pic.num_comps):
            sx, sy = pic.comp_shift[comp]
            w, h = size >> sx, size >> sy
            cx0, cy0 = x0 >> sx, y0 >> sy
            o = self.orig[comp][cy0:cy0 + h, cx0:cx0 + w]
            r = pic.rec[comp][cy0:cy0 + h, cx0:cx0 + w]
            d = (o - r).astype(np.float64).ravel()
            wgt = 1.0 if comp == 0 else getattr(self, "chroma_weight", 1.0)
            sse += wgt * float(np.dot(d, d))
            lv = pic.coeff[comp][cy0:cy0 + h, cx0:cx0 + w]
            bits += self._res_bits_est(lv) if np.any(lv) else 1.0
            pbd = sps.pcm_bit_depth_luma if comp == 0 \
                else sps.pcm_bit_depth_chroma
            pcm_bits += w * h * pbd
        if lam * pcm_bits >= sse + lam * bits:
            return
        from hm16_2_tpu_torch.ops.intra_ref import DC_IDX
        sl = np.s_[py:py + n, px:px + n]
        pic.ipcm[sl] = 1
        pic.part_size[sl] = SIZE_2Nx2N    # pcm_flag follows 2Nx2N part only
        pic.intra_luma[sl] = DC_IDX
        pic.intra_chroma[sl] = DM_CHROMA_IDX
        pic.tr_idx[sl] = 0
        pic.coded[sl] = True
        for comp in range(pic.num_comps):
            sx, sy = pic.comp_shift[comp]
            w, h = size >> sx, size >> sy
            cx0, cy0 = x0 >> sx, y0 >> sy
            bd = self.bit_depth[comp]
            pbd = sps.pcm_bit_depth_luma if comp == 0 \
                else sps.pcm_bit_depth_chroma
            o = self.orig[comp][cy0:cy0 + h, cx0:cx0 + w]
            pic.rec[comp][cy0:cy0 + h, cx0:cx0 + w] = \
                (o >> (bd - pbd)) << (bd - pbd)
            pic.coeff[comp][cy0:cy0 + h, cx0:cx0 + w] = 0
            pic.cbf[comp][sl] = 0

    def _ccp_capture_luma(self, x0, y0, size, rec_resi):
        """Record this luma TU's reconstructed residual (UNCLIPPED inverse
        transform output — decode/ctu_dec.py stores the same) for the
        chroma cross-component prediction of the co-located TU."""
        buf = getattr(self, "_ccp_lresi", None)
        if buf is None:
            buf = self._ccp_lresi = np.zeros(self.pic.rec[0].shape,
                                             dtype=np.int64)
        buf[y0:y0 + size, x0:x0 + size] = rec_resi

    def _ccp_adjust(self, comp, px, py, x0, y0, size, resi):
        """Cross-component prediction alpha search (TEncSearch.cpp:1910
        xCalcCrossComponentPredictionAlpha, decision by direct SSE over
        the signallable set {0,+-1,+-2,+-4,+-8}): stores the winning alpha
        for the emitter and returns (adjusted_residual, term) where term
        is the reconstruction-side addend (alpha * luma_resi) >> 3."""
        pic = self.pic
        n = max(size >> 2, 1)
        if int(pic.intra_chroma[py, px]) != DM_CHROMA_IDX:
            return resi, None
        buf = getattr(self, "_ccp_lresi", None)
        lr = None if buf is None else buf[y0:y0 + size, x0:x0 + size]
        if lr is None or not np.any(lr):
            pic.ccp_alpha[comp][py:py + n, px:px + n] = 0
            return resi, None
        lam = getattr(self, "lam", 1.0)
        r64 = resi.astype(np.float64).ravel()
        best = (float(np.dot(r64, r64)) + lam * 1.0, 0, resi, None)
        for a in (1, -1, 2, -2, 4, -4, 8, -8):
            term = (a * lr) >> 3
            adj = resi - term
            a64 = adj.astype(np.float64).ravel()
            bits = 1.0 + 2.0 + abs(a).bit_length()   # flag+sign+unary
            cost = float(np.dot(a64, a64)) + lam * bits
            if cost < best[0]:
                best = (cost, a, adj, term)
        _, alpha, adj, term = best
        pic.ccp_alpha[comp][py:py + n, px:px + n] = alpha
        return adj, term

    def _rext_tu_flags(self, size, comp, mode):
        """(rotate, rdpcm_axis) for a TS/transquant-bypass intra TU:
        residual rotation for 4x4 intra non-transformed blocks
        (TComTU::isNonTransformedResidualRotated) and the implicit-RDPCM
        axis when the prediction is exactly horizontal/vertical
        (TComTrQuant::rdpcmNxN implicit branch).  rdpcm_axis: 1 = rows
        cumsum (hor), 0 = cols cumsum (ver), None = off — matches
        decode/ctu_dec.py _apply_rdpcm."""
        from hm16_2_tpu_torch.ops.intra_ref import HOR_IDX, VER_IDX
        sps = self.sps
        rotate = bool(sps.transform_skip_rotation) and size == 4
        axis = None
        if sps.implicit_rdpcm:
            if mode == HOR_IDX:
                axis = 1
            elif mode == VER_IDX:
                axis = 0
        return rotate, axis

    def _ts_rdpcm_quant(self, resi, qp, bd, log2_tr, slm, axis):
        """Transform-skip quantization with implicit residual DPCM: each
        row (axis=0, vertical prediction) / column (axis=1) is predicted
        from the RECONSTRUCTED previous one, quantized, and accumulated —
        the exact inverse of the decoder's dequant + inv-shift + cumsum
        (TComTrQuant::rdpcmNxN quantized path).  Returns (levels,
        rec_resi) in pixel orientation."""
        tshift = transforms_ref.transform_shift(bd, log2_tr, 15)
        s = resi.shape[0]
        levels = np.zeros_like(resi)
        rec = np.zeros_like(resi)
        prev = np.zeros(s, dtype=np.int64)
        for i in range(s):
            line = resi[i] - prev if axis == 0 else resi[:, i] - prev
            blk = np.zeros_like(resi)
            if axis == 0:
                blk[i] = line
            else:
                blk[:, i] = line
            fwd = (blk << tshift) if tshift >= 0 else (blk >> (-tshift))
            q = transforms_ref.quant(fwd, qp, bd, log2_tr, is_intra=True,
                                     scaling_list_coeffs=slm)
            deq = transforms_ref.dequant(q, qp, bd, log2_tr, slm, True)
            r = transforms_ref.inverse_transform_skip(deq, bd)
            if axis == 0:
                levels[i] = q[i]
                prev = prev + r[i]
                rec[i] = prev
            else:
                levels[:, i] = q[:, i]
                prev = prev + r[:, i]
                rec[:, i] = prev
        return levels, rec

    def _code_tu_bypass(self, comp, x0, y0, cs, pred, mode=-1) -> int:
        """Transquant-bypass TU (cu_transquant_bypass_flag = 1): the
        residual samples are the coded coefficients, reconstruction is
        lossless (HM QpParam/TComTrQuant transquant-bypass branches).
        RExt: implicit RDPCM codes the per-line differences; 4x4 intra
        blocks are rotated 180 degrees prior to entropy coding."""
        pic = self.pic
        orig = self.orig[comp][y0:y0 + cs, x0:x0 + cs].astype(np.int64)
        resi = orig - pred
        if self.pps.cross_component_prediction_enabled and mode >= 0:
            if comp == 0:
                self._ccp_capture_luma(x0, y0, cs, resi)
            else:
                # adjusted residual still reconstructs losslessly:
                # pred + (resi - term) + term == orig  (4:4:4 only, so
                # plane coords are luma coords; parts = coords // 4)
                resi, _ = self._ccp_adjust(comp, x0 // 4, y0 // 4,
                                           x0, y0, cs, resi)
        # mode < 0: inter CU (rotation and implicit RDPCM are intra-only
        # on this path; explicit inter RDPCM is not searched)
        rotate, axis = self._rext_tu_flags(cs, comp, mode) if mode >= 0 \
            else (False, None)
        lv = resi
        if axis is not None:
            lv = np.diff(resi, axis=axis, prepend=0)
        if rotate:
            lv = lv[::-1, ::-1]
        pic.coeff[comp][y0:y0 + cs, x0:x0 + cs] = lv
        pic.rec[comp][y0:y0 + cs, x0:x0 + cs] = orig
        return 1 if np.any(lv) else 0

    def _code_tu_with_tskip(self, px, py, log2, comp, mode, size, x0, y0,
                            bd):
        """4x4 TU coded both ways — DCT/DST vs transform skip (HM
        xTransformSkip, TComTrQuant.cpp:1874) — keeping the cheaper by
        SSE + lambda * estimated bits; sets pic.tskip for the emitter."""
        pic = self.pic
        pred = self._predict(px, py, log2, comp, mode)
        log2_tr = size.bit_length() - 1
        use_dst = (comp == 0 and size == 4)
        qp = self._tu_qp(px, py, comp)
        orig = self.orig[comp][y0:y0 + size, x0:x0 + size].astype(np.int64)
        resi = orig - pred
        ccp = bool(self.pps.cross_component_prediction_enabled)
        term = None
        if ccp and comp:
            resi, term = self._ccp_adjust(comp, px, py, x0, y0, size, resi)
        lam = getattr(self, "lam", 1.0)
        wgt = 1.0 if comp == 0 else getattr(self, "chroma_weight", 1.0)
        best = None
        rotate, rd_axis = self._rext_tu_flags(size, comp, int(mode))
        for ts in (0, 1):
            slm = self._scaling_for(comp, log2_tr, True)
            if ts and rd_axis is not None:
                # implicit RDPCM engages whenever the TU is
                # transform-skipped and the intra mode is exactly hor/ver
                lv_pix, rec_resi = self._ts_rdpcm_quant(
                    resi, qp, bd, log2_tr, slm, rd_axis)
                levels = lv_pix[::-1, ::-1] if rotate else lv_pix
                cbf = 1 if np.any(levels) else 0
            else:
                if ts:
                    src = resi[::-1, ::-1] if rotate else resi
                    tshift = transforms_ref.transform_shift(bd, log2_tr,
                                                            15)
                    fwd = (src << tshift) if tshift >= 0 else \
                        (src >> (-tshift))
                else:
                    fwd = transforms_ref.forward_transform(resi, bd,
                                                           use_dst)
                levels = transforms_ref.quant(fwd, qp, bd, log2_tr,
                                              is_intra=True,
                                              scaling_list_coeffs=slm)
                scan = self._sbh_scan(size, comp, int(mode))
                if scan is not None and np.any(levels):
                    levels = transforms_ref.sign_bit_hiding(
                        levels, fwd, qp, bd, log2_tr, scan)
                cbf = 1 if np.any(levels) else 0
                if cbf:
                    deq = transforms_ref.dequant(levels, qp, bd, log2_tr,
                                                 slm)
                    if ts:
                        rec_resi = transforms_ref.inverse_transform_skip(
                            deq, bd)
                        if rotate:
                            rec_resi = rec_resi[::-1, ::-1]
                    else:
                        rec_resi = transforms_ref.inverse_transform(
                            deq, bd, use_dst)
                else:
                    rec_resi = 0
            full = rec_resi if term is None else rec_resi + term
            rec = np.clip(pred + full, 0, (1 << bd) - 1)
            d = (orig - rec).astype(np.float64)
            bits = (self._res_bits_est(levels) if cbf else 0.8) + 1.0
            cost = wgt * float(np.dot(d.ravel(), d.ravel())) + lam * bits
            if best is None or cost < best[0]:
                best = (cost, ts, cbf, levels, rec, rec_resi)
        _, ts, cbf, levels, rec, rec_resi = best
        if ccp and comp == 0:
            self._ccp_capture_luma(x0, y0, size, rec_resi)
        pic.coeff[comp][y0:y0 + size, x0:x0 + size] = levels
        pic.rec[comp][y0:y0 + size, x0:x0 + size] = rec
        n = max((1 << log2) >> 2, 1)
        pic.tskip[comp][py:py + n, px:px + n] = ts
        return cbf

    def _native_intra_code_tu(self, px, py, log2, comp, mode,
                              out=None) -> int:
        """Fused C++ intra TU: reference assembly + smoothing + prediction
        + transform/quant/recon in one call (the AI hot loop); returns cbf
        or -1 when unavailable / outside the fast-availability path.
        out=(lvl_ptr, lvl_stride, rec_ptr, rec_stride) redirects the
        outputs to scratch buffers (trial coding without commitment)."""
        from hm16_2_tpu_torch import native
        lib = native.get_dsp()
        pic = self.pic
        if lib is None or self.pps.constrained_intra_pred or \
                self.sps.scaling_list_enabled or \
                self.pps.cross_component_prediction_enabled or \
                self.pps.transquant_bypass_enabled or \
                len(pic.tiles.col_bounds) != 2 or \
                len(pic.tiles.row_bounds) != 2 or len(pic.slices) != 1:
            return -1
        if comp and self.sps.chroma_format_idc not in (0, 1):
            return -1   # 4:2:2 TU walk / 4:4:4 chroma ref filtering
        sps = self.sps
        sx, sy = pic.comp_shift[comp]
        size = (1 << log2) >> (sx if comp else 0)
        x0 = (px * 4) >> (sx if comp else 0)
        y0 = (py * 4) >> (sy if comp else 0)
        bd = self.bit_depth[comp]
        qp = self._tu_qp(px, py, comp)
        use_dst = comp == 0 and size == 4
        cache = getattr(self, "_nat_cache", None)
        if cache is None:
            cache = self._nat_cache = {}
        ent = cache.get(comp)
        if ent is None:
            orig = self.orig[comp]
            if orig.dtype != np.int32 or not orig.flags.c_contiguous:
                orig = np.ascontiguousarray(orig, dtype=np.int32)
                self.orig[comp] = orig
            rec = pic.rec[comp]
            coeff = pic.coeff[comp]
            coded = pic.coded
            assert coded.dtype == np.bool_ and coded.flags.c_contiguous
            ent = cache[comp] = (
                orig.ctypes.data, orig.shape[1],
                rec.ctypes.data, rec.shape[1], rec.shape[0],
                coeff.ctypes.data, coeff.shape[1],
                coded.ctypes.data, coded.shape[1],
                1 if sps.strong_intra_smoothing else 0,
                1 if sps.intra_smoothing_disabled else 0,
                sps.chroma_format_idc)
        (optr0, ostride, rptr0, rstride, rh, cptr0, cstride,
         kptr, kstride, strong, smooth_dis, cfmt) = ent
        import ctypes
        scan = self._sbh_scan(size, comp, int(mode))
        scan_p = scan.ctypes.data_as(ctypes.c_void_p) if scan is not None \
            else None
        blob = self._rdoq_blob(comp, size,
                               self._mdcs_scan_type(size, comp, int(mode)),
                               qp)
        if out is None:
            out = (cptr0 + 4 * (y0 * cstride + x0), cstride,
                   rptr0 + 4 * (y0 * rstride + x0), rstride)
        return lib.intra_code_tu(
            rptr0, rstride, rstride, rh, kptr, kstride, pic.w, pic.h,
            sx if comp else 0, sy if comp else 0,
            x0, y0, size, int(mode), bd, 1 if comp == 0 else 0,
            strong, smooth_dis, cfmt,
            optr0 + 4 * (y0 * ostride + x0), ostride, qp,
            1 if use_dst else 0, 1,
            out[0], out[1], out[2], out[3], scan_p, blob)

    def _native_code_tu(self, comp, x0, y0, size, log2_tr, bd, qp, use_dst,
                        is_intra, pred, mode_for_scan=-1) -> int:
        """Fused C++ transform/quant/recon; returns cbf or -1 (unavailable).
        Writes levels and reconstruction directly into the picture planes."""
        from hm16_2_tpu_torch import native
        lib = native.get_dsp()
        if lib is None or self.sps.scaling_list_enabled or \
                self.pps.transquant_bypass_enabled:
            # the native TU coder quantizes with the flat matrix only;
            # scaling lists / lossless CUs take the python path
            return -1
        import ctypes
        pic = self.pic
        orig = self.orig[comp]
        if orig.dtype != np.int32 or not orig.flags.c_contiguous:
            orig = np.ascontiguousarray(orig, dtype=np.int32)
            self.orig[comp] = orig
        pred32 = np.ascontiguousarray(pred, dtype=np.int32)
        coeff = pic.coeff[comp]
        rec = pic.rec[comp]
        i32 = ctypes.c_int32
        optr = orig.ctypes.data_as(ctypes.c_void_p).value + \
            4 * (y0 * orig.shape[1] + x0)
        cptr = coeff.ctypes.data_as(ctypes.c_void_p).value + \
            4 * (y0 * coeff.shape[1] + x0)
        rptr = rec.ctypes.data_as(ctypes.c_void_p).value + \
            4 * (y0 * rec.shape[1] + x0)
        scan = self._sbh_scan(size, comp, mode_for_scan)
        scan_p = scan.ctypes.data_as(ctypes.c_void_p) if scan is not None \
            else None
        blob = self._rdoq_blob(comp, size,
                               self._mdcs_scan_type(size, comp,
                                                    mode_for_scan), qp)
        return lib.code_tu(
            ctypes.c_void_p(optr), orig.shape[1],
            pred32.ctypes.data_as(ctypes.c_void_p), size,
            size, log2_tr, bd, qp, 1 if use_dst else 0,
            1 if is_intra else 0,
            ctypes.c_void_p(cptr), coeff.shape[1],
            ctypes.c_void_p(rptr), rec.shape[1], scan_p, blob)

    # ------------------------------------------------------------------
    # RDOQ support: per-slice context bit-cost tables + per-(component,
    # size, scan, qp) parameter blobs for the native rate-distortion
    # optimized quantizer (dsp_core rdoq_quant; HM xRateDistOptQuant,
    # TComTrQuant.cpp:1974-2547)
    # ------------------------------------------------------------------

    def _rdoq_tables(self):
        tabs = getattr(self, "_rdoq_tab", None)
        if tabs is not None:
            return tabs
        from hm16_2_tpu_torch.common.cabac_data import ENTROPY_BITS
        from hm16_2_tpu_torch.decode.ctu_dec import (
            CBF_CTX_START, CTX_SET_START, SIG_CTX_CHANNEL_OFFSET)
        ctx = ContextSet()
        ctx.reset(self.sh.slice_type, min(max(self.sh.qp, 0), 51))

        def pair(name, i):
            st = int(ctx.state[ctx.idx(name, i)])
            return (float(ENTROPY_BITS[st ^ 0]) / 32768.0,
                    float(ENTROPY_BITS[st ^ 1]) / 32768.0)

        def arr(name, base, cnt):
            out = np.empty((cnt, 2), np.float64)
            for k in range(cnt):
                out[k] = pair(name, base + k)
            return out

        tabs = {}
        for chan in (0, 1):
            tabs[chan] = dict(
                sig=arr("sig", SIG_CTX_CHANNEL_OFFSET[chan],
                        28 if chan == 0 else 16),
                one=arr("one", 4 * CTX_SET_START[chan],
                        16 if chan == 0 else 8),
                abs=arr("abs", CTX_SET_START[chan], 4 if chan == 0 else 2),
                cg=arr("sig_cg", 2 * chan, 2),
                lastx=arr("last", 15 * chan, 15),
                lasty=arr("last_y", 15 * chan, 15),
                cbf=pair("qt_cbf", CBF_CTX_START[chan] + (1 - chan)))
        self._rdoq_tab = tabs
        return tabs

    def _rdoq_blob(self, comp, size, scan_type, qp):
        """ctypes RdoqBlob pointer for this TU class, or None (disabled)."""
        if not getattr(self, "rdoq", False) or not self.rdo:
            return None
        cache = getattr(self, "_rdoq_blobs", None)
        if cache is None:
            cache = self._rdoq_blobs = {}
        chan = 0 if comp == 0 else 1
        key = (chan, size, scan_type, qp)
        ent = cache.get(key)
        if ent is not None:
            return ent[0]
        import ctypes

        from hm16_2_tpu_torch import native
        from hm16_2_tpu_torch.common.tables import QUANT_SCALES, get_scan
        from hm16_2_tpu_torch.decode.ctu_dec import (
            NON_DIAG_8x8_CTX_OFFSET, SIG_CTX_SET_START)
        t = self._rdoq_tables()[chan]
        log2n = size.bit_length() - 1
        bd = self.bit_depth[comp]
        tshift = 15 - bd - log2n
        qscale = float(QUANT_SCALES[qp % 6])
        blob = native.RdoqBlob()
        blob.lambda_ = self.lam if comp == 0 else self.lam / self.chroma_weight
        blob.err_scale = (2.0 ** (-2.0 * tshift)) / (qscale * qscale)
        blob.cbf_bits0, blob.cbf_bits1 = t["cbf"]
        blob.chan = chan
        blob.scan_type = scan_type
        if size == 4:
            blob.first_sig_ctx = SIG_CTX_SET_START[chan][0]
        elif size == 8:
            blob.first_sig_ctx = SIG_CTX_SET_START[chan][1] + \
                (NON_DIAG_8x8_CTX_OFFSET[chan] if scan_type else 0)
        else:
            blob.first_sig_ctx = SIG_CTX_SET_START[chan][2]
        blob.single_ctx = 0
        blob.sbh = int(self.pps.sign_data_hiding)
        cw = log2n - 2
        if chan == 0:
            blob.off_x = blob.off_y = cw * 3 + ((cw + 1) >> 2)
            blob.shift_x = blob.shift_y = (cw + 3) >> 2
        else:
            blob.off_x = blob.off_y = 0
            blob.shift_x = blob.shift_y = cw
        blob.has_cbf = 1
        scan = np.ascontiguousarray(
            get_scan(size, size, scan_type, grouped=True), dtype=np.int32)
        cg = max(size // 4, 1)
        scan_cg = np.ascontiguousarray(
            get_scan(cg, cg, scan_type, grouped=False), dtype=np.int32)
        keep = (t["sig"], t["one"], t["abs"], t["cg"], t["lastx"], t["lasty"],
                scan, scan_cg)
        blob.sig_bits = t["sig"].ctypes.data
        blob.one_bits = t["one"].ctypes.data
        blob.abs_bits = t["abs"].ctypes.data
        blob.cg_bits = t["cg"].ctypes.data
        blob.lastx_bits = t["lastx"].ctypes.data
        blob.lasty_bits = t["lasty"].ctypes.data
        blob.scan = scan.ctypes.data
        blob.scan_cg = scan_cg.ctypes.data
        ptr = ctypes.byref(blob)
        cache[key] = (ptr, blob, keep)
        return ptr

    _sbh_scan_cache: dict = {}

    def _mdcs_scan_type(self, size, comp, mode):
        """Mode-dependent coefficient scan (the entropy coder's MDCS rule;
        the chroma size limit is component-scaled — 8 in 4:4:4)."""
        from hm16_2_tpu_torch.ops.intra_ref import HOR_IDX, VER_IDX
        sx, sy = self.pic.comp_shift[comp]
        max_mdcs = 8 if comp == 0 else min(8 >> sx, 8 >> sy)
        if mode >= 0 and size <= max_mdcs:
            if abs(mode - VER_IDX) <= 4:
                return 1
            if abs(mode - HOR_IDX) <= 4:
                return 2
        return 0

    def _sbh_scan(self, size, comp, mode):
        """Coding-scan raster positions for sign-bit hiding, or None when
        SBH is off.  Scan choice mirrors the entropy coder's MDCS rule."""
        if not self.pps.sign_data_hiding:
            return None
        from hm16_2_tpu_torch.common.tables import get_scan
        scan_type = self._mdcs_scan_type(size, comp, mode)
        key = (size, scan_type)
        arr = self._sbh_scan_cache.get(key)
        if arr is None:
            arr = np.ascontiguousarray(
                get_scan(size, size, scan_type, grouped=True), dtype=np.int32)
            self._sbh_scan_cache[key] = arr
        return arr

    def _scaling_for(self, comp, log2_tr, is_intra):
        """Flat per-coefficient scaling matrix for the encoder's
        quant/dequant, or None when scaling lists are off (HM
        getQuantCoeff/getDequantCoeff selection in xQuant/xDeQuant)."""
        if not self.sps.scaling_list_enabled:
            return None
        key = (comp, log2_tr, bool(is_intra))
        cache = getattr(self, "_sl_enc_cache", None)
        if cache is None:
            cache = self._sl_enc_cache = {}
        m = cache.get(key)
        if m is None:
            from hm16_2_tpu_torch.headers.params import scaling_matrix_flat
            sl = self.pps.scaling_list if self.pps.scaling_list_present \
                else (self.sps.scaling_list if self.sps.scaling_list_present
                      else None)
            m = scaling_matrix_flat(sl, log2_tr,
                                    (0 if is_intra else 3) + comp)
            cache[key] = m
        return m

    def _tu_qp(self, px, py, comp):
        sps, pps, sh = self.sps, self.pps, self.sh
        qpy = int(self.pic.qp[py, px])
        if comp == 0:
            return qpy + 6 * (sps.bit_depth_luma - 8)
        bd_offset = 6 * (sps.bit_depth_chroma - 8)
        off = (pps.cb_qp_offset + sh.cb_qp_offset) if comp == 1 else \
            (pps.cr_qp_offset + sh.cr_qp_offset)
        base = int(np.clip(qpy + off, -bd_offset, 57))
        if base < 0:
            return base + bd_offset
        from hm16_2_tpu_torch.common.tables import CHROMA_QP_SCALE
        return int(CHROMA_QP_SCALE[sps.chroma_format_idc][base]) + bd_offset

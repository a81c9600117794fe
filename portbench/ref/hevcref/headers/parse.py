"""Header parsing: VPS/SPS/PPS, slice headers, scaling lists, pred-weight
tables (spec 7.3.x).  Bit-exact dual of the reference Exp-Golomb readers
(HM TDecCAVLC.cpp:85-1985).
"""

from __future__ import annotations

import numpy as np

from hevcref.bitstream.bitio import BitReader
from hevcref.common.tables import get_scan, SCAN_DIAG
from hevcref.headers.params import (
    PPS, SPS, VPS, PredWeight, ProfileTierLevel, ScalingList, ShortTermRPS,
    SliceHeader, B_SLICE, P_SLICE, I_SLICE, is_bla, is_idr, is_irap,
    default_scaling_list_coeffs,
)


# ---------------------------------------------------------------------------
# profile_tier_level
# ---------------------------------------------------------------------------

def parse_profile_tier(br: BitReader) -> ProfileTierLevel:
    p = ProfileTierLevel()
    p.profile_space = br.u(2)
    p.tier_flag = br.flag()
    p.profile_idc = br.u(5)
    p.compat_flags = br.u(32)
    p.progressive_source = br.flag()
    p.interlaced_source = br.flag()
    p.non_packed = br.flag()
    p.frame_only = br.flag()
    if p.profile_idc in (4, 5) or ((p.compat_flags >> (31 - 4)) & 1) \
            or ((p.compat_flags >> (31 - 5)) & 1):
        # RExt / high-throughput-RExt constraint flags
        p.max_12bit = br.flag()
        p.max_10bit = br.flag()
        p.max_8bit = br.flag()
        p.max_422chroma = br.flag()
        p.max_420chroma = br.flag()
        p.max_monochrome = br.flag()
        p.intra_constraint = br.flag()
        p.one_picture_only = br.flag()
        p.lower_bit_rate = br.flag()
        br.u(16); br.u(16); br.u(3)   # reserved_zero_35bits
    else:
        br.u(16); br.u(16); br.u(12)  # reserved_zero_44bits
    return p


def parse_ptl(br: BitReader, profile_present: bool, max_sub_layers_minus1: int) -> ProfileTierLevel:
    ptl = parse_profile_tier(br) if profile_present else ProfileTierLevel()
    ptl.level_idc = br.u(8)
    sub_profile_present = []
    sub_level_present = []
    for _ in range(max_sub_layers_minus1):
        sub_profile_present.append(br.flag() if profile_present else 0)
        sub_level_present.append(br.flag())
    if max_sub_layers_minus1 > 0:
        for _ in range(max_sub_layers_minus1, 8):
            br.u(2)
    for i in range(max_sub_layers_minus1):
        if profile_present and sub_profile_present[i]:
            parse_profile_tier(br)
        if sub_level_present[i]:
            br.u(8)
    return ptl


# ---------------------------------------------------------------------------
# scaling_list_data
# ---------------------------------------------------------------------------

SCALING_LIST_NUM = 6
SCALING_LIST_SIZES = [16, 64, 256, 1024]


def parse_scaling_list(br: BitReader) -> ScalingList:
    sl = ScalingList()
    for size_id in range(4):
        for list_id in range(SCALING_LIST_NUM):
            if size_id == 3 and list_id % 3 != 0:
                # 32x32 has only lists 0 and 3 coded; copy the same list's
                # values from the smaller size (HM TDecCAVLC.cpp:1881-1891)
                sl.lists[(size_id, list_id)] = sl.lists[(size_id - 1, list_id)].copy()
                sl.dc[(size_id, list_id)] = sl.dc.get((size_id - 1, list_id),
                                                      sl.lists[(size_id, list_id)][0])
                continue
            pred_mode = br.flag()
            sl.pred_mode_flag[(size_id, list_id)] = pred_mode
            if not pred_mode:   # copy mode
                delta = br.ue()
                if size_id == 3:
                    delta *= 3
                ref_id = list_id - delta
                sl.pred_list_idx[(size_id, list_id)] = ref_id
                if ref_id == list_id:
                    sl.lists[(size_id, list_id)] = default_scaling_list_coeffs(size_id, list_id)
                    if size_id > 1:
                        sl.dc[(size_id, list_id)] = 16
                else:
                    sl.lists[(size_id, list_id)] = sl.lists[(size_id, ref_id)].copy()
                    if size_id > 1:
                        sl.dc[(size_id, list_id)] = sl.dc[(size_id, ref_id)]
            else:               # DPCM mode
                coef_num = min(64, SCALING_LIST_SIZES[size_id])
                next_coef = 8
                if size_id > 1:
                    dc = br.se() + 8
                    sl.dc[(size_id, list_id)] = dc
                    next_coef = dc
                side = 4 if size_id == 0 else 8
                scan = get_scan(side, side, SCAN_DIAG, grouped=False)
                dst = np.zeros(coef_num, dtype=np.int64)
                for i in range(coef_num):
                    next_coef = (next_coef + br.se() + 256) % 256
                    dst[scan[i]] = next_coef
                sl.lists[(size_id, list_id)] = dst
    return sl


# ---------------------------------------------------------------------------
# short-term RPS
# ---------------------------------------------------------------------------

def parse_short_term_rps(br: BitReader, sps: SPS, idx: int,
                         rps_list: list[ShortTermRPS],
                         total_sets: int | None = None) -> ShortTermRPS:
    """total_sets: num_short_term_ref_pic_sets from the SPS (delta_idx is
    only coded for the slice-header-signalled set, idx == total_sets)."""
    if total_sets is None:
        total_sets = len(rps_list)
    rps = ShortTermRPS()
    inter_pred = br.flag() if idx > 0 else 0
    if inter_pred:
        delta_idx_minus1 = br.ue() if idx == total_sets else 0
        r_idx = idx - 1 - delta_idx_minus1
        ref = rps_list[r_idx]
        sign = br.flag()
        abs_delta = br.ue() + 1
        delta_rps = (1 - 2 * sign) * abs_delta
        deltas, used = [], []
        for j in range(ref.num_pics + 1):
            ref_idc = br.flag()
            if ref_idc == 0:
                ref_idc = br.flag() << 1
            if ref_idc in (1, 2):
                d = delta_rps + (ref.delta_poc[j] if j < ref.num_pics else 0)
                deltas.append(d)
                used.append(1 if ref_idc == 1 else 0)
        order = sorted(range(len(deltas)), key=lambda k: deltas[k])
        neg = [k for k in order if deltas[k] < 0]
        pos = [k for k in order if deltas[k] >= 0]
        # negative pics closest-first (descending), positive ascending
        neg_sorted = sorted(neg, key=lambda k: -deltas[k])
        pos_sorted = sorted(pos, key=lambda k: deltas[k])
        rps.num_negative = len(neg_sorted)
        rps.num_positive = len(pos_sorted)
        rps.delta_poc = [deltas[k] for k in neg_sorted] + [deltas[k] for k in pos_sorted]
        rps.used = [used[k] for k in neg_sorted] + [used[k] for k in pos_sorted]
        rps.inter_pred = True
        rps.delta_rps = delta_rps
    else:
        rps.num_negative = br.ue()
        rps.num_positive = br.ue()
        prev = 0
        for _ in range(rps.num_negative):
            prev = prev - br.ue() - 1
            rps.delta_poc.append(prev)
            rps.used.append(br.flag())
        prev = 0
        for _ in range(rps.num_positive):
            prev = prev + br.ue() + 1
            rps.delta_poc.append(prev)
            rps.used.append(br.flag())
    return rps


# ---------------------------------------------------------------------------
# VPS / SPS / PPS
# ---------------------------------------------------------------------------

def parse_vps(br: BitReader) -> VPS:
    v = VPS()
    v.vps_id = br.u(4)
    br.u(2)                      # reserved_three_2bits
    br.u(6)                      # max_layers_minus1
    v.max_sub_layers = br.u(3) + 1
    v.temporal_id_nesting = br.flag()
    br.u(16)                     # reserved_0xffff
    v.ptl = parse_ptl(br, True, v.max_sub_layers - 1)
    sub_layer_ordering = br.flag()
    v.max_dec_pic_buffering = []
    v.num_reorder_pics = []
    v.max_latency_increase = []
    start = 0 if sub_layer_ordering else v.max_sub_layers - 1
    for _ in range(start, v.max_sub_layers):
        v.max_dec_pic_buffering.append(br.ue() + 1)
        v.num_reorder_pics.append(br.ue())
        v.max_latency_increase.append(br.ue())
    max_layer_id = br.u(6)
    num_op_sets = br.ue() + 1
    for _ in range(1, num_op_sets):
        for _ in range(max_layer_id + 1):
            br.flag()
    v.timing_info_present = br.flag()
    if v.timing_info_present:
        br.u(32); br.u(32)
        if br.flag():
            br.ue()
        num_hrd = br.ue()
        for i in range(num_hrd):
            br.ue()
            cprms = br.flag() if i > 0 else 1
            parse_hrd_parameters(br, cprms, v.max_sub_layers - 1)
    if br.flag():                # vps_extension_flag
        while br.more_rbsp_data():
            br.flag()
    return v


def parse_hrd_parameters(br: BitReader, common_inf: int, max_sub_layers_minus1: int):
    nal_hrd = vcl_hrd = 0
    sub_pic = 0
    if common_inf:
        nal_hrd = br.flag()
        vcl_hrd = br.flag()
        if nal_hrd or vcl_hrd:
            sub_pic = br.flag()
            if sub_pic:
                br.u(8); br.u(5); br.flag(); br.u(5)
            br.u(4); br.u(4)     # bit_rate_scale, cpb_size_scale
            if sub_pic:
                br.u(4)
            br.u(5); br.u(5); br.u(5)
    for _ in range(max_sub_layers_minus1 + 1):
        fixed_rate = br.flag()
        fixed_rate_within = br.flag() if not fixed_rate else 1
        low_delay = 0
        if fixed_rate_within:
            br.ue()
        else:
            low_delay = br.flag()
        cpb_cnt = 1 if low_delay else br.ue() + 1
        for hrd_type in range(2):
            if (hrd_type == 0 and nal_hrd) or (hrd_type == 1 and vcl_hrd):
                for _ in range(cpb_cnt):
                    br.ue(); br.ue()
                    if sub_pic:
                        br.ue(); br.ue()
                    br.flag()


def parse_vui(br: BitReader, sps: SPS):
    if br.flag():               # aspect_ratio_info_present
        if br.u(8) == 255:
            br.u(16); br.u(16)
    if br.flag():               # overscan_info_present
        br.flag()
    if br.flag():               # video_signal_type_present
        br.u(3); br.flag()
        if br.flag():           # colour_description_present
            br.u(8); br.u(8); br.u(8)
    if br.flag():               # chroma_loc_info_present
        br.ue(); br.ue()
    br.flag()                   # neutral_chroma_indication
    br.flag()                   # field_seq_flag
    br.flag()                   # frame_field_info_present
    if br.flag():               # default_display_window
        br.ue(); br.ue(); br.ue(); br.ue()
    if br.flag():               # vui_timing_info_present
        br.u(32); br.u(32)
        if br.flag():
            br.ue()
        if br.flag():           # hrd_parameters_present
            parse_hrd_parameters(br, 1, sps.max_sub_layers - 1)
    if br.flag():               # bitstream_restriction
        br.flag(); br.flag(); br.flag()
        br.ue(); br.ue(); br.ue(); br.ue(); br.ue()


def parse_sps(br: BitReader) -> SPS:
    s = SPS()
    s.vps_id = br.u(4)
    s.max_sub_layers = br.u(3) + 1
    s.temporal_id_nesting = br.flag()
    s.ptl = parse_ptl(br, True, s.max_sub_layers - 1)
    s.sps_id = br.ue()
    s.chroma_format_idc = br.ue()
    if s.chroma_format_idc == 3:
        s.separate_colour_plane = br.flag()
    s.pic_width = br.ue()
    s.pic_height = br.ue()
    if br.flag():
        wux = 2 if s.chroma_format_idc in (1, 2) else 1
        wuy = 2 if s.chroma_format_idc == 1 else 1
        s.conformance_window = (br.ue() * wux, br.ue() * wux,
                                br.ue() * wuy, br.ue() * wuy)
    s.bit_depth_luma = 8 + br.ue()
    s.bit_depth_chroma = 8 + br.ue()
    s.log2_max_poc_lsb = 4 + br.ue()
    s.sub_layer_ordering_info_present = br.flag()
    s.max_dec_pic_buffering, s.num_reorder_pics, s.max_latency_increase = [], [], []
    for i in range(s.max_sub_layers):
        s.max_dec_pic_buffering.append(br.ue() + 1)
        s.num_reorder_pics.append(br.ue())
        s.max_latency_increase.append(br.ue())
        if not s.sub_layer_ordering_info_present:
            while len(s.max_dec_pic_buffering) < s.max_sub_layers:
                s.max_dec_pic_buffering.append(s.max_dec_pic_buffering[0])
                s.num_reorder_pics.append(s.num_reorder_pics[0])
                s.max_latency_increase.append(s.max_latency_increase[0])
            break
    s.log2_min_cb = br.ue() + 3
    s.log2_ctb = s.log2_min_cb + br.ue()
    s.log2_min_tb = br.ue() + 2
    s.log2_max_tb = s.log2_min_tb + br.ue()
    s.max_tr_hierarchy_depth_inter = br.ue() + 1
    s.max_tr_hierarchy_depth_intra = br.ue() + 1
    s.scaling_list_enabled = br.flag()
    if s.scaling_list_enabled:
        s.scaling_list_present = br.flag()
        if s.scaling_list_present:
            s.scaling_list = parse_scaling_list(br)
    s.amp_enabled = br.flag()
    s.sao_enabled = br.flag()
    s.pcm_enabled = br.flag()
    if s.pcm_enabled:
        s.pcm_bit_depth_luma = br.u(4) + 1
        s.pcm_bit_depth_chroma = br.u(4) + 1
        s.log2_min_pcm_cb = br.ue() + 3
        s.log2_max_pcm_cb = s.log2_min_pcm_cb + br.ue()
        s.pcm_loop_filter_disabled = br.flag()
    num_rps = br.ue()
    s.rps_list = []
    for i in range(num_rps):
        s.rps_list.append(parse_short_term_rps(br, s, i, s.rps_list, num_rps))
    s.long_term_ref_pics_present = br.flag()
    if s.long_term_ref_pics_present:
        s.num_long_term_ref_pics = br.ue()
        for _ in range(s.num_long_term_ref_pics):
            s.lt_ref_pic_poc_lsb.append(br.u(s.log2_max_poc_lsb))
            s.used_by_curr_pic_lt.append(br.flag())
    s.temporal_mvp_enabled = br.flag()
    s.strong_intra_smoothing = br.flag()
    s.vui_present = br.flag()
    if s.vui_present:
        parse_vui(br, s)
    if br.flag():               # sps_extension_present
        ext_flags = [br.flag() for _ in range(8)]
        if ext_flags[0]:        # RExt
            s.transform_skip_rotation = br.flag()
            s.transform_skip_context = br.flag()
            s.implicit_rdpcm = br.flag()
            s.explicit_rdpcm = br.flag()
            s.extended_precision = br.flag()
            s.intra_smoothing_disabled = br.flag()
            s.high_precision_offsets = br.flag()
            s.persistent_rice_adaptation = br.flag()
            s.cabac_bypass_alignment = br.flag()
        if any(ext_flags[1:]):
            while br.more_rbsp_data():
                br.flag()
    return s


def parse_pps(br: BitReader) -> PPS:
    p = PPS()
    p.pps_id = br.ue()
    p.sps_id = br.ue()
    p.dependent_slice_segments_enabled = br.flag()
    p.output_flag_present = br.flag()
    p.num_extra_slice_header_bits = br.u(3)
    p.sign_data_hiding = br.flag()
    p.cabac_init_present = br.flag()
    p.num_ref_idx_l0_default = br.ue() + 1
    p.num_ref_idx_l1_default = br.ue() + 1
    p.init_qp = 26 + br.se()
    p.constrained_intra_pred = br.flag()
    p.transform_skip_enabled = br.flag()
    p.cu_qp_delta_enabled = br.flag()
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = br.ue()
    p.cb_qp_offset = br.se()
    p.cr_qp_offset = br.se()
    p.slice_chroma_qp_offsets_present = br.flag()
    p.weighted_pred = br.flag()
    p.weighted_bipred = br.flag()
    p.transquant_bypass_enabled = br.flag()
    p.tiles_enabled = br.flag()
    p.entropy_coding_sync = br.flag()
    if p.tiles_enabled:
        p.num_tile_cols = br.ue() + 1
        p.num_tile_rows = br.ue() + 1
        p.uniform_spacing = br.flag()
        if not p.uniform_spacing:
            p.tile_col_widths = [br.ue() + 1 for _ in range(p.num_tile_cols - 1)]
            p.tile_row_heights = [br.ue() + 1 for _ in range(p.num_tile_rows - 1)]
        if p.num_tile_cols + p.num_tile_rows > 2:
            p.loop_filter_across_tiles = br.flag()
    p.loop_filter_across_slices = br.flag()
    p.deblocking_filter_control_present = br.flag()
    if p.deblocking_filter_control_present:
        p.deblocking_filter_override_enabled = br.flag()
        p.deblocking_filter_disabled = br.flag()
        if not p.deblocking_filter_disabled:
            p.beta_offset_div2 = br.se()
            p.tc_offset_div2 = br.se()
    p.scaling_list_present = br.flag()
    if p.scaling_list_present:
        p.scaling_list = parse_scaling_list(br)
    p.lists_modification_present = br.flag()
    p.log2_parallel_merge_level = 2 + br.ue()
    p.slice_header_extension_present = br.flag()
    if br.flag():               # pps_extension_present
        ext_flags = [br.flag() for _ in range(8)]
        if ext_flags[0]:        # RExt
            if p.transform_skip_enabled:
                p.log2_max_transform_skip_block_size = 2 + br.ue()
            p.cross_component_prediction_enabled = br.flag()
            p.chroma_qp_offset_list_enabled = br.flag()
            if p.chroma_qp_offset_list_enabled:
                p.diff_cu_chroma_qp_offset_depth = br.ue()
                table_size = br.ue() + 1
                for _ in range(table_size):
                    p.cb_qp_offset_list.append(br.se())
                    p.cr_qp_offset_list.append(br.se())
            p.log2_sao_offset_scale_luma = br.ue()
            p.log2_sao_offset_scale_chroma = br.ue()
        if any(ext_flags[1:]):
            while br.more_rbsp_data():
                br.flag()
    return p


# ---------------------------------------------------------------------------
# slice_segment_header
# ---------------------------------------------------------------------------

def parse_slice_header(br: BitReader, nal_type: int, temporal_id: int,
                       sps_map: dict[int, SPS], pps_map: dict[int, PPS],
                       prev_tid0_poc: int = 0,
                       ep_byte_positions: list | None = None,
                       raw_len: int = 0) -> SliceHeader:
    """Parse a slice segment header.

    ep_byte_positions: byte offsets of emulation-prevention bytes removed
    from the original NAL payload (needed to convert entry-point offsets,
    which count escaped bytes, into unescaped substream sizes —
    HM TDecCAVLC.cpp:1438-1473).
    """
    sh = SliceHeader(nal_type=nal_type, temporal_id=temporal_id)
    sh.first_slice_in_pic = br.flag()
    if is_irap(nal_type):
        sh.no_output_of_prior_pics = br.flag()
    sh.pps_id = br.ue()
    pps = pps_map[sh.pps_id]
    sps = sps_map[pps.sps_id]
    sh.pps, sh.sps = pps, sps
    chroma = sps.chroma_format_idc != 0

    if pps.dependent_slice_segments_enabled and not sh.first_slice_in_pic:
        sh.dependent_slice_segment = br.flag()
    num_ctus = sps.pic_width_in_ctbs * sps.pic_height_in_ctbs
    bits_addr = 0
    while num_ctus > (1 << bits_addr):
        bits_addr += 1
    if not sh.first_slice_in_pic:
        sh.segment_address = br.u(bits_addr)

    if not sh.dependent_slice_segment:
        for _ in range(pps.num_extra_slice_header_bits):
            br.flag()
        sh.slice_type = br.ue()
        sh.pic_output_flag = br.flag() if pps.output_flag_present else 1

        if is_idr(nal_type):
            sh.poc = 0
            sh.rps = ShortTermRPS()
        else:
            sh.poc_lsb = br.u(sps.log2_max_poc_lsb)
            max_lsb = 1 << sps.log2_max_poc_lsb
            prev_lsb = prev_tid0_poc & (max_lsb - 1)
            prev_msb = prev_tid0_poc - prev_lsb
            if sh.poc_lsb < prev_lsb and prev_lsb - sh.poc_lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif sh.poc_lsb > prev_lsb and sh.poc_lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            if is_bla(nal_type):
                msb = 0
            sh.poc = msb + sh.poc_lsb

            if br.flag():       # short_term_ref_pic_set_sps_flag
                nbits = 0
                while (1 << nbits) < len(sps.rps_list):
                    nbits += 1
                sh.rps_idx = br.u(nbits) if nbits > 0 else 0
                sh.rps = sps.rps_list[sh.rps_idx]
            else:
                sh.rps = parse_short_term_rps(br, sps, len(sps.rps_list),
                                              sps.rps_list)
            if sps.long_term_ref_pics_present:
                _parse_lt_pics(br, sh, sps)
            if is_bla(nal_type):
                sh.rps = ShortTermRPS()
            if sps.temporal_mvp_enabled:
                sh.temporal_mvp_enabled = br.flag()

        if sps.sao_enabled:
            sh.sao_luma = br.flag()
            if chroma:
                sh.sao_chroma = br.flag()
        if is_idr(nal_type):
            sh.temporal_mvp_enabled = 0

        if sh.slice_type != I_SLICE:
            if br.flag():       # num_ref_idx_active_override
                sh.num_ref_idx[0] = br.ue() + 1
                sh.num_ref_idx[1] = (br.ue() + 1) if sh.slice_type == B_SLICE else 0
            else:
                sh.num_ref_idx[0] = pps.num_ref_idx_l0_default
                sh.num_ref_idx[1] = pps.num_ref_idx_l1_default if sh.slice_type == B_SLICE else 0

            num_pics_cur = _num_rps_curr(sh)
            for lx in range(2 if sh.slice_type == B_SLICE else 1):
                if pps.lists_modification_present and num_pics_cur > 1:
                    if br.flag():
                        length = 1
                        n = num_pics_cur - 1
                        while n >> 1:
                            n >>= 1
                            length += 1
                        sh.ref_pic_list_modification[lx] = [
                            br.u(length) for _ in range(sh.num_ref_idx[lx])]
            if sh.slice_type == B_SLICE:
                sh.mvd_l1_zero = br.flag()
            if pps.cabac_init_present:
                sh.cabac_init_flag = br.flag()
            if sh.temporal_mvp_enabled:
                if sh.slice_type == B_SLICE:
                    sh.collocated_from_l0 = br.flag()
                if ((sh.collocated_from_l0 and sh.num_ref_idx[0] > 1)
                        or (not sh.collocated_from_l0 and sh.num_ref_idx[1] > 1)):
                    sh.collocated_ref_idx = br.ue()
            if ((pps.weighted_pred and sh.slice_type == P_SLICE)
                    or (pps.weighted_bipred and sh.slice_type == B_SLICE)):
                _parse_pred_weight_table(br, sh, sps, chroma)
            sh.max_num_merge_cand = 5 - br.ue()

        sh.qp = pps.init_qp + br.se()
        if pps.slice_chroma_qp_offsets_present:
            if chroma:
                sh.cb_qp_offset = br.se()
                sh.cr_qp_offset = br.se()
        if pps.chroma_qp_offset_list_enabled and len(pps.cb_qp_offset_list) > 0:
            sh.cu_chroma_qp_offset_enabled = br.flag()
        if pps.deblocking_filter_control_present:
            if pps.deblocking_filter_override_enabled:
                sh.deblocking_filter_override = br.flag()
            if sh.deblocking_filter_override:
                sh.deblocking_filter_disabled = br.flag()
                if not sh.deblocking_filter_disabled:
                    sh.beta_offset_div2 = br.se()
                    sh.tc_offset_div2 = br.se()
            else:
                sh.deblocking_filter_disabled = pps.deblocking_filter_disabled
                sh.beta_offset_div2 = pps.beta_offset_div2
                sh.tc_offset_div2 = pps.tc_offset_div2
        sao_on = sps.sao_enabled and (sh.sao_luma or (chroma and sh.sao_chroma))
        dbf_on = not sh.deblocking_filter_disabled
        if pps.loop_filter_across_slices and (sao_on or dbf_on):
            sh.loop_filter_across_slices = br.flag()
        else:
            sh.loop_filter_across_slices = pps.loop_filter_across_slices

    entry_point_offsets = []
    if pps.tiles_enabled or pps.entropy_coding_sync:
        sh.num_entry_points = br.ue()
        if sh.num_entry_points > 0:
            offset_len = br.ue() + 1
            entry_point_offsets = [br.u(offset_len) + 1
                                   for _ in range(sh.num_entry_points)]
    if pps.slice_header_extension_present:
        ext_len = br.ue()
        for _ in range(ext_len):
            br.u(8)
    # byte_alignment()
    one = br.flag()
    assert one == 1, "alignment_bit_equal_to_one missing"
    br.byte_align()

    # convert entry-point offsets (escaped-byte counts) to substream sizes
    if entry_point_offsets:
        ep = ep_byte_positions or []
        hdr_end = br.pos // 8
        # account for EPBs inside the header itself
        hdr_end_escaped = hdr_end + sum(1 for e in ep if e < hdr_end)
        sizes = []
        cur = prev = 0
        for off in entry_point_offsets:
            cur += off
            epb = sum(1 for e in ep
                      if prev + hdr_end_escaped <= _escaped_pos(e, ep) < cur + hdr_end_escaped)
            sizes.append(off - epb)
            prev = cur
        sh.entry_point_offsets = sizes
    return sh


def _escaped_pos(unescaped_pos: int, ep: list) -> int:
    """Position of an EPB in the escaped stream given its unescaped index."""
    return unescaped_pos + sum(1 for e in ep if e < unescaped_pos)


def _num_rps_curr(sh: SliceHeader) -> int:
    n = sum(sh.rps.used) if sh.rps else 0
    n += sum(sh.lt_used)
    return n


def _parse_lt_pics(br: BitReader, sh: SliceHeader, sps: SPS):
    num_lt_sps = 0
    if sps.num_long_term_ref_pics > 0:
        num_lt_sps = br.ue()
    bits_lt = 0
    while sps.num_long_term_ref_pics > (1 << bits_lt):
        bits_lt += 1
    num_lt_pics = br.ue()
    sh.num_lt_pics = num_lt_sps + num_lt_pics
    max_lsb = 1 << sps.log2_max_poc_lsb
    prev_delta_msb = 0
    entries = []
    for k in range(sh.num_lt_pics):
        if k < num_lt_sps:
            idx = br.u(bits_lt) if bits_lt > 0 else 0
            poc_lsb_lt = sps.lt_ref_pic_poc_lsb[idx]
            used = sps.used_by_curr_pic_lt[idx]
        else:
            poc_lsb_lt = br.u(sps.log2_max_poc_lsb)
            used = br.flag()
        msb_present = br.flag()
        if msb_present:
            delta_msb = br.ue()
            first = (k == 0) or (k == num_lt_sps)
            cycle = delta_msb if first else delta_msb + prev_delta_msb
            poc_lt = sh.poc - cycle * max_lsb - sh.poc_lsb + poc_lsb_lt
            prev_delta_msb = cycle
        else:
            poc_lt = poc_lsb_lt
            if k == num_lt_sps:
                prev_delta_msb = 0
        entries.append((poc_lt, used, msb_present))
    # stored most-recent-first like HM fills j downward; keep parse order
    sh.lt_poc = [e[0] for e in entries]
    sh.lt_used = [e[1] for e in entries]
    sh.lt_msb_present = [e[2] for e in entries]


def _parse_pred_weight_table(br: BitReader, sh: SliceHeader, sps: SPS, chroma: bool):
    sh.luma_log2_weight_denom = br.ue()
    if chroma:
        sh.chroma_log2_weight_denom = sh.luma_log2_weight_denom + br.se()
    n_lists = 2 if sh.slice_type == B_SLICE else 1
    for lx in range(n_lists):
        luma_flags = [br.flag() for _ in range(sh.num_ref_idx[lx])]
        chroma_flags = [br.flag() for _ in range(sh.num_ref_idx[lx])] if chroma \
            else [0] * sh.num_ref_idx[lx]
        for r in range(sh.num_ref_idx[lx]):
            wy = PredWeight(present=bool(luma_flags[r]),
                            log2_denom=sh.luma_log2_weight_denom,
                            weight=1 << sh.luma_log2_weight_denom, offset=0)
            if luma_flags[r]:
                wy.weight = br.se() + (1 << sh.luma_log2_weight_denom)
                wy.offset = br.se()
            sh.pred_weights[(lx, r, 0)] = wy
            if chroma:
                rng = (1 << sps.bit_depth_chroma) // 2 \
                    if sps.high_precision_offsets else 128
                for c in (1, 2):
                    wc = PredWeight(present=bool(chroma_flags[r]),
                                    log2_denom=sh.chroma_log2_weight_denom,
                                    weight=1 << sh.chroma_log2_weight_denom,
                                    offset=0)
                    if chroma_flags[r]:
                        wc.weight = br.se() + (1 << sh.chroma_log2_weight_denom)
                        delta = br.se()
                        pred = rng - ((rng * wc.weight) >> sh.chroma_log2_weight_denom)
                        wc.offset = int(np.clip(delta + pred, -rng, rng - 1))
                    sh.pred_weights[(lx, r, c)] = wc

"""Header writing: VPS/SPS/PPS/slice headers + SEI (spec 7.3.x, dual of
hm16_2_tpu_torch.headers.parse; reference TEncCavlc.cpp:155-1140, SEIwrite.cpp).
"""

from __future__ import annotations

from hm16_2_tpu_torch.bitstream.bitio import BitWriter, make_nal
from hm16_2_tpu_torch.headers.params import (
    PPS, SPS, VPS, ProfileTierLevel, ShortTermRPS, SliceHeader,
    B_SLICE, P_SLICE, I_SLICE, is_idr, is_irap,
    NAL_VPS, NAL_SPS, NAL_PPS, NAL_SEI_PREFIX, NAL_SEI_SUFFIX)


def write_profile_tier(bw: BitWriter, p: ProfileTierLevel):
    bw.u(p.profile_space, 2)
    bw.flag(p.tier_flag)
    bw.u(p.profile_idc, 5)
    bw.u(p.compat_flags, 32)
    bw.flag(p.progressive_source)
    bw.flag(p.interlaced_source)
    bw.flag(p.non_packed)
    bw.flag(p.frame_only)
    if p.profile_idc in (4, 5):
        bw.flag(p.max_12bit); bw.flag(p.max_10bit); bw.flag(p.max_8bit)
        bw.flag(p.max_422chroma); bw.flag(p.max_420chroma); bw.flag(p.max_monochrome)
        bw.flag(p.intra_constraint); bw.flag(p.one_picture_only); bw.flag(p.lower_bit_rate)
        bw.u(0, 16); bw.u(0, 16); bw.u(0, 3)
    else:
        bw.u(0, 16); bw.u(0, 16); bw.u(0, 12)


def write_ptl(bw: BitWriter, p: ProfileTierLevel, max_sub_layers_minus1: int = 0):
    write_profile_tier(bw, p)
    bw.u(p.level_idc, 8)
    if max_sub_layers_minus1 > 0:
        # no per-sub-layer profile/level info, just the presence flags
        # and the 8-entry alignment (7.3.3)
        for _ in range(max_sub_layers_minus1):
            bw.flag(0)            # sub_layer_profile_present_flag
            bw.flag(0)            # sub_layer_level_present_flag
        for _ in range(8 - max_sub_layers_minus1):
            bw.u(0, 2)            # reserved_zero_2bits


def main_profile_ptl(ten_bit: bool = False) -> ProfileTierLevel:
    p = ProfileTierLevel()
    p.profile_idc = 2 if ten_bit else 1
    # compat: Main(1) + Main10(2)  (TEncTop.cpp:460-479)
    p.compat_flags = (1 << (31 - 1)) | (1 << (31 - 2))
    p.progressive_source = 0
    p.frame_only = 0
    p.level_idc = 0
    return p


def rext_profile_ptl(bit_depth: int, chroma_format: int,
                     intra_only: bool = False,
                     high_throughput: bool = False) -> ProfileTierLevel:
    """Main-RExt (profile_idc 4) / high-throughput-RExt (5) profile with
    the RExt constraint-flag combination for the coded format (the named
    profiles of A.3.5; TEncCavlc codeProfileTier RExt branch,
    TAppEncCfg.cpp strToExtendedProfile)."""
    p = ProfileTierLevel()
    p.profile_idc = 5 if high_throughput else 4
    p.compat_flags = 1 << (31 - p.profile_idc)
    p.progressive_source = 0
    p.frame_only = 0
    p.level_idc = 0
    p.max_12bit = 1
    p.max_10bit = 1 if bit_depth <= 10 else 0
    p.max_8bit = 1 if (bit_depth <= 8 and chroma_format != 2) else 0
    p.max_422chroma = 1 if chroma_format <= 2 else 0
    p.max_420chroma = 1 if chroma_format <= 1 else 0
    p.max_monochrome = 1 if chroma_format == 0 else 0
    p.intra_constraint = 1 if intra_only else 0
    p.one_picture_only = 0
    p.lower_bit_rate = 1
    return p


def write_vps(v: VPS) -> bytes:
    bw = BitWriter()
    bw.u(v.vps_id, 4)
    bw.u(3, 2)                    # reserved_three_2bits
    bw.u(0, 6)                    # max_layers_minus1
    bw.u(v.max_sub_layers - 1, 3)
    bw.flag(v.temporal_id_nesting)
    bw.u(0xFFFF, 16)
    write_ptl(bw, v.ptl, v.max_sub_layers - 1)
    bw.flag(1)                    # sub_layer_ordering_info_present
    for i in range(v.max_sub_layers):
        bw.ue(v.max_dec_pic_buffering[i] - 1)
        bw.ue(v.num_reorder_pics[i])
        bw.ue(v.max_latency_increase[i])
    bw.u(0, 6)                    # max_nuh_reserved_zero_layer_id
    bw.ue(0)                      # max_op_sets_minus1
    bw.flag(0)                    # timing_info_present
    bw.flag(0)                    # vps_extension
    bw.byte_align_with_stop_bit()
    return make_nal(NAL_VPS, bw.get_bytes())


def write_short_term_rps(bw: BitWriter, rps: ShortTermRPS, idx: int):
    if idx > 0:
        bw.flag(0)                # inter_ref_pic_set_prediction_flag (explicit)
    bw.ue(rps.num_negative)
    bw.ue(rps.num_positive)
    prev = 0
    for j in range(rps.num_negative):
        bw.ue(prev - rps.delta_poc[j] - 1)
        prev = rps.delta_poc[j]
        bw.flag(rps.used[j])
    prev = 0
    for j in range(rps.num_negative, rps.num_negative + rps.num_positive):
        bw.ue(rps.delta_poc[j] - prev - 1)
        prev = rps.delta_poc[j]
        bw.flag(rps.used[j])


def write_sps(s: SPS) -> bytes:
    bw = BitWriter()
    bw.u(s.vps_id, 4)
    bw.u(s.max_sub_layers - 1, 3)
    bw.flag(s.temporal_id_nesting)
    write_ptl(bw, s.ptl, s.max_sub_layers - 1)
    bw.ue(s.sps_id)
    bw.ue(s.chroma_format_idc)
    if s.chroma_format_idc == 3:
        bw.flag(s.separate_colour_plane)
    bw.ue(s.pic_width)
    bw.ue(s.pic_height)
    l, r, t, b = s.conformance_window
    if any((l, r, t, b)):
        bw.flag(1)
        wux = 2 if s.chroma_format_idc in (1, 2) else 1
        wuy = 2 if s.chroma_format_idc == 1 else 1
        bw.ue(l // wux); bw.ue(r // wux); bw.ue(t // wuy); bw.ue(b // wuy)
    else:
        bw.flag(0)
    bw.ue(s.bit_depth_luma - 8)
    bw.ue(s.bit_depth_chroma - 8)
    bw.ue(s.log2_max_poc_lsb - 4)
    bw.flag(1)                    # sub_layer_ordering_info_present
    for i in range(s.max_sub_layers):
        bw.ue(s.max_dec_pic_buffering[i] - 1)
        bw.ue(s.num_reorder_pics[i])
        bw.ue(s.max_latency_increase[i])
    bw.ue(s.log2_min_cb - 3)
    bw.ue(s.log2_ctb - s.log2_min_cb)
    bw.ue(s.log2_min_tb - 2)
    bw.ue(s.log2_max_tb - s.log2_min_tb)
    bw.ue(s.max_tr_hierarchy_depth_inter - 1)
    bw.ue(s.max_tr_hierarchy_depth_intra - 1)
    bw.flag(s.scaling_list_enabled)
    if s.scaling_list_enabled:
        bw.flag(s.scaling_list_present)
        if s.scaling_list_present:
            write_scaling_list_data(bw, s.scaling_list)
    bw.flag(s.amp_enabled)
    bw.flag(s.sao_enabled)
    bw.flag(s.pcm_enabled)
    if s.pcm_enabled:
        bw.u(s.pcm_bit_depth_luma - 1, 4)
        bw.u(s.pcm_bit_depth_chroma - 1, 4)
        bw.ue(s.log2_min_pcm_cb - 3)
        bw.ue(s.log2_max_pcm_cb - s.log2_min_pcm_cb)
        bw.flag(s.pcm_loop_filter_disabled)
    bw.ue(len(s.rps_list))
    for i, rps in enumerate(s.rps_list):
        write_short_term_rps(bw, rps, i)
    bw.flag(s.long_term_ref_pics_present)
    if s.long_term_ref_pics_present:
        bw.ue(s.num_long_term_ref_pics)
        for k in range(s.num_long_term_ref_pics):
            bw.u(s.lt_ref_pic_poc_lsb[k], s.log2_max_poc_lsb)
            bw.flag(s.used_by_curr_pic_lt[k])
    bw.flag(s.temporal_mvp_enabled)
    bw.flag(s.strong_intra_smoothing)
    bw.flag(s.vui_present)
    if s.vui_present:
        _write_vui(bw, s)
    rext = (s.transform_skip_rotation or s.transform_skip_context
            or s.implicit_rdpcm or s.explicit_rdpcm or s.extended_precision
            or s.intra_smoothing_disabled or s.high_precision_offsets
            or s.persistent_rice_adaptation or s.cabac_bypass_alignment)
    bw.flag(1 if rext else 0)     # sps_extension_present
    if rext:
        # sps_range_extension (7.3.2.2.2; TEncCavlc codeSPSExtension)
        bw.flag(1)                # sps_range_extension_flag
        for _ in range(7):
            bw.flag(0)            # multilayer/3d/scc/4 reserved
        bw.flag(s.transform_skip_rotation)
        bw.flag(s.transform_skip_context)
        bw.flag(s.implicit_rdpcm)
        bw.flag(s.explicit_rdpcm)
        bw.flag(s.extended_precision)
        bw.flag(s.intra_smoothing_disabled)
        bw.flag(s.high_precision_offsets)
        bw.flag(s.persistent_rice_adaptation)
        bw.flag(s.cabac_bypass_alignment)
    bw.byte_align_with_stop_bit()
    return make_nal(NAL_SPS, bw.get_bytes())


def write_pps(p: PPS) -> bytes:
    bw = BitWriter()
    bw.ue(p.pps_id)
    bw.ue(p.sps_id)
    bw.flag(p.dependent_slice_segments_enabled)
    bw.flag(p.output_flag_present)
    bw.u(p.num_extra_slice_header_bits, 3)
    bw.flag(p.sign_data_hiding)
    bw.flag(p.cabac_init_present)
    bw.ue(p.num_ref_idx_l0_default - 1)
    bw.ue(p.num_ref_idx_l1_default - 1)
    bw.se(p.init_qp - 26)
    bw.flag(p.constrained_intra_pred)
    bw.flag(p.transform_skip_enabled)
    bw.flag(p.cu_qp_delta_enabled)
    if p.cu_qp_delta_enabled:
        bw.ue(p.diff_cu_qp_delta_depth)
    bw.se(p.cb_qp_offset)
    bw.se(p.cr_qp_offset)
    bw.flag(p.slice_chroma_qp_offsets_present)
    bw.flag(p.weighted_pred)
    bw.flag(p.weighted_bipred)
    bw.flag(p.transquant_bypass_enabled)
    bw.flag(p.tiles_enabled)
    bw.flag(p.entropy_coding_sync)
    if p.tiles_enabled:
        bw.ue(p.num_tile_cols - 1)
        bw.ue(p.num_tile_rows - 1)
        bw.flag(p.uniform_spacing)
        if not p.uniform_spacing:
            for w in p.tile_col_widths:
                bw.ue(w - 1)
            for h in p.tile_row_heights:
                bw.ue(h - 1)
        if p.num_tile_cols + p.num_tile_rows > 2:
            bw.flag(p.loop_filter_across_tiles)
    bw.flag(p.loop_filter_across_slices)
    bw.flag(p.deblocking_filter_control_present)
    if p.deblocking_filter_control_present:
        bw.flag(p.deblocking_filter_override_enabled)
        bw.flag(p.deblocking_filter_disabled)
        if not p.deblocking_filter_disabled:
            bw.se(p.beta_offset_div2)
            bw.se(p.tc_offset_div2)
    bw.flag(p.scaling_list_present)
    if p.scaling_list_present:
        write_scaling_list_data(bw, p.scaling_list)
    bw.flag(p.lists_modification_present)
    bw.ue(p.log2_parallel_merge_level - 2)
    bw.flag(p.slice_header_extension_present)
    rext = ((p.transform_skip_enabled
             and p.log2_max_transform_skip_block_size != 2)
            or p.cross_component_prediction_enabled
            or p.chroma_qp_offset_list_enabled
            or p.log2_sao_offset_scale_luma
            or p.log2_sao_offset_scale_chroma)
    bw.flag(1 if rext else 0)     # pps_extension_present
    if rext:
        # pps_range_extension (7.3.2.3.2; TEncCavlc codePPSExtension)
        bw.flag(1)                # pps_range_extension_flag
        for _ in range(7):
            bw.flag(0)
        if p.transform_skip_enabled:
            bw.ue(p.log2_max_transform_skip_block_size - 2)
        bw.flag(p.cross_component_prediction_enabled)
        bw.flag(p.chroma_qp_offset_list_enabled)
        if p.chroma_qp_offset_list_enabled:
            bw.ue(p.diff_cu_chroma_qp_offset_depth)
            bw.ue(len(p.cb_qp_offset_list) - 1)
            for cb, cr in zip(p.cb_qp_offset_list, p.cr_qp_offset_list):
                bw.se(cb)
                bw.se(cr)
        bw.ue(p.log2_sao_offset_scale_luma)
        bw.ue(p.log2_sao_offset_scale_chroma)
    bw.byte_align_with_stop_bit()
    return make_nal(NAL_PPS, bw.get_bytes())


def _write_vui(bw: BitWriter, s: SPS):
    """VUI with timing info (TEncCavlc::codeVUI, TEncCavlc.cpp:1039);
    unused feature groups are written absent."""
    bw.flag(0)                    # aspect_ratio_info_present
    bw.flag(0)                    # overscan_info_present
    bw.flag(0)                    # video_signal_type_present
    bw.flag(0)                    # chroma_loc_info_present
    bw.flag(0)                    # neutral_chroma_indication
    bw.flag(getattr(s, "vui_field_seq", 0))   # field_seq_flag
    bw.flag(s.vui_frame_field_info)
    bw.flag(0)                    # default_display_window
    bw.flag(1)                    # vui_timing_info_present
    bw.u(s.vui_num_units_in_tick, 32)
    bw.u(s.vui_time_scale, 32)
    bw.flag(0)                    # poc_proportional_to_timing
    bw.flag(1 if s.vui_hrd_present else 0)
    if s.vui_hrd_present:
        write_hrd_parameters(bw, s)
    bw.flag(0)                    # bitstream_restriction


# ---------------------------------------------------------------------------
# HRD (hypothetical reference decoder) parameters + the SEI messages that
# depend on them.  Mirrors TEncCavlc::codeHrdParameters (TEncCavlc.cpp) and
# SEIwrite.cpp xWriteSEIBufferingPeriod / xWriteSEIPictureTiming; the
# fixed-length delay fields all use 24 bits (length_minus1 = 23), the HM
# default.
# ---------------------------------------------------------------------------

HRD_DELAY_BITS = 24               # initial/au-removal/dpb-output delay lengths


def hrd_scale_values(sps: SPS):
    """(bit_rate_scale, bit_rate_value_minus1, cpb_size_scale,
    cpb_size_value_minus1) for the single CPB (cpb_cnt = 1).

    BitRate = (value+1) << (6 + scale); CpbSize = (value+1) << (4 + scale)
    (spec E.2.3).  Scales are chosen so the value fits the spec's strict
    rounding with small error, like TEncTop's xSetHrdParameters."""
    def split(val, base):
        scale = 0
        while (val >> (base + scale + 1)) >= (1 << 20) and scale < 15:
            scale += 1
        return scale, max((val >> (base + scale)) - 1, 0)

    br_scale, br_val = split(max(sps.hrd_bit_rate, 1 << 6), 6)
    cpb_scale, cpb_val = split(max(sps.hrd_cpb_size, 1 << 4), 4)
    return br_scale, br_val, cpb_scale, cpb_val


def write_hrd_parameters(bw: BitWriter, s: SPS):
    """hrd_parameters() with commonInfPresent = 1, NAL HRD only, one
    sub-layer, one CPB, no sub-pic HRD (E.2.2)."""
    br_scale, br_val, cpb_scale, cpb_val = hrd_scale_values(s)
    bw.flag(1)                    # nal_hrd_parameters_present
    bw.flag(0)                    # vcl_hrd_parameters_present
    bw.flag(0)                    # sub_pic_hrd_params_present
    bw.u(br_scale, 4)             # bit_rate_scale
    bw.u(cpb_scale, 4)            # cpb_size_scale
    bw.u(HRD_DELAY_BITS - 1, 5)   # initial_cpb_removal_delay_length_minus1
    bw.u(HRD_DELAY_BITS - 1, 5)   # au_cpb_removal_delay_length_minus1
    bw.u(HRD_DELAY_BITS - 1, 5)   # dpb_output_delay_length_minus1
    for _ in range(s.max_sub_layers):
        bw.flag(1)                # fixed_pic_rate_general_flag
        bw.ue(0)                  # elemental_duration_in_tc_minus1
        bw.ue(0)                  # cpb_cnt_minus1
        # nal_hrd sub-layer parameters, one CPB
        bw.ue(br_val)             # bit_rate_value_minus1
        bw.ue(cpb_val)            # cpb_size_value_minus1
        bw.flag(0)                # cbr_flag


def write_buffering_period_sei(sps: SPS, sps_id: int = 0) -> bytes:
    """buffering_period SEI (type 0, D.2.2; SEIwrite.cpp
    xWriteSEIBufferingPeriod).  initial_cpb_removal_delay is the 90 kHz
    time to fill the CPB at the nominal rate."""
    bw = BitWriter()
    bw.ue(sps_id)                 # bp_seq_parameter_set_id
    bw.flag(0)                    # irap_cpb_params_present_flag
    bw.flag(0)                    # concatenation_flag
    bw.u(0, HRD_DELAY_BITS)       # au_cpb_removal_delay_delta_minus1
    br_scale, br_val, cpb_scale, cpb_val = hrd_scale_values(sps)
    bit_rate = (br_val + 1) << (6 + br_scale)
    cpb_size = (cpb_val + 1) << (4 + cpb_scale)
    delay = max(int(90000 * cpb_size / bit_rate), 1)
    delay = min(delay, (1 << HRD_DELAY_BITS) - 1)
    offset = (1 << HRD_DELAY_BITS) - 1 - delay
    bw.u(delay, HRD_DELAY_BITS)   # nal_initial_cpb_removal_delay[0]
    bw.u(offset, HRD_DELAY_BITS)  # nal_initial_cpb_removal_offset[0]
    bw.byte_align_with_stop_bit()
    return _make_sei(0, bw.get_bytes())


def write_recovery_point_sei(recovery_poc_cnt: int = 0, exact_match: int = 1,
                             broken_link: int = 0) -> bytes:
    """recovery_point SEI (type 6, D.2.8; SEIwrite.cpp
    xWriteSEIRecoveryPoint)."""
    bw = BitWriter()
    bw.se(recovery_poc_cnt)
    bw.flag(exact_match)
    bw.flag(broken_link)
    bw.byte_align_with_stop_bit()
    return _make_sei(6, bw.get_bytes())


# ---------------------------------------------------------------------------
# scaling_list_data (7.3.4; TEncCavlc::codeScalingList) — dual of
# parse.parse_scaling_list
# ---------------------------------------------------------------------------

def write_scaling_list_data(bw: BitWriter, sl) -> None:
    """Write scaling_list_data().  Lists equal to the default (or absent)
    are coded in copy mode with delta 0; others in DPCM mode over the
    diagonal scan, with a separate DC for 16x16/32x32."""
    import numpy as np
    from hm16_2_tpu_torch.common.tables import get_scan, SCAN_DIAG
    from hm16_2_tpu_torch.headers.params import default_scaling_list_coeffs
    for size_id in range(4):
        for list_id in range(6):
            if size_id == 3 and list_id % 3 != 0:
                continue          # 32x32 codes lists 0 and 3 only
            coefs = sl.lists.get((size_id, list_id)) if sl else None
            dc = sl.dc.get((size_id, list_id), 16) if sl else 16
            if coefs is None or (
                    np.array_equal(coefs,
                                   default_scaling_list_coeffs(size_id,
                                                               list_id))
                    and (size_id <= 1 or dc == 16)):
                bw.flag(0)        # scaling_list_pred_mode_flag: copy
                bw.ue(0)          # pred_matrix_id_delta 0 = use default
                continue
            bw.flag(1)            # DPCM-coded
            coef_num = min(64, (16, 64, 256, 1024)[size_id])
            next_coef = 8
            if size_id > 1:
                bw.se(int(dc) - 8)
                next_coef = int(dc)
            side = 4 if size_id == 0 else 8
            scan = get_scan(side, side, SCAN_DIAG, grouped=False)
            for i in range(coef_num):
                cur = int(coefs[scan[i]])
                delta = (cur - next_coef + 256) % 256
                if delta > 127:
                    delta -= 256
                bw.se(delta)
                next_coef = cur


def _make_sei(payload_type: int, payload: bytes, nal_type=NAL_SEI_PREFIX):
    bw = BitWriter()
    # ff_byte run-length coding of payload type and size (7.3.5): values
    # >= 255 emit 0xFF bytes until the remainder fits one byte
    for v in (payload_type, len(payload)):
        while v >= 255:
            bw.u(0xFF, 8)
            v -= 255
        bw.u(v, 8)
    for b in payload:
        bw.u(b, 8)
    bw.byte_align_with_stop_bit()
    return make_nal(nal_type, bw.get_bytes())


def write_active_parameter_sets_sei(vps_id=0, sps_id=0) -> bytes:
    """active_parameter_sets SEI (type 129, SEIwrite.cpp
    xWriteSEIActiveParameterSets)."""
    bw = BitWriter()
    bw.u(vps_id, 4)
    bw.flag(1)                    # self_contained_cvs_flag
    bw.flag(1)                    # no_parameter_set_update_flag
    bw.ue(0)                      # num_sps_ids_minus1
    bw.ue(sps_id)
    bw.byte_align_with_stop_bit()       # sei payload alignment
    return _make_sei(129, bw.get_bytes())


def write_pic_timing_sei(pic_struct=0, sps: SPS | None = None,
                         au_cpb_removal_delay: int = 1,
                         pic_dpb_output_delay: int = 0) -> bytes:
    """pic_timing SEI (type 1) with frame-field info; when the SPS carries
    HRD parameters (vui_hrd_present) the cpb-removal/dpb-output delays are
    written too (D.2.3; SEIwrite.cpp xWriteSEIPictureTiming)."""
    bw = BitWriter()
    bw.u(pic_struct, 4)
    bw.u(0, 2)                    # source_scan_type: progressive
    bw.flag(0)                    # duplicate_flag
    if sps is not None and sps.vui_hrd_present:
        mask = (1 << HRD_DELAY_BITS) - 1
        bw.u(max(au_cpb_removal_delay - 1, 0) & mask, HRD_DELAY_BITS)
        bw.u(pic_dpb_output_delay & mask, HRD_DELAY_BITS)
    bw.byte_align_with_stop_bit()
    return _make_sei(1, bw.get_bytes())


def write_slice_header(bw: BitWriter, sh: SliceHeader, sps: SPS, pps: PPS):
    """Write the slice segment header up to and incl. byte alignment.
    The CABAC slice data is appended to the same BitWriter afterwards."""
    bw.flag(sh.first_slice_in_pic)
    if is_irap(sh.nal_type):
        bw.flag(sh.no_output_of_prior_pics)
    bw.ue(sh.pps_id)
    if pps.dependent_slice_segments_enabled and not sh.first_slice_in_pic:
        bw.flag(sh.dependent_slice_segment)
    if not sh.first_slice_in_pic:
        num_ctus = sps.pic_width_in_ctbs * sps.pic_height_in_ctbs
        bits = 0
        while num_ctus > (1 << bits):
            bits += 1
        bw.u(sh.segment_address, bits)
    if not sh.dependent_slice_segment:
        for _ in range(pps.num_extra_slice_header_bits):
            bw.flag(0)
        bw.ue(sh.slice_type)
        if pps.output_flag_present:
            bw.flag(sh.pic_output_flag)
        if not is_idr(sh.nal_type):
            bw.u(sh.poc & ((1 << sps.log2_max_poc_lsb) - 1), sps.log2_max_poc_lsb)
            if sh.rps_idx >= 0:
                bw.flag(1)
                nbits = 0
                while (1 << nbits) < len(sps.rps_list):
                    nbits += 1
                if nbits > 0:
                    bw.u(sh.rps_idx, nbits)
            else:
                bw.flag(0)
                write_short_term_rps(bw, sh.rps, len(sps.rps_list))
            if sps.long_term_ref_pics_present:
                _write_lt_pics(bw, sh, sps)
            if sps.temporal_mvp_enabled:
                bw.flag(sh.temporal_mvp_enabled)
        if sps.sao_enabled:
            bw.flag(sh.sao_luma)
            if sps.chroma_format_idc != 0:
                bw.flag(sh.sao_chroma)
        if sh.slice_type != I_SLICE:
            _write_inter_slice_fields(bw, sh, sps, pps)
        bw.se(sh.qp - pps.init_qp)
        if pps.slice_chroma_qp_offsets_present:
            bw.se(sh.cb_qp_offset)
            bw.se(sh.cr_qp_offset)
        if pps.deblocking_filter_control_present:
            if pps.deblocking_filter_override_enabled:
                bw.flag(sh.deblocking_filter_override)
            if sh.deblocking_filter_override:
                bw.flag(sh.deblocking_filter_disabled)
                if not sh.deblocking_filter_disabled:
                    bw.se(sh.beta_offset_div2)
                    bw.se(sh.tc_offset_div2)
        sao_on = sps.sao_enabled and (sh.sao_luma or sh.sao_chroma)
        dbf_on = not sh.deblocking_filter_disabled
        if pps.loop_filter_across_slices and (sao_on or dbf_on):
            bw.flag(sh.loop_filter_across_slices)
    if pps.tiles_enabled or pps.entropy_coding_sync:
        bw.ue(len(sh.entry_point_offsets))
        if sh.entry_point_offsets:
            offset_len = max(x - 1 for x in sh.entry_point_offsets).bit_length()
            offset_len = max(offset_len, 1)
            bw.ue(offset_len - 1)
            for off in sh.entry_point_offsets:
                bw.u(off - 1, offset_len)
    # byte_alignment()
    bw.u(1, 1)
    bw.align_zero()


def _write_inter_slice_fields(bw, sh, sps, pps):
    override = (sh.num_ref_idx[0] != pps.num_ref_idx_l0_default) or \
        (sh.slice_type == B_SLICE and sh.num_ref_idx[1] != pps.num_ref_idx_l1_default)
    bw.flag(1 if override else 0)
    if override:
        bw.ue(sh.num_ref_idx[0] - 1)
        if sh.slice_type == B_SLICE:
            bw.ue(sh.num_ref_idx[1] - 1)
    if pps.lists_modification_present:
        _write_lists_modification(bw, sh)
    if sh.slice_type == B_SLICE:
        bw.flag(sh.mvd_l1_zero)
    if pps.cabac_init_present:
        bw.flag(sh.cabac_init_flag)
    if sh.temporal_mvp_enabled:
        if sh.slice_type == B_SLICE:
            bw.flag(sh.collocated_from_l0)
        if (sh.collocated_from_l0 and sh.num_ref_idx[0] > 1) or \
                (not sh.collocated_from_l0 and sh.num_ref_idx[1] > 1):
            bw.ue(sh.collocated_ref_idx)
    if (pps.weighted_pred and sh.slice_type == P_SLICE) or \
            (pps.weighted_bipred and sh.slice_type == B_SLICE):
        _write_pred_weight_table(bw, sh, sps)
    bw.ue(5 - sh.max_num_merge_cand)


def _write_lt_pics(bw, sh, sps):
    """Dual of parse._parse_lt_pics; all entries written slice-level
    (num_long_term_sps = 0)."""
    if sps.num_long_term_ref_pics > 0:
        bw.ue(0)
    n = len(sh.lt_poc)
    bw.ue(n)
    max_lsb = 1 << sps.log2_max_poc_lsb
    prev_cycle = 0
    for k in range(n):
        poc_lt = sh.lt_poc[k]
        bw.u(poc_lt & (max_lsb - 1), sps.log2_max_poc_lsb)
        bw.flag(sh.lt_used[k])
        msb_present = sh.lt_msb_present[k] if k < len(sh.lt_msb_present) \
            else 0
        bw.flag(1 if msb_present else 0)
        if msb_present:
            cycle = (sh.poc - poc_lt - sh.poc_lsb
                     + (poc_lt & (max_lsb - 1))) // max_lsb
            delta = cycle if k == 0 else cycle - prev_cycle
            bw.ue(delta)
            prev_cycle = cycle


def _write_lists_modification(bw, sh):
    """Dual of the parse-side ref_pic_lists_modification block."""
    from hm16_2_tpu_torch.headers.parse import _num_rps_curr
    num_pics_cur = _num_rps_curr(sh)
    if num_pics_cur <= 1:
        return
    length = 1
    n = num_pics_cur - 1
    while n >> 1:
        n >>= 1
        length += 1
    for lx in range(2 if sh.slice_type == B_SLICE else 1):
        mod = sh.ref_pic_list_modification[lx]
        bw.flag(1 if mod else 0)
        if mod:
            for e in mod[: sh.num_ref_idx[lx]]:
                bw.u(e, length)


def _write_pred_weight_table(bw, sh, sps):
    """Dual of parse._parse_pred_weight_table (xCodePredWeightTable,
    TEncCavlc.cpp:983)."""
    import numpy as np
    chroma = sps.chroma_format_idc != 0
    bw.ue(sh.luma_log2_weight_denom)
    if chroma:
        bw.se(sh.chroma_log2_weight_denom - sh.luma_log2_weight_denom)
    n_lists = 2 if sh.slice_type == B_SLICE else 1
    for lx in range(n_lists):
        for r in range(sh.num_ref_idx[lx]):
            w = sh.pred_weights.get((lx, r, 0))
            bw.flag(1 if (w is not None and w.present) else 0)
        if chroma:
            for r in range(sh.num_ref_idx[lx]):
                w = sh.pred_weights.get((lx, r, 1))
                bw.flag(1 if (w is not None and w.present) else 0)
        for r in range(sh.num_ref_idx[lx]):
            wy = sh.pred_weights.get((lx, r, 0))
            if wy is not None and wy.present:
                bw.se(wy.weight - (1 << sh.luma_log2_weight_denom))
                bw.se(wy.offset)
            if chroma:
                wc1 = sh.pred_weights.get((lx, r, 1))
                if wc1 is not None and wc1.present:
                    rng = (1 << sps.bit_depth_chroma) // 2 \
                        if sps.high_precision_offsets else 128
                    for c in (1, 2):
                        wc = sh.pred_weights[(lx, r, c)]
                        bw.se(wc.weight
                              - (1 << sh.chroma_log2_weight_denom))
                        pred = rng - ((rng * wc.weight)
                                      >> sh.chroma_log2_weight_denom)
                        bw.se(wc.offset - pred)


def write_hash_sei(digests: list[bytes], method: int = 0) -> bytes:
    bw = BitWriter()
    bw.u(132, 8)                  # decoded_picture_hash
    payload = bytes([method]) + b"".join(digests)
    bw.u(len(payload), 8)
    for b in payload:
        bw.u(b, 8)
    bw.byte_align_with_stop_bit()
    return make_nal(NAL_SEI_SUFFIX, bw.get_bytes())

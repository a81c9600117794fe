"""Parameter-set and slice-header state (H.265 7.3.2, 7.3.6).

TPU-native analogue of HM `TComSlice.h:429-1544` (TComVPS/SPS/PPS/RPS/
ScalingList/slice state) as plain dataclasses: the codec engines treat these
as static (trace-time) configuration; per-sample state lives in arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import numpy as np

# NAL unit types (spec table 7-1)
NAL_TRAIL_N, NAL_TRAIL_R = 0, 1
NAL_TSA_N, NAL_TSA_R = 2, 3
NAL_STSA_N, NAL_STSA_R = 4, 5
NAL_RADL_N, NAL_RADL_R = 6, 7
NAL_RASL_N, NAL_RASL_R = 8, 9
NAL_BLA_W_LP, NAL_BLA_W_RADL, NAL_BLA_N_LP = 16, 17, 18
NAL_IDR_W_RADL, NAL_IDR_N_LP, NAL_CRA = 19, 20, 21
NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34
NAL_AUD, NAL_EOS, NAL_EOB, NAL_FD = 35, 36, 37, 38
NAL_SEI_PREFIX, NAL_SEI_SUFFIX = 39, 40

B_SLICE, P_SLICE, I_SLICE = 0, 1, 2


def is_irap(nal_type: int) -> bool:
    return 16 <= nal_type <= 23


def is_idr(nal_type: int) -> bool:
    return nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


def is_bla(nal_type: int) -> bool:
    return nal_type in (NAL_BLA_W_LP, NAL_BLA_W_RADL, NAL_BLA_N_LP)


def is_cra(nal_type: int) -> bool:
    return nal_type == NAL_CRA


def is_rasl(nal_type: int) -> bool:
    return nal_type in (NAL_RASL_N, NAL_RASL_R)


def is_radl(nal_type: int) -> bool:
    return nal_type in (NAL_RADL_N, NAL_RADL_R)


def is_reference_nal(nal_type: int) -> bool:
    """Sub-layer reference picture (odd VCL types <16, or >=16 VCL)."""
    if nal_type <= 15:
        return bool(nal_type & 1)
    return nal_type <= 23


@dataclass
class ProfileTierLevel:
    profile_space: int = 0
    tier_flag: int = 0
    profile_idc: int = 1
    compat_flags: int = 0           # 32-bit mask
    progressive_source: int = 1
    interlaced_source: int = 0
    non_packed: int = 0
    frame_only: int = 1
    level_idc: int = 0
    # RExt constraint flags
    max_12bit: int = 0
    max_10bit: int = 0
    max_8bit: int = 0
    max_422chroma: int = 0
    max_420chroma: int = 0
    max_monochrome: int = 0
    intra_constraint: int = 0
    one_picture_only: int = 0
    lower_bit_rate: int = 0


@dataclass
class ShortTermRPS:
    """One short-term reference picture set (spec 7.3.7)."""
    num_negative: int = 0
    num_positive: int = 0
    delta_poc: list = field(default_factory=list)      # signed deltas, neg first
    used: list = field(default_factory=list)
    # inter-RPS coding bookkeeping (encode side)
    inter_pred: bool = False
    delta_idx: int = 1
    delta_rps: int = 0

    @property
    def num_pics(self) -> int:
        return self.num_negative + self.num_positive


@dataclass
class ScalingList:
    """4 sizes x 6 lists (+DC for 16x16/32x32). Flat arrays in raster order
    of the *scan* used for coding; stored here in diag-scan coeff order."""
    lists: dict = field(default_factory=dict)   # (size_id, list_id) -> np.ndarray
    dc: dict = field(default_factory=dict)      # (size_id, list_id) -> int
    pred_mode_flag: dict = field(default_factory=dict)
    pred_list_idx: dict = field(default_factory=dict)


@dataclass
class VPS:
    vps_id: int = 0
    max_layers: int = 1
    max_sub_layers: int = 1
    temporal_id_nesting: int = 1
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    max_dec_pic_buffering: list = field(default_factory=lambda: [1])
    num_reorder_pics: list = field(default_factory=lambda: [0])
    max_latency_increase: list = field(default_factory=lambda: [0])
    timing_info_present: int = 0


@dataclass
class SPS:
    vps_id: int = 0
    max_sub_layers: int = 1
    temporal_id_nesting: int = 1
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    sps_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane: int = 0
    pic_width: int = 0
    pic_height: int = 0
    conformance_window: tuple = (0, 0, 0, 0)    # l, r, t, b (in chroma units)
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_poc_lsb: int = 8
    sub_layer_ordering_info_present: int = 1
    max_dec_pic_buffering: list = field(default_factory=lambda: [5])
    num_reorder_pics: list = field(default_factory=lambda: [0])
    max_latency_increase: list = field(default_factory=lambda: [0])
    log2_min_cb: int = 3
    log2_ctb: int = 6
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_tr_hierarchy_depth_inter: int = 3
    max_tr_hierarchy_depth_intra: int = 3
    scaling_list_enabled: int = 0
    scaling_list_present: int = 0
    scaling_list: ScalingList | None = None
    amp_enabled: int = 1
    sao_enabled: int = 1
    pcm_enabled: int = 0
    pcm_bit_depth_luma: int = 8
    pcm_bit_depth_chroma: int = 8
    log2_min_pcm_cb: int = 3
    log2_max_pcm_cb: int = 5
    pcm_loop_filter_disabled: int = 0
    rps_list: list = field(default_factory=list)    # list[ShortTermRPS]
    long_term_ref_pics_present: int = 0
    num_long_term_ref_pics: int = 0
    lt_ref_pic_poc_lsb: list = field(default_factory=list)
    used_by_curr_pic_lt: list = field(default_factory=list)
    temporal_mvp_enabled: int = 1
    strong_intra_smoothing: int = 1
    vui_present: int = 0
    vui_num_units_in_tick: int = 1
    vui_time_scale: int = 30
    vui_frame_field_info: int = 0
    vui_field_seq: int = 0
    vui_raw_bits: tuple = ()
    vui_hrd_present: int = 0      # NAL HRD parameters in VUI (E.2.2)
    hrd_bit_rate: int = 0         # nominal CPB input rate, bits/s
    hrd_cpb_size: int = 0         # CPB size, bits
    # range extension
    extended_precision: int = 0
    transform_skip_rotation: int = 0
    transform_skip_context: int = 0
    implicit_rdpcm: int = 0
    explicit_rdpcm: int = 0
    intra_smoothing_disabled: int = 0
    high_precision_offsets: int = 0
    persistent_rice_adaptation: int = 0
    cabac_bypass_alignment: int = 0

    # ---- derived ----
    @property
    def ctb_size(self) -> int:
        return 1 << self.log2_ctb

    @property
    def pic_width_in_ctbs(self) -> int:
        return (self.pic_width + self.ctb_size - 1) >> self.log2_ctb

    @property
    def pic_height_in_ctbs(self) -> int:
        return (self.pic_height + self.ctb_size - 1) >> self.log2_ctb

    @property
    def chroma_shift_x(self) -> int:
        return 1 if self.chroma_format_idc in (1, 2) else 0

    @property
    def chroma_shift_y(self) -> int:
        return 1 if self.chroma_format_idc == 1 else 0

    def max_tr_dynamic_range(self, is_chroma: bool) -> int:
        bd = self.bit_depth_chroma if is_chroma else self.bit_depth_luma
        return max(15, bd + 6) if self.extended_precision else 15


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    dependent_slice_segments_enabled: int = 0
    output_flag_present: int = 0
    num_extra_slice_header_bits: int = 0
    sign_data_hiding: int = 1
    cabac_init_present: int = 0
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: int = 0
    transform_skip_enabled: int = 0
    cu_qp_delta_enabled: int = 0
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: int = 0
    weighted_pred: int = 0
    weighted_bipred: int = 0
    transquant_bypass_enabled: int = 0
    tiles_enabled: int = 0
    entropy_coding_sync: int = 0
    num_tile_cols: int = 1
    num_tile_rows: int = 1
    uniform_spacing: int = 1
    tile_col_widths: list = field(default_factory=list)   # in CTBs
    tile_row_heights: list = field(default_factory=list)
    loop_filter_across_tiles: int = 1
    loop_filter_across_slices: int = 1
    deblocking_filter_control_present: int = 0
    deblocking_filter_override_enabled: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    scaling_list_present: int = 0
    scaling_list: ScalingList | None = None
    lists_modification_present: int = 0
    log2_parallel_merge_level: int = 2
    slice_header_extension_present: int = 0
    # range extension
    log2_max_transform_skip_block_size: int = 2
    cross_component_prediction_enabled: int = 0
    chroma_qp_offset_list_enabled: int = 0
    diff_cu_chroma_qp_offset_depth: int = 0
    cb_qp_offset_list: list = field(default_factory=list)
    cr_qp_offset_list: list = field(default_factory=list)
    log2_sao_offset_scale_luma: int = 0
    log2_sao_offset_scale_chroma: int = 0


@dataclass
class PredWeight:
    """Per-(list, refIdx, component) explicit weighted-prediction params."""
    present: bool = False
    log2_denom: int = 0
    weight: int = 1
    offset: int = 0


@dataclass
class SliceHeader:
    nal_type: int = 0
    temporal_id: int = 0
    first_slice_in_pic: int = 1
    no_output_of_prior_pics: int = 0
    pps_id: int = 0
    dependent_slice_segment: int = 0
    segment_address: int = 0
    slice_type: int = I_SLICE
    pic_output_flag: int = 1
    colour_plane_id: int = 0
    poc_lsb: int = 0
    poc: int = 0
    rps: ShortTermRPS | None = None
    rps_idx: int = -1
    num_lt_pics: int = 0
    lt_poc: list = field(default_factory=list)
    lt_used: list = field(default_factory=list)
    lt_msb_present: list = field(default_factory=list)
    lt_delta_poc_msb: list = field(default_factory=list)
    temporal_mvp_enabled: int = 0
    sao_luma: int = 0
    sao_chroma: int = 0
    num_ref_idx: list = field(default_factory=lambda: [0, 0])
    ref_pic_list_modification: list = field(default_factory=lambda: [None, None])
    mvd_l1_zero: int = 0
    cabac_init_flag: int = 0
    collocated_from_l0: int = 1
    collocated_ref_idx: int = 0
    pred_weights: dict = field(default_factory=dict)  # (list, ref, comp) -> PredWeight
    luma_log2_weight_denom: int = 0
    chroma_log2_weight_denom: int = 0
    max_num_merge_cand: int = 5
    qp: int = 26
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    cu_chroma_qp_offset_enabled: int = 0
    deblocking_filter_override: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    loop_filter_across_slices: int = 1
    num_entry_points: int = 0
    entry_point_offsets: list = field(default_factory=list)
    # resolved at activation time:
    sps: SPS | None = None
    pps: PPS | None = None

    @property
    def is_intra(self) -> bool:
        return self.slice_type == I_SLICE


def default_scaling_list_coeffs(size_id: int, list_id: int) -> np.ndarray:
    """Default (flat for 4x4, JPEG-like for >=8x8) scaling list in raster
    order of the up-sampled matrix's diag-scan coding order."""
    from hevcref.common.tables import (
        SCALING_LIST_DEFAULT_4x4, SCALING_LIST_DEFAULT_8x8_INTRA,
        SCALING_LIST_DEFAULT_8x8_INTER)
    if size_id == 0:
        return SCALING_LIST_DEFAULT_4x4.copy()
    intra = (list_id < 3) if size_id < 3 else (list_id == 0)
    return (SCALING_LIST_DEFAULT_8x8_INTRA if intra
            else SCALING_LIST_DEFAULT_8x8_INTER).copy()


SCALING_FILE_MATRIX_NAMES = [
    ["INTRA4X4_LUMA", "INTRA4X4_CHROMAU", "INTRA4X4_CHROMAV",
     "INTER4X4_LUMA", "INTER4X4_CHROMAU", "INTER4X4_CHROMAV"],
    ["INTRA8X8_LUMA", "INTRA8X8_CHROMAU", "INTRA8X8_CHROMAV",
     "INTER8X8_LUMA", "INTER8X8_CHROMAU", "INTER8X8_CHROMAV"],
    ["INTRA16X16_LUMA", "INTRA16X16_CHROMAU", "INTRA16X16_CHROMAV",
     "INTER16X16_LUMA", "INTER16X16_CHROMAU", "INTER16X16_CHROMAV"],
    ["INTRA32X32_LUMA", None, None, "INTER32X32_LUMA", None, None],
]
SCALING_FILE_DC_NAMES = [
    [None] * 6, [None] * 6,
    ["INTRA16X16_LUMA_DC", "INTRA16X16_CHROMAU_DC", "INTRA16X16_CHROMAV_DC",
     "INTER16X16_LUMA_DC", "INTER16X16_CHROMAU_DC", "INTER16X16_CHROMAV_DC"],
    ["INTRA32X32_LUMA_DC", None, None, "INTER32X32_LUMA_DC", None, None],
]


def parse_scaling_list_file(path: str) -> "ScalingList":
    """Parse an HM ScalingListFile (TComScalingList::xParseScalingList,
    TComSlice.cpp:2108): each matrix is introduced by a line containing its
    name, followed by 16/64 comma- or whitespace-separated values in raster
    order of the base matrix, with a separate _DC entry for >=16x16.
    32x32 chroma lists are derived from the 16x16 ones."""
    import re
    with open(path) as f:
        text = f.read()
    lines = text.splitlines()

    def read_values(name, count):
        for i, ln in enumerate(lines):
            if name in ln:
                # reject a match that is really the _DC entry
                if not name.endswith("_DC") and name + "_DC" in ln:
                    continue
                after = ln.split(name, 1)[1]
                nums = re.findall(r"-?\d+",
                                  after + "\n" + "\n".join(lines[i + 1:]))
                if len(nums) < count:
                    raise ValueError(
                        f"scaling list file: matrix {name} truncated")
                return [int(v) for v in nums[:count]]
        raise ValueError(f"scaling list file: matrix {name} not found")

    sl = ScalingList()
    for size_id in range(4):
        count = 16 if size_id == 0 else 64
        for list_id in range(6):
            name = SCALING_FILE_MATRIX_NAMES[size_id][list_id]
            if name is None:        # 32x32 chroma: derive from 16x16
                sl.lists[(size_id, list_id)] = \
                    sl.lists[(size_id - 1, list_id)].copy()
                sl.dc[(size_id, list_id)] = sl.dc[(size_id - 1, list_id)]
                continue
            vals = np.array(read_values(name, count), dtype=np.int64)
            if np.any(vals < 1) or np.any(vals > 255):
                raise ValueError(f"scaling list {name}: out of range")
            sl.lists[(size_id, list_id)] = vals
            if size_id > 1:
                dc = read_values(SCALING_FILE_DC_NAMES[size_id][list_id],
                                 1)[0]
                if not 1 <= dc <= 255:
                    raise ValueError(f"scaling list {name}: DC out of range")
                sl.dc[(size_id, list_id)] = dc
    return sl


def scaling_matrix_flat(sl: "ScalingList | None", log2_tr: int,
                        list_id: int) -> np.ndarray:
    """Per-coefficient scaling matrix for a TU, flat in raster order.

    Upsamples >=16x16 lists (coded as 8x8 + DC) by pixel repetition and
    substitutes the DC (HM xSetScalingListDec / processScalingListDec,
    TComTrQuant.cpp:3090); falls back to the default lists for absent
    entries.  Shared by the decoder dequant and the encoder quant paths.
    """
    size_id = log2_tr - 2
    if sl is not None and (size_id, list_id) in sl.lists:
        coefs = sl.lists[(size_id, list_id)]
        dc = sl.dc.get((size_id, list_id), 16)
    else:
        coefs = default_scaling_list_coeffs(size_id, list_id)
        dc = 16
    size = 1 << log2_tr
    if size_id <= 1:
        mat = np.asarray(coefs).reshape(size, size).copy()
    else:
        ratio = size // 8
        base = np.asarray(coefs).reshape(8, 8)
        mat = np.repeat(np.repeat(base, ratio, 0), ratio, 1).copy()
        mat[0, 0] = dc
    return mat.astype(np.int64).ravel()

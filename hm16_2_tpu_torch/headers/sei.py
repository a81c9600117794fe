"""SEI message suite: writers + parsers + human-readable dump.

The reference encoder writes ~20 SEI payload types driven by cfg keys
(SEIwrite.cpp; SEI.h:55-580 defines the catalogue) and the decoder
parses and reports them (SEIread.cpp).  This module adds the
non-HRD payload types on top of the five living in headers/write.py
(buffering_period, pic_timing, recovery_point, active_parameter_sets,
decoded_picture_hash), plus typed parsing and a `describe` dump used by
`tools/decode.py --seidump` (the TAppDecoder `SEI message` trace dual).

Payload type numbers follow H.265 annex D / SEI.h PayloadType.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from hm16_2_tpu_torch.bitstream.bitio import BitReader, BitWriter
from hm16_2_tpu_torch.headers.params import NAL_SEI_PREFIX
from hm16_2_tpu_torch.headers.write import _make_sei

SEI_NAMES = {
    0: "buffering_period", 1: "pic_timing", 2: "pan_scan_rect",
    3: "filler_payload", 4: "user_data_registered_itu_t_t35",
    5: "user_data_unregistered", 6: "recovery_point", 9: "scene_info",
    15: "picture_snapshot", 16: "progressive_refinement_segment_start",
    17: "progressive_refinement_segment_end",
    19: "film_grain_characteristics", 22: "post_filter_hint",
    23: "tone_mapping_info", 45: "frame_packing_arrangement",
    47: "display_orientation", 128: "structure_of_pictures_info",
    129: "active_parameter_sets", 130: "decoding_unit_info",
    131: "temporal_sub_layer_zero_index", 132: "decoded_picture_hash",
    133: "scalable_nesting", 134: "region_refresh_info",
    135: "no_display", 136: "time_code",
    137: "mastering_display_colour_volume",
    138: "segmented_rect_frame_packing_arrangement",
    139: "temporal_motion_constrained_tile_sets",
    140: "chroma_resampling_filter_hint", 141: "knee_function_info",
}


# ---------------------------------------------------------------------------
# writers (SEIwrite.cpp duals); each returns a complete prefix-SEI NAL
# ---------------------------------------------------------------------------

def write_user_data_unregistered(data: bytes,
                                 uuid: bytes = b"\x2c\xa2\xde\x09\xb5\x17"
                                               b"\x47\xdb\xbb\x55\xa4\xfe"
                                               b"\x7f\xc2\xfc\x4e") -> bytes:
    """user_data_unregistered (type 5, D.2.7)."""
    assert len(uuid) == 16
    bw = BitWriter()
    for b in uuid + data:
        bw.u(b, 8)
    return _make_sei(5, bw.get_bytes())


def write_tone_mapping(tone_map_id=0, coded_bit_depth=8, target_bit_depth=8,
                       model_id=0, min_value=0, max_value=255,
                       sigmoid_midpoint=128, sigmoid_width=64) -> bytes:
    """tone_mapping_info (type 23, D.2.15), models 0 (linear) and 1
    (sigmoidal) — the cfg-driven subset (SEIToneMapInfo)."""
    bw = BitWriter()
    bw.ue(tone_map_id)
    bw.flag(0)                        # tone_map_cancel_flag
    bw.flag(1)                        # tone_map_persistence_flag
    bw.u(coded_bit_depth, 8)
    bw.u(target_bit_depth, 8)
    bw.ue(model_id)
    if model_id == 0:
        bw.u(min_value, 32)
        bw.u(max_value, 32)
    elif model_id == 1:
        bw.u(sigmoid_midpoint, 32)
        bw.u(sigmoid_width, 32)
    else:
        raise ValueError("tone map models 2-4 not supported")
    bw.byte_align_with_stop_bit()
    return _make_sei(23, bw.get_bytes())


def write_frame_packing(arrangement_type=3, quincunx=0,
                        content_interpretation=0, sei_id=0) -> bytes:
    """frame_packing_arrangement (type 45, D.2.16; SEIFramePacking cfg:
    type 3 side-by-side / 4 top-bottom / 5 temporal interleave)."""
    bw = BitWriter()
    bw.ue(sei_id)                     # frame_packing_arrangement_id
    bw.flag(0)                        # cancel_flag
    bw.u(arrangement_type, 7)
    bw.flag(quincunx)
    bw.u(content_interpretation, 6)
    bw.flag(0)                        # spatial_flipping_flag
    bw.flag(0)                        # frame0_flipped_flag
    bw.flag(0)                        # field_views_flag
    bw.flag(0)                        # current_frame_is_frame0_flag
    bw.flag(0)                        # frame0_self_contained_flag
    bw.flag(0)                        # frame1_self_contained_flag
    if not quincunx and arrangement_type != 5:
        bw.u(0, 4)                    # frame0_grid_position_x
        bw.u(0, 4)                    # frame0_grid_position_y
        bw.u(0, 4)                    # frame1_grid_position_x
        bw.u(0, 4)                    # frame1_grid_position_y
    bw.u(0, 8)                        # frame_packing_arrangement_reserved
    bw.flag(1)                        # persistence_flag
    bw.flag(0)                        # upsampled_aspect_ratio_flag
    bw.byte_align_with_stop_bit()
    return _make_sei(45, bw.get_bytes())


def write_display_orientation(rotation_anticlockwise=0, hor_flip=0,
                              ver_flip=0) -> bytes:
    """display_orientation (type 47, D.2.18; SEIDisplayOrientation cfg,
    rotation in units of 2^-16 * 360 degrees)."""
    bw = BitWriter()
    bw.flag(0)                        # display_orientation_cancel_flag
    bw.flag(hor_flip)
    bw.flag(ver_flip)
    bw.u(rotation_anticlockwise, 16)
    bw.flag(1)                        # persistence_flag
    bw.byte_align_with_stop_bit()
    return _make_sei(47, bw.get_bytes())


def write_temporal_level0_index(tl0_idx: int, irap_poc_id: int) -> bytes:
    """temporal_sub_layer_zero_index (type 131; SEITemporalLevel0Index)."""
    bw = BitWriter()
    bw.u(tl0_idx & 0xFF, 8)
    bw.u(irap_poc_id & 0xFF, 8)
    return _make_sei(131, bw.get_bytes())


def write_region_refresh(refreshed: int = 1) -> bytes:
    """region_refresh_info (type 134; SEIGradualDecodingRefreshInfo)."""
    bw = BitWriter()
    bw.flag(refreshed)
    bw.byte_align_with_stop_bit()
    return _make_sei(134, bw.get_bytes())


def write_no_display() -> bytes:
    """no_display (type 135; empty payload — marks pictures not intended
    for output, SEINoDisplay cfg)."""
    return _make_sei(135, b"")


def write_time_code(n_frames: int, seconds: int, minutes: int,
                    hours: int) -> bytes:
    """time_code (type 136, D.2.27; SEITimeCodeEnabled cfg)."""
    bw = BitWriter()
    bw.u(1, 2)                        # num_clock_ts
    bw.flag(1)                        # clock_timestamp_flag
    bw.flag(0)                        # units_field_based_flag
    bw.u(0, 5)                        # counting_type
    bw.flag(1)                        # full_timestamp_flag
    bw.flag(0)                        # discontinuity_flag
    bw.flag(0)                        # cnt_dropped_flag
    bw.u(n_frames & 0x1FF, 9)
    bw.u(seconds, 6)
    bw.u(minutes, 6)
    bw.u(hours, 5)
    bw.u(0, 5)                        # time_offset_length
    bw.byte_align_with_stop_bit()
    return _make_sei(136, bw.get_bytes())


def write_mastering_display(primaries=((34000, 16000), (13250, 34500),
                                       (7500, 3000)),
                            white_point=(15635, 16450),
                            max_luminance=10000000,
                            min_luminance=500) -> bytes:
    """mastering_display_colour_volume (type 137, D.2.28; BT.2020/P3
    sample values; SEIMasteringDisplayColourVolume cfg)."""
    bw = BitWriter()
    for x, y in primaries:
        bw.u(x, 16)
        bw.u(y, 16)
    bw.u(white_point[0], 16)
    bw.u(white_point[1], 16)
    bw.u(max_luminance, 32)
    bw.u(min_luminance, 32)
    return _make_sei(137, bw.get_bytes())


# ---------------------------------------------------------------------------
# parsers (SEIread.cpp duals) + dump
# ---------------------------------------------------------------------------

@dataclass
class SEIMessage:
    payload_type: int
    name: str
    fields: dict = field(default_factory=dict)

    def __str__(self):
        kv = " ".join(f"{k}={v}" for k, v in self.fields.items())
        return f"SEI {self.name}({self.payload_type}) {kv}".rstrip()


def parse_payload(ptype: int, payload: bytes) -> SEIMessage:
    name = SEI_NAMES.get(ptype, f"reserved_{ptype}")
    f = {}
    br = BitReader(payload)
    try:
        if ptype == 0:
            f["bp_seq_parameter_set_id"] = br.ue()
            f["irap_cpb_params_present"] = br.flag()
        elif ptype == 1:
            f["pic_struct"] = br.u(4)
            f["source_scan_type"] = br.u(2)
            f["duplicate_flag"] = br.flag()
        elif ptype == 5:
            f["uuid"] = payload[:16].hex()
            f["data"] = payload[16:48].decode("latin1")
        elif ptype == 6:
            f["recovery_poc_cnt"] = br.se()
            f["exact_match"] = br.flag()
            f["broken_link"] = br.flag()
        elif ptype == 23:
            f["tone_map_id"] = br.ue()
            if not br.flag():
                f["persistence"] = br.flag()
                f["coded_bit_depth"] = br.u(8)
                f["target_bit_depth"] = br.u(8)
                mid = br.ue()
                f["model_id"] = mid
                if mid == 0:
                    f["min_value"] = br.u(32)
                    f["max_value"] = br.u(32)
                elif mid == 1:
                    f["sigmoid_midpoint"] = br.u(32)
                    f["sigmoid_width"] = br.u(32)
        elif ptype == 45:
            f["id"] = br.ue()
            if not br.flag():
                f["type"] = br.u(7)
                f["quincunx"] = br.flag()
                f["content_interpretation"] = br.u(6)
        elif ptype == 47:
            if not br.flag():
                f["hor_flip"] = br.flag()
                f["ver_flip"] = br.flag()
                f["rotation"] = br.u(16)
                f["persistence"] = br.flag()
        elif ptype == 129:
            f["active_vps_id"] = br.u(4)
            f["self_contained_cvs"] = br.flag()
            f["no_parameter_set_update"] = br.flag()
            n = br.ue() + 1
            f["active_seq_parameter_set_ids"] = [br.ue() for _ in range(n)]
        elif ptype == 131:
            f["temporal_sub_layer_zero_idx"] = br.u(8)
            f["irap_pic_id"] = br.u(8)
        elif ptype == 132:
            method = payload[0]
            f["hash_type"] = ("MD5", "CRC", "checksum")[method] \
                if method < 3 else method
            f["digest"] = payload[1:].hex()
        elif ptype == 134:
            f["refreshed_region_flag"] = br.flag()
        elif ptype == 136:
            f["num_clock_ts"] = br.u(2)
            if br.flag():
                br.flag()
                f["counting_type"] = br.u(5)
                full = br.flag()
                br.flag()
                br.flag()
                f["n_frames"] = br.u(9)
                if full:
                    f["time"] = "%02d:%02d:%02d" % tuple(reversed(
                        [br.u(6), br.u(6), br.u(5)]))
        elif ptype == 137:
            prim = [(br.u(16), br.u(16)) for _ in range(3)]
            f["display_primaries"] = prim
            f["white_point"] = (br.u(16), br.u(16))
            f["max_luminance"] = br.u(32)
            f["min_luminance"] = br.u(32)
        elif not payload:
            pass
        else:
            f["payload"] = payload[:24].hex() + \
                ("..." if len(payload) > 24 else "")
    except (IndexError, ValueError):
        f["truncated"] = True
    return SEIMessage(ptype, name, f)


def dump_stream_sei(data: bytes) -> list[str]:
    """All SEI messages of an Annex-B stream, rendered one per line
    (decode-order; prefix and suffix NALs)."""
    from hm16_2_tpu_torch.bitstream.bitio import (
        split_annexb, strip_emulation_prevention)
    from hm16_2_tpu_torch.decode.top import parse_sei_rbsp
    from hm16_2_tpu_torch.headers import params as P
    out = []
    for nal in split_annexb(data):
        nal_type = (nal[0] >> 1) & 0x3F
        if nal_type not in (P.NAL_SEI_PREFIX, P.NAL_SEI_SUFFIX):
            continue
        kind = "prefix" if nal_type == P.NAL_SEI_PREFIX else "suffix"
        rbsp = strip_emulation_prevention(nal[2:])
        for ptype, payload in parse_sei_rbsp(rbsp):
            out.append(f"[{kind}] {parse_payload(ptype, payload)}")
    return out

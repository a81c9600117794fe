"""Native (C++) hot-loop components.

cabac_core.so implements the CABAC residual-coding inner loops (the
dominant share of entropy bins).  Built on first import with g++ -O3;
falls back to the pure-Python path when unavailable or when
HM16_NO_NATIVE=1 is set.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "cabac_core.cpp")
_SO = os.path.join(_DIR, "cabac_core.so")

_lib = None


class DecState(ctypes.Structure):
    _fields_ = [("buf", ctypes.c_void_p),
                ("pos", ctypes.c_int64),
                ("len", ctypes.c_int64),
                ("range_", ctypes.c_int32),
                ("value", ctypes.c_int64),
                ("bits_needed", ctypes.c_int32)]


class EncState(ctypes.Structure):
    _fields_ = [("out", ctypes.c_void_p),
                ("n", ctypes.c_int64),
                ("low", ctypes.c_uint32),
                ("range_", ctypes.c_int32),
                ("bits_left", ctypes.c_int32),
                ("num_buffered", ctypes.c_int32),
                ("buffered_byte", ctypes.c_int32),
                ("counting", ctypes.c_int32),
                ("_pad", ctypes.c_int32),
                ("frac_bits", ctypes.c_int64),
                ("bins", ctypes.c_int64)]


class RdoqBlob(ctypes.Structure):
    """Per-(component, TU size, scan) RDOQ parameters (dsp_core RdoqBlob)."""
    _fields_ = [("lambda_", ctypes.c_double),
                ("err_scale", ctypes.c_double),
                ("cbf_bits0", ctypes.c_double),
                ("cbf_bits1", ctypes.c_double),
                ("chan", ctypes.c_int32),
                ("scan_type", ctypes.c_int32),
                ("first_sig_ctx", ctypes.c_int32),
                ("single_ctx", ctypes.c_int32),
                ("sbh", ctypes.c_int32),
                ("off_x", ctypes.c_int32),
                ("off_y", ctypes.c_int32),
                ("shift_x", ctypes.c_int32),
                ("shift_y", ctypes.c_int32),
                ("has_cbf", ctypes.c_int32),
                ("pad_", ctypes.c_int32),
                ("pad2_", ctypes.c_int32),
                ("sig_bits", ctypes.c_void_p),
                ("one_bits", ctypes.c_void_p),
                ("abs_bits", ctypes.c_void_p),
                ("cg_bits", ctypes.c_void_p),
                ("lastx_bits", ctypes.c_void_p),
                ("lasty_bits", ctypes.c_void_p),
                ("scan", ctypes.c_void_p),
                ("scan_cg", ctypes.c_void_p)]


class InterCtx(ctypes.Structure):
    """Mirror of dsp_core InterCtx (native inter CU commit)."""
    _fields_ = [("pic_w", ctypes.c_int32), ("pic_h", ctypes.c_int32),
                ("parts_w", ctypes.c_int32),
                ("num_comps", ctypes.c_int32),
                ("chroma_fmt", ctypes.c_int32),
                ("max_tb_log2", ctypes.c_int32),
                ("try_tusplit", ctypes.c_int32),
                ("allow_collapse", ctypes.c_int32),
                ("bd", ctypes.c_int32 * 3),
                ("qp_comp", ctypes.c_int32 * 3),
                ("lam", ctypes.c_double),
                ("chroma_weight", ctypes.c_double),
                ("orig_p", ctypes.c_void_p * 3),
                ("rec_p", ctypes.c_void_p * 3),
                ("coeff_p", ctypes.c_void_p * 3),
                ("orig_stride", ctypes.c_int64 * 3),
                ("plane_stride", ctypes.c_int64 * 3),
                ("mv", ctypes.c_void_p),
                ("mv_list_stride", ctypes.c_int64),
                ("ref_idx", ctypes.c_void_p),
                ("ri_list_stride", ctypes.c_int64),
                ("inter_dir", ctypes.c_void_p),
                ("skip", ctypes.c_void_p),
                ("merge_flag", ctypes.c_void_p),
                ("tr_idx", ctypes.c_void_p),
                ("cbf", ctypes.c_void_p * 3),
                ("ref_pix", ctypes.c_void_p * 48),
                ("ref_stride", ctypes.c_int64 * 48),
                ("ref_w", ctypes.c_int32 * 48),
                ("ref_h", ctypes.c_int32 * 48),
                ("ref_poc", ctypes.c_int32 * 16),
                ("n_ref", ctypes.c_int32 * 2),
                ("blobs", ctypes.c_void_p * 12),
                ("resenc", ctypes.c_void_p),
                ("bits_ctx_init", ctypes.c_void_p),
                ("bits_ctx_n", ctypes.c_int64),
                ("bits_params", ctypes.c_void_p * 24),
                ("bits_scan", ctypes.c_void_p * 12),
                ("bits_scan_cg", ctypes.c_void_p * 12)]


class CommitCtx(ctypes.Structure):
    """Mirror of dsp_core CommitCtx (native plan-commit engine)."""
    _fields_ = [("pic_w", ctypes.c_int32), ("pic_h", ctypes.c_int32),
                ("parts_w", ctypes.c_int32), ("plan_w", ctypes.c_int32),
                ("ctb_log2", ctypes.c_int32),
                ("num_comps", ctypes.c_int32), ("chroma_fmt", ctypes.c_int32),
                ("slice_qp", ctypes.c_int32),
                ("strong_smoothing", ctypes.c_int32),
                ("smoothing_disabled", ctypes.c_int32),
                ("mode_intra", ctypes.c_int32),
                ("size_2nx2n", ctypes.c_int32), ("size_nxn", ctypes.c_int32),
                ("dm_chroma_idx", ctypes.c_int32),
                ("bd", ctypes.c_int32 * 3), ("qp_comp", ctypes.c_int32 * 3),
                ("pad_", ctypes.c_int32),
                ("lam", ctypes.c_double),
                ("orig_p", ctypes.c_void_p * 3),
                ("rec_p", ctypes.c_void_p * 3),
                ("coeff_p", ctypes.c_void_p * 3),
                ("orig_stride", ctypes.c_int64 * 3),
                ("plane_stride", ctypes.c_int64 * 3),
                ("plane_h", ctypes.c_int64 * 3),
                ("coded", ctypes.c_void_p), ("depth", ctypes.c_void_p),
                ("part_size", ctypes.c_void_p),
                ("pred_mode", ctypes.c_void_p),
                ("intra_luma", ctypes.c_void_p),
                ("intra_chroma", ctypes.c_void_p),
                ("qp_arr", ctypes.c_void_p), ("slice_id", ctypes.c_void_p),
                ("tr_idx", ctypes.c_void_p),
                ("cbf", ctypes.c_void_p * 3),
                ("plan_depth", ctypes.c_void_p),
                ("plan_nxn", ctypes.c_void_p),
                ("plan_mode", ctypes.c_void_p),
                ("plan_tusplit", ctypes.c_void_p),
                ("plan_cmode", ctypes.c_void_p),
                ("plan_cands", ctypes.c_void_p),
                ("blobs", ctypes.c_void_p * 36),
                ("resenc", ctypes.c_void_p),
                ("bits_ctx_init", ctypes.c_void_p),
                ("bits_ctx_n", ctypes.c_int64),
                ("bits_params", ctypes.c_void_p * 24),
                ("bits_scan", ctypes.c_void_p * 12),
                ("bits_scan_cg", ctypes.c_void_p * 12)]


class CtuEncCtx(ctypes.Structure):
    """Mirror of cabac_core CtuEncCtx (native pass-2 CTU syntax emitter)."""
    _fields_ = [("pic_w", ctypes.c_int32), ("pic_h", ctypes.c_int32),
                ("parts_w", ctypes.c_int32), ("ctb_log2", ctypes.c_int32),
                ("num_comps", ctypes.c_int32), ("chroma_fmt", ctypes.c_int32),
                ("log2_min_cb", ctypes.c_int32),
                ("log2_min_tb", ctypes.c_int32),
                ("log2_max_tb", ctypes.c_int32),
                ("max_tr_depth_intra", ctypes.c_int32),
                ("pcm_enabled", ctypes.c_int32),
                ("log2_min_pcm", ctypes.c_int32),
                ("log2_max_pcm", ctypes.c_int32),
                ("size_2nx2n", ctypes.c_int32),
                ("mode_intra", ctypes.c_int32),
                ("dm_chroma_idx", ctypes.c_int32),
                ("ctx_split", ctypes.c_int32),
                ("ctx_part_size", ctypes.c_int32),
                ("ctx_intra_mode", ctypes.c_int32),
                ("ctx_chroma_mode", ctypes.c_int32),
                ("ctx_subdiv", ctypes.c_int32),
                ("ctx_qt_cbf", ctypes.c_int32),
                ("pad_", ctypes.c_int32),
                ("coded", ctypes.c_void_p), ("depth", ctypes.c_void_p),
                ("part_size", ctypes.c_void_p),
                ("pred_mode", ctypes.c_void_p),
                ("intra_luma", ctypes.c_void_p),
                ("intra_chroma", ctypes.c_void_p),
                ("cbf", ctypes.c_void_p * 3),
                ("tr_idx", ctypes.c_void_p),
                ("coeff", ctypes.c_void_p * 3),
                ("coeff_stride", ctypes.c_int64 * 3),
                ("res_params", ctypes.c_void_p * 24),
                ("scan", ctypes.c_void_p * 12),
                ("scan_cg", ctypes.c_void_p * 12),
                ("rice_stats", ctypes.c_void_p)]


class ResParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "width", "chan", "scan_type", "first_sig_ctx", "single_ctx",
        "be_valid", "use_rice_adaptation", "align_bypass",
        "use_limited_prefix", "max_tr_dynamic_range", "rice_stat_idx",
        "ctx_last_x", "ctx_last_y", "ctx_sig_cg", "ctx_sig", "ctx_one",
        "ctx_abs", "ctx_set_start", "off_x", "off_y", "shift_x", "shift_y")]


def _build():
    subprocess.run(
        ["g++", "-O3", "-march=native", "-ffp-contract=off", "-funroll-loops", "-shared",
         "-fPIC", "-o", _SO, _SRC],
        check=True, capture_output=True)


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("HM16_NO_NATIVE"):
        from hm16_2_tpu_torch import trace
        trace.unavailable("cabac_core", "HM16_NO_NATIVE is set")
        return None
    try:
        if (not os.path.exists(_SO) or
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_SO)
    except Exception as e:
        from hm16_2_tpu_torch import trace
        trace.unavailable("cabac_core", e)
        return None
    lib.set_tables.argtypes = [ctypes.c_void_p] * 4
    lib.decode_residual.argtypes = [
        ctypes.POINTER(DecState), ctypes.c_void_p, ctypes.POINTER(ResParams),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.decode_residual.restype = ctypes.c_int
    lib.encode_residual.argtypes = [
        ctypes.POINTER(EncState), ctypes.c_void_p, ctypes.POINTER(ResParams),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.encode_residual.restype = ctypes.c_int

    lib.set_entropy_table.argtypes = [ctypes.c_void_p]
    lib.encode_ctu_syntax.argtypes = [
        ctypes.POINTER(EncState), ctypes.c_void_p,
        ctypes.POINTER(CtuEncCtx), ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.encode_ctu_syntax.restype = ctypes.c_int

    from hm16_2_tpu_torch.common import cabac_data as CD
    global _tables_keepalive
    _tables_keepalive = (
        np.ascontiguousarray(CD.LPS_TABLE, dtype=np.uint8),
        np.ascontiguousarray(CD.RENORM_TABLE, dtype=np.uint8),
        np.ascontiguousarray(CD.NEXT_STATE_MPS, dtype=np.uint8),
        np.ascontiguousarray(CD.NEXT_STATE_LPS, dtype=np.uint8),
        np.ascontiguousarray(CD.ENTROPY_BITS, dtype=np.int64))
    lib.set_tables(*[t.ctypes.data_as(ctypes.c_void_p)
                     for t in _tables_keepalive[:4]])
    lib.set_entropy_table(
        _tables_keepalive[4].ctypes.data_as(ctypes.c_void_p))
    _lib = lib
    return lib


_SRC_DSP = os.path.join(_DIR, "dsp_core.cpp")
_SO_DSP = os.path.join(_DIR, "dsp_core.so")
_dsp = None
_dsp_failed = False


def get_dsp():
    """ctypes handle to the fused TU-coding DSP core (or None)."""
    global _dsp, _dsp_failed
    if _dsp is not None or _dsp_failed:
        return _dsp
    if os.environ.get("HM16_NO_NATIVE"):
        _dsp_failed = True
        from hm16_2_tpu_torch import trace
        trace.unavailable("dsp_core", "HM16_NO_NATIVE is set")
        return None
    try:
        if (not os.path.exists(_SO_DSP) or
                os.path.getmtime(_SO_DSP) < os.path.getmtime(_SRC_DSP)):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-ffp-contract=off", "-funroll-loops", "-shared",
                 "-fPIC", "-o", _SO_DSP, _SRC_DSP],
                check=True, capture_output=True)
        lib = ctypes.CDLL(_SO_DSP)
    except Exception as e:
        _dsp_failed = True
        from hm16_2_tpu_torch import trace
        trace.unavailable("dsp_core", e)
        return None
    lib.set_dsp_tables.argtypes = [ctypes.c_void_p] * 7
    lib.code_tu.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.code_tu.restype = ctypes.c_int

    from hm16_2_tpu_torch.common.tables import (
        DCT, DST4, INV_QUANT_SCALES, QUANT_SCALES)
    global _dsp_tables_keepalive
    _dsp_tables_keepalive = tuple(
        np.ascontiguousarray(a, dtype=np.int32)
        for a in (DCT[4], DCT[8], DCT[16], DCT[32], DST4,
                  QUANT_SCALES, INV_QUANT_SCALES))
    lib.set_dsp_tables(*[t.ctypes.data_as(ctypes.c_void_p)
                         for t in _dsp_tables_keepalive])
    lib.intra_code_tu.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.intra_code_tu.restype = ctypes.c_int
    lib.commit_plan_ctu.argtypes = [ctypes.POINTER(CommitCtx),
                                    ctypes.c_int, ctypes.c_int]
    lib.commit_plan_ctu.restype = ctypes.c_int
    lib.commit_plan_frame.argtypes = [ctypes.POINTER(CommitCtx)]
    lib.commit_plan_frame.restype = ctypes.c_int
    lib.sao_frame_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.sao_apply_ctu.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.deblock_luma_edges.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.deblock_chroma_edges.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.inter_commit_cu.argtypes = [
        ctypes.POINTER(InterCtx), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.inter_commit_cu.restype = ctypes.c_int
    lib.ic_cand_sse.argtypes = [
        ctypes.POINTER(InterCtx), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ic_cand_sse.restype = ctypes.c_double
    lib.ic_cand_sse_batch.argtypes = [
        ctypes.POINTER(InterCtx), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.ic_cand_sse_batch.restype = ctypes.c_int
    lib.mc_block_native.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mc_block_native.restype = ctypes.c_int
    lib.set_intra_tables.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    from hm16_2_tpu_torch.common.tables import ANG_TABLE, INV_ANG_TABLE
    global _intra_tables_keepalive
    _intra_tables_keepalive = (
        np.ascontiguousarray(ANG_TABLE, dtype=np.int32),
        np.ascontiguousarray(INV_ANG_TABLE, dtype=np.int32))
    lib.set_intra_tables(*[t.ctypes.data_as(ctypes.c_void_p)
                           for t in _intra_tables_keepalive])
    _dsp = lib
    return lib

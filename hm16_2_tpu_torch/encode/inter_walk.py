"""The native walk of an inter plan's CTUs (`native/inter_walk.cpp`).

One C call commits one CTU of a P or B picture's frame plan
(`encode/inter_plan.py`): for each CU the plan decided as inter, in z-order,
the exact merge and AMVP lists from the committed neighbours, the SSE
rerank of the merge candidates against the planned motion signalled as
AMVP, the CU's field writes and `dsp_core`'s `inter_commit_cu`.  It is the
native twin of `CtuSearch._commit_plan_tree` -> `_commit_planned_inter` /
`_commit_planned_rect` -> `MvPredictor` and gives the same bytes.

`commit_frame(search, pic)` walks every CTU of a P or B picture with an
inter plan as a CTU wavefront over the host's cores (`native/intra_wave.cpp`'s
scheduler: CTU (x, y) once row y - 1 has finished x + 2 CTUs), where the
picture is one slice and one tile; the caller commits from the first CTU
it handed back on, in raster order.  `commit_ctu(search, cx, cy)` is the
walk of one CTU, tried for every CTU the wavefront did not commit.  A
planned intra CU is committed by the host's `CtuSearch._commit_cu` (or
`_commit_nxn`) through a callback, in its z-order place, one at a time and
from whichever thread walks its CTU.  The walk engages only where the
native inter commit engine does (`CtuSearch._inter_ctx()`: no weighted
prediction, 4:0:0 or 4:2:0, no cu_qp_delta, no scaling lists, no
transquant bypass, at most 8 references, HM16_NO_COMMIT_ENGINE unset) and
the host mapping has no variant switched on (HM16_KIND_RD,
HM16_RERANK_LUMA_ONLY).  A CTU holding an uncovered area, a reference
index out of range or a CU without a compensable candidate is handed back
untouched, and the caller commits it as before.  Slices and tiles take the
decoder's availability rules.  Either way the bytes are those of the
raster walk.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import weakref

import numpy as np

from hm16_2_tpu_torch import trace as _trace

_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SRC = os.path.join(_DIR, "inter_walk.cpp")
_SO = os.path.join(_DIR, "inter_walk.so")
_lib = None
_failed = False

_P = ctypes.c_void_p
_I = ctypes.c_int32
MAX_REFS = 16


class WalkCtx(ctypes.Structure):
    """Mirror of inter_walk.cpp's WalkCtx."""
    _fields_ = [(n, _I) for n in (
        "pic_w", "pic_h", "parts_w", "parts_h", "log2_ctb", "w_ctbs",
        "min_cb_log2", "plan_w", "plan_h", "is_b", "max_merge", "plevel",
        "tmvp", "ldc", "col_from_l0", "cur_poc")] + [
        ("num_ref_idx", _I * 2), ("n_list", _I * 2),
        ("ref_poc", _I * (2 * MAX_REFS)), ("ref_lt", _I * (2 * MAX_REFS)),
        ("col_poc", _I), ("col_pw", _I), ("col_ph", _I)] + [
        (n, _P) for n in (
            "col_pred_mode", "col_ref_idx", "col_ref_poc", "col_mv",
            "slice_id", "tile_of_ctu", "ctu_rs_to_ts", "coded", "depth",
            "part_size", "pred_mode", "tr_idx", "merge_flag", "skip",
            "inter_dir", "qp", "intra_luma")] + [
        ("cbf", _P * 3), ("intra_chroma", _P), ("ipcm", _P),
        ("tskip", _P * 3)] + [
        (n, _P) for n in ("ref_idx", "mvp_idx", "mv", "mvd",
                          "ref_poc_arr")] + [
        ("num_comps", _I), ("rec_p", _P * 3), ("coeff_p", _P * 3),
        ("plane_stride", ctypes.c_int64 * 3)] + [
        (n, _P) for n in (
            "p_cov", "p_pred_inter", "p_skip_hint", "p_depth", "p_part",
            "p_dir", "p_mv", "p_ref", "p_pu", "ictx", "cand_sse",
            "commit_cu", "host_cu")] + [
        ("lam", ctypes.c_double), ("cu_qp", _I), ("ctu_cus", _P),
        ("ctu_host_cus", _P)]

HOST_CU = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int)


def get_lib():
    """ctypes handle to inter_walk.so (built next to its source on first
    use), or None; why it did not load is recorded with the tracer."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        if os.environ.get("HM16_NO_NATIVE"):
            raise RuntimeError("HM16_NO_NATIVE is set")
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-ffp-contract=off",
                 "-funroll-loops", "-pthread", "-shared", "-fPIC", "-o",
                 tmp, _SRC],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        lib.iw_sizeof_ctx.restype = ctypes.c_int64
        if lib.iw_sizeof_ctx() != ctypes.sizeof(WalkCtx):
            raise RuntimeError("WalkCtx layout differs from the library's")
    except Exception as e:
        _failed = True
        _trace.unavailable("inter_walk", e)
        return None
    ctx = ctypes.POINTER(WalkCtx)
    lib.iw_commit_ctu.argtypes = [ctx, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_double, ctypes.c_int]
    lib.iw_commit_ctu.restype = ctypes.c_int
    lib.iw_wave_ctu.argtypes = [_P, ctypes.c_int, ctypes.c_int]
    lib.iw_wave_ctu.restype = ctypes.c_int
    lib.iw_merge_list.argtypes = [ctx] + [ctypes.c_int] * 6 + [_P]
    lib.iw_merge_list.restype = ctypes.c_int
    lib.iw_amvp_list.argtypes = [ctx] + [ctypes.c_int] * 6 + [_P]
    lib.iw_amvp_list.restype = ctypes.c_int
    _lib = lib
    return lib


def _ptr(arr, dtype, keep, shape=None):
    """The address of arr when it is C-contiguous of dtype (and shape),
    else None; arr is kept alive with the context."""
    if not isinstance(arr, np.ndarray) or arr.dtype != np.dtype(dtype) \
            or not arr.flags.c_contiguous \
            or (shape is not None and arr.shape != tuple(shape)):
        return None
    keep.append(arr)
    return arr.ctypes.data


def lists_context(pic, rc):
    """A WalkCtx holding what the merge and AMVP derivations read (the
    picture's arrays, the slice, the reference lists, the colocated
    picture), or None where the walk does not apply.  The context keeps
    its arrays alive in its `keep` attribute."""
    sh = rc.sh
    if not 1 <= sh.max_num_merge_cand <= 5 or len(rc.ref_lists) != 2 or \
            any(len(lst) > MAX_REFS for lst in rc.ref_lists):
        return None
    C = WalkCtx()
    keep = []
    shp = (pic.ph, pic.pw)
    C.pic_w, C.pic_h = pic.w, pic.h
    C.parts_w, C.parts_h = pic.pw, pic.ph
    C.log2_ctb, C.w_ctbs = pic.log2_ctb, pic.w_ctbs
    C.min_cb_log2 = pic.sps.log2_min_cb
    C.is_b = 1 if sh.slice_type == 0 else 0
    C.max_merge = sh.max_num_merge_cand
    C.plevel = sh.pps.log2_parallel_merge_level
    C.tmvp = 1 if sh.temporal_mvp_enabled and rc.col_pic is not None else 0
    C.ldc = 1 if rc.ldc else 0
    C.col_from_l0 = sh.collocated_from_l0
    C.cur_poc = sh.poc
    for lx in range(2):
        C.num_ref_idx[lx] = sh.num_ref_idx[lx]
        C.n_list[lx] = len(rc.ref_lists[lx])
        for ri, ref in enumerate(rc.ref_lists[lx]):
            C.ref_poc[lx * MAX_REFS + ri] = ref.poc
            C.ref_lt[lx * MAX_REFS + ri] = 1 if ref.is_long_term else 0
    if C.tmvp:
        col = rc.col_pic
        cshp = getattr(col.pred_mode, "shape", None)
        if cshp is None or len(cshp) != 2:
            return None
        C.col_poc = col.poc
        C.col_ph, C.col_pw = cshp
        ptrs = (_ptr(col.pred_mode, np.int8, keep),
                _ptr(col.ref_idx, np.int8, keep, (2,) + cshp),
                _ptr(col.ref_poc, np.int32, keep, (2,) + cshp),
                _ptr(col.mv, np.int32, keep, (2,) + cshp + (2,)))
        if None in ptrs:
            return None
        (C.col_pred_mode, C.col_ref_idx, C.col_ref_poc, C.col_mv) = ptrs
    parts = [
        ("slice_id", pic.slice_id, np.int32, shp),
        ("tile_of_ctu", pic.tiles.tile_of_ctu, np.int32,
         (pic.h_ctbs, pic.w_ctbs)),
        ("ctu_rs_to_ts", pic.tiles.ctu_rs_to_ts, np.int64,
         (pic.h_ctbs * pic.w_ctbs,)),
        ("coded", pic.coded, np.bool_, shp),
        ("depth", pic.depth, np.int8, shp),
        ("part_size", pic.part_size, np.int8, shp),
        ("pred_mode", pic.pred_mode, np.int8, shp),
        ("tr_idx", pic.tr_idx, np.int8, shp),
        ("merge_flag", pic.merge_flag, np.int8, shp),
        ("skip", pic.skip, np.int8, shp),
        ("inter_dir", pic.inter_dir, np.int8, shp),
        ("qp", pic.qp, np.int16, shp),
        ("intra_luma", pic.intra_luma, np.int16, shp),
        ("intra_chroma", pic.intra_chroma, np.int16, shp),
        ("ipcm", pic.ipcm, np.int8, shp),
        ("ref_idx", pic.ref_idx, np.int8, (2,) + shp),
        ("mvp_idx", pic.mvp_idx, np.int8, (2,) + shp),
        ("mv", pic.mv, np.int32, (2,) + shp + (2,)),
        ("mvd", pic.mvd, np.int32, (2,) + shp + (2,)),
        ("ref_poc_arr", pic.ref_poc, np.int32, (2,) + shp)]
    for name, arr, dtype, want in parts:
        p = _ptr(arr, dtype, keep, want)
        if p is None:
            return None
        setattr(C, name, p)
    for c in range(3):
        cbf = _ptr(pic.cbf[c], np.uint8, keep, shp)
        tskip = _ptr(pic.tskip[c], np.int8, keep, shp)
        if cbf is None or tskip is None:
            return None
        C.cbf[c], C.tskip[c] = cbf, tskip
    C.num_comps = pic.num_comps
    for c in range(pic.num_comps):
        sx, sy = pic.comp_shift[c]
        if (sx, sy) != ((0, 0) if c == 0 else (1, 1)):
            return None
        want = ((pic.ph * 4) >> sy, (pic.pw * 4) >> sx)
        rec = _ptr(pic.rec[c], np.int32, keep, want)
        coeff = _ptr(pic.coeff[c], np.int32, keep, want)
        if rec is None or coeff is None:
            return None
        C.rec_p[c], C.coeff_p[c] = rec, coeff
        C.plane_stride[c] = want[1]
    C.keep = keep
    return C


def _plan_context(search):
    """lists_context of the search's picture with its plan and the native
    inter commit engine, or None where the walk does not engage."""
    plan = search.plan
    if os.environ.get("HM16_KIND_RD") or \
            os.environ.get("HM16_RERANK_LUMA_ONLY"):
        return None
    mvp = getattr(search, "mvp", None)
    if mvp is None or mvp.rc.sh is not search.sh:
        return None
    lib = get_lib()
    if lib is None:
        return None
    ic = search._inter_ctx()
    if ic is None:
        return None
    pic = search.pic
    C = lists_context(pic, mvp.rc)
    if C is None:
        return None
    h4, w4 = pic.h // 4, pic.w // 4
    keep = C.keep
    C.plan_w, C.plan_h = w4, h4
    ptrs = tuple(
        _ptr(np.ascontiguousarray(getattr(plan, name)), dtype, keep, shape)
        for name, dtype, shape in (
            ("cov", np.bool_, (h4, w4)), ("pred_inter", np.bool_, (h4, w4)),
            ("skip_hint", np.bool_, (h4, w4)), ("depth", np.int8, (h4, w4)),
            ("part", np.int8, (h4, w4)), ("dir", np.int8, (h4, w4)),
            ("mv", np.int32, (2, h4, w4, 2)), ("ref", np.int8, (2, h4, w4)),
            ("pu", np.int32, (2, 4, h4, w4))))
    if None in ptrs:
        return None
    (C.p_cov, C.p_pred_inter, C.p_skip_hint, C.p_depth, C.p_part, C.p_dir,
     C.p_mv, C.p_ref, C.p_pu) = ptrs
    from hm16_2_tpu_torch import native
    dsp = native.get_dsp()
    keep.append(ic)
    C.ictx = ctypes.addressof(ic)
    C.cand_sse = ctypes.cast(dsp.ic_cand_sse, _P).value
    C.commit_cu = ctypes.cast(dsp.inter_commit_cu, _P).value
    ref = weakref.ref(search)        # the context is kept on the search
    host = HOST_CU(lambda px, py, log2: _commit_intra(ref(), px, py, log2))
    keep.append(host)
    C.host_cu = ctypes.cast(host, _P).value
    C.cus_of_ctu = np.zeros(pic.w_ctbs * pic.h_ctbs, np.int32)
    C.host_cus_of_ctu = np.zeros_like(C.cus_of_ctu)
    C.ctu_cus = _ptr(C.cus_of_ctu, np.int32, keep)
    C.ctu_host_cus = _ptr(C.host_cus_of_ctu, np.int32, keep)
    return C


def _commit_intra(search, px, py, log2):
    """A planned intra CU inside the walk, committed as _commit_plan_tree
    does: 0, or -1 (the walk then hands its CTU back, and the host commits
    the CTU again and meets what failed)."""
    try:
        plan = search.plan
        if log2 == 3 and plan.nxn[py, px]:
            search._commit_nxn(px, py)
        else:
            search._commit_cu(px, py, log2, int(plan.mode[py, px]),
                              tusplit=bool(plan.tusplit[py, px]))
    except Exception:
        return -1
    return 0


def _context(search):
    """The walk's context for the search's plan (made once a plan), or
    None where the walk does not engage."""
    got = getattr(search, "_iwalk", None)
    if got is None or got[0] is not search.plan:
        got = search._iwalk = (search.plan, _plan_context(search))
    return got[1]


def commit_frame(search, pic, nthreads=None):
    """Walks the CTUs of the search's inter plan as a CTU wavefront on
    `nthreads` threads (default `intra_wave.threads` of the CTU grid):
    what `intra_wave_commit` returns, 0 or 1 + the raster index k of the
    first CTU handed back (the CTUs from k on are left as the raster walk
    leaves them, for the caller to commit from k), or None where the
    wavefront does not engage (no context; several slices or tiles;
    cu_qp_delta; one thread; the scheduler does not load) and the caller
    commits every CTU."""
    ctx = _context(search)
    if ctx is None or len(pic.slices) != 1 or \
            len(pic.tiles.col_bounds) != 2 or \
            len(pic.tiles.row_bounds) != 2 or \
            search.pps.cu_qp_delta_enabled:
        return None
    from hm16_2_tpu_torch.encode import intra_wave
    wc, hc = pic.w_ctbs, pic.h_ctbs
    n = intra_wave.threads(wc, hc) if nthreads is None else nthreads
    wave = intra_wave.get_lib() if n > 1 else None
    tr = _trace.ON
    if wave is None:
        tr and _trace.count("commit.wave_threads", 1)
        return None
    ctx.lam, ctx.cu_qp = float(search.lam), int(search.cur_qp)
    s = tr and _trace.open("commit.recon", key="inter_walk")
    waited = ctypes.c_int64(0)
    rc = wave.intra_wave_commit(
        ctypes.addressof(ctx), ctypes.cast(_lib.iw_wave_ctu, _P).value,
        wc, hc, n, pic.coded.ctypes.data, pic.pw, pic.ctb // 4,
        ctypes.byref(waited))
    if s:
        k = wc * hc if rc == 0 else rc - 1
        _trace.close(s, "commit.native_cus", int(ctx.cus_of_ctu[:k].sum()))
        host = int(ctx.host_cus_of_ctu[:k].sum())
        host and _trace.count("commit.python_cus", host)
        k and _trace.count("commit.walk_ctus", k)
        _trace.count("commit.wave_threads", n)
        _trace.count("commit.wave_ctus", k)
        _trace.count("commit.wave_wait_ms", round(waited.value / 1e6))
    return rc


def commit_ctu(search, cx, cy):
    """Commits CTU (cx, cy) of the search's inter plan natively: True, or
    False when the walk does not engage or hands the CTU back as it found
    it (the caller then commits it)."""
    ctx = _context(search)
    if ctx is None:
        return False
    s = _trace.ON and _trace.open("commit.recon", key="inter_walk")
    n = _lib.iw_commit_ctu(ctypes.byref(ctx), cx, cy, float(search.lam),
                           int(search.cur_qp))
    if n < 0:
        s and _trace.close(s, "commit.native_refused_ctus")
        return False
    s and _trace.close(s, "commit.native_cus", n)
    host = int(ctx.host_cus_of_ctu[cy * ctx.w_ctbs + cx])
    s and host and _trace.count("commit.python_cus", host)
    s and _trace.count("commit.walk_ctus")
    return True


def merge_list(ctx, x, y, w, h, pu_idx, part_size):
    """The native merge list of a PU as MvPredictor.merge_candidates gives
    it, truncated to max_num_merge_cand, or None where the host raises."""
    out = np.zeros((8, 7), np.int32)
    n = get_lib().iw_merge_list(ctypes.byref(ctx), x, y, w, h, pu_idx,
                                part_size, out.ctypes.data)
    if n < 0:
        return None
    return [(int(d), (int(r0), (int(a), int(b))), (int(r1), (int(c), int(e))))
            for d, r0, a, b, r1, c, e in out[:n]]


def amvp_list(ctx, x, y, w, h, lx, ref_idx):
    """The native AMVP predictors of a PU as MvPredictor.amvp_candidates
    gives them, or None where the host raises."""
    out = np.zeros(4, np.int32)
    if get_lib().iw_amvp_list(ctypes.byref(ctx), x, y, w, h, lx, ref_idx,
                              out.ctypes.data) < 0:
        return None
    return [(int(out[0]), int(out[1])), (int(out[2]), int(out[3]))]

"""The port's hand-written CUDA kernels: build, bindings and launch counts.

Sources live in `csrc/`; they are compiled at first use by `nvcc` for
Hopper (`sm_90a`) into one shared library with a plain C interface, cached
in `_build/` under a hash of the sources and flags, and bound with ctypes.
Every launch goes on PyTorch's current stream and allocates nothing itself:
the functions here allocate outputs with torch, check device, dtype, shape
and contiguity, launch, and raise if `cudaGetLastError()` is not 0.

    K1 ref_buffers    csrc/ref_buffers.cu (every size and plane of a
                                          picture in one launch)
       ref_buffers_band                  (K1 on one row band with its halos,
                                          every size of a band height in one
                                          launch: parallel.frame_shard)
    K2 intra_size_rd  csrc/intra_rd.cu   (also SATD-only for _premodes, and
                                          the P plan's intra alternative)
       analysis_step                     (K2's analysis mode: parallel.mesh)
    K3 intra_cand_rd  csrc/intra_rd.cu
    K4 plan_dp        csrc/plan_dp.cu    (the AI plan's chroma candidates and
                                          64x64 modes, then its chroma fold,
                                          64x64 cost, DP and emission a CTA
                                          per CTU pair; the P/B plan's DP and
                                          emission a CTA per CTU)
    K5 inter_me       csrc/inter_me.cu   (downsample, coarse grid, pyramid,
                                          argmin, refinement; the plan's
                                          MVD-bin model)
       me_frame                          (K5 with me_frame's log bit model
                                          and the winners' costs)
       inter_me_band, me_frame_band      (K5 on one row band against the
                                          whole references: parallel.
                                          plan_shard, parallel.me_shard)
    K6 subpel_planes  csrc/subpel.cu
    K7 inter_uni      csrc/inter_rd.cu   (q-pel refinement)
       inter_pick                        (K7's list picks: every size, shape
                                          and list of a picture in one launch)
       inter_bi_refine                   (K7's per-block-reference mode:
                                          the B plan's bi refinement)
    K8 inter_cu_rd    csrc/inter_rd.cu   (P pictures)
       inter_cu_rd_b                     (K8's B mode)

`LAUNCHES` counts kernel launches per kernel (and per mode of K7 and K8);
the counts grow only where a kernel is launched.  While `trace` is on, each
public wrapper is a `kernel` span carrying its `LAUNCHES` key (the one-entry
`ref_buffers` and `ref_buffers_band` are their multi form's span), and each
launch adds to the `kernel.launches` counter and to its span's `n`.  Nothing
here runs at import: `nvcc` is looked up and run on the first launch (or an
explicit `build()`).  Loading the library checks that every argument
struct's ctypes mirror has the C struct's size.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from hm16_2_tpu_torch import trace as _trace
from hm16_2_tpu_torch.common.tables import ANG_TABLE, DCT, DST4, INV_ANG_TABLE, \
    INV_QUANT_SCALES, QUANT_SCALES
from hm16_2_tpu_torch.ops.intra_ref import should_filter

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
_BUILD = os.path.join(_DIR, "_build")
_SOURCES = ("ref_buffers.cu", "intra_rd.cu", "plan_dp.cu", "inter_me.cu",
            "subpel.cu", "inter_rd.cu")
_HEADERS = ("intra_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES = {"ref_buffers": 0, "intra_size_rd": 0, "intra_cand_rd": 0,
            "plan_dp": 0, "inter_me": 0, "subpel_planes": 0, "inter_uni": 0,
            "inter_pick": 0, "inter_bi_refine": 0, "inter_cu_rd": 0,
            "inter_cu_rd_b": 0, "me_frame": 0, "ref_buffers_band": 0,
            "inter_me_band": 0, "me_frame_band": 0, "analysis_step": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


MAX_K1 = 10              # hm::kMaxK1: K1 entries per launch


class K1Entry(ctypes.Structure):
    """hm::K1Entry (csrc/ref_buffers.cu)."""
    _fields_ = [("plane", ctypes.c_void_p), ("bufs", ctypes.c_void_p),
                ("blocks", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("ph", "pw", "s", "bd", "strong", "nby",
                                    "nbx", "max_row", "first")]


class K1Args(ctypes.Structure):
    """hm::K1Args (csrc/ref_buffers.cu)."""
    _fields_ = [("n", ctypes.c_int), ("total", ctypes.c_int),
                ("halo_top", ctypes.c_void_p), ("halo_bot", ctypes.c_void_p),
                ("band_first", ctypes.c_int), ("e", K1Entry * MAX_K1)]


class TqParams(ctypes.Structure):
    """hm::TqParams (csrc/intra_common.cuh)."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "s", "log2", "bd", "maxv", "edge", "fwd_s1", "fwd_s2", "q_scale",
        "q_bits", "q_add", "dq_scale", "dq_shift", "dq_min", "dq_max",
        "inv_s2")] + [("filt", ctypes.c_ulonglong)]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class PlanPre(ctypes.Structure):
    """hm::PlanPre (csrc/plan_dp.cu)."""
    _fields_ = [("dm", _P * 3), ("n", _I * 3), ("modes5", _P * 3),
                ("base", _I * 4), ("satd32", _P), ("nbx32", _I),
                ("nby64", _I), ("nbx64", _I), ("mode64", _P), ("pm64", _P)]


class PlanCtu(ctypes.Structure):
    """hm::PlanCtu (csrc/plan_dp.cu)."""
    _fields_ = [("nby", _I * 5), ("nbx", _I * 5), ("lam", _F), ("cw", _F),
                ("nxn_bits", _F), ("split_bits", _F), ("bits64", _F),
                ("mode_bits", _F * 5), ("cost", _P * 4), ("mode", _P * 5),
                ("cand", _P * 4), ("chroma", (_P * 4) * 3), ("d64", _P),
                ("b64", _P)]


class InterCtu(ctypes.Structure):
    """hm::InterCtu (csrc/plan_dp.cu)."""
    _fields_ = [("ny", _I * 4), ("nx", _I * 4), ("h4", _I), ("w4", _I),
                ("lam", _F), ("split_bits", _F), ("cost", _P * 4),
                ("rec", _P * 4)]


MAX_PICK = 24            # hm::kMaxPick: list-pick entries per launch


class PickEntry(ctypes.Structure):
    """hm::PickEntry (csrc/inter_rd.cu)."""
    _fields_ = [("mvq", _P), ("satd", _P), ("pred4", _P), ("lmap", _P),
                ("mr", _I), ("nref", _I), ("N", _I), ("off", _I)]


class PickArgs(ctypes.Structure):
    """hm::PickArgs (csrc/inter_rd.cu)."""
    _fields_ = [("n", _I), ("total", _I), ("lam", _F), ("iout", _P),
                ("fout", _P), ("e", PickEntry * MAX_PICK)]


class UniRes(ctypes.Structure):
    """hm::UniRes (csrc/inter_rd.cu)."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("mv", "uref", "ridx", "bits",
                                              "cost")]


class CuRdArgs(ctypes.Structure):
    """hm::CuRdArgs (csrc/inter_rd.cu)."""
    _fields_ = [("cur", ctypes.c_void_p), ("h", ctypes.c_int),
                ("w", ctypes.c_int), ("sub", ctypes.c_void_p),
                ("Hp", ctypes.c_int), ("Wp", ctypes.c_int),
                ("nx", ctypes.c_int), ("uni", UniRes),
                ("tmvp4", ctypes.c_void_p), ("ref0", ctypes.c_int),
                ("rect", UniRes * 2), ("has_rect", ctypes.c_int),
                ("i_mode", ctypes.c_void_p), ("i_top3", ctypes.c_void_p),
                ("i_cost", ctypes.c_void_p), ("has_intra", ctypes.c_int),
                ("lamf", ctypes.c_float), ("lams", ctypes.c_float),
                ("nmerge", ctypes.c_int), ("tq", TqParams),
                ("tm", ctypes.c_void_p), ("model", ctypes.c_void_p),
                ("rec", ctypes.c_void_p), ("cost", ctypes.c_void_p),
                # B mode only
                ("uni1", UniRes), ("tmvp4_1", ctypes.c_void_p),
                ("ref1", ctypes.c_int), ("rect1", UniRes * 2),
                ("anchor0", ctypes.c_void_p), ("anchor1", ctypes.c_void_p),
                ("mvb0", ctypes.c_void_p), ("mvb1", ctypes.c_void_p),
                ("nref0", ctypes.c_int), ("nref1", ctypes.c_int)]

# each C argument struct (its sizeof exported by the library) and its mirror
_STRUCTS = {"hm_sizeof_k1_args": K1Args, "hm_sizeof_tq_params": TqParams,
            "hm_sizeof_plan_pre": PlanPre, "hm_sizeof_plan_ctu": PlanCtu,
            "hm_sizeof_inter_ctu": InterCtu, "hm_sizeof_pick_args": PickArgs,
            "hm_sizeof_uni_res": UniRes, "hm_sizeof_cu_rd_args": CuRdArgs}


_lib = None


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return path


def _library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(_BUILD, f"libhm16_kernels_{h.hexdigest()[:16]}.so")


def build():
    """Compile the kernels if the cached library is missing, one nvcc per
    source, all at once, then link; returns (library path, seconds spent
    compiling).  ptxas's report of each kernel (registers, shared memory,
    spills) is kept beside the library (`resource_usage`)."""
    out = _library_path()
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o",
                               f"{tmp}.{i}.o", os.path.join(_CSRC, src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for i, src in enumerate(_SOURCES)]
    errs, report = [], []
    for src, pr in zip(_SOURCES, procs):
        o, e = pr.communicate()
        if pr.returncode != 0:
            errs.append(o + e)
        report.append(f"== {src}\n{o}{e}")
    with open(out + ".ptxas.txt", "w") as f:
        f.write("".join(report))
    objs = [f"{tmp}.{i}.o" for i in range(len(_SOURCES))]
    if not errs:
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp,
                            *objs], capture_output=True, text=True)
        if r.returncode != 0:
            errs.append(r.stdout + r.stderr)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if errs:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errs))
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


def resource_usage():
    """ptxas's report of the built library's kernels (`build()` first)."""
    with open(_library_path() + ".ptxas.txt") as f:
        return f.read()


def dynamic_smem():
    """Shared memory per CTA in bytes: K1's (static, one size for every s),
    and the dynamic shared memory of K2 and K3 by block size and mode, of
    K6, and of K8 by CU size and mode, as the library launches them
    (ptxas reports static shared memory only)."""
    lib = _load()
    out = {"ref_multi_kernel (static)": lib.hm_k1_smem_bytes()}
    for s in (4, 8, 16, 32):
        for op, kern in enumerate(("size_rd_kernel<{}, RD>",
                                   "size_rd_kernel<{}, SATD>",
                                   "cand_rd_kernel<{}>",
                                   "analysis_kernel<{}>")):
            out[kern.format(s)] = lib.hm_intra_smem_bytes(s, op)
    out["subpel_kernel"] = lib.hm_subpel_smem_bytes()
    for s in (8, 16, 32, 64):
        for b, mode in ((0, "P"), (1, "B")):
            out[f"cu_rd_kernel<{s}, {mode}>"] = lib.hm_cu_rd_smem_bytes(s, b)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build()[0])
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "hm_ref_buffers_multi": [ctypes.POINTER(K1Args), P],
        "hm_ref_buffers_band_multi": [ctypes.POINTER(K1Args), P],
        "hm_intra_size_rd": [P, P, I, ctypes.POINTER(TqParams), P, P, P, F,
                             I, I, P, P, P, P, P],
        "hm_intra_cand_rd": [P, P, P, I, I, ctypes.POINTER(TqParams), P, P,
                             P, P, P, P],
        "hm_analysis_step": [P, P, I, ctypes.POINTER(TqParams), P, P, P, P, P,
                             P, P],
        "hm_plan_pre": [ctypes.POINTER(PlanPre), P],
        "hm_plan_ctu": [ctypes.POINTER(PlanCtu), P, P],
        "hm_emit_inter_plan": [ctypes.POINTER(InterCtu), P, P],
        "hm_me_down": [P, I, I, I, I, I, P, P],
        "hm_me_coarse8": [P, P, I, I, I, I, I, I, I, P, P],
        "hm_me_quad": [P, ctypes.c_longlong, I, I, I, I, P, P],
        "hm_me_argmin": [P, I, I, I, I, I, I, P, F, I, P, P],
        "hm_me_refine": [P, I, P, I, I, I, I, I, I, I, P, P, F, I, P, P, P],
        "hm_subpel_planes": [P, I, I, I, I, P, P],
        "hm_frac_refine": [P, I, I, P, I, I, I, I, I, I, P, I, P, P, P, P, F,
                           P, P, P],
        "hm_uni_select_all": [ctypes.POINTER(PickArgs), P],
        "hm_cu_rd": [ctypes.POINTER(CuRdArgs), I, I, I, P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.hm_error_string.argtypes = [ctypes.c_int]
    lib.hm_error_string.restype = ctypes.c_char_p
    lib.hm_cu_rd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.hm_cu_rd_smem_bytes.restype = ctypes.c_size_t
    lib.hm_subpel_smem_bytes.argtypes = []
    lib.hm_subpel_smem_bytes.restype = ctypes.c_size_t
    lib.hm_k1_smem_bytes.argtypes = []
    lib.hm_k1_smem_bytes.restype = ctypes.c_size_t
    lib.hm_intra_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.hm_intra_smem_bytes.restype = ctypes.c_size_t
    for name, mirror in _STRUCTS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], ctypes.c_size_t
        if fn() != ctypes.sizeof(mirror):
            raise RuntimeError(f"{mirror.__name__}: the C struct has {fn()} "
                               f"bytes, its ctypes mirror "
                               f"{ctypes.sizeof(mirror)}")
    _lib = lib
    return lib


def _launch(kernel, name, *args):
    lib = _load()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{lib.hm_error_string(rc).decode()}")
    LAUNCHES[kernel] += 1
    _trace.ON and _trace.launched()


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _need(t, dtype, shape=None, name="tensor"):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# constant tables on the device
# ---------------------------------------------------------------------------

_tables = {}


def _device_tables(device):
    """Transform matrices, angle tables and the bits-model constants as
    device tensors (built once per device from the reference's tables)."""
    key = str(device)
    if key not in _tables:
        from hm16_2_tpu_torch.encode import intra_rd as R
        i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                        device=device)
        model = np.concatenate([
            R.LN_LAST, [R.LOG2E],
            [R.BITS_COEF[k] for k in ("nzc", "nnz", "gt1", "esc", "last",
                                      "cgs")],
            [R.BITS_CONST, R.BITS_EMPTY, R.BITS_FLOOR,
             R.LUMA_MODE_BITS]]).astype(np.float32)
        _tables[key] = {
            "dct": {s: i32(DCT[s]) for s in (4, 8, 16, 32)},
            "dst4": i32(DST4),
            "ang": i32(np.concatenate([ANG_TABLE, INV_ANG_TABLE])),
            "model": torch.as_tensor(model, device=device),
        }
    return _tables[key]


def _tq_params(s, bd, qp, is_luma, inter=False):
    """The transform chain's constants for one size (hm::TqParams); inter:
    the inter rounding offset (85) in place of the intra one (171)."""
    log2 = s.bit_length() - 1
    per, rem = qp // 6, qp % 6
    tshift = 15 - bd - log2
    q_bits = 14 + per + tshift
    dq_shift = 6 - (tshift + per)
    target_bd = min(16, 32 + dq_shift - 7)
    filt = 0
    for m in range(35):
        if should_filter(m, s, is_luma):
            filt |= 1 << m
    return TqParams(
        s=s, log2=log2, bd=bd, maxv=(1 << bd) - 1,
        edge=int(is_luma and s <= 16), fwd_s1=log2 - 1 + bd - 8,
        fwd_s2=log2 + 6, q_scale=int(QUANT_SCALES[rem]), q_bits=q_bits,
        q_add=(85 if inter else 171) << (q_bits - 9),
        dq_scale=int(INV_QUANT_SCALES[rem]),
        dq_shift=dq_shift, dq_min=-(1 << (target_bd - 1)),
        dq_max=(1 << (target_bd - 1)) - 1, inv_s2=20 - bd, filt=filt)


def _tmat(tabs, s, use_dst):
    return tabs["dst4"] if (use_dst and s == 4) else tabs["dct"][s]


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def _k1_entry(plane, s, bd, strong, nby, nbx, max_row=0):
    """One K1 entry on `plane` (checked) and its outputs, allocated."""
    dev = plane.device
    n = nby * nbx
    bufs = torch.empty((n, 2, 4 * s + 1), dtype=torch.int32, device=dev)
    blocks = torch.empty((n, s, s), dtype=torch.int32, device=dev)
    ph, pw = plane.shape
    return K1Entry(plane.data_ptr(), bufs.data_ptr(), blocks.data_ptr(), ph,
                   pw, s, bd, int(bool(strong)), nby, nbx, max_row, 0), \
        (bufs, blocks)


def _k1_launch(kernel, name, args, outs, lead):
    """Launch K1 on `args` on lead's stream unless no entry has a block."""
    if any(blocks.numel() for _, blocks in outs):
        _launch(kernel, name, ctypes.byref(args), _stream(lead))
    return outs


def _k1_plane(plane, s, bd, name):
    _need(plane, torch.int32, name=name)
    if plane.dim() != 2 or s not in (4, 8, 16, 32) or not 8 <= bd <= 16:
        raise ValueError(f"{name}: a 2-D plane, s in 4..32 and bd in 8..16, "
                         f"got {tuple(plane.shape)}, s={s}, bd={bd}")


def ref_buffers_multi(entries):
    """K1 over up to MAX_K1 entries (plane, s, bd, strong, h, w) in one
    launch: per entry the (N, 2, 4s+1) buffers and (N, s, s) blocks of
    every aligned s-block inside (h, w) of its (ph, pw) plane, raster
    order.  An entry without a block gets empty outputs."""
    span = _trace.ON and _trace.open("kernel", key="ref_buffers")
    if not 0 < len(entries) <= MAX_K1:
        raise ValueError(f"ref_buffers_multi: {len(entries)} entries, not "
                         f"1..{MAX_K1}")
    dev = entries[0][0].device
    args, outs = K1Args(n=len(entries)), []
    for j, (plane, s, bd, strong, h, w) in enumerate(entries):
        _k1_plane(plane, s, bd, f"ref_buffers_multi entry {j}")
        ph, pw = plane.shape
        nby, nbx = h // s, w // s
        if plane.device != dev or h < 0 or w < 0 or nby * s > ph or \
                nbx * s > pw:
            raise ValueError(f"ref_buffers_multi entry {j}: s={s} for "
                             f"{h}x{w} in a {ph}x{pw} plane on "
                             f"{plane.device} (entry 0 on {dev})")
        args.e[j], out = _k1_entry(plane, s, bd, strong, nby, nbx)
        outs.append(out)
    result = _k1_launch("ref_buffers", "hm_ref_buffers_multi", args, outs,
                        entries[0][0])
    span and _trace.close(span)
    return result


def ref_buffers(plane, s, bd, strong, h, w):
    """K1 on one size: ref_buffers_multi's one-entry launch."""
    return ref_buffers_multi([(plane, s, bd, strong, h, w)])[0]


def ref_buffers_band_multi(band, halo_top, halo_bot, sizes, bd, strong,
                           band_first, pic_h):
    """K1's band mode over the sizes of one band height in one launch: per
    size s the buffers and blocks of every aligned s-block of a (B, W) row
    band whose first row is picture row band_first of pic_h, with the band
    above's last row halo_top (1, W) and the band below's first rows
    halo_bot (max(sizes), W)."""
    span = _trace.ON and _trace.open("kernel", key="ref_buffers_band")
    if not 0 < len(sizes) <= MAX_K1:
        raise ValueError(f"ref_buffers_band_multi: {len(sizes)} sizes, not "
                         f"1..{MAX_K1}")
    B, W = band.shape
    smax = max(sizes)
    dev = band.device
    _need(halo_top, torch.int32, (1, W), "halo_top")
    _need(halo_bot, torch.int32, (smax, W), "halo_bot")
    if not (halo_top.device == halo_bot.device == dev) or band_first < 0 \
            or band_first + B > pic_h:
        raise ValueError(f"ref_buffers_band_multi: a {B}x{W} band at row "
                         f"{band_first} of {pic_h}, halos on "
                         f"{halo_top.device}, {halo_bot.device}")
    args, outs = K1Args(n=len(sizes)), []
    args.halo_top, args.halo_bot = halo_top.data_ptr(), halo_bot.data_ptr()
    args.band_first = band_first
    for j, s in enumerate(sizes):
        _k1_plane(band, s, bd, "ref_buffers_band_multi band")
        args.e[j], out = _k1_entry(band, s, bd, strong, B // s, W // s,
                                   min(B + s - 1, pic_h - 1 - band_first))
        outs.append(out)
    result = _k1_launch("ref_buffers_band", "hm_ref_buffers_band_multi", args,
                        outs, band)
    span and _trace.close(span)
    return result


def ref_buffers_band(band, halo_top, halo_bot, s, bd, strong, band_first,
                     pic_h):
    """K1's band mode on one size (halo_bot (s, W)): the one-entry launch."""
    return ref_buffers_band_multi(band, halo_top, halo_bot, [s], bd, strong,
                                  band_first, pic_h)[0]


# ---------------------------------------------------------------------------
# K2 / K3
# ---------------------------------------------------------------------------

def _need_blocks(bufs, blocks, s):
    n = bufs.shape[0]
    _need(bufs, torch.int32, (n, 2, 4 * s + 1), "bufs")
    _need(blocks, torch.int32, (n, s, s), "blocks")
    if s not in (4, 8, 16, 32) or n == 0:
        raise ValueError(f"bad block size {s} or empty batch")
    return n


def intra_size_rd(bufs, blocks, lam, s, bd, k, qp, is_luma, use_dst,
                  want_satd, inter=False):
    span = _trace.ON and _trace.open("kernel", key="intra_size_rd")
    n = _need_blocks(bufs, blocks, s)
    if not 3 <= k <= 4:
        raise ValueError(f"intra_size_rd: k={k} outside 3..4")
    dev = bufs.device
    tabs = _device_tables(dev)
    p = _tq_params(s, bd, qp, is_luma, inter)
    mode = torch.empty(n, dtype=torch.int32, device=dev)
    cost = torch.empty(n, dtype=torch.float32, device=dev)
    top3 = torch.empty((n, 3), dtype=torch.int32, device=dev)
    satd = torch.empty((n, 35), dtype=torch.int32, device=dev) \
        if want_satd else None
    _launch("intra_size_rd", "hm_intra_size_rd", _ptr(bufs), _ptr(blocks),
            n, ctypes.byref(p), _ptr(_tmat(tabs, s, use_dst)),
            _ptr(tabs["ang"]), _ptr(tabs["model"]), float(np.float32(lam)),
            k, int(bool(want_satd)), _ptr(mode), _ptr(cost), _ptr(top3),
            _ptr(satd), _stream(bufs))
    span and _trace.close(span)
    return mode, cost, top3, satd


def intra_premodes(bufs, blocks, s, bd):
    span = _trace.ON and _trace.open("kernel", key="intra_size_rd")
    n = _need_blocks(bufs, blocks, s)
    dev = bufs.device
    tabs = _device_tables(dev)
    p = _tq_params(s, bd, 0, True)
    mode = torch.empty(n, dtype=torch.int32, device=dev)
    _launch("intra_size_rd", "hm_intra_size_rd", _ptr(bufs), _ptr(blocks),
            n, ctypes.byref(p), _ptr(_tmat(tabs, s, False)),
            _ptr(tabs["ang"]), _ptr(tabs["model"]), 0.0, 0, 0, _ptr(mode),
            None, None, None, _stream(bufs))
    span and _trace.close(span)
    return mode


def intra_cand_rd(bufs, blocks, modes, s, bd, qp, is_luma, use_dst):
    span = _trace.ON and _trace.open("kernel", key="intra_cand_rd")
    n = _need_blocks(bufs, blocks, s)
    kk = modes.shape[1]
    _need(modes, torch.int32, (n, kk), "modes")
    dev = bufs.device
    tabs = _device_tables(dev)
    p = _tq_params(s, bd, qp, is_luma)
    dist = torch.empty((n, kk), dtype=torch.float32, device=dev)
    bits = torch.empty((n, kk), dtype=torch.float32, device=dev)
    _launch("intra_cand_rd", "hm_intra_cand_rd", _ptr(bufs), _ptr(blocks),
            _ptr(modes), n, kk, ctypes.byref(p),
            _ptr(_tmat(tabs, s, use_dst)), _ptr(tabs["ang"]),
            _ptr(tabs["model"]), _ptr(dist), _ptr(bits), _stream(bufs))
    span and _trace.close(span)
    return dist, bits


def analysis_step(orig, bufs, qp, s, bd):
    """K2's analysis mode over (..., N, s, s) blocks and their (..., N, 2,
    4s+1) buffers: (best mode, its SATD, levels (..., N, s, s), the int32
    total of the SATDs)."""
    span = _trace.ON and _trace.open("kernel", key="analysis_step")
    lead = tuple(orig.shape[:-2])
    n = int(np.prod(lead)) if lead else 1
    _need(orig, torch.int32, lead + (s, s), "orig")
    _need(bufs, torch.int32, lead + (2, 4 * s + 1), "bufs")
    if s not in (4, 8, 16, 32) or n == 0:
        raise ValueError(f"analysis_step: bad block size {s} or empty batch")
    dev = orig.device
    tabs = _device_tables(dev)
    p = _tq_params(s, bd, qp, True)
    best = torch.empty(lead, dtype=torch.int32, device=dev)
    cost = torch.empty(lead, dtype=torch.int32, device=dev)
    levels = torch.empty(lead + (s, s), dtype=torch.int32, device=dev)
    total = torch.zeros((), dtype=torch.int32, device=dev)
    _launch("analysis_step", "hm_analysis_step", _ptr(bufs), _ptr(orig), n,
            ctypes.byref(p), _ptr(_tmat(tabs, s, True)), _ptr(tabs["ang"]),
            _ptr(best), _ptr(cost), _ptr(levels), _ptr(total), _stream(orig))
    span and _trace.close(span)
    return best, cost, levels, total


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def plan_pre(dms, satd32, nby64, nbx64):
    """K4's first launch of an AI frame: the (n, 5) chroma candidates of
    each (n,) DM grid of `dms` (at most three) and, with satd32 (nby32,
    nbx32, 35), the (nby64, nbx64) 64x64 modes and their copy per TU32
    (else None, None)."""
    span = _trace.ON and _trace.open("kernel", key="plan_dp")
    from hm16_2_tpu_torch.encode.intra_rd import CHROMA_BASE_MODES
    if len(dms) > 3:
        raise ValueError("plan_pre: at most three chroma sizes")
    a = PlanPre(base=(_I * 4)(*CHROMA_BASE_MODES))
    lead, outs = None, []
    for k, dm in enumerate(dms):
        n = dm.shape[0]
        _need(dm, torch.int32, (n,), "dm")
        out = torch.empty((n, 5), dtype=torch.int32, device=dm.device)
        a.dm[k], a.n[k], a.modes5[k] = dm.data_ptr(), n, out.data_ptr()
        outs.append(out)
        lead = dm
    m64 = pm64 = None
    if satd32 is not None:
        nby32, nbx32 = satd32.shape[:2]
        _need(satd32, torch.int32, (nby32, nbx32, 35), "satd32")
        if 2 * nby64 > nby32 or 2 * nbx64 > nbx32:
            raise ValueError("plan_pre: 64x64 grid larger than the TU32 grid")
        dev = satd32.device
        m64 = torch.empty((nby64, nbx64), dtype=torch.int32, device=dev)
        pm64 = torch.empty(4 * nby64 * nbx64, dtype=torch.int32, device=dev)
        a.satd32, a.nbx32, a.nby64, a.nbx64 = satd32.data_ptr(), nbx32, \
            nby64, nbx64
        a.mode64, a.pm64 = m64.data_ptr(), pm64.data_ptr()
        lead = satd32
    if sum(a.n) + (m64.numel() if m64 is not None else 0):
        _launch("plan_dp", "hm_plan_pre", ctypes.byref(a), _stream(lead))
    span and _trace.close(span)
    return outs, m64, pm64


def plan_dp(lam, cw, h, w, mode_s, cost_s, cand_s, db_s, d64, b64,
            mode64_g):
    """K4's CTU launch of an AI frame: the chroma fold of the sizes in db_s
    ({s: (d_cb, b_cb, d_cr, b_cr) (n, 5) float32 from K3}), the 64x64 cost
    (d64, b64: K3 at the 64x64 level, or None), the quadtree DP and the
    packed (7, h/4, w/4) int8 plan."""
    span = _trace.ON and _trace.open("kernel", key="plan_dp")
    from hm16_2_tpu_torch.encode.intra_rd import CHROMA_MODE_BITS, \
        NXN_OVERHEAD_BITS, SPLIT_OVERHEAD_BITS
    dev = cost_s[4].device
    shape_s = {s: (h // s, w // s) for s in (4, 8, 16, 32, 64)}
    g = PlanCtu(lam=float(np.float32(lam)), cw=float(np.float32(cw)),
                nxn_bits=NXN_OVERHEAD_BITS, split_bits=SPLIT_OVERHEAD_BITS,
                bits64=8.0, mode_bits=(_F * 5)(*CHROMA_MODE_BITS))
    keep = []                     # tensors whose pointers the struct holds
    for l, s in enumerate((4, 8, 16, 32, 64)):
        g.nby[l], g.nbx[l] = shape_s[s]
        if s == 64:
            continue
        _need(cost_s[s], torch.float32, shape_s[s], f"cost{s}")
        _need(mode_s[s], torch.int32, shape_s[s], f"mode{s}")
        _need(cand_s[s], torch.int32, shape_s[s] + (3,), f"cand{s}")
        if cost_s[s].numel():
            keep += [cost_s[s], mode_s[s], cand_s[s]]
            g.cost[l], g.mode[l], g.cand[l] = (t.data_ptr() for t in (
                cost_s[s], mode_s[s], cand_s[s]))
    for l, s in enumerate((8, 16, 32)):
        if s not in db_s:
            continue
        n = shape_s[s][0] * shape_s[s][1]
        for k, (name, t) in enumerate(zip(("d_cb", "b_cb", "d_cr", "b_cr"),
                                          db_s[s])):
            _need(t, torch.float32, (n, 5), f"{name}{s}")
            keep.append(t)
            g.chroma[l][k] = t.data_ptr() if n else None
    if d64 is not None:
        n64 = shape_s[64][0] * shape_s[64][1]
        _need(d64, torch.float32, (4 * n64,), "d64")
        _need(b64, torch.float32, (4 * n64,), "b64")
        _need(mode64_g, torch.int32, shape_s[64], "mode64")
        if n64:
            keep += [d64, b64, mode64_g]
            g.d64, g.b64, g.mode[4] = d64.data_ptr(), b64.data_ptr(), \
                mode64_g.data_ptr()
    out = torch.empty((7, h // 4, w // 4), dtype=torch.int8, device=dev)
    _launch("plan_dp", "hm_plan_ctu", ctypes.byref(g), _ptr(out),
            _stream(cost_s[4]))
    span and _trace.close(span)
    return out


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

_ME_BINS, _ME_LOG = 0, 1          # K5's bit models (csrc/inter_me.cu)


def _me_band(kernel, h, row0, full_h):
    """K5's launch count of a call: `kernel`, or `kernel`_band when the
    current picture is a row band (rows row0.. of a full_h-row picture)."""
    full_h = h if full_h is None else full_h
    if row0 % 4 or row0 < 0 or row0 + h > full_h:
        raise ValueError(f"K5: band of {h} rows at row {row0} of {full_h}")
    return (kernel if full_h == h else kernel + "_band"), full_h


def _me_grids(kernel, cur, refs, mvp8, h, w, row0, full_h):
    """K5's shared front: the float32 coarse grids (R, 1089, h/s, w/s) of
    the squares s = 8..64 of the band cur (rows row0.. of the picture)
    against the whole (R, full_h, w) references, launches counted under
    `kernel`."""
    R = refs.shape[0]
    _need(cur, torch.int32, (h, w), "cur")
    _need(refs, torch.int32, (R, full_h, w), "refs")
    _need(mvp8, torch.int32, (R, h // 8, w // 8, 2), "mvp8")
    dev = cur.device
    st = _stream(cur)
    hc, wc, fhc = h // 4, w // 4, full_h // 4
    n8y, n8x = h // 8, w // 8
    if not (R and n8y and n8x):
        raise ValueError(f"{kernel}: no 8x8 block in {h}x{w} or no reference")
    cd = torch.empty((hc, wc), dtype=torch.int32, device=dev)
    rd = torch.empty((R, fhc, wc), dtype=torch.int32, device=dev)
    _launch(kernel, "hm_me_down", _ptr(cur), 1, h, w, hc, wc, _ptr(cd), st)
    _launch(kernel, "hm_me_down", _ptr(refs), R, full_h, w, fhc, wc, _ptr(rd),
            st)
    O = 33 * 33
    grids = {8: torch.empty((R, O, n8y, n8x), dtype=torch.float32,
                            device=dev)}
    _launch(kernel, "hm_me_coarse8", _ptr(cd), _ptr(rd), R, hc, wc, fhc,
            row0 // 4, n8y, n8x, _ptr(grids[8]), st)
    for s in (16, 32, 64):
        ny, nx = h // s, w // s
        p = grids[s // 2]
        grids[s] = torch.empty((R, O, ny, nx), dtype=torch.float32, device=dev)
        if ny and nx:
            _launch(kernel, "hm_me_quad", _ptr(p), R * O, p.shape[2],
                    p.shape[3], ny, nx, _ptr(grids[s]), st)
    return grids


def inter_me(cur, refs, mvp8, lams, h, w, parts, row0=0, full_h=None):
    from hm16_2_tpu_torch.encode.inter_plan import _me_mvp, _shapes
    R = refs.shape[0]
    kernel, full_h = _me_band("inter_me", h, row0, full_h)
    span = _trace.ON and _trace.open("kernel", key=kernel)
    grids = _me_grids(kernel, cur, refs, mvp8, h, w, row0, full_h)
    dev, st, lam = cur.device, _stream(cur), float(np.float32(lams))
    out = {}
    for s, part, bh, bw, Ny, Nx in _shapes(h, w, parts):
        g = grids[s] if part == 0 else grids[s // 2]
        mvp = _me_mvp(mvp8, s, part)[:, :Ny, :Nx].contiguous()
        coarse = torch.empty((R, Ny * Nx, 2), dtype=torch.int32, device=dev)
        _launch(kernel, "hm_me_argmin", _ptr(g), g.shape[2], g.shape[3],
                part, R, Ny, Nx, _ptr(mvp), lam, _ME_BINS, _ptr(coarse), st)
        mv = torch.empty((R, Ny, Nx, 2), dtype=torch.int32, device=dev)
        _launch(kernel, "hm_me_refine", _ptr(cur), w, _ptr(refs), row0,
                full_h, R, bh, bw, Ny, Nx, _ptr(coarse), _ptr(mvp), lam,
                _ME_BINS, _ptr(mv), None, st)
        out[(s, part)] = mv
    span and _trace.close(span)
    return out


def me_frame(cur, refs, mvp8, lam, h, w, row0=0, full_h=None):
    """K5 in me_frame's mode: {s: (mv (R, N, 2) int32 full-pel (dy, dx),
    cost (R, N) float32)} for the squares s = 8..64 that fit in h x w; cur
    may be the band of rows row0.. of a full_h-row picture."""
    R = refs.shape[0]
    kernel, full_h = _me_band("me_frame", h, row0, full_h)
    span = _trace.ON and _trace.open("kernel", key=kernel)
    grids = _me_grids(kernel, cur, refs, mvp8, h, w, row0, full_h)
    dev, st, lamf = cur.device, _stream(cur), float(np.float32(lam))
    out = {}
    for s in (8, 16, 32, 64):
        ny, nx = h // s, w // s
        if not (ny and nx):
            continue
        g = grids[s]
        mvp = mvp8[:, ::s // 8, ::s // 8][:, :ny, :nx].contiguous()
        coarse = torch.empty((R, ny * nx, 2), dtype=torch.int32, device=dev)
        _launch(kernel, "hm_me_argmin", _ptr(g), ny, nx, 0, R, ny, nx,
                _ptr(mvp), lamf, _ME_LOG, _ptr(coarse), st)
        mv = torch.empty((R, ny * nx, 2), dtype=torch.int32, device=dev)
        cost = torch.empty((R, ny * nx), dtype=torch.float32, device=dev)
        _launch(kernel, "hm_me_refine", _ptr(cur), w, _ptr(refs), row0,
                full_h, R, s, s, ny, nx, _ptr(coarse), _ptr(mvp), lamf,
                _ME_LOG, _ptr(mv), _ptr(cost), st)
        out[s] = (mv, cost)
    span and _trace.close(span)
    return out


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def subpel_planes(refs, bd, h, w):
    span = _trace.ON and _trace.open("kernel", key="subpel_planes")
    from hm16_2_tpu_torch.encode.inter_plan import MARGIN
    R = refs.shape[0]
    _need(refs, torch.int32, (R, h, w), "refs")
    if not 8 <= bd <= 12:
        raise ValueError(f"subpel_planes: bit depth {bd} outside 8..12")
    out = torch.empty((R, 16, h + 2 * MARGIN + 1, w + 2 * MARGIN + 1),
                      dtype=torch.int16, device=refs.device)
    _launch("subpel_planes", "hm_subpel_planes", _ptr(refs), R, h, w, bd,
            _ptr(out), _stream(refs))
    span and _trace.close(span)
    return out


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def _frac_refine(kernel, sub, cur, mv, qstart, pred4, lams, bh, bw,
                 uref=None, other=None):
    """mv / pred4: (Rb, Ny, Nx, 2); with uref (N,) the block's reference is
    uref[n] for every batch entry, else the entry's index; other: (o_uref
    (N,), o_mv4 (N, 2)), the hypothesis of the bi target."""
    R, Hp, Wp = sub.shape[0], sub.shape[2], sub.shape[3]
    Rb, Ny, Nx = mv.shape[:3]
    h, w = cur.shape
    _need(sub, torch.int16, (R, 16, Hp, Wp), "sub")
    _need(cur, torch.int32, name="cur")
    _need(mv, torch.int32, (Rb, Ny, Nx, 2), "mv")
    _need(pred4, torch.int32, (Rb, Ny, Nx, 2), "pred4")
    N = Ny * Nx
    if uref is not None:
        _need(uref, torch.int32, (N,), "uref")
    elif Rb != R:
        raise ValueError("frac_refine: one batch entry per reference")
    o_uref = o_mv4 = None
    if other is not None:
        o_uref, o_mv4 = other
        _need(o_uref, torch.int32, (N,), "o_uref")
        _need(o_mv4, torch.int32, (N, 2), "o_mv4")
    if bh % 8 or bw % 8 or Ny * bh > h or Nx * bw > w:
        raise ValueError(f"frac_refine: bad block {bh}x{bw}")
    dev = sub.device
    mv4 = torch.empty((Rb, N, 2), dtype=torch.int32, device=dev)
    satd = torch.empty((Rb, N), dtype=torch.float32, device=dev)
    _launch(kernel, "hm_frac_refine", _ptr(sub), Hp, Wp, _ptr(cur), w, bh,
            bw, Ny, Nx, Rb, _ptr(mv), int(qstart), _ptr(pred4), _ptr(uref),
            _ptr(o_uref), _ptr(o_mv4), float(np.float32(lams)), _ptr(mv4),
            _ptr(satd), _stream(sub))
    return mv4, satd


def frac_refine(sub, cur, mv_int, pred4, lams, bh, bw):
    span = _trace.ON and _trace.open("kernel", key="inter_uni")
    result = _frac_refine("inter_uni", sub, cur, mv_int, False, pred4, lams,
                          bh, bw)
    span and _trace.close(span)
    return result


def frac_refine_any(sub, cur, mv4, uref, anchor4, o_uref, o_mv4, lams, s):
    span = _trace.ON and _trace.open("kernel", key="inter_bi_refine")
    h, w = cur.shape
    ny, nx = h // s, w // s
    _need(mv4, torch.int32, (ny * nx, 2), "mv4")
    _need(anchor4, torch.int32, (ny * nx, 2), "anchor4")
    out, satd = _frac_refine("inter_bi_refine", sub, cur,
                             mv4.reshape(1, ny, nx, 2), True,
                             anchor4.reshape(1, ny, nx, 2), lams, s, s,
                             uref=uref, other=(o_uref, o_mv4))
    span and _trace.close(span)
    return out[0], satd[0]


def uni_select_all(entries, lams):
    """K7's list picks of every entry (mvq (R, N, 2), satd (R, N), pred4
    (R, N, 2), lmap (mr,), nref) of a picture in one launch: one dict per
    entry, whose tensors are views of two arenas."""
    span = _trace.ON and _trace.open("kernel", key="inter_pick")
    if not 0 < len(entries) <= MAX_PICK:
        raise ValueError(f"uni_select_all: {len(entries)} entries, not "
                         f"1..{MAX_PICK}")
    lead = entries[0][1]
    a = PickArgs(n=len(entries), lam=float(np.float32(lams)))
    checked, sizes, off = set(), [], 0       # the lists share a shape's
    for k, (mvq, satd, pred4, lmap, nref) in enumerate(entries):  # tensors
        R, N = satd.shape
        mr = lmap.shape[0]
        key = (id(mvq), id(satd), id(pred4), id(lmap))
        if key not in checked:
            _need(mvq, torch.int32, (R, N, 2), "mvq")
            _need(satd, torch.float32, (R, N), "satd")
            _need(pred4, torch.int32, (R, N, 2), "pred4")
            _need(lmap, torch.int32, (mr,), "lmap")
            if not (mvq.device == satd.device == pred4.device ==
                    lmap.device == lead.device):
                raise ValueError("uni_select_all: entries on different "
                                 "devices")
            if mvq.data_ptr() % 8 or pred4.data_ptr() % 8:
                raise ValueError("uni_select_all: mvq and pred4 are read as "
                                 "8-byte pairs and must be 8-byte aligned")
            checked.add(key)
        a.e[k] = PickEntry(mvq.data_ptr(), satd.data_ptr(), pred4.data_ptr(),
                           lmap.data_ptr(), mr, int(nref), N, off)
        sizes.append(N)
        off += N
    iout = torch.empty(6 * off, dtype=torch.int32, device=lead.device)
    fout = torch.empty(3 * off, dtype=torch.float32, device=lead.device)
    a.total, a.iout, a.fout = off, iout.data_ptr(), fout.data_ptr()
    _launch("inter_pick", "hm_uni_select_all", ctypes.byref(a), _stream(lead))
    two = [n for N in sizes for n in (N, N)]
    ints = iout[:2 * off].split(two)
    pairs = iout[2 * off:].view(2 * off, 2).split(two)
    floats = fout.split([n for N in sizes for n in (N, N, N)])
    result = [{"ridx": ints[2 * k], "uref": ints[2 * k + 1],
               "mv": pairs[2 * k], "anchor": pairs[2 * k + 1],
               "satd": floats[3 * k], "bits": floats[3 * k + 1],
               "cost": floats[3 * k + 2]} for k in range(len(sizes))]
    span and _trace.close(span)
    return result


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

def _uni_res(e, n):
    for k, dt, sh in (("mv", torch.int32, (n, 2)), ("uref", torch.int32, (n,)),
                      ("ridx", torch.int32, (n,)),
                      ("bits", torch.float32, (n,)),
                      ("cost", torch.float32, (n,))):
        _need(e[k], dt, sh, k)
    return UniRes(*[e[k].data_ptr() for k in ("mv", "uref", "ridx", "bits",
                                              "cost")])


def _cu_rd_args(cur, sub, s, uni, tmvp4, ref0, rect, intra, lamf, lams, qp,
                bd, nmerge):
    """CuRdArgs of list 0, the rect shapes and the intra alternative."""
    h, w = cur.shape
    ny, nx = h // s, w // s
    N = ny * nx
    R, Hp, Wp = sub.shape[0], sub.shape[2], sub.shape[3]
    _need(cur, torch.int32, name="cur")
    _need(sub, torch.int16, (R, 16, Hp, Wp), "sub")
    _need(tmvp4, torch.int32, (N, 2), "tmvp4")
    if s not in (8, 16, 32, 64) or N == 0:
        raise ValueError(f"cu_rd: bad CU size {s} for {h}x{w}")
    t = min(s, 32)
    tabs = _device_tables(cur.device)
    a = CuRdArgs(cur=cur.data_ptr(), h=h, w=w, sub=sub.data_ptr(), Hp=Hp,
                 Wp=Wp, nx=nx, uni=_uni_res(uni, N), tmvp4=tmvp4.data_ptr(),
                 ref0=int(ref0), lamf=float(np.float32(lamf)),
                 lams=float(np.float32(lams)), nmerge=int(nmerge),
                 tq=_tq_params(t, bd, qp, True, inter=True),
                 tm=tabs["dct"][t].data_ptr(), model=tabs["model"].data_ptr())
    if rect is not None:
        a.has_rect = 1
        a.rect[0] = _uni_res(rect[1], 2 * N)
        a.rect[1] = _uni_res(rect[2], 2 * N)
    if intra is not None:
        m, c, c3 = intra
        _need(m, torch.int32, (N,), "imode")
        _need(c, torch.float32, (N,), "icost")
        _need(c3, torch.int32, (N, 3), "itop3")
        a.has_intra = 1
        a.i_mode, a.i_cost, a.i_top3 = m.data_ptr(), c.data_ptr(), \
            c3.data_ptr()
    return a, N


def _cu_rd_launch(kernel, a, cur, s, N, is_b):
    from hm16_2_tpu_torch.encode.inter_plan import NREC
    rec = torch.empty((N, NREC), dtype=torch.int32, device=cur.device)
    cost = torch.empty((N,), dtype=torch.float32, device=cur.device)
    a.rec, a.cost = rec.data_ptr(), cost.data_ptr()
    _launch(kernel, "hm_cu_rd", ctypes.byref(a), s, N, int(is_b),
            _stream(cur))
    return rec, cost


def cu_rd(cur, sub, s, uni, tmvp4, ref0, rect, intra, lamf, lams, qp, bd,
          nmerge):
    span = _trace.ON and _trace.open("kernel", key="inter_cu_rd")
    a, N = _cu_rd_args(cur, sub, s, uni, tmvp4, ref0, rect, intra, lamf,
                       lams, qp, bd, nmerge)
    result = _cu_rd_launch("inter_cu_rd", a, cur, s, N, False)
    span and _trace.close(span)
    return result


def cu_rd_b(cur, sub, s, uni, tmvp4, first, nref, mvb, rect, intra, lamf,
            lams, qp, bd, nmerge):
    span = _trace.ON and _trace.open("kernel", key="inter_cu_rd_b")
    a, N = _cu_rd_args(cur, sub, s, uni[0], tmvp4[0], first[0],
                       None if rect is None else {p: e[0] for p, e in
                                                  rect.items()},
                       intra, lamf, lams, qp, bd, nmerge)
    _need(tmvp4[1], torch.int32, (N, 2), "tmvp4_1")
    for name, t in (("anchor0", uni[0]["anchor"]),
                    ("anchor1", uni[1]["anchor"]), ("mvb0", mvb[0]),
                    ("mvb1", mvb[1])):
        _need(t, torch.int32, (N, 2), name)
    a.uni1 = _uni_res(uni[1], N)
    a.tmvp4_1, a.ref1 = tmvp4[1].data_ptr(), int(first[1])
    if rect is not None:
        a.rect1[0] = _uni_res(rect[1][1], 2 * N)
        a.rect1[1] = _uni_res(rect[2][1], 2 * N)
    a.anchor0, a.anchor1 = uni[0]["anchor"].data_ptr(), \
        uni[1]["anchor"].data_ptr()
    a.mvb0, a.mvb1 = mvb[0].data_ptr(), mvb[1].data_ptr()
    a.nref0, a.nref1 = int(nref[0]), int(nref[1])
    result = _cu_rd_launch("inter_cu_rd_b", a, cur, s, N, True)
    span and _trace.close(span)
    return result


# ---------------------------------------------------------------------------
# K4, P-picture plan
# ---------------------------------------------------------------------------

def emit_inter_plan(recs, costs, lamf, h, w):
    span = _trace.ON and _trace.open("kernel", key="plan_dp")
    from hm16_2_tpu_torch.encode.inter_plan import NREC, PLAN_CHANNELS, \
        SIZES, SPLIT_BITS
    lead = next(c for c in costs.values() if c is not None)
    g = InterCtu(h4=h // 4, w4=w // 4, lam=float(np.float32(lamf)),
                 split_bits=SPLIT_BITS)
    for i, s in enumerate(SIZES):
        g.ny[i], g.nx[i] = h // s, w // s
        if costs[s] is not None:
            n = g.ny[i] * g.nx[i]
            _need(costs[s], torch.float32, (n,), f"cost{s}")
            _need(recs[s], torch.int32, (n, NREC), f"rec{s}")
            g.cost[i], g.rec[i] = costs[s].data_ptr(), recs[s].data_ptr()
    out = torch.empty((PLAN_CHANNELS, h // 4, w // 4), dtype=torch.int16,
                      device=lead.device)
    _launch("plan_dp", "hm_emit_inter_plan", ctypes.byref(g), _ptr(out),
            _stream(lead))
    span and _trace.close(span)
    return out

"""The port's hand-written CUDA kernels: build, bindings and launch counts.

Sources live in `csrc/`; they are compiled at first use by `nvcc` for
Hopper (`sm_90a`) into one shared library with a plain C interface, cached
in `_build/` under a hash of the sources and flags, and bound with ctypes.
Every launch goes on PyTorch's current stream and allocates nothing itself:
the functions here allocate outputs with torch, check device, dtype, shape
and contiguity, launch, and raise if `cudaGetLastError()` is not 0.

    K1 ref_buffers    csrc/ref_buffers.cu
    K2 intra_size_rd  csrc/intra_rd.cu   (also SATD-only for _premodes, and
                                          the P plan's intra alternative)
    K3 intra_cand_rd  csrc/intra_rd.cu
    K4 plan_dp        csrc/plan_dp.cu    (chroma fold, 64x64 level, DP,
                                          emission of both plans)
    K5 inter_me       csrc/inter_me.cu   (downsample, coarse grid, pyramid,
                                          argmin, refinement)
    K6 subpel_planes  csrc/subpel.cu
    K7 inter_uni      csrc/inter_rd.cu   (q-pel refinement, list pick)
       inter_bi_refine                   (K7's per-block-reference mode:
                                          the B plan's bi refinement)
    K8 inter_cu_rd    csrc/inter_rd.cu   (P pictures)
       inter_cu_rd_b                     (K8's B mode)

`LAUNCHES` counts kernel launches per kernel (and per mode of K7 and K8);
the counts grow only where a kernel is launched.  Nothing here runs at
import: `nvcc` is looked up and run on the first launch (or an explicit
`build()`).  Loading the library checks that every argument struct's ctypes
mirror has the C struct's size.
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

from hm16_2_tpu.common.tables import ANG_TABLE, DCT, DST4, INV_ANG_TABLE, \
    INV_QUANT_SCALES, QUANT_SCALES
from hm16_2_tpu.ops.intra_ref import should_filter

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
_BUILD = os.path.join(_DIR, "_build")
_SOURCES = ("ref_buffers.cu", "intra_rd.cu", "plan_dp.cu", "inter_me.cu",
            "subpel.cu", "inter_rd.cu")
_HEADERS = ("intra_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

LAUNCHES = {"ref_buffers": 0, "intra_size_rd": 0, "intra_cand_rd": 0,
            "plan_dp": 0, "inter_me": 0, "subpel_planes": 0, "inter_uni": 0,
            "inter_bi_refine": 0, "inter_cu_rd": 0, "inter_cu_rd_b": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class TqParams(ctypes.Structure):
    """hm::TqParams (csrc/intra_common.cuh)."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "s", "log2", "bd", "maxv", "edge", "fwd_s1", "fwd_s2", "q_scale",
        "q_bits", "q_add", "dq_scale", "dq_shift", "dq_min", "dq_max",
        "inv_s2")] + [("filt", ctypes.c_ulonglong)]


class PlanGrids(ctypes.Structure):
    """hm::PlanGrids (csrc/plan_dp.cu)."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "h4", "w4", "nby4", "nbx4", "nby8", "nbx8", "nby16", "nbx16",
        "nby32", "nbx32", "nby64", "nbx64")] + [(n, ctypes.c_void_p) for n in (
            "c64", "split32", "split16", "nxn", "mode4", "mode8", "mode16",
            "mode32", "mode64", "cand4", "cand8", "cand16", "cand32",
            "cmode8", "cmode16", "cmode32")]


class InterGrids(ctypes.Structure):
    """hm::InterGrids (csrc/plan_dp.cu)."""
    _fields_ = [("h4", ctypes.c_int), ("w4", ctypes.c_int),
                ("ny", ctypes.c_int * 4), ("nx", ctypes.c_int * 4),
                ("split16", ctypes.c_void_p), ("split32", ctypes.c_void_p),
                ("split64", ctypes.c_void_p), ("rec", ctypes.c_void_p * 4)]


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
_STRUCTS = {"hm_sizeof_tq_params": TqParams,
            "hm_sizeof_plan_grids": PlanGrids,
            "hm_sizeof_inter_grids": InterGrids,
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
    compiling)."""
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
    errs = []
    for pr in procs:
        o, e = pr.communicate()
        if pr.returncode != 0:
            errs.append(o + e)
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


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build()[0])
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "hm_ref_buffers": [P, I, I, I, I, I, I, I, P, P, P],
        "hm_intra_size_rd": [P, P, I, ctypes.POINTER(TqParams), P, P, P, F,
                             I, I, P, P, P, P, P],
        "hm_intra_cand_rd": [P, P, P, I, I, ctypes.POINTER(TqParams), P, P,
                             P, P, P, P],
        "hm_chroma_modes5": [P, I, I, I, I, I, P, P],
        "hm_chroma_fold": [P, P, P, P, P, P, I, F, F, P, P, P, P],
        "hm_mode64": [P, I, I, I, P, P, P],
        "hm_cost64": [P, P, P, I, I, I, F, F, P, P],
        "hm_dp_level": [P, I, P, I, I, F, F, I, P, P, P],
        "hm_emit_plan": [ctypes.POINTER(PlanGrids), P, P],
        "hm_emit_inter_plan": [ctypes.POINTER(InterGrids), P, P],
        "hm_me_down": [P, I, I, I, I, I, P, P],
        "hm_me_coarse8": [P, P, I, I, I, I, I, P, P],
        "hm_me_quad": [P, ctypes.c_longlong, I, I, I, I, P, P],
        "hm_me_argmin": [P, I, I, I, I, I, I, P, F, P, P],
        "hm_me_refine": [P, I, I, P, I, I, I, I, I, P, P, F, P, P],
        "hm_subpel_planes": [P, I, I, I, I, P, P],
        "hm_frac_refine": [P, I, I, P, I, I, I, I, I, I, P, I, P, P, P, P, F,
                           P, P, P],
        "hm_uni_select": [P, P, P, P, I, I, I, F, P, P, P, P, P, P, P, P],
        "hm_cu_rd": [ctypes.POINTER(CuRdArgs), I, I, I, P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.hm_error_string.argtypes = [ctypes.c_int]
    lib.hm_error_string.restype = ctypes.c_char_p
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
            "chroma_bits": torch.as_tensor(
                np.asarray(R.CHROMA_MODE_BITS, np.float32), device=device),
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

def ref_buffers(plane, s, bd, strong, h, w):
    ph, pw = plane.shape
    _need(plane, torch.int32, name="plane")
    nby, nbx = h // s, w // s
    if s not in (4, 8, 16, 32) or nby * s > ph or nbx * s > pw:
        raise ValueError(f"ref_buffers: bad size s={s} for {h}x{w} in a "
                         f"{ph}x{pw} plane")
    n = nby * nbx
    bufs = torch.empty((n, 2, 4 * s + 1), dtype=torch.int32,
                       device=plane.device)
    blocks = torch.empty((n, s, s), dtype=torch.int32, device=plane.device)
    if n:
        _launch("ref_buffers", "hm_ref_buffers", _ptr(plane), ph, pw, s, bd,
                int(bool(strong)), nby, nbx, _ptr(bufs), _ptr(blocks),
                _stream(plane))
    return bufs, blocks


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
    return mode, cost, top3, satd


def intra_premodes(bufs, blocks, s, bd):
    n = _need_blocks(bufs, blocks, s)
    dev = bufs.device
    tabs = _device_tables(dev)
    p = _tq_params(s, bd, 0, True)
    mode = torch.empty(n, dtype=torch.int32, device=dev)
    _launch("intra_size_rd", "hm_intra_size_rd", _ptr(bufs), _ptr(blocks),
            n, ctypes.byref(p), _ptr(_tmat(tabs, s, False)),
            _ptr(tabs["ang"]), _ptr(tabs["model"]), 0.0, 0, 0, _ptr(mode),
            None, None, None, _stream(bufs))
    return mode


def intra_cand_rd(bufs, blocks, modes, s, bd, qp, is_luma, use_dst):
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
    return dist, bits


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def chroma_modes5(dm):
    from hm16_2_tpu_torch.encode.intra_rd import CHROMA_BASE_MODES
    n = dm.shape[0]
    _need(dm, torch.int32, (n,), "dm")
    out = torch.empty((n, 5), dtype=torch.int32, device=dm.device)
    _launch("plan_dp", "hm_chroma_modes5", _ptr(dm), n, *CHROMA_BASE_MODES,
            _ptr(out), _stream(dm))
    return out


def chroma_fold(d_cb, b_cb, d_cr, b_cr, cost, lam, cw):
    n = cost.numel()
    _need(cost, torch.float32, name="cost")
    for name, t in (("d_cb", d_cb), ("b_cb", b_cb), ("d_cr", d_cr),
                    ("b_cr", b_cr)):
        _need(t, torch.float32, (n, 5), name)
    tabs = _device_tables(cost.device)
    cost_out = torch.empty_like(cost)
    add = torch.empty_like(cost)
    cmode = torch.empty(cost.shape, dtype=torch.int32, device=cost.device)
    _launch("plan_dp", "hm_chroma_fold", _ptr(d_cb), _ptr(b_cb), _ptr(d_cr),
            _ptr(b_cr), _ptr(cost), _ptr(tabs["chroma_bits"]), n,
            float(np.float32(lam)), float(np.float32(cw)), _ptr(cost_out),
            _ptr(add), _ptr(cmode), _stream(cost))
    return cost_out, add, cmode


def mode64(satd32, nby64, nbx64):
    nby32, nbx32 = satd32.shape[:2]
    _need(satd32, torch.int32, (nby32, nbx32, 35), "satd32")
    if 2 * nby64 > nby32 or 2 * nbx64 > nbx32:
        raise ValueError("mode64: 64x64 grid larger than the TU32 grid")
    dev = satd32.device
    m64 = torch.empty((nby64, nbx64), dtype=torch.int32, device=dev)
    pm64 = torch.empty(4 * nby64 * nbx64, dtype=torch.int32, device=dev)
    _launch("plan_dp", "hm_mode64", _ptr(satd32), nbx32, nby64, nbx64,
            _ptr(m64), _ptr(pm64), _stream(satd32))
    return m64, pm64


def plan_dp(lam, h, w, mode_s, cost_s, cand_s, cmode_s, chroma_add32, d64,
            b64, mode64_g):
    from hm16_2_tpu_torch.encode.intra_rd import NXN_OVERHEAD_BITS, \
        SPLIT_OVERHEAD_BITS
    dev = cost_s[4].device
    lamf = float(np.float32(lam))
    shape_s = {s: (h // s, w // s) for s in (4, 8, 16, 32, 64)}
    for s in (4, 8, 16, 32):
        _need(cost_s[s], torch.float32, shape_s[s], f"cost{s}")
        _need(mode_s[s], torch.int32, shape_s[s], f"mode{s}")
        _need(cand_s[s], torch.int32, shape_s[s] + (3,), f"cand{s}")
    st = _stream(cost_s[4])
    nby64, nbx64 = shape_s[64]
    nby32, nbx32 = shape_s[32]
    u8 = lambda hh, ww: torch.empty((hh, ww), dtype=torch.uint8, device=dev)

    cost64 = None
    if d64 is not None:
        _need(d64, torch.float32, (4 * nby64 * nbx64,), "d64")
        _need(b64, torch.float32, (4 * nby64 * nbx64,), "b64")
        if chroma_add32 is not None:
            _need(chroma_add32, torch.float32, shape_s[32], "chroma_add32")
        cost64 = torch.empty((nby64, nbx64), dtype=torch.float32, device=dev)
        _launch("plan_dp", "hm_cost64", _ptr(d64), _ptr(b64),
                _ptr(chroma_add32), nbx32, nby64, nbx64, lamf, 8.0,
                _ptr(cost64), st)

    def level(child, parent, ovh):
        hp, wp = parent.shape
        flag = u8(hp, wp)
        out = torch.empty_like(parent)
        _launch("plan_dp", "hm_dp_level", _ptr(child), child.shape[1],
                _ptr(parent), hp, wp, lamf, ovh, 0, _ptr(flag), _ptr(out),
                st)
        return flag, out

    nxn = split16 = split32 = c64 = None
    cu8 = cost_s[8]
    if shape_s[8][0] and cost_s[4].numel() and cu8.numel():
        nxn, cu8 = level(cost_s[4], cu8, NXN_OVERHEAD_BITS)
    cu16 = cost_s[16]
    if shape_s[16][0] and cu8.numel() and cu16.numel():
        split16, cu16 = level(cu8, cu16, SPLIT_OVERHEAD_BITS)
    cu32 = cost_s[32]
    if nby32 and cu16.numel() and cu32.numel():
        split32, cu32 = level(cu16, cu32, SPLIT_OVERHEAD_BITS)
    if cost64 is not None:
        c64 = u8(nby64, nbx64)
        _launch("plan_dp", "hm_dp_level", _ptr(cu32), nbx32, _ptr(cost64),
                nby64, nbx64, lamf, SPLIT_OVERHEAD_BITS, 1, _ptr(c64), None,
                st)

    h4, w4 = h // 4, w // 4
    g = PlanGrids(h4=h4, w4=w4)
    for s in (4, 8, 16, 32, 64):
        setattr(g, f"nby{s}", shape_s[s][0])
        setattr(g, f"nbx{s}", shape_s[s][1])
    keep = []                     # tensors whose pointers the struct holds

    def put(field, t):
        if t is not None and t.numel():
            keep.append(t)
            setattr(g, field, t.data_ptr())

    put("c64", c64)
    put("split32", split32)
    put("split16", split16)
    put("nxn", nxn)
    for s in (4, 8, 16, 32):
        put(f"mode{s}", mode_s[s])
        put(f"cand{s}", cand_s[s])
    if cost64 is not None:
        _need(mode64_g, torch.int32, (nby64, nbx64), "mode64")
        put("mode64", mode64_g)
    for s in (8, 16, 32):
        if s in cmode_s:
            _need(cmode_s[s], torch.int32, shape_s[s], f"cmode{s}")
            put(f"cmode{s}", cmode_s[s])
    out = torch.empty((7, h4, w4), dtype=torch.int8, device=dev)
    _launch("plan_dp", "hm_emit_plan", ctypes.byref(g), _ptr(out), st)
    return out


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def inter_me(cur, refs, mvp8, lams, h, w, parts):
    from hm16_2_tpu_torch.encode.inter_plan import _me_mvp, _shapes
    R = refs.shape[0]
    _need(cur, torch.int32, (h, w), "cur")
    _need(refs, torch.int32, (R, h, w), "refs")
    _need(mvp8, torch.int32, (R, h // 8, w // 8, 2), "mvp8")
    dev = cur.device
    st = _stream(cur)
    lam = float(np.float32(lams))
    hc, wc = h // 4, w // 4
    n8y, n8x = h // 8, w // 8
    if not (R and n8y and n8x):
        raise ValueError(f"inter_me: no 8x8 block in {h}x{w} or no reference")
    cd = torch.empty((hc, wc), dtype=torch.int32, device=dev)
    rd = torch.empty((R, hc, wc), dtype=torch.int32, device=dev)
    _launch("inter_me", "hm_me_down", _ptr(cur), 1, h, w, hc, wc, _ptr(cd),
            st)
    _launch("inter_me", "hm_me_down", _ptr(refs), R, h, w, hc, wc, _ptr(rd),
            st)
    O = 33 * 33
    grids = {8: torch.empty((R, O, n8y, n8x), dtype=torch.float32,
                            device=dev)}
    _launch("inter_me", "hm_me_coarse8", _ptr(cd), _ptr(rd), R, hc, wc, n8y,
            n8x, _ptr(grids[8]), st)
    for s in (16, 32, 64):
        ny, nx = h // s, w // s
        p = grids[s // 2]
        grids[s] = torch.empty((R, O, ny, nx), dtype=torch.float32, device=dev)
        if ny and nx:
            _launch("inter_me", "hm_me_quad", _ptr(p), R * O, p.shape[2],
                    p.shape[3], ny, nx, _ptr(grids[s]), st)
    out = {}
    for s, part, bh, bw, Ny, Nx in _shapes(h, w, parts):
        g = grids[s] if part == 0 else grids[s // 2]
        mvp = _me_mvp(mvp8, s, part)[:, :Ny, :Nx].contiguous()
        coarse = torch.empty((R, Ny * Nx, 2), dtype=torch.int32, device=dev)
        _launch("inter_me", "hm_me_argmin", _ptr(g), g.shape[2], g.shape[3],
                part, R, Ny, Nx, _ptr(mvp), lam, _ptr(coarse), st)
        mv = torch.empty((R, Ny, Nx, 2), dtype=torch.int32, device=dev)
        _launch("inter_me", "hm_me_refine", _ptr(cur), h, w, _ptr(refs), R,
                bh, bw, Ny, Nx, _ptr(coarse), _ptr(mvp), lam, _ptr(mv), st)
        out[(s, part)] = mv
    return out


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def subpel_planes(refs, bd, h, w):
    from hm16_2_tpu_torch.encode.inter_plan import MARGIN
    R = refs.shape[0]
    _need(refs, torch.int32, (R, h, w), "refs")
    if not 8 <= bd <= 12:
        raise ValueError(f"subpel_planes: bit depth {bd} outside 8..12")
    out = torch.empty((R, 16, h + 2 * MARGIN + 1, w + 2 * MARGIN + 1),
                      dtype=torch.int16, device=refs.device)
    _launch("subpel_planes", "hm_subpel_planes", _ptr(refs), R, h, w, bd,
            _ptr(out), _stream(refs))
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
    return _frac_refine("inter_uni", sub, cur, mv_int, False, pred4, lams, bh,
                        bw)


def frac_refine_any(sub, cur, mv4, uref, anchor4, o_uref, o_mv4, lams, s):
    h, w = cur.shape
    ny, nx = h // s, w // s
    _need(mv4, torch.int32, (ny * nx, 2), "mv4")
    _need(anchor4, torch.int32, (ny * nx, 2), "anchor4")
    out, satd = _frac_refine("inter_bi_refine", sub, cur,
                             mv4.reshape(1, ny, nx, 2), True,
                             anchor4.reshape(1, ny, nx, 2), lams, s, s,
                             uref=uref, other=(o_uref, o_mv4))
    return out[0], satd[0]


def uni_select(mvq, satd, pred4, lmap, nref, lams):
    R, N = satd.shape
    mr = lmap.shape[0]
    _need(mvq, torch.int32, (R, N, 2), "mvq")
    _need(satd, torch.float32, (R, N), "satd")
    _need(pred4, torch.int32, (R, N, 2), "pred4")
    _need(lmap, torch.int32, (mr,), "lmap")
    dev = satd.device
    i32 = lambda *sh: torch.empty(sh, dtype=torch.int32, device=dev)
    f32 = lambda *sh: torch.empty(sh, dtype=torch.float32, device=dev)
    out = {"ridx": i32(N), "uref": i32(N), "mv": i32(N, 2), "satd": f32(N),
           "bits": f32(N), "cost": f32(N), "anchor": i32(N, 2)}
    _launch("inter_uni", "hm_uni_select", _ptr(mvq), _ptr(satd), _ptr(pred4),
            _ptr(lmap), mr, int(nref), N, float(np.float32(lams)),
            *[_ptr(out[k]) for k in ("ridx", "uref", "mv", "satd", "bits",
                                     "cost", "anchor")], _stream(satd))
    return out


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
    a, N = _cu_rd_args(cur, sub, s, uni, tmvp4, ref0, rect, intra, lamf,
                       lams, qp, bd, nmerge)
    return _cu_rd_launch("inter_cu_rd", a, cur, s, N, False)


def cu_rd_b(cur, sub, s, uni, tmvp4, first, nref, mvb, rect, intra, lamf,
            lams, qp, bd, nmerge):
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
    return _cu_rd_launch("inter_cu_rd_b", a, cur, s, N, True)


# ---------------------------------------------------------------------------
# K4, P-picture plan
# ---------------------------------------------------------------------------

def emit_inter_plan(recs, costs, lamf, h, w):
    from hm16_2_tpu_torch.encode.inter_plan import NREC, PLAN_CHANNELS, \
        SIZES, SPLIT_BITS
    dev = next(c.device for c in costs.values() if c is not None)
    st = _stream(next(c for c in costs.values() if c is not None))
    lam = float(np.float32(lamf))
    shape = {s: (h // s, w // s) for s in SIZES}
    g = InterGrids(h4=h // 4, w4=w // 4)
    keep = []
    for i, s in enumerate(SIZES):
        g.ny[i], g.nx[i] = shape[s]
        if costs[s] is not None:
            n = shape[s][0] * shape[s][1]
            _need(costs[s], torch.float32, (n,), f"cost{s}")
            _need(recs[s], torch.int32, (n, NREC), f"rec{s}")
            keep.append(recs[s])
            g.rec[i] = recs[s].data_ptr()

    def level(child, s):
        """DP level into size s: its split flags and its updated costs."""
        hp, wp = shape[s]
        flag = torch.empty((hp, wp), dtype=torch.uint8, device=dev)
        out = torch.empty((hp * wp,), dtype=torch.float32, device=dev)
        _launch("plan_dp", "hm_dp_level", _ptr(child), shape[s // 2][1],
                _ptr(costs[s]), hp, wp, lam, SPLIT_BITS, 0, _ptr(flag),
                _ptr(out), st)
        keep.append(flag)
        return flag, out

    cu = costs[8]
    for s, field in ((16, "split16"), (32, "split32"), (64, "split64")):
        if cu is None or costs[s] is None:
            break
        flag, cu = level(cu, s)
        setattr(g, field, flag.data_ptr())
    out = torch.empty((PLAN_CHANNELS, h // 4, w // 4), dtype=torch.int16,
                      device=dev)
    _launch("plan_dp", "hm_emit_inter_plan", ctypes.byref(g), _ptr(out), st)
    return out

"""The native intra walk of a planned I slice as a CTU wavefront
(`native/intra_wave.cpp`).

`commit_frame(cctx, pic)` commits every CTU of a planned I picture through
`dsp_core`'s `commit_plan_ctu`, as `commit_plan_frame` does in raster
order, on as many host threads as the CTU grid and the cores the process
may use allow: `threads(wc, hc)`, that is min(usable cores, CTU rows,
(CTU columns + 1) // 2).  CTU (x, y) starts once row y - 1 has finished
min(x + 2, wc) CTUs, so each CTU sees the neighbours the raster walk shows
it, and the picture's arrays and the stream's bytes are those of the raster
walk.  Where one thread is all there is, or the library does not load (why
is recorded with the tracer), `commit_plan_frame` runs as before.

Its counters, on the open `commit.recon` span while the tracer is on:
`commit.wave_threads` (threads the walk ran with, 1 when serial),
`commit.wave_ctus` (CTUs the wavefront committed) and
`commit.wave_wait_ms` (summed ms that workers waited on the row above).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

from hm16_2_tpu_torch import native
from hm16_2_tpu_torch import trace as _trace

_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SRC = os.path.join(_DIR, "intra_wave.cpp")
_SO = os.path.join(_DIR, "intra_wave.so")
_lib = None
_failed = False


def get_lib():
    """ctypes handle to intra_wave.so (built next to its source on first
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
                ["g++", "-O3", "-march=native", "-pthread", "-shared",
                 "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
    except Exception as e:
        _failed = True
        _trace.unavailable("intra_wave", e)
        return None
    lib.intra_wave_commit.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64)]
    lib.intra_wave_commit.restype = ctypes.c_int
    _lib = lib
    return lib


def threads(wc, hc):
    """The wavefront's threads on a wc x hc CTU grid: the usable cores,
    at most one a CTU row, at most one per two CTU columns (a row runs two
    CTUs behind the one above it)."""
    return max(1, min(len(os.sched_getaffinity(0)), hc, (wc + 1) // 2))


def commit_frame(cctx, pic, nthreads=None):
    """Commits every CTU of the planned I picture `pic` through the commit
    context `cctx` (`CtuSearch._commit_ctx()`) on `nthreads` threads
    (default `threads(...)` of its CTU grid).  Returns what
    `commit_plan_frame` returns: 0, or 1 + the raster index of the first
    CTU the native walk could not commit; the CTUs after it are left as
    the raster walk leaves them, for the host to commit from there."""
    dsp = native.get_dsp()
    wc, hc = pic.w_ctbs, pic.h_ctbs
    n = threads(wc, hc) if nthreads is None else nthreads
    lib = get_lib() if n > 1 else None
    tr = _trace.ON
    if lib is None:
        tr and _trace.count("commit.wave_threads", 1)
        return dsp.commit_plan_frame(ctypes.byref(cctx))
    waited = ctypes.c_int64(0)
    rc = lib.intra_wave_commit(
        ctypes.addressof(cctx),
        ctypes.cast(dsp.commit_plan_ctu, ctypes.c_void_p).value, wc, hc, n,
        pic.coded.ctypes.data, pic.pw, pic.ctb // 4, ctypes.byref(waited))
    if tr:
        _trace.count("commit.wave_threads", n)
        _trace.count("commit.wave_ctus", wc * hc if rc == 0 else rc - 1)
        _trace.count("commit.wave_wait_ms", round(waited.value / 1e6))
    return rc

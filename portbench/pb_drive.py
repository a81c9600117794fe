"""Drives the encoder under test through warm-up and one measured window.

One closed-loop client: the next frame is handed to the encoder as soon as
the previous call returns.  Everything recorded here comes from the
benchmark's own wrappers around the encoder's calls: per picture, the
hand-over and return times, the encoder's cumulative `stage_ms` before and
after, its reconstruction, its access unit and its packed frame plan; per
plan, the live references (the work of K7).  Nothing of the encoder is
changed.
"""

from __future__ import annotations

import time

import numpy as np


class WindowRanOut(RuntimeError):
    pass


class Recorder:
    """Wraps the encoder's per-picture call and its plan fetches."""

    def __init__(self, enc):
        from hm16_2_tpu_torch import kernels
        from hm16_2_tpu_torch.encode import inter_plan, intra_rd
        self.enc = enc
        self.kernels = kernels
        self.pics = {}            # poc -> record
        self.order = []           # coding order
        self.cur = None
        self.refs = {}            # poc -> number of live reference planes
        self._undo = []
        orig_one = enc._encode_one

        def encode_one(planes, poc, sh, **kw):
            if kw.get("trial"):
                return orig_one(planes, poc, sh, **kw)
            rec = {"poc": poc, "stage0": dict(enc.stage_ms),
                   "t0": time.perf_counter()}
            self.cur = rec
            au = orig_one(planes, poc, sh, **kw)
            rec.update(t1=time.perf_counter(), stage1=dict(enc.stage_ms),
                       recon=enc.last_recon, au=au,
                       slice_type=int(sh.slice_type))
            self.cur = None
            self.order.append(poc)
            self.pics[poc] = rec
            return au

        enc._encode_one = encode_one
        for mod in (intra_rd, inter_plan):
            self._wrap_fetch(mod)
        orig_inputs = inter_plan._plan_inputs

        def plan_inputs(sps, sh, rc):
            out = orig_inputs(sps, sh, rc)
            self.refs[int(sh.poc)] = len(out[0])
            return out

        inter_plan._plan_inputs = plan_inputs
        self._undo.append((inter_plan, "_plan_inputs", orig_inputs))

    def _wrap_fetch(self, mod):
        orig = mod.fetch_plan

        def fetch_plan(fut, h, w):
            plan = orig(fut, h, w)
            if self.cur is not None:
                self.cur["plan"] = fut.host.numpy().copy()
            return plan

        mod.fetch_plan = fetch_plan
        self._undo.append((mod, "fetch_plan", orig))

    def launches(self):
        return sum(self.kernels.LAUNCHES.values())

    def close(self):
        for mod, name, orig in self._undo:
            setattr(mod, name, orig)
        self._undo.clear()


def _i32(planes):
    return [np.ascontiguousarray(p, dtype=np.int32) for p in planes]


class Client:
    """Hands frames over one by one and records when each AU came back.

    mode "push": `push_frame` per frame (AUs come back per GOP);
    mode "stream": one `encode_stream` generator (the pipelined intra path).
    A unit ends at a call that returned access units; the window stops
    before a unit that the length of the last unit says would end past the
    deadline, and ends at the return of its last AU."""

    def __init__(self, enc, rec, frames, mode):
        self.enc, self.rec, self.frames, self.mode = enc, rec, frames, mode
        self.handed = {}          # poc -> hand-over time
        self.returned = {}        # poc -> return time
        self.next_poc = 0
        self.last_unit = None
        self._last_ret = None
        self._gen = None
        if mode == "stream":
            self._gen = enc.encode_stream(self._feed())
        elif mode != "push":
            raise ValueError(f"unknown drive mode {mode!r}")

    def _feed(self):
        while self.next_poc < len(self.frames):
            poc = self.next_poc
            planes = _i32(self.frames[poc])
            self.next_poc += 1
            self.handed[poc] = time.perf_counter()
            yield planes
        raise WindowRanOut(f"all {len(self.frames)} frames were coded")

    def step(self):
        """One call into the encoder; returns the POCs whose AUs it returned."""
        n0 = len(self.rec.order)
        if self.mode == "stream":
            try:
                aus = [next(self._gen)]
            except StopIteration:
                raise WindowRanOut(f"all {len(self.frames)} frames were coded")
        else:
            poc = self.next_poc
            if poc >= len(self.frames):
                raise WindowRanOut(f"all {len(self.frames)} frames were coded")
            planes = _i32(self.frames[poc])
            self.next_poc += 1
            self.handed[poc] = time.perf_counter()
            aus = self.enc.push_frame(planes, poc)
        t = time.perf_counter()
        pocs = self.rec.order[n0:]
        if len(pocs) != len(aus):
            raise RuntimeError(f"{len(aus)} AUs came back for {len(pocs)} "
                               f"coded pictures")
        for poc in pocs:
            self.returned[poc] = t
        if pocs:
            if self._last_ret is not None:
                self.last_unit = t - self._last_ret
            self._last_ret = t
        return pocs

    def warm_up(self, n_pictures):
        done = 0
        while done < n_pictures:
            done += len(self.step())
        return done

    def window(self, seconds, on_start=None):
        """Measure; returns (t_start, t_end, POCs counted in the window,
        units counted).  A unit that ends past the deadline is counted, and
        the window ends at its return: all the work over all the time."""
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        counted, t_end, units = [], t0, 0
        boundary = True
        while True:
            if boundary and counted and \
                    time.perf_counter() - t0 + self.last_unit > seconds:
                break
            pocs = self.step()
            boundary = bool(pocs)
            if pocs:
                counted += pocs
                units += 1
                t_end = self.returned[pocs[0]]
                if t_end - t0 > seconds:
                    break
        if not counted:
            raise RuntimeError(f"no access unit came back within {seconds} s")
        return t0, t_end, counted, units

    def close(self):
        if self._gen is not None:
            self._gen.close()

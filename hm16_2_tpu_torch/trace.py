"""Spans and counters of the encoder's host work, on the clock of
`time.perf_counter_ns()`.

The tracer is off by default: `enable()` switches it on, `disable()` off,
and `drain()` returns what was recorded and clears it.  While it is off,
each instrumented site costs one check of the module flag `ON`, or of a
local it was read into: nothing is allocated and no clock is read beyond
the readings `Encoder.stage_ms` always takes.

    from hm16_2_tpu_torch import trace
    trace.enable()
    aus = list(enc.encode_stream(frames))
    rec = trace.drain()           # Record(spans, counters, unavailable)
    trace.disable()

A span is a named interval of host time, the POC of the picture it works
for, and its parent (the span open when it began; None for a root):

    call             one public entry of the encoder (`push_frame`, `flush`,
                     `encode_frame`, one step of `encode_stream`): the root
    picture          one coded picture (`_encode_one`; trials are not traced)
    plan.dispatch    the enqueue of a plan, with the POC of the picture the
                     plan is for, in the call or picture it runs in; an
                     in-call plan's dispatch ends where its fetch begins
    plan.wait        blocked on a plan until its data is on the host
    commit           `stage_ms["commit"]`, with these children:
      commit.map     Python mapping of a planned inter CU onto the exact
                     merge and AMVP lists (its self time; its
                     reconstruction is a commit.recon inside it)
      commit.recon   reconstruction of planned CUs: the native intra walk,
                     `inter_commit_cu`, or their Python fallbacks
      commit.search  the host's local search, a plan's fallback or the
                     whole CTU of a picture without a plan
    filters.deblock  `stage_ms["filters"]` up to the end of deblocking
    filters.sao      the rest of `stage_ms["filters"]`
    emit             `stage_ms["emit"]`
    finish           `stage_ms["finish"]`
    kernel           a public wrapper of `kernels.py`, entry to return;
                     `key` is its `kernels.LAUNCHES` key

A span's `key` is None elsewhere, but for a Python reconstruction of a
planned inter CU ("python"), which ends with the commit.map it runs in.
Its `n` is a count kept on it: a kernel span's launches, a picture's CTUs
written by the Python syntax writer.

The stage spans share their clock readings with `stage_ms`, so each
equals its stage to the nanosecond.  Counters are integers under (name, POC):

    commit.native_cus, commit.python_cus   CUs finally committed, by the
                                           code that reconstructed them
    commit.search_cus                      of those, found by local search
    commit.native_refused_ctus             CTUs the native walk handed back
    emit.native_ctus, emit.python_ctus     CTUs by the syntax writer used
    kernel.launches                        kernel launches
    native.unavailable                     (POC None) native libraries
                                           that did not load; the reasons
                                           are in `Record.unavailable`

Each site is written as its own statements, which hold nothing but calls
of this module: `s = tr and trace.open(name)` before the code it times and
`s and trace.close(s)` after it, with `tr` (or the picture's span) read
once from `ON`.  A record is read by the benchmark (`portbench/pb_spans.py`).
"""

from __future__ import annotations

import functools
import time
from collections import namedtuple

ON = False

# a span: [name, poc, start_ns, end_ns, parent, key, n, index, mark]; a
# picture's mark is where its deblocking ended (perf_counter seconds)
_spans = []
_stack = []         # the open spans, innermost last
_counters = {}      # (name, poc) -> int
UNAVAILABLE = {}    # native library -> why it did not load (kept when off)

Span = namedtuple("Span", "name poc start_ns end_ns parent key n",
                  defaults=(0,))
Record = namedtuple("Record", "spans counters unavailable")

STAGE_SPANS = ("commit", "filters.deblock", "filters.sao", "emit", "finish")


def enable():
    global ON
    ON = True


def disable():
    global ON
    ON = False


def drain():
    """The spans (a span still open has end_ns None) and counters recorded
    since the last drain, then clears them.  Handles of spans still open
    are forgotten: closing them later records nothing."""
    spans = [Span(*s[:7]) for s in _spans]
    counters = dict(_counters)
    if UNAVAILABLE:
        counters[("native.unavailable", None)] = len(UNAVAILABLE)
    _spans.clear()
    _stack.clear()
    _counters.clear()
    return Record(spans, counters, dict(UNAVAILABLE))


def unavailable(name, why):
    """Keeps, once, why the native library `name` did not load; for a
    failed build, with what the compiler wrote."""
    if name not in UNAVAILABLE:
        err = getattr(why, "stderr", None)
        UNAVAILABLE[name] = (f"{why}: {err.decode(errors='replace')}"
                             if isinstance(err, bytes) and err else str(why))


def open(name, poc=None, key=None):
    """Opens a span under the innermost open one; poc None takes the
    parent's.  Returns its handle for `close`."""
    top = _stack[-1] if _stack else None
    if poc is None and top is not None:
        poc = top[1]
    elif name == "picture" and _stack and _stack[0][1] is None:
        _stack[0][1] = poc            # a call takes its first picture's POC
    span = [name, poc, time.perf_counter_ns(), None,
            None if top is None else top[7], key, 0, len(_spans), None]
    _spans.append(span)
    _stack.append(span)
    return span


def close(span, counter=None, n=1):
    """Ends the span and any span still open inside it, and adds n to
    `counter` at its POC; a span closed already, or forgotten by `drain`,
    is left as it is."""
    if not span or span[3] is not None or span[7] >= len(_spans) \
            or _spans[span[7]] is not span:
        return
    t = time.perf_counter_ns()
    while _stack:
        s = _stack.pop()
        s[3] = t
        if s is span:
            break
    if counter is not None and n:
        count(counter, n, span[1])


def discard(span):
    """Forgets a span that has nothing inside it."""
    if _spans and _spans[-1] is span:
        _spans.pop()
        if _stack and _stack[-1] is span:
            _stack.pop()


def add(name, start_s, end_s, parent):
    """Records a closed span [start_s, end_s] (perf_counter seconds) under
    the open span `parent`, with its POC."""
    _spans.append([name, parent[1], round(start_s * 1e9), round(end_s * 1e9),
                   parent[7], None, 0, len(_spans), None])


def count(name, n=1, poc=None):
    """Adds n to the counter of (name, poc); poc None takes the innermost
    open span's."""
    if poc is None and _stack:
        poc = _stack[-1][1]
    k = (name, poc)
    _counters[k] = _counters.get(k, 0) + n


def stage_end(total_ms, t0, picture=None, key=None):
    """The end of an encoder stage: total_ms plus the milliseconds since
    t0 (a `time.perf_counter()` reading), the stage's new `stage_ms`.
    With `picture` (its open span) the stage `key` becomes its span over
    the same readings: the commit span opened at t0 is closed,
    filters.sao runs from where `split` ended the deblocking, emit and
    finish are recorded."""
    t1 = time.perf_counter()
    total_ms += (t1 - t0) * 1e3
    if not picture:
        return total_ms
    if key == "commit":
        commit = next((s for s in reversed(_stack) if s[0] == "commit"),
                      None)
        if commit is not None:
            close(commit)
            commit[2], commit[3] = round(t0 * 1e9), round(t1 * 1e9)
    elif key == "filters":
        add("filters.sao", picture[8], t1, picture)
    elif key in ("emit", "finish"):
        add(key, t0, t1, picture)
    return total_ms


def split(picture, name, start):
    """Records [start, now] as `name` under the picture span and keeps
    now, where the rest of the stage (`stage_end`) starts."""
    picture[8] = time.perf_counter()
    add(name, start, picture[8], picture)


def wait_open():
    """Opens a plan.wait: when the innermost span is the plan.dispatch of
    an in-call plan, the dispatch ends here and the wait takes its POC."""
    top = _stack[-1] if _stack else None
    if top is not None and top[0] == "plan.dispatch":
        close(top)
        return open("plan.wait", top[1])
    return open("plan.wait")


def close_map(span, done):
    """Ends a commit.map.  A Python reconstruction still open inside it
    (key "python", the last thing the mapping ran) ends with it, and its
    CU counts when the mapping committed it (done)."""
    top = _stack[-1] if _stack else None
    if done and top is not None and top is not span and top[5] == "python":
        count("commit.python_cus", 1, span[1])
    close(span)


def close_search(span, n):
    """Ends a commit.search that committed n CUs."""
    close(span, "commit.search_cus", n)
    if n:
        count("commit.python_cus", n, span[1])


def emit_python(picture, n=1):
    """n CTUs of the picture written by the Python syntax writer."""
    picture[6] += n


def emit_end(picture, n_ctus):
    """Counts the picture's CTUs by syntax writer."""
    count("emit.python_ctus", picture[6], picture[1])
    count("emit.native_ctus", n_ctus - picture[6], picture[1])


def launched():
    """One kernel launch, counted at the innermost span's POC and on the
    kernel span it is made in."""
    count("kernel.launches")
    for s in reversed(_stack):
        if s[0] == "kernel":
            s[6] += 1
            break


def enter(poc=None):
    """The call span of a public entry, or None when an entry is already
    open (the outermost entry is the call)."""
    return None if _stack else open("call", poc)


def leave(call):
    """Ends a call span; an empty call without a POC (a flush with nothing
    to code, the step that ends a stream) is forgotten."""
    if call[1] is None:
        discard(call)
    close(call)


def entry(fn):
    """A public entry of the encoder, `fn(self, planes, poc, ...)` or
    `fn(self)`: while tracing, its call is a `call` span with that POC."""
    @functools.wraps(fn)
    def run(self, *args, **kw):
        if not ON:
            return fn(self, *args, **kw)
        call = enter(args[1] if len(args) > 1 else kw.get("poc"))
        try:
            return fn(self, *args, **kw)
        finally:
            if call:
                leave(call)
    return run


def steps(gen):
    """Yields what gen yields, each step from resume to yield one call."""
    try:
        while True:
            call = ON and enter()
            try:
                item = next(gen)
            except StopIteration:
                return
            finally:
                if call:
                    leave(call)
            yield item
    finally:
        gen.close()


def stepped(gen_fn):
    """A generator function whose every step is a call (see `steps`)."""
    @functools.wraps(gen_fn)
    def run(*args, **kw):
        return steps(gen_fn(*args, **kw))
    return run


def _cus(depth, log2_ctb, ph, pw):
    """CUs of each CTU, (ceil(ph/c), ceil(pw/c)) with c the CTU's size in
    parts, of the ph x pw parts of per-part CU depths starting at a CTU's
    corner: a part starts a CU where both its coordinates are multiples of
    the CU's size in parts."""
    import numpy as np
    d = np.asarray(depth)[:ph, :pw].astype(np.int64)
    n = ((1 << log2_ctb) >> d) // 4
    ys, xs = np.ogrid[:ph, :pw]
    first = ((ys % n) == 0) & ((xs % n) == 0)
    c = 1 << (log2_ctb - 2)
    hc, wc = -(-ph // c), -(-pw // c)
    pad = np.zeros((hc * c, wc * c), np.int64)
    pad[:ph, :pw] = first
    return pad.reshape(hc, c, wc, c).sum(axis=(1, 3))


def cus_in_ts(pic, n):
    """CUs of the first n CTUs of a coded picture in tile scan."""
    per_ctu = _cus(pic.depth, pic.log2_ctb, pic.h // 4, pic.w // 4)
    return int(per_ctu.ravel()[pic.tiles.ctu_ts_to_rs[:n]].sum())


def ctu_cus(pic, cx, cy):
    """CUs of one CTU of a coded picture."""
    c = pic.ctb // 4
    px, py = cx * c, cy * c
    return int(_cus(pic.depth[py:py + c, px:px + c], pic.log2_ctb,
                    min(c, pic.h // 4 - py), min(c, pic.w // 4 - px))[0, 0])

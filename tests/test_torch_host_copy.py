"""The port's copy of the reference's host code.

The port imports nothing of the JAX package: it keeps a copy of every host
module it runs (headers, CABAC, the decoder, the commit engine and its C++
sources, the encoder top level, the CLIs, the host tools), at the same
path under `hm16_2_tpu_torch/`.  Each copy equals its reference after the
import rewrite `hm16_2_tpu.` -> `hm16_2_tpu_torch.`; the encoder top level,
the encoder CLI and the BD-rate harness differ only inside the named blocks
that point them at the port's device code (and, in the encoder top level,
at the port's native inter walk and the CTU wavefronts of the intra and
inter walks, whose bytes `stream_digest.PINNED`,
tests/test_torch_inter_walk.py, tests/test_torch_intra_wave.py and
tests/test_torch_inter_wave.py hold).  The encoder top level also
holds the tracer's statements (`trace.py`), which are taken out before it
is compared; the native loader and commit engine differ only where the
loader records why a library did not load and the engine's debug prints
were taken out.
"""

import ast
import difflib
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REF = re.compile(r"\bhm16_2_tpu(?=\.|\s+import\b)")

COPIES = [f"{m}.py" for m in (
    "bitstream/__init__", "bitstream/bitio", "bitstream/cabac",
    "common/__init__", "common/cabac_data", "common/cabac_init_data",
    "common/tables", "config/__init__", "config/options", "decode/__init__",
    "decode/ctu_dec", "decode/loopfilter", "decode/mvpred", "decode/picture",
    "decode/refpics", "decode/top", "encode/ctu_enc", "encode/sao_enc",
    "encode/ratectrl", "encode/preanalysis", "encode/rrsp",
    "encode/wp_analysis", "headers/__init__", "headers/params",
    "headers/parse", "headers/sei", "headers/write", "io/__init__", "io/yuv",
    "native/__init__", "ops/deblock_ref", "ops/interp_ref", "ops/intra_ref",
    "ops/sao_ref", "ops/satd", "ops/transforms_ref", "tools/__init__",
    "tools/annexb_bytecount", "tools/bitrate_targeting",
    "tools/convert_bitdepth", "tools/decode", "tools/fit_bits_model",
    "tools/realclip")] + ["native/cabac_core.cpp", "native/dsp_core.cpp"]

# (function, first line, end line): the lines of the function from the one
# holding `first` up to the one holding `end` (exclusive) may differ; a
# block without markers is the whole function, one without a function is
# searched in the whole file
NAMED = {
    "encode/top.py": [
        ("Encoder.__init__", None, None),
        ("Encoder._submit_plan", None, None),
        ("Encoder._predispatch_ra", None, None),
        ("Encoder._encode_one", "def _tick(key, t0):",
         "is_idr = sh.nal_type in"),
        ("Encoder._encode_one", "search = CtuSearch(",
         "# pass 1: mode decisions"),
        ("Encoder._encode_one", "cctx = search._commit_ctx()",
         "slice_of_ts = np.zeros(n_ctus"),
        ("CtuSearch.decide_ctu", "ctypes.byref(cctx), cx, cy) == 0:",
         "self._commit_plan_tree(cx * parts, cy * parts"),
        ("CtuSearch._premodes", None, None),
        ("CtuSearch._search_luma_mode_recon", None, None)],
    "tools/encode.py": [
        (None, "import numpy as np", "from hm16_2_tpu_torch.config.options"),
        ("build_options", "o = Options()", 'o.add("InputFile"'),
        ("main", "enc = Encoder(", "fin = open(inp")],
    "tools/bdrate.py": [
        ("encode_ours", None, None),
        ("run", "def run(", "frames = read_yuv_frames"),
        ("run", "bs, dt = encode_ours(", "op, ob = seq_psnr_bits"),
        ("main", 'ap.add_argument("--qps"', "print(json.dumps(")],
}

# copies held to their reference outside these blocks only (the same form)
EDITED = {
    "native/__init__.py": [
        ("get_lib", 'if os.environ.get("HM16_NO_NATIVE"):',
         "lib.set_tables.argtypes"),
        ("get_dsp", 'if os.environ.get("HM16_NO_NATIVE"):',
         "lib.set_dsp_tables.argtypes")],
    "native/dsp_core.cpp": [
        (None, "double cost = dist + C->lam * bits;",
         "if (first || cost < best_cost) {"),
        (None, "if (pd < depth || log2 <= 3) {",
         "return -1;   // plan inconsistency")],
}


# copies whose tracer statements are taken out before they are compared
TRACED = ("encode/top.py",)


def _read(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


def _rewrite(src):
    return _REF.sub("hm16_2_tpu_torch", src)


def _functions(tree):
    """{qualname: node} of the module's functions and methods."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _tracer_call(node):
    f = node.func
    return isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
        and f.value.id == "_trace"


def _only_tracer(node):
    """Whether node names the tracer `_trace` and calls nothing else."""
    names = False
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and not _tracer_call(n):
            return False
        names = names or isinstance(n, ast.Name) and n.id == "_trace"
    return names


def _tracer_statement(stmt):
    """An expression or an assignment to locals that calls the tracer and
    nothing else, or the tracer's import."""
    if isinstance(stmt, ast.ImportFrom):
        return all(a.asname == "_trace" for a in stmt.names)
    if isinstance(stmt, ast.Assign):
        return all(isinstance(t, ast.Name) for t in stmt.targets) and \
            _only_tracer(stmt.value)
    return isinstance(stmt, ast.Expr) and _only_tracer(stmt.value)


def _strip_tracer(src):
    """src without the tracer's statements and decorators."""
    drop = set()
    for node in ast.walk(ast.parse(src)):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            for stmt in stmts if isinstance(stmts, list) else ():
                if _tracer_statement(stmt):
                    drop.update(range(stmt.lineno, stmt.end_lineno + 1))
        for dec in getattr(node, "decorator_list", ()):
            if _only_tracer(dec):
                drop.update(range(dec.lineno, dec.end_lineno + 1))
    return "\n".join(line for k, line in enumerate(src.splitlines(), 1)
                     if k not in drop) + "\n"


def _cut(src, blocks):
    """The lines of src with each named block replaced by one line naming
    it."""
    lines = src.splitlines()
    funcs = _functions(ast.parse(src)) \
        if any(func for func, _, _ in blocks) else {}
    spans = []
    for func, first, end in blocks:
        if func is None:
            lo, hi = 0, len(lines)
        else:
            node = funcs[func]
            lo = min([node.lineno] + [d.lineno for d in node.decorator_list])
            lo, hi = lo - 1, node.end_lineno
        if first is not None:
            i = next(k for k in range(lo, hi) if first in lines[k])
            j = next(k for k in range(i + 1, hi) if end in lines[k])
            lo, hi = i, j
        spans.append((lo, hi, f"<{func}: {first}>"))
    for lo, hi, name in sorted(spans, reverse=True):
        lines[lo:hi] = [name]
    return lines


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_reference(path):
    ref = _read(os.path.join("hm16_2_tpu", path))
    got = _read(os.path.join("hm16_2_tpu_torch", path))
    ref = _rewrite(ref) if path.endswith(".py") else ref
    if path in EDITED:
        ref, got = _cut(ref, EDITED[path]), _cut(got, EDITED[path])
    assert got == ref


@pytest.mark.parametrize("path", sorted(NAMED))
def test_copy_differs_only_in_named_blocks(path):
    """The encoder top level (device, plan submission and fetch, the
    pipelined RA plans, the fallback's frame ME and 35-mode analysis, the
    stage clock `_tick` that ends the tracer's stage spans, the call of
    the native inter walk `encode/inter_walk.py` in `decide_ctu`, the
    planned I picture's walk as a CTU wavefront `encode/intra_wave.py`
    and the P/B picture's as one `inter_walk.commit_frame`, in one
    block), once its tracer statements are out, the encoder CLI (its
    Device option) and the BD-rate harness (its encode arm's device and
    Device option) differ from the reference only in their named
    blocks."""
    ref = _cut(_rewrite(_read(os.path.join("hm16_2_tpu", path))), NAMED[path])
    got = _read(os.path.join("hm16_2_tpu_torch", path))
    if path in TRACED:
        got = _strip_tracer(got)
    got = _cut(got, NAMED[path])
    diff = list(difflib.unified_diff(ref, got, lineterm=""))
    assert not diff, "\n".join(diff)


@pytest.mark.parametrize("src, kept", [
    ("s = tr and n > 2 and _trace.open('a')\nf()\n", "f()\n"),
    ("s and _trace.close(s, 'n', _trace.ctu_cus(p, 0, 0))\n", "\n"),
    ("@_trace.entry\ndef f():\n    pass\n", "def f():\n    pass\n"),
    ("s = _trace.ON and self.commit()\n", None),
    ("_trace.close(s, 'n', len(p))\n", None),
    ("self.s = _trace.ON\n", None),
    ("if s:\n    _trace.close(s)\n", "if s:\n")])
def test_only_the_tracers_statements_are_taken_out(src, kept):
    """A statement is the tracer's when it calls the tracer and nothing
    else and assigns only locals: a call of the encoder's code, or state
    kept, stays in the comparison, and so does a guard around the
    tracer."""
    assert _strip_tracer(src) == (src if kept is None else kept)


def test_port_imports_no_reference_module():
    """No module of the port imports the JAX package or jax."""
    bad = []
    pat = re.compile(r"^\s*(from|import)\s+(hm16_2_tpu|jax)\b(?!_torch)",
                     re.M)
    for dirpath, _, files in os.walk(os.path.join(ROOT, "hm16_2_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    bad += [f"{path}: {m.group(0).strip()}"
                            for m in pat.finditer(f.read())]
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        bad += [f"chip_smoke.py: {m.group(0).strip()}"
                for m in pat.finditer(f.read())]
    assert not bad, bad

"""The port's copy of the reference's host code.

The port imports nothing of the JAX package: it keeps a copy of every host
module it runs (headers, CABAC, the decoder, the commit engine and its C++
sources, the encoder top level, the CLIs), at the same path under
`hm16_2_tpu_torch/`.  Each copy equals its reference after the import
rewrite `hm16_2_tpu.` -> `hm16_2_tpu_torch.`; the encoder top level and the
encoder CLI differ only inside the named blocks that point them at the
port's device code.
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
    "tools/decode")] + ["native/cabac_core.cpp", "native/dsp_core.cpp"]

# (function, first line, end line): the lines of the function from the one
# holding `first` up to the one holding `end` (exclusive) may differ; a
# block without markers is the whole function, one without a function is
# searched in the whole file
NAMED = {
    "encode/top.py": [
        ("Encoder.__init__", None, None),
        ("Encoder._submit_plan", None, None),
        ("Encoder._predispatch_ra", None, None),
        ("Encoder._encode_one", "search = CtuSearch(",
         "# pass 1: mode decisions"),
        ("CtuSearch._premodes", None, None),
        ("CtuSearch._search_luma_mode_recon", None, None)],
    "tools/encode.py": [
        (None, "import numpy as np", "from hm16_2_tpu_torch.config.options"),
        ("build_options", "o = Options()", 'o.add("InputFile"'),
        ("main", "enc = Encoder(", "fin = open(inp")],
}


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


def _cut(src, blocks):
    """The lines of src with each named block replaced by one line naming
    it."""
    lines = src.splitlines()
    funcs = _functions(ast.parse(src))
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
    assert got == (_rewrite(ref) if path.endswith(".py") else ref)


@pytest.mark.parametrize("path", sorted(NAMED))
def test_copy_differs_only_in_named_blocks(path):
    """The encoder top level (device, plan submission and fetch, the
    pipelined RA plans, the fallback's frame ME and 35-mode analysis) and
    the encoder CLI (its Device option) differ from the reference only in
    their named blocks."""
    ref = _cut(_rewrite(_read(os.path.join("hm16_2_tpu", path))), NAMED[path])
    got = _cut(_read(os.path.join("hm16_2_tpu_torch", path)), NAMED[path])
    diff = list(difflib.unified_diff(ref, got, lineterm=""))
    assert not diff, "\n".join(diff)


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

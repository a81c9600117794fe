"""Every cell resolves to its files by name, BENCHMARK.json keeps to the
contract's shapes, and a new cell, configuration, mix and per-layer metric
are added as new files and entries alone."""

import json
import os
import re
import shutil

import pytest
from pb_testlib import PB, ROOT

import pb_spec
import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = pb_spec.load(ROOT)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    cell, cfg, traffic, metrics = run.load_cell(w["name"], ROOT)
    assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
    assert metrics["end_to_end"] and metrics["per_layer"]
    for m in metrics["per_layer"]:
        assert callable(pb_spec.reader(m["name"], ROOT))
    assert {m["name"] for m in metrics["end_to_end"]} == \
        {"fps", "latency_ms.p90", "setup_s"}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    with open(os.path.join(ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == c["reduced"]
    for k in cfg["reduced"]:    # a published key the run does not honour
        assert "not honoured" in cfg["published"][k]
    assert not {k for k, v in cfg["published"].items()
                if "not honoured" in v} - set(cfg["reduced"])
    assert (cfg["width"], cfg["height"]) == (1920, 1080)
    assert cfg["source"] == c["source"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_entries(kind):
    for m in BENCH[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if kind == "end_to_end":
            assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] == "fps" and m["layer"]
            for w in m.get("workloads", []):
                pb_spec.cell(BENCH, w)


def test_additions_need_no_edit(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and a cell as new files and entries; load_cell and the
    reader find them with no file of portbench/ edited."""
    root = tmp_path
    shutil.copytree(PB, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "ref"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.load(open(os.path.join(PB, "configs",
                                      "ctc-ai-main-1080p.json")))
    cfg["name"] = "new-config"
    (root / "portbench/configs/new-config.json").write_text(json.dumps(cfg))
    traffic = json.load(open(os.path.join(PB, "traffic",
                                          "plates-qp32.json")))
    traffic.update(name="new-mix", qp=37)
    (root / "portbench/traffic/new-mix.json").write_text(json.dumps(traffic))
    (root / "portbench/metrics/new_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["configs"].append({"name": "new-config", "source": "x",
                             "file": "portbench/configs/new-config.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "x", "moves": "fps",
                               "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, cfg2, traffic2, metrics = run.load_cell("new-cell", str(root))
    assert cfg2["name"] == "new-config" and traffic2["qp"] == 37
    names = [m["name"] for m in metrics["per_layer"]]
    assert "new_metric" in names and "k7_qpel_roofline" not in names
    assert pb_spec.reader("new_metric", str(root))(None) == 42.0

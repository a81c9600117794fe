"""A run on the CPU at a small size: the result line has the contract's
keys, every per-layer metric of the cell is read, and without a CUDA device
the command exits non-zero and prints no result."""

import json
import os
import subprocess
import sys

import pytest
import torch
from pb_testlib import PB, ROOT, FakeTrace, small_cell

import pb_trace
import run

CPU = torch.device("cpu")


def _run(name, w, h, seconds, trace, monkeypatch=None, seed=20260417):
    cfg, traffic, metrics = small_cell(name, w, h)
    if trace:
        monkeypatch.setattr(pb_trace, "DeviceTrace", FakeTrace)
    return run.run_cell(cfg, traffic, metrics, seed, seconds, trace,
                        CPU, log=lambda s: None), metrics


def test_result_keys_end_to_end():
    res, metrics = _run("ai-main-1080p.qp32", 192, 128, 3, 0)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in metrics["end_to_end"]}
    for m in metrics["end_to_end"]:
        v = res["metrics"][m["name"]]
        assert v["unit"] == m["unit"] and v["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for k, v in res["checks"].items():
        assert v == {"value": 0, "limit": 0}, k
    json.dumps(res)


def test_every_per_layer_metric_is_read(monkeypatch):
    res, metrics = _run("ai-main-1080p.qp22", 192, 128, 3, 1, monkeypatch)
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert set(res["metrics"]) == {m["name"] for m in metrics["per_layer"]}
    for v in res["metrics"].values():
        assert v["value"] >= 0
    assert 0 < res["metrics"]["device.idle_share"]["value"] < 100
    assert res["device"]["busy_s"] == pytest.approx(0.040)
    assert res["device"]["window_s"] > res["device"]["busy_s"]
    bd = res["breakdown"]
    assert bd["device_ops"][0][0].startswith("frac_refine_kernel")
    assert 1 <= len(bd["idle_gaps"]) <= 10
    assert all(isinstance(g[0], str) and g[1] > 0 for g in bd["idle_gaps"])


def test_readers_without_a_trace_read_nothing():
    import pb_spec
    ctx = run.Ctx(pictures=0, stage_ms={}, launches=0, device_events=[],
                  window_s=1.0, busy_s=0.0, plans=[], width=1920, height=1080)
    for m in pb_spec.load(ROOT)["per_layer"]:
        assert pb_spec.reader(m["name"])(ctx) is None, m["name"]


def test_no_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(PB, "run.py"),
                        "--workload", "ra-main-1080p.qp32", "--seed",
                        "3000000001", "--seconds", "5", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "CUDA" in r.stderr


@pytest.mark.gpu
def test_card_run(cuda):
    """On the card: one short run of the AI cell is correct."""
    _, cfg, traffic, metrics = run.load_cell("ai-main-1080p.qp32")
    res = run.run_cell(cfg, traffic, metrics, 7, 8, 0, cuda,
                       kind=torch.cuda.get_device_name(cuda))
    assert res["correct"] and res["device"]["platform"] == "gpu"

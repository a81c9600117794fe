"""Finds a cell's files by the names in BENCHMARK.json: its configuration
under configs/, its traffic mix under traffic/, and the reader of each of
its per-layer metrics under metrics/.  Adding a cell, a configuration, a
mix or a metric adds files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench, cell_, root=ROOT):
    entry = next(c for c in bench["configs"] if c["name"] == cell_["config"])
    return _json(os.path.join(root, entry["file"]))


def traffic(cell_, root=ROOT):
    return _json(os.path.join(root, "portbench", "traffic",
                              cell_["traffic"] + ".json"))


def metrics(bench, cell_, kind):
    """The cell's metric entries of one kind ("end_to_end", "per_layer")."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_["name"] in m["workloads"]]


def reader(name, root=ROOT):
    """`read(ctx)` of metrics/<name>.py: the metric's value, or None where
    the run gave it nothing to read."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "pb_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

"""BENCHMARK.json keeps the contract, and every name in it finds its files."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests.tiny import ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_end_to_end_metrics():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert set(e2e) == {"train_edges_per_s", "train_edges_per_s.recurrent", "peak_mem_gib",
                        "setup_s"}
    # Every cell reports setup_s and one other end-to-end metric at least.
    for w in m["workloads"]:
        here = [x for x in e2e.values() if w["name"] in x.get("workloads", [w["name"]])]
        assert "setup_s" in {x["name"] for x in here} and len(here) >= 2
    for x in e2e.values():
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25


@pytest.mark.parametrize("metric", [x["name"] for x in manifest()["per_layer"]])
def test_per_layer_metric_has_a_reader(metric):
    m = {x["name"]: x for x in manifest()["per_layer"]}[metric]
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert m["moves"] in {x["name"] for x in manifest()["end_to_end"]}
    assert callable(harness.metric_reader(metric))
    cells = {w["name"] for w in manifest()["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    # Each of its cells reports the end-to-end metric it moves.
    moved = {x["name"]: x for x in manifest()["end_to_end"]}[m["moves"]]
    assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("workload", [w["name"] for w in manifest()["workloads"]])
def test_cell_finds_its_files(workload):
    c = harness.find_cell(manifest(), workload)
    assert c.chips == 1
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert hasattr(c.family, "logits") and hasattr(c.cost, "epoch_ops")
    assert hasattr(c.graph, "port") and hasattr(c.graph, "reference_windows")
    assert hasattr(c.task, "trial") and hasattr(c.drive, "window")
    cfg_entry = {x["name"]: x for x in manifest()["configs"]}[c.cfg["name"]]
    assert json.loads((ROOT / cfg_entry["file"]).read_text()) == c.cfg
    assert cfg_entry["reduced"] == c.cfg["reduced"] == []
    assert len(next(w for w in manifest()["workloads"] if w["name"] == workload)["why"]) <= 200

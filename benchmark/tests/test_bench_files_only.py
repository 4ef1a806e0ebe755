"""A cell, a configuration, a traffic mix and a per-layer metric added as
files alone: the harness finds each by its name and runs the new cell."""

import json
import shutil

import torch

from benchmark import harness
from benchmark.tests.tiny import manifest, write_konect


def test_new_files_run_as_a_cell(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((bench / "configs" / "tmgcn2.json").read_text())
    cfg.update(name="tmgcn2_relu", nonlin2="relu")
    (bench / "configs" / "tmgcn2_relu.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "cost" / "tmgcn2.py", bench / "cost" / "tmgcn2_relu.py")
    traffic = json.loads((bench / "traffic" / "powerlaw500k.json").read_text())
    traffic["name"] = "powerlaw_small"
    traffic["graph"].update(nodes=200, slices=6, entries_per_slice=400)
    traffic["labels"]["edges"] = 300
    traffic["drive"]["chunk"] = 4
    (bench / "traffic" / "powerlaw_small.json").write_text(json.dumps(traffic))
    (bench / "limits" / "tmgcn2_relu.powerlaw_small.json").write_text(
        json.dumps({"loss": 1e-4, "grad1": 1e-4, "change": 1e-4}))
    (bench / "metrics" / "loop.steps.py").write_text(
        "def read(ctx):\n    return float(len(ctx.boundaries)) if ctx.trace else None\n")
    man = manifest()
    man["workloads"].append({"name": "tmgcn2_relu.powerlaw_small", "config": "tmgcn2_relu",
                             "traffic": "powerlaw_small", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "loop.steps", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "training loop",
                             "moves": "train_edges_per_s"})
    c = harness.find_cell(man, "tmgcn2_relu.powerlaw_small", bench)
    assert c.cfg["nonlin2"] == "relu" and c.traffic["graph"]["nodes"] == 200
    assert "loop.steps" in [m["name"] for m in c.per_layer]
    assert harness.metric_reader("loop.steps", bench) is not None
    out = harness.run_cell(c, 12345, 0.2, False, torch.device("cpu"), 0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_konect_traffic_reads_the_named_file(tmp_path):
    c = harness.find_cell(manifest(), "wdgcn.chess")
    c.traffic["drive"].update(epochs=40, eval_every=10)
    data = write_konect(tmp_path / "k", n_nodes=30, per_slice=6, seed=3)
    out = harness.run_cell(c, 7, 0.2, False, torch.device("cpu"), 0.0, data_dir=data)
    assert out["correct"], out["checks"]
    assert (data / "saved_content_chess.mat").exists()  # the port's cache, in the data dir


UNIFORM = '''"""A test graph kind: entries uniform over the nodes of each slice."""

import torch

from benchmark import generator, program

SEEDED = True


def port(cell, seed, device, spans, data_dir=None):
    p = cell.traffic["graph"]
    T, N, E = p["slices"], p["nodes"], p["entries_per_slice"]
    g = generator.generator(seed, 1, device)
    r = torch.randint(0, N, (T * E,), generator=g, device=device)
    c = torch.randint(0, N, (T * E,), generator=g, device=device)
    t = torch.arange(T, device=device).repeat_interleave(E)
    graph = generator.graph(T, N, t, r, c, cell.traffic["labels"], g, device)
    return program.build_generated(cell, graph, device, spans), graph


def reference_windows(cell, graph, device, data_dir=None):
    return generator.reference_windows(cell.cfg, graph)
'''


def test_new_graph_kind_task_and_drive_run_as_a_cell(tmp_path):
    """A graph kind, a task and a drive that the harness has never seen,
    each a new file, named by a new traffic mix: the cell runs, correct."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "graphs" / "uniform.py").write_text(UNIFORM)
    shutil.copy(bench / "tasks" / "edge_cls.py", bench / "tasks" / "edge_cls_again.py")
    shutil.copy(bench / "drives" / "steps.py", bench / "drives" / "steps_again.py")
    traffic = {"name": "uniform_small", "why": "a test",
               "graph": {"kind": "uniform", "nodes": 150, "slices": 5, "entries_per_slice": 300},
               "task": "edge_cls_again", "features": 2,
               "labels": {"classes": 2, "class_weights": [0.5, 0.5], "edges": 200},
               "drive": {"kind": "steps_again", "chunk": 3, "compared_steps": 3}}
    (bench / "traffic" / "uniform_small.json").write_text(json.dumps(traffic))
    (bench / "limits" / "wdgcn.uniform_small.json").write_text(
        json.dumps({"loss": 1e-4, "grad1": 1e-4, "change": 1e-4}))
    man = manifest()
    man["workloads"].append({"name": "wdgcn.uniform_small", "config": "wdgcn",
                             "traffic": "uniform_small", "chips": 1, "why": "a test"})
    c = harness.find_cell(man, "wdgcn.uniform_small", bench)
    assert c.graph.__file__.endswith("uniform.py") and c.task.TASK == "edge_cls"
    out = harness.run_cell(c, 2**33 + 1, 0.2, True, torch.device("cpu"), 0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "readout_scatter_roofline" not in out["metrics"]  # no card, no kernel

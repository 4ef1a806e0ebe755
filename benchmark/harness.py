"""One run of one cell: set-up, the measured window, the traced readings
(``trace=True``), then the reference and the comparison.

Everything of a cell is found by name: ``BENCHMARK.json`` lists the cell
with its configuration and traffic; ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json`` and ``benchmark/limits/<cell>.json``
hold their data; ``benchmark/reference/<family>.py`` and
``benchmark/cost/<config>.py`` the configuration's plain reference and
work counts; the traffic names its graph kind
(``benchmark/graphs/<kind>.py``), its task (``benchmark/tasks/<task>.py``)
and its drive (``benchmark/drives/<kind>.py``); each per-layer metric has
its reader, ``benchmark/metrics/<metric>.py``. A cell, a configuration, a
traffic mix, a graph kind, a task, a drive or a metric is added by adding
files.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import correctness, generator, program
from benchmark import trace as tracing

BENCH = Path(__file__).resolve().parent
GIB = float(1 << 30)


@dataclasses.dataclass
class Cell:
    """A cell of BENCHMARK.json with its files read."""

    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    family: object  # benchmark/reference/<family>.py
    cost: object  # benchmark/cost/<config>.py
    graph: object  # benchmark/graphs/<traffic's graph kind>.py
    task: object  # benchmark/tasks/<traffic's task>.py
    drive: object  # benchmark/drives/<traffic's drive kind>.py
    end_to_end: list
    per_layer: list


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def find_cell(manifest: dict, name: str, bench: Path = BENCH) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the cells are {sorted(cells)}")
    w = cells[name]
    cfg = load_json(bench / "configs" / f"{w['config']}.json")
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")

    def here(metric):
        return name in metric.get("workloads", [name])

    return Cell(
        name=name, chips=w["chips"], cfg=cfg, traffic=traffic,
        limits=load_json(bench / "limits" / f"{name}.json"),
        family=_load(bench / "reference" / f"{cfg['family']}.py"),
        cost=_load(bench / "cost" / f"{w['config']}.py"),
        graph=_load(bench / "graphs" / f"{traffic['graph']['kind']}.py"),
        task=_load(bench / "tasks" / f"{traffic['task']}.py"),
        drive=_load(bench / "drives" / f"{traffic['drive']['kind']}.py"),
        end_to_end=[m for m in manifest["end_to_end"] if here(m)],
        per_layer=[m for m in manifest["per_layer"] if here(m)],
    )


def _load(path: Path):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    name = f"benchmark._{path.parent.name}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = BENCH):
    """The ``read`` of ``benchmark/metrics/<name>.py``."""
    return _load(bench / "metrics" / f"{name}.py").read


@dataclasses.dataclass
class Context:
    """What the per-layer readers read."""

    cfg: dict
    n_classes: int
    spans: dict
    eval_every: int = 1
    boundaries: list = dataclasses.field(default_factory=list)  # (trial, epoch, host s)
    plain_epoch_s: float | None = None
    trace: tracing.Trace | None = None
    cost: object = None
    counts: dict | None = None


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             data_dir=None) -> dict:
    """One run: returns the result line's dict (and ``checks``)."""
    tr = cell.traffic
    n_classes = tr["labels"]["classes"]
    shapes = cell.family.param_shapes(tr["features"], cell.cfg["hidden_feat"], n_classes)
    spans = program.Spans()
    spans.seconds["setup.start"] = time.perf_counter() - t_start
    with spans("setup.device", device):
        torch.empty(1, device=device)
    built, source = cell.graph.port(cell, seed, device, spans, data_dir)
    program.check_variables(built.adapter, shapes)
    n_train = built.n_train_edges
    gen = generator.generator(seed, 2, device)

    def draw():
        return generator.initial_variables(shapes, gen, device)

    t_first = time.perf_counter()
    run = cell.drive.window(cell, built, draw, seconds, device)
    setup_s = run["window_start"] - t_start
    spans.seconds["setup.first_steps"] = run["window_start"] - t_first
    _, peak_all = program.memory(device)

    ctx = Context(cfg=cell.cfg, n_classes=n_classes, spans=dict(spans.seconds))
    if trace:
        t = cell.drive.traced(cell, built, run, draw)
        ctx.plain_epoch_s, ctx.trace = t["plain_epoch_s"], t["trace"]
        ctx.boundaries, ctx.eval_every = t["boundaries"], t["eval_every"]

    # The program's state goes before the reference runs.
    prog = cell.drive.program_readings(cell, run)
    init0 = run["init0"]
    info = {k: run[k] for k in ("epochs", "seconds", "trials", "trial_start_bytes",
                                "block_walls") if k in run}
    out = {"correct": None, "attempted": run["epochs"], "failed": run["failed"]}
    peak = run["peak"]
    del built, run
    _free(device)
    wins = cell.graph.reference_windows(cell, source, device, data_dir)
    ref = cell.drive.reference_readings(cell, init0, wins)
    out["correct"], checks = correctness.judge(correctness.readings(prog, ref), cell.limits)

    if trace:
        ctx.cost, ctx.counts = cell.cost, cell.cost.counts(wins["train"])
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"train_edges_per_s": info["epochs"] * n_train / info["seconds"],
               "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        # ``train_edges_per_s.<group>``: the rate, under a bound of its group.
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out["metrics"] = metrics
    out["device"] = device_info(device, cell.chips, peak_all)
    if trace:
        out["device"].update(busy_s=tracing.busy_s(ctx.trace), window_s=ctx.trace.window_s)
        out["breakdown"] = tracing.breakdown(ctx.trace)
    walls = info.pop("block_walls")
    info["block_s"] = {"n": len(walls), "median": float(np.median(walls)) if walls else None,
                       "min": min(walls, default=None), "max": max(walls, default=None)}
    info["setup_spans"] = ctx.spans
    out["window"] = info
    out["checks"] = checks
    return out


def device_info(device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": peak}


def as_numbers(x):
    """numpy scalars as Python numbers, for the result line."""
    if isinstance(x, dict):
        return {k: as_numbers(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [as_numbers(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x

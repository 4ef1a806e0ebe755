"""Tiny versions of the cells, for the CPU tests: the cell's own files with
the traffic cut down (a small KONECT-format file, a small generated graph,
short trials)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def write_konect(d: Path, n_nodes: int = 40, n_slices: int = 100, per_slice: int = 8,
                 seed: int = 0) -> Path:
    """A chess-format file: a header comment, then `src dst result<TAB>time`."""
    rng = np.random.default_rng(seed)
    lines = ["% asym multisigned"]
    for t in range(n_slices):
        for _ in range(per_slice):
            s, dd = rng.choice(n_nodes, 2, replace=False) + 1
            lines.append(f"{s} {dd} {rng.integers(-1, 2)}\t{1000.5 + t}")
    d.mkdir(parents=True, exist_ok=True)
    (d / "out.chess.csv").write_text("\n".join(lines) + "\n")
    return d


def cell(name: str, tmp: Path, bench: Path = harness.BENCH, man: dict | None = None):
    """(cell, data_dir) of ``name`` at a CPU size."""
    c = harness.find_cell(man or manifest(), name, bench)
    if c.traffic["graph"]["kind"] == "konect":
        c.traffic["drive"].update(epochs=60, eval_every=10)
        return c, write_konect(tmp / "konect")
    c.traffic["graph"].update(nodes=300, slices=8, entries_per_slice=600)
    c.traffic["labels"]["edges"] = 500
    c.traffic["drive"]["chunk"] = 5
    return c, None

"""A KONECT edge file of the checkout, the dataset the port's registry
names: the port reads it through its own pipeline (``build_data``, which
caches its artifact beside the file); the reference reads the same file
and works out the windows again. Nothing is drawn from the seed."""

from __future__ import annotations

from pathlib import Path

from benchmark import program
from benchmark.reference import data as refdata

SEEDED = False


def port(cell, seed: int, device, spans, data_dir=None):
    d = Path(data_dir or cell.traffic["graph"]["data_dir"])
    return program.build_konect(cell, d, device, spans), d


def reference_windows(cell, data_dir: Path, device, _data_dir=None) -> dict:
    cfg, tr = cell.cfg, cell.traffic
    g = tr["graph"]
    raw = refdata.load_konect(Path(data_dir) / g["file"], columns=tuple(g["columns"]),
                              skiprows=g["skiprows"], comments=g["comments"],
                              time_delta=g["time_delta"])
    return refdata.konect_windows(
        raw, *g["windows"], same_block=cfg["same_block_size"],
        n_classes=tr["labels"]["classes"],
        m_diagonals=cfg["m_diagonals"] if cfg["method"] == "tmgcn" else None,
        m_weight=cfg.get("m_weight", "inverse"), edge_life=g["edge_life"], device=device)

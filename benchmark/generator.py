"""The one generator every traffic mix goes through.

A traffic mix is a JSON file under ``benchmark/traffic/`` that names a
graph kind and its parameters (``graph``), the port's task (``task``),
the labels, and how the window drives training (``drive``). The graph
kind is a module ``benchmark/graphs/<kind>.py`` with two functions:

* ``port(cell, seed, device, spans, data_dir)``: the port's data and
  adapter for the cell (``program.Built``), and the raw source that the
  reference is handed too;
* ``reference_windows(cell, source, device, data_dir)``: the reference's
  windows, worked out again from that raw source;

and ``SEEDED``, whether the graph is drawn from ``--seed``. This module
holds what the kinds share: seeds, generated graphs and the initial
parameters. A generated graph has the same sizes for every seed.
"""

from __future__ import annotations

import dataclasses

import torch

SEED_MIX = 0x9E3779B97F4A7C15


def sub_seed(seed: int, stream: int) -> int:
    """A seed for stream ``stream`` of run seed ``seed`` (any whole number)."""
    return (int(seed) * 1_000_003 + stream * SEED_MIX) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


@dataclasses.dataclass
class Graph:
    """A generated temporal graph and its labelled edges, on the device."""

    n_slices: int
    n_nodes: int
    t: torch.Tensor  # (nnz,) slice of each entry, ascending
    r: torch.Tensor
    c: torch.Tensor
    v: torch.Tensor  # float32
    edges: torch.Tensor  # (3, E) [slice, src, trg]
    target: torch.Tensor  # (E,)


def graph(T: int, N: int, t, r, c, labels: dict, g: torch.Generator, device,
          edges_from: torch.Generator | None = None) -> Graph:
    """A generated graph from its entries: each entry takes the value
    1/sqrt(row count · column count) of its slice (the symmetric degree
    normalisation), and ``labels["edges"]`` labelled edges are uniform
    (slice, src, trg), drawn from ``edges_from`` (default ``g``), with
    uniform classes drawn from ``g``."""
    ones = torch.ones(t.shape[0], device=device)
    deg_r = torch.zeros(T * N, device=device).index_add_(0, t * N + r, ones)
    deg_c = torch.zeros(T * N, device=device).index_add_(0, t * N + c, ones)
    v = torch.rsqrt(deg_r[t * N + r] * deg_c[t * N + c])
    n_e, ge = labels["edges"], edges_from or g
    edges = torch.stack([
        torch.randint(0, T, (n_e,), generator=ge, device=device),
        torch.randint(0, N, (n_e,), generator=ge, device=device),
        torch.randint(0, N, (n_e,), generator=ge, device=device),
    ])
    target = torch.randint(0, labels["classes"], (n_e,), generator=g, device=device)
    return Graph(T, N, t, r, c, v, edges, target)


def reference_windows(cfg: dict, g: Graph) -> dict:
    """The reference's one window of a generated graph: its entries are the
    tensor the model propagates (M-transformed for TM-GCN)."""
    from benchmark.reference import data as refdata
    from benchmark.reference import ops as refops

    M = None
    if cfg["method"] == "tmgcn":
        M = refops.m_matrix(g.n_slices, cfg["m_diagonals"], cfg.get("m_weight", "inverse"))
    return {"train": refdata.graph_window(g.t, g.r, g.c, g.v, g.n_slices, g.n_nodes, M,
                                          g.edges, g.target)}


def initial_variables(shapes: dict, gen: torch.Generator, device) -> dict:
    """Standard-normal values for a tree of shapes, drawn leaf by leaf in
    sorted key order (the reference's t.randn initialisation)."""
    return {k: initial_variables(v, gen, device) if isinstance(v, dict)
            else torch.randn(tuple(v), generator=gen, device=device)
            for k, v in sorted(shapes.items())}

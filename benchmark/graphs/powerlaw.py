"""A power-law temporal graph made on the device from the seed.

Node popularity is the Pareto(``pareto_shape``) quantiles given to the
nodes in one order drawn from ``layout_seed``; the labelled edges are
drawn from it too. So every run seed has the same heavy rows and the
same rows for the restricted layer 2 to compute, which set the kernels'
speed. The run seed draws each of ``slices`` slices'
``entries_per_slice`` entries (rows and columns by popularity;
``generator.graph`` normalises them) and the edges' classes.
"""

from __future__ import annotations

import torch

from benchmark import generator, program

SEEDED = True


def make(p: dict, labels: dict, seed: int, device) -> generator.Graph:
    N, T, E = p["nodes"], p["slices"], p["entries_per_slice"]
    u = (torch.arange(N, dtype=torch.float64, device=device) + 0.5) / N
    quantiles = (1.0 - u) ** (-1.0 / p["pareto_shape"])
    pop = torch.empty_like(quantiles)
    layout = generator.generator(p["layout_seed"], 1, device)
    pop[torch.randperm(N, generator=layout, device=device)] = quantiles
    g = generator.generator(seed, 1, device)
    cdf = torch.cumsum(pop, 0)
    cdf /= cdf[-1].clone()

    def draw(n):
        x = torch.rand(n, generator=g, device=device, dtype=torch.float64)
        return torch.clamp(torch.searchsorted(cdf, x), max=N - 1)

    r, c = draw(T * E), draw(T * E)
    t = torch.arange(T, device=device).repeat_interleave(E)
    return generator.graph(T, N, t, r, c, labels, g, device, edges_from=layout)


def port(cell, seed: int, device, spans, data_dir=None):
    graph = make(cell.traffic["graph"], cell.traffic["labels"], seed, device)
    return program.build_generated(cell, graph, device, spans), graph


def reference_windows(cell, graph, device, data_dir=None) -> dict:
    return generator.reference_windows(cell.cfg, graph)

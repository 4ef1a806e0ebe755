"""The work of one training epoch of WD-GCN, counted from the cell's inputs
and widths.

The loss reads the LSTM's output only at the labelled edges' endpoints,
so the work these inputs need is the scan of each endpoint node up to
the last slice at which it is read (``node_steps`` rows), the GCN layer
on those rows, the readout, and their gradients. The propagation C ⊛ X
is parameter-free and done once at set-up; the readout U is frozen.
"""

from __future__ import annotations

import torch

from benchmark.cost import common as c


def counts(win) -> dict:
    N = win.n_nodes
    e = win.edges
    nodes = torch.cat([e[1], e[2]])
    last = torch.full((N,), -1, dtype=torch.long, device=nodes.device)
    last.scatter_reduce_(0, nodes, torch.cat([e[0], e[0]]), reduce="amax")
    ends = torch.unique(torch.cat([e[0] * N + e[1], e[0] * N + e[2]]))
    return {"edges": int(e.shape[1]), "ends": int(ends.numel()),
            "node_steps": int((last + 1).sum()), "rows": win.n_slices * N,
            "f0": int(win.X.shape[-1])}


def epoch_ops(n: dict, cfg: dict, n_classes: int) -> list[c.Op]:
    (f1,) = cfg["hidden_feat"]
    f0, E, ends, S = n["f0"], n["edges"], n["ends"], n["node_steps"]
    gates = 4 * f1
    n_params = f0 * f1 + 2 * f1 * gates + gates
    scan_flops = 2.0 * 2 * S * f1 * gates + 10.0 * S * f1
    return [
        c.matmul("gcn", S, f0, f1),
        c.elementwise("relu", S * f1),
        c.Op("lstm", scan_flops, c.WORD * (S * f1 + ends * f1 + 2 * f1 * gates + gates)),
        c.readout("readout", E, ends, f1, n_classes),
        *c.cross_entropy(E, n_classes),
        c.readout_grads("readout_grad", E, ends, f1, n_classes, weight_grad=False),
        c.Op("lstm_grad", 2 * scan_flops + 2.0 * 2 * S * f1 * gates,
             c.WORD * (S * f1 + ends * f1 + S * f1 + 2 * f1 * gates + gates)),
        c.elementwise("relu_grad", S * f1, reads=2),
        c.matmul_grads("gcn_grad", S, f0, f1, input_grad=False),
        c.sgd_momentum(n_params),
    ]


def kernel_products(n: dict, cfg: dict) -> list[c.Op]:
    """The sparse product a step hands to a hand-written kernel: the
    readout's backward, the 2E endpoint gradients added into the dense
    (T·N, F) gradient of the LSTM's output."""
    (f1,) = cfg["hidden_feat"]
    return [c.scatter_rows("readout_scatter", 2 * n["edges"], n["rows"], f1)]

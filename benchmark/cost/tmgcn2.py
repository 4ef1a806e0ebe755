"""The work of one training epoch of the 2-layer TM-GCN, counted from the
cell's inputs and widths.

The loss reads layer 2 only at the labelled edges' endpoint rows, so the
work these inputs need is layer 2 on those rows (the propagated tensor's
entries in them) and layer 1 on the rows those entries read. That count
is the same whatever operator, packing or kernel computes it; the first
propagation Ct ⊛ (M ×₁ X) is parameter-free and done once at set-up.
"""

from __future__ import annotations

import torch

from benchmark.cost import common as c


def counts(win) -> dict:
    """Sizes of the work, from a window's entries and labelled edges."""
    N = win.n_nodes
    e = win.edges
    ends = torch.unique(torch.cat([e[0] * N + e[1], e[0] * N + e[2]]))
    member = torch.isin(win.rows, ends)
    return {"edges": int(e.shape[1]), "ends": int(ends.numel()), "nnz": int(member.sum()),
            "used": int(torch.unique(win.cols[member]).numel()), "f0": int(win.X.shape[-1])}


def epoch_ops(n: dict, cfg: dict, n_classes: int) -> list[c.Op]:
    f1, f2 = cfg["hidden_feat"]
    f0, E, ends, nnz, used = n["f0"], n["edges"], n["ends"], n["nnz"], n["used"]
    n_params = f0 * f1 + f1 * f2 + 2 * f2 * n_classes
    return [
        c.matmul("layer1", used, f0, f1),
        c.elementwise("nonlin", used * f1),
        c.spmm("layer2", nnz, ends, used, f1),
        c.matmul("layer2_w", ends, f1, f2),
        c.readout("readout", E, ends, f2, n_classes),
        *c.cross_entropy(E, n_classes),
        c.readout_grads("readout_grad", E, ends, f2, n_classes),
        c.matmul_grads("layer2_w_grad", ends, f1, f2),
        c.spmm("layer2_grad", nnz, used, ends, f1),
        c.elementwise("nonlin_grad", used * f1, reads=2),
        c.matmul_grads("layer1_grad", used, f0, f1, input_grad=False),
        c.sgd_momentum(n_params),
    ]


def kernel_products(n: dict, cfg: dict) -> list[c.Op]:
    """The sparse products a step hands to a hand-written kernel: layer 2's
    propagation at the endpoint rows and its transpose in the backward."""
    f1 = cfg["hidden_feat"][0]
    return [c.spmm("layer2", n["nnz"], n["ends"], n["used"], f1),
            c.spmm("layer2_grad", n["nnz"], n["used"], n["ends"], f1)]

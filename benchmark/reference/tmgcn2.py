"""The 2-layer TM-GCN (IBM/TM-GCN EmbeddingGCN2, condensed W, no M⁻¹):

    AtXt = Ct ⊛ (M ×₁ X)                      (parameter-free, once)
    Y    = nonlin(AtXt · W1)
    Z    = (Ct ⊛ Y) · W2                      (every row of every slice)
    logits(k, i, j) = [Z[k, i], Z[k, j]] · U

in plain float32, with the readout U split into its source and target
halves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.ops import mm, spmm

NONLIN = {"selu": F.selu, "relu": torch.relu}


def param_shapes(f0: int, hidden: list[int], n_classes: int) -> dict:
    f1, f2 = hidden
    return {"params": {"W1": (f0, f1), "W2": (f1, f2), "U": (2 * f2, n_classes)},
            "buffers": {}}


def prepare(win, cfg: dict, tf32: bool = False) -> dict:
    T, N, F0 = win.X.shape
    MX = mm(win.M, win.X.reshape(T, N * F0), tf32).reshape(T * N, F0)
    return {"AtXt": spmm(win.rows, win.cols, win.vals, MX, T * N, tf32)}


def logits(params: dict, buffers: dict, win, cache: dict, cfg: dict,
           tf32: bool = False) -> torch.Tensor:
    N = win.n_nodes
    rows = win.n_slices * N
    Y = NONLIN[cfg["nonlin2"]](mm(cache["AtXt"], params["W1"], tf32))
    Z = mm(spmm(win.rows, win.cols, win.vals, Y, rows, tf32), params["W2"], tf32)
    f2 = params["W2"].shape[1]
    e = win.edges
    src, trg = e[0] * N + e[1], e[0] * N + e[2]
    return mm(Z[src], params["U"][:f2], tf32) + mm(Z[trg], params["U"][f2:], tf32)

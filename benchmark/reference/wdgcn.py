"""WD-GCN (IBM/TM-GCN wd_gcn_functions.py WD_GCN): one GCN layer, then one
LSTM cell shared by every node scanned over the slices:

    AX  = C ⊛ X                               (parameter-free, once)
    Y   = relu(AX · W)
    z_g = Y[t] · W_g + b_g + h · U_g          for the gates f, j, o, c
    c   = σ(z_j) σ(z_c) + σ(z_f) c,   h = σ(z_o) tanh(c),   Z[t] = h
    logits(k, i, j) = [Z[k, i], Z[k, j]] · U

as the reference has it: the candidate takes a sigmoid, and the readout U
and the initial h and c are frozen random buffers.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops import mm, spmm

GATES = "fjoc"


def param_shapes(f0: int, hidden: list[int], n_classes: int) -> dict:
    (f1,) = hidden
    lstm = {f"{w}{g}": (f1, f1) for w in "WU" for g in GATES}
    lstm.update({f"b{g}": (f1,) for g in GATES})
    return {"params": {"W": (f0, f1), "lstm": lstm},
            "buffers": {"U": (2 * f1, n_classes), "h_init": (f1,), "c_init": (f1,)}}


def prepare(win, cfg: dict, tf32: bool = False) -> dict:
    T, N, F0 = win.X.shape
    return {"AX": spmm(win.rows, win.cols, win.vals, win.X.reshape(T * N, F0), T * N, tf32)}


def logits(params: dict, buffers: dict, win, cache: dict, cfg: dict,
           tf32: bool = False) -> torch.Tensor:
    T, N = win.n_slices, win.n_nodes
    p = params["lstm"]
    f1 = params["W"].shape[1]
    Y = torch.relu(mm(cache["AX"], params["W"], tf32)).reshape(T, N, f1)
    Wg = torch.cat([p[f"W{g}"] for g in GATES], dim=1)
    Ug = torch.cat([p[f"U{g}"] for g in GATES], dim=1)
    bg = torch.cat([p[f"b{g}"] for g in GATES])
    h = buffers["h_init"].expand(N, f1)
    c = buffers["c_init"].expand(N, f1)
    out = []
    for t in range(T):
        z = mm(Y[t], Wg, tf32) + bg + mm(h, Ug, tf32)
        f, j, o, cand = torch.sigmoid(z).split(f1, dim=1)
        c = j * cand + f * c
        h = o * torch.tanh(c)
        out.append(h)
    Z = torch.stack(out).reshape(T * N, f1)
    e = win.edges
    src, trg = e[0] * N + e[1], e[0] * N + e[2]
    U = buffers["U"]
    return mm(Z[src], U[:f1], tf32) + mm(Z[trg], U[f1:], tf32)

"""The reference's inputs, worked out from raw edges.

``konect_windows`` follows IBM/TM-GCN's preprocessing (read_data.py) from a
KONECT edge file: one slice per unique timestamp (or fixed-width bins),
A_labels (weights summed per slice and pair), A (ones, duplicates summed),
B = (A + Aᵀ)/2, each edge alive ``edge_life`` slices, C = D^-1/2 (B + I)
D^-1/2, empty slices up to the windows' total, the three windows, and for
TM-GCN Ct = M ×₁ C of each window. Features are the [in, out] degrees of
ones on A_labels' support; labels are sign(weight) + 1 (3 classes) or
sign(weight) != -1 (2 classes). ``graph_window`` takes a generated graph
as it is: its entries are the tensor the model propagates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.ops import coalesce, degree_features, m_matrix


@dataclasses.dataclass
class Window:
    """One window as the reference's models read it. ``rows``/``cols`` are
    flat (t·N + node) indices of the propagated tensor's entries."""

    n_slices: int
    n_nodes: int
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor  # float32
    X: torch.Tensor  # (T, N, F0) float32
    M: torch.Tensor | None  # (T, T) float32, TM-GCN only
    edges: torch.Tensor  # (3, E) [slice, src, trg]
    target: torch.Tensor  # (E,) class
    eval_mask: torch.Tensor  # (E,) scored at evaluation


def load_konect(path, columns=(0, 1, 2, 3), skiprows: int = 1, comments: str = "%",
                time_delta: float | None = None) -> dict:
    """Raw edges of a KONECT file: 0-based src, dst, weight, slice id."""
    arr = np.loadtxt(path, skiprows=skiprows, comments=comments, ndmin=2)[:, list(columns)]
    src, dst, w, ts = (arr[:, i] for i in range(4))
    one_based = src.min() >= 1 and dst.min() >= 1
    n_nodes = int(max(src.max(), dst.max())) + (0 if one_based else 1)
    if one_based:
        src, dst = src - 1, dst - 1
    if time_delta is None:
        uniq = np.unique(ts)
        n_slices, sid = len(uniq), np.searchsorted(uniq, ts)
        keep = np.ones(len(ts), bool)
    else:
        n_slices = int(np.floor((ts.max() - ts.min()) / time_delta))
        keep = ts < ts.min() + n_slices * time_delta
        sid = np.floor((ts - ts.min()) / time_delta)
    return {"src": src[keep].astype(np.int64), "dst": dst[keep].astype(np.int64),
            "weight": w[keep], "slice": sid[keep].astype(np.int64),
            "n_nodes": n_nodes, "n_slices": n_slices}


def window_bounds(s_train: int, s_val: int, s_test: int, same_block: bool) -> dict:
    """[start, end) slices of train, val and test: shifted windows of width
    s_train (same_block), or disjoint ones."""
    if same_block:
        return {"train": (0, s_train), "val": (s_val, s_train + s_val),
                "test": (s_val + s_test, s_train + s_val + s_test)}
    return {"train": (0, s_train), "val": (s_train, s_train + s_val),
            "test": (s_train + s_val, s_train + s_val + s_test)}


def _split(key, N):
    NN = N * N
    return key // NN, (key % NN) // N, key % N


def normalized_tensor(t, s, d, n_slices: int, N: int, edge_life: int, device):
    """C of read_data.py: (t, r, c, v float64) of D^-1/2 (B + I) D^-1/2,
    B the symmetrised counts, each edge alive ``edge_life`` slices."""
    NN = N * N
    ak, av = coalesce(t * NN + s * N + d, torch.ones(len(t), device=device))
    at, ar, ac = _split(ak, N)
    bk, bv = coalesce(torch.cat([ak, at * NN + ac * N + ar]), torch.cat([av, av]) * 0.5)
    bt, br, bc = _split(bk, N)
    lt, lr, lc, lv = [], [], [], []
    for o in range(edge_life):
        keep = bt + o < n_slices
        lt.append(bt[keep] + o), lr.append(br[keep]), lc.append(bc[keep]), lv.append(bv[keep])
    eye_t = torch.arange(n_slices, device=device).repeat_interleave(N)
    eye_n = torch.arange(N, device=device).repeat(n_slices)
    ck, cv = coalesce(torch.cat(lt + [eye_t]) * NN + torch.cat(lr + [eye_n]) * N
                      + torch.cat(lc + [eye_n]),
                      torch.cat(lv + [torch.ones(len(eye_t), dtype=torch.float64, device=device)]))
    ct, cr, cc = _split(ck, N)
    deg = torch.zeros(n_slices * N, dtype=torch.float64, device=device)
    deg.index_add_(0, ct * N + cr, cv)
    cv = cv / torch.sqrt(deg[ct * N + cr] * deg[ct * N + cc])
    return ct, cr, cc, cv


def m_transformed(t, r, c, v, M: torch.Tensor, N: int):
    """Ct[s] = sum over u of M[s, u] C[u], coalesced (float64 values)."""
    T = M.shape[0]
    Md = M.to(v.device)
    ks, vs = [], []
    for d in range(T):
        w = torch.diagonal(Md, -d)  # M[u + d, u]
        if not bool(torch.any(w != 0)):
            continue
        keep = t + d < T
        tu = t[keep]
        ks.append((tu + d) * (N * N) + r[keep] * N + c[keep])
        vs.append(v[keep] * w[tu])
    k, val = coalesce(torch.cat(ks), torch.cat(vs))
    return (*_split(k, N), val)


def konect_windows(raw: dict, s_train: int, s_val: int, s_test: int, same_block: bool,
                   n_classes: int, m_diagonals: int | None, m_weight: str = "inverse",
                   edge_life: int = 10, device="cpu") -> dict[str, Window]:
    """The three windows of a KONECT dataset. ``m_diagonals`` None: the
    untransformed C (the baselines); else Ct with M's band."""
    N = raw["n_nodes"]
    T_raw = raw["n_slices"]
    total = s_train + s_val + s_test
    NN = N * N
    t = torch.as_tensor(raw["slice"], device=device)
    s = torch.as_tensor(raw["src"], device=device)
    d = torch.as_tensor(raw["dst"], device=device)
    w = torch.as_tensor(raw["weight"], device=device)
    lk, lv = coalesce(t * NN + s * N + d, w)
    lt, ls, ld = _split(lk, N)
    # Degree features of ones on A_labels' support, empty slices up to total.
    X = degree_features(lt, ls, ld, torch.ones_like(lv), max(T_raw, total), N)
    ct, cr, cc, cv = normalized_tensor(t, s, d, T_raw, N, edge_life, device)
    sign = torch.sign(lv.to(torch.float32))
    label = (sign + 1).long() if n_classes == 3 else (sign != -1).long()
    M = None
    if m_diagonals is not None:
        M = m_matrix(s_train, m_diagonals, m_weight)
    out = {}
    for name, (a, b) in window_bounds(s_train, s_val, s_test, same_block).items():
        m = (ct >= a) & (ct < b)
        wt, wr, wc, wv = ct[m] - a, cr[m], cc[m], cv[m]
        if M is not None:
            wt, wr, wc, wv = m_transformed(wt, wr, wc, wv, M, N)
        em = (lt >= a) & (lt < b)
        edges = torch.stack([lt[em] - a, ls[em], ld[em]])
        if name == "train" or not same_block:
            mask = torch.ones(edges.shape[1], dtype=torch.bool, device=device)
        else:
            mask = edges[0] >= s_train - (s_val if name == "val" else s_test)
        out[name] = Window(
            n_slices=b - a, n_nodes=N, rows=wt * N + wr, cols=wt * N + wc,
            vals=wv.to(torch.float32), X=X[a:b].to(torch.float32),
            M=None if M is None else M.to(device=device, dtype=torch.float32),
            edges=edges, target=label[em], eval_mask=mask,
        )
    return out


def graph_window(t, r, c, v, n_slices: int, n_nodes: int, M: torch.Tensor | None,
                 edges: torch.Tensor, target: torch.Tensor) -> Window:
    """A generated graph's one window: its entries as they are, the
    weighted [in, out] degrees as features, every edge scored."""
    X = degree_features(t, r, c, v, n_slices, n_nodes).to(torch.float32)
    return Window(
        n_slices=n_slices, n_nodes=n_nodes, rows=t * n_nodes + r, cols=t * n_nodes + c,
        vals=v.to(torch.float32), X=X,
        M=None if M is None else M.to(device=v.device, dtype=torch.float32),
        edges=edges, target=target,
        eval_mask=torch.ones(edges.shape[1], dtype=torch.bool, device=v.device),
    )

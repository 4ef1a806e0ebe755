"""Offline preprocessing: raw edge lists -> normalized temporal tensors.

Port of tmgcn_tpu.preprocess.pipeline (host-side numpy/scipy, unchanged
in substance, so both packages build identical artifacts).

Re-implements (vectorized, seedable, host-side) the behavior of the
reference preprocessing pipeline — capability reference: IBM/TM-GCN
TensorGCN-master/read_data.m (canonical MATLAB), read_data.py and
full_read_data.py (PyTorch ports). Stages:

    1. time binning: slice id = floor((ts - t0) / time_delta), or one
       slice per unique timestamp (Chess/AMLSim) (read_data.py:73-83)
    2. A (binary) and A_labels (weighted) temporal tensors  (:85-86)
    3. per-slice symmetrization B = (A + A^T) / 2           (:88-109)
    4. edge life: B[t] += B_orig[t-w+1..t]                  (:116-125)
    5. normalization C = D^{-1/2} (B + I) D^{-1/2}          (:130-164)
    6. overlapping windows C_train/val/test of width S_train(:174-188)
    7. M-product Ct_* = M ×₁ C_*                            (:204-223)

Everything operates on scipy CSR per slice and returns TemporalCOO
(host numpy) containers; no accelerator involvement.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from tmgcn_torch.core.mmatrix import make_m_dct, make_m_matrix
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.ops.mtransform import m_transform_coo


@dataclasses.dataclass(frozen=True)
class RawEdges:
    """Parsed raw data: (E,) arrays src/dst (0-based), weight, slice id."""

    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    slice_id: np.ndarray
    n_nodes: int
    n_slices: int


def bin_edges(
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,
    timestamp: np.ndarray,
    time_delta: float | None,
    n_slices_cap: int | None = None,
    one_based_nodes: bool = True,
) -> RawEdges:
    """Assign each edge to a time slice.

    time_delta=None -> one slice per unique timestamp (Chess/AMLSim
    convention); otherwise fixed-width bins from the minimum timestamp,
    truncated to ``floor((max-min)/delta)`` slices like the reference.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float64)
    timestamp = np.asarray(timestamp, dtype=np.float64)
    if one_based_nodes:
        n_nodes = int(max(src.max(), dst.max()))
        src = src - 1
        dst = dst - 1
    else:
        n_nodes = int(max(src.max(), dst.max())) + 1

    if time_delta is None:
        uniq = np.unique(timestamp)
        n_slices = len(uniq)
        slice_id = np.searchsorted(uniq, timestamp)
        keep = np.ones(len(src), dtype=bool)
    else:
        t0 = timestamp.min()
        n_slices = int(np.floor((timestamp.max() - t0) / time_delta))
        keep = timestamp < t0 + n_slices * time_delta
        slice_id = np.floor((timestamp - t0) / time_delta).astype(np.int64)
    if n_slices_cap is not None:
        n_slices = min(n_slices, n_slices_cap)
        keep &= slice_id < n_slices
    return RawEdges(
        src=src[keep],
        dst=dst[keep],
        weight=weight[keep],
        slice_id=slice_id[keep],
        n_nodes=n_nodes,
        n_slices=n_slices,
    )


def _slice_csrs(raw: RawEdges, values: np.ndarray) -> list[sp.csr_matrix]:
    """Per-slice CSR matrices (duplicates summed, like coalesce)."""
    N = raw.n_nodes
    out = []
    for k in range(raw.n_slices):
        m = raw.slice_id == k
        out.append(
            sp.coo_matrix((values[m], (raw.src[m], raw.dst[m])), shape=(N, N)).tocsr()
        )
    return out


def build_tensors(raw: RawEdges, pad_multiple: int = 128) -> tuple[TemporalCOO, TemporalCOO]:
    """A (binary, duplicates summed) and A_labels (weighted) tensors."""
    ones = np.ones_like(raw.weight)
    A = _csr_list_to_coo([m for m in _slice_csrs(raw, ones)], raw.n_nodes, pad_multiple)
    A_labels = _csr_list_to_coo(
        [m for m in _slice_csrs(raw, raw.weight)], raw.n_nodes, pad_multiple
    )
    return A, A_labels


def _csr_list_to_coo(
    csrs: list[sp.spmatrix], n_nodes: int, pad_multiple: int = 128
) -> TemporalCOO:
    slices = []
    for m in csrs:
        c = m.tocoo()
        slices.append((c.row, c.col, c.data))
    return TemporalCOO.from_slices(slices, n_nodes, pad_multiple=pad_multiple)


def _coo_to_csr_list(A: TemporalCOO) -> list[sp.csr_matrix]:
    rows = np.asarray(A.rows)
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals, dtype=np.float64)
    nnz = np.asarray(A.nnz)
    N = A.n_nodes
    return [
        sp.coo_matrix(
            (vals[k, : nnz[k]], (rows[k, : nnz[k]], cols[k, : nnz[k]])), shape=(N, N)
        ).tocsr()
        for k in range(A.n_slices)
    ]


def symmetrize(A: TemporalCOO, pad_multiple: int = 128) -> TemporalCOO:
    """B[k] = (A[k] + A[k]^T) / 2."""
    csrs = _coo_to_csr_list(A)
    return _csr_list_to_coo(
        [(m + m.T) * 0.5 for m in csrs], A.n_nodes, pad_multiple
    )


def apply_edge_life(
    A: TemporalCOO, window: int, pad_multiple: int = 128
) -> TemporalCOO:
    """Each edge persists ``window`` slices: B[t] = Σ_{s=t-w+1..t} A[s]."""
    csrs = _coo_to_csr_list(A)
    T = len(csrs)
    out = []
    acc = None
    for t in range(T):
        lo = max(0, t - window + 1)
        # Sliding-window sum (recomputed per step; nnz stays modest).
        acc = csrs[lo]
        for s in range(lo + 1, t + 1):
            acc = acc + csrs[s]
        out.append(acc)
    return _csr_list_to_coo(out, A.n_nodes, pad_multiple)


def normalize_laplacian(
    A: TemporalCOO, pad_multiple: int = 128, kind: str = "sym"
) -> TemporalCOO:
    """Per-slice normalized adjacency with self-loops.

    kind="sym": C = D^{-1/2}(A+I)D^{-1/2} (the pipeline default,
    read_data.py:130-164); kind="col": column-stochastic C = (A+I)Dc^{-1}
    (the reference's alternative normalization_type=0,
    embedding_help_functions.py:36-59); kind="sym_mean": symmetrize by
    (A+A^T)/2 first then sym-normalize (normalization_type=1, :61-100).
    """
    csrs = _coo_to_csr_list(A)
    N = A.n_nodes
    eye = sp.identity(N, format="csr")
    out = []
    for m in csrs:
        if kind == "sym_mean":
            m = (m + m.T) * 0.5
        c = m + eye
        if kind == "col":
            col = np.asarray(c.sum(axis=0)).ravel()
            out.append(c @ sp.diags(1.0 / col))
        elif kind in ("sym", "sym_mean"):
            deg = np.asarray(c.sum(axis=1)).ravel()
            dinv = 1.0 / np.sqrt(deg)
            D = sp.diags(dinv)
            out.append(D @ c @ D)
        else:
            raise ValueError(f"unknown normalization kind: {kind!r}")
    return _csr_list_to_coo(out, N, pad_multiple)


def filter_nodes_by_column_sum(
    raw: RawEdges, min_sum: float
) -> RawEdges:
    """Drop nodes whose total incoming weight is below ``min_sum``.

    Mirrors the reference's wikiconflict filtering (read_data.m:154-170);
    kept nodes are renumbered densely.
    """
    col_sum = np.zeros(raw.n_nodes)
    np.add.at(col_sum, raw.dst, np.abs(raw.weight))
    keep_nodes = np.nonzero(col_sum >= min_sum)[0]
    remap = -np.ones(raw.n_nodes, dtype=np.int64)
    remap[keep_nodes] = np.arange(len(keep_nodes))
    keep = (remap[raw.src] >= 0) & (remap[raw.dst] >= 0)
    return RawEdges(
        src=remap[raw.src[keep]],
        dst=remap[raw.dst[keep]],
        weight=raw.weight[keep],
        slice_id=raw.slice_id[keep],
        n_nodes=len(keep_nodes),
        n_slices=raw.n_slices,
    )


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    s_train: int
    s_val: int
    s_test: int
    time_delta: float | None  # None -> one slice per unique timestamp
    edge_life: bool = True
    edge_life_window: int = 10
    make_symmetric: bool = True
    n_diagonals: int = 20
    m_weight: str = "inverse"  # read_data.m M_choice=2
    m_row_normalize: bool = False
    m_family: str = "banded"  # "banded" | "dct" (the paper's dense alternative)
    normalization: str = "sym"  # see normalize_laplacian
    min_column_sum: float | None = None  # wikiconflict filtering
    pad_multiple: int = 128


@dataclasses.dataclass(frozen=True)
class PreprocessedData:
    """The full preprocessing artifact (windows of width s_train)."""

    A: TemporalCOO
    A_labels: TemporalCOO
    C: TemporalCOO  # full normalized tensor, all slices
    C_windows: dict[str, TemporalCOO]
    Ct_windows: dict[str, TemporalCOO]  # M-transformed
    M: np.ndarray
    config: PreprocessConfig


def preprocess(raw: RawEdges, cfg: PreprocessConfig) -> PreprocessedData:
    """Run the full pipeline on parsed raw edges."""
    if cfg.min_column_sum is not None:
        raw = filter_nodes_by_column_sum(raw, cfg.min_column_sum)
    A, A_labels = build_tensors(raw, cfg.pad_multiple)
    B = symmetrize(A, cfg.pad_multiple) if cfg.make_symmetric else A
    if cfg.edge_life:
        B = apply_edge_life(B, cfg.edge_life_window, cfg.pad_multiple)
    C = normalize_laplacian(B, cfg.pad_multiple, kind=cfg.normalization)

    total = cfg.s_train + cfg.s_val + cfg.s_test
    if C.n_slices < total:
        # Extend with empty slices (reference pads TTT up to the total).
        csrs = _coo_to_csr_list(C)
        csrs += [sp.csr_matrix((C.n_nodes, C.n_nodes))] * (total - C.n_slices)
        C = _csr_list_to_coo(csrs, C.n_nodes, cfg.pad_multiple)

    T = cfg.s_train
    bounds = {
        "train": (0, T),
        "val": (cfg.s_val, T + cfg.s_val),
        "test": (cfg.s_val + cfg.s_test, T + cfg.s_val + cfg.s_test),
    }
    C_windows = {w: C.slice_window(a, b) for w, (a, b) in bounds.items()}
    if cfg.m_family == "dct":
        M = make_m_dct(T)
    else:
        M = make_m_matrix(
            T, cfg.n_diagonals, weight=cfg.m_weight, row_normalize=cfg.m_row_normalize
        )
    Ct_windows = {
        w: m_transform_coo(Cw, M, pad_multiple=cfg.pad_multiple)
        for w, Cw in C_windows.items()
    }
    return PreprocessedData(
        A=A,
        A_labels=A_labels,
        C=C,
        C_windows=C_windows,
        Ct_windows=Ct_windows,
        M=M,
        config=cfg,
    )

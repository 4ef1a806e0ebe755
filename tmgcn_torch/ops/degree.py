"""Degree-based node features (port of tmgcn_tpu.ops.degree).

Capability reference: IBM/TM-GCN builds each node's 2-feature signal as
[in-degree, out-degree] per slice via ``t.sparse.sum(A, 1/2)`` (e.g.
TensorGCN-master/embedding_help_functions.py:597-609). The port computes
them host-side during data preparation.
"""

from __future__ import annotations

import numpy as np

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.utils.profiling import spanned


@spanned("data.features")
def degree_features_np(A: TemporalCOO) -> np.ndarray:
    """(T, N, 2) float64: [:, :, 0] = column sums, [:, :, 1] = row sums.

    Column sums match ``t.sparse.sum(A, 1)`` (in-degree of node j); row
    sums match ``t.sparse.sum(A, 2)``.
    """
    rows = np.asarray(A.rows)
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals, dtype=np.float64)
    T = A.n_slices
    out = np.zeros((T, A.n_nodes, 2))
    for k in range(T):
        np.add.at(out[k, :, 0], cols[k], vals[k])
        np.add.at(out[k, :, 1], rows[k], vals[k])
    return out


@spanned("data.features")
def spectral_features_np(A: TemporalCOO, k: int = 2) -> np.ndarray:
    """(T, N, k) float64 spectral node features, constant across slices.

    The top-k eigenvectors (after the trivial leading one) of the
    symmetrically normalized time-aggregated adjacency
    D^{-1/2}(ΣₜAₜ)D^{-1/2}, scaled by √N: the JAX package's community
    feature option for SBM link prediction (the reference has none; its
    degree features carry no community signal). The same dense eigh, and
    the same order and sign of the eigenvectors, as the JAX package's.
    Host-side, once during data preparation.
    """
    rows = np.asarray(A.rows)
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals, dtype=np.float64)
    nnz = np.asarray(A.nnz)
    N, T = A.n_nodes, A.n_slices
    agg = np.zeros((N, N))
    for t in range(T):
        n = int(nnz[t])
        np.add.at(agg, (rows[t][:n], cols[t][:n]), vals[t][:n])
    agg = (agg + agg.T) / 2
    deg = agg.sum(1)
    inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    norm = inv_sqrt[:, None] * agg * inv_sqrt[None, :]
    _, eigvecs = np.linalg.eigh(norm)
    # The largest eigenpair is the trivial sqrt-degree direction; the next
    # k carry the block structure, largest first.
    vecs = eigvecs[:, -(k + 1) : -1][:, ::-1] * np.sqrt(N)
    return np.broadcast_to(vecs[None], (T, N, k)).copy()

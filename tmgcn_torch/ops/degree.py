"""Degree-based node features (port of tmgcn_tpu.ops.degree).

Capability reference: IBM/TM-GCN builds each node's 2-feature signal as
[in-degree, out-degree] per slice via ``t.sparse.sum(A, 1/2)`` (e.g.
TensorGCN-master/embedding_help_functions.py:597-609). The port computes
them host-side during data preparation.
"""

from __future__ import annotations

import numpy as np

from tmgcn_torch.core.sparse import TemporalCOO


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

"""The M-transform: temporal mixing via a T x T matrix (port of
tmgcn_tpu.ops.mtransform).

``m_transform(M, X)`` computes the mode-1 tensor-matrix product
``Xt = M ×₁ X``, i.e. ``Xt[s] = Σ_t M[s, t] X[t]`` (capability reference:
``t.matmul(self.M, X.reshape(T, -1)).reshape(...)`` in IBM/TM-GCN,
TensorGCN-master/embedding_help_functions.py:204). On the card this is one
dense (T, T) x (T, N*F) product, left to ``torch.matmul``.

``m_transform_coo`` applies M to a temporal sparse tensor host-side in
scipy (the offline artifact Ct, reference func_MProduct
read_data.py:204-223).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from tmgcn_torch.core.sparse import TemporalCOO


def m_transform(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Dense M-transform: (T, T) x (T, ...) -> (T, ...) along axis 0."""
    T = X.shape[0]
    flat = X.reshape(T, -1)
    out = torch.matmul(M.to(X.dtype), flat)
    return out.reshape(X.shape)


def m_transform_inverse(
    M: torch.Tensor, X: torch.Tensor, assume_lower_triangular: bool | None = None
) -> torch.Tensor:
    """Apply M^{-1} along the time axis.

    Banded (lower-triangular) M uses a triangular solve; dense families
    (DCT) need a general solve. Auto-detects from M unless the flag is
    given.
    """
    T = X.shape[0]
    flat = X.reshape(T, -1)
    Mx = M.to(X.dtype)
    lower = assume_lower_triangular
    if lower is None:
        upper = torch.triu(Mx, diagonal=1)
        lower = bool(torch.allclose(upper, torch.zeros_like(upper)))
    if lower:
        out = torch.linalg.solve_triangular(Mx, flat, upper=False)
    else:
        out = torch.linalg.solve(Mx, flat)
    return out.reshape(X.shape)


def m_transform_coo(
    C: TemporalCOO, M: np.ndarray, pad_multiple: int = 128
) -> TemporalCOO:
    """Sparse M-transform (host-side): Ct[s] = Σ_t M[s, t] C[t].

    Each output slice is a weighted union of the input slices in M's band,
    accumulated in scipy CSR, then repacked padded and sorted.
    """
    M = np.asarray(M)
    T = C.n_slices
    N = C.n_nodes
    rows = np.asarray(C.rows)
    cols = np.asarray(C.cols)
    vals = np.asarray(C.vals, dtype=np.float64)
    nnz = np.asarray(C.nnz)

    csr = []
    for k in range(T):
        n = int(nnz[k])
        csr.append(
            sp.coo_matrix((vals[k, :n], (rows[k, :n], cols[k, :n])), shape=(N, N)).tocsr()
        )

    out_slices = []
    for s in range(T):
        acc = sp.csr_matrix((N, N), dtype=np.float64)
        for t in np.nonzero(M[s])[0]:
            acc = acc + M[s, t] * csr[int(t)]
        acc = acc.tocoo()
        out_slices.append((acc.row, acc.col, acc.data))

    return TemporalCOO.from_slices(
        out_slices, N, dtype=C.vals.dtype, pad_multiple=pad_multiple
    )

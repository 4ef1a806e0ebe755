"""Constructors of the temporal mixing matrix M.

M is the heart of the tensor M-product: a T x T lower-triangular banded
matrix mixing each time slice with its ``n_diagonals - 1`` predecessors.
The reference codebase uses three slightly different conventions (see
SURVEY.md §2.1); they are all instances of one parameterized function:

  * MATLAB pipeline (read_data.m:116-127): weight 1/(d+1) on diagonal
    offset d, no row normalization       -> weight="inverse", row_normalize=False
  * Python pipeline (read_data.py:55-62): weight 1 on every diagonal,
    then row-normalize                   -> weight="ones", row_normalize=True
  * SBM/SEIR scripts (SBM_our.py:88-96): weight 1/(d+1), no row norm
                                         -> weight="inverse", row_normalize=False

An orthonormal DCT-II family is also provided — the paper's alternative
M choice — which is dense rather than banded.
"""

from __future__ import annotations

import numpy as np


def make_m_matrix(
    n_slices: int,
    n_diagonals: int = 20,
    weight: str = "inverse",
    row_normalize: bool = False,
    dtype=np.float64,
) -> np.ndarray:
    """Banded lower-triangular mixing matrix.

    Args:
        n_slices: T, the window length.
        n_diagonals: number of diagonals in the band (main + below).
        weight: "inverse" (diagonal offset d weighted 1/(d+1)) or "ones".
        row_normalize: divide each row by the sum of its absolute values.
    """
    if weight not in ("inverse", "ones"):
        raise ValueError(f"unknown weight scheme: {weight!r}")
    T = n_slices
    M = np.zeros((T, T), dtype=dtype)
    for d in range(min(n_diagonals, T)):
        w = 1.0 / (d + 1) if weight == "inverse" else 1.0
        idx = np.arange(T - d)
        M[idx + d, idx] = w
    if row_normalize:
        M = M / np.sum(np.abs(M), axis=1, keepdims=True)
    return M


def make_m_dct(n_slices: int, dtype=np.float64) -> np.ndarray:
    """Orthonormal DCT-II mixing matrix (dense alternative M family)."""
    T = n_slices
    k = np.arange(T)[:, None]
    n = np.arange(T)[None, :]
    M = np.cos(np.pi * (2 * n + 1) * k / (2 * T))
    M *= np.sqrt(2.0 / T)
    M[0, :] *= np.sqrt(0.5)
    return M.astype(dtype)


def band_offsets(M: np.ndarray) -> tuple[int, int]:
    """Return (lower_bandwidth, upper_bandwidth) of a banded matrix.

    Used by the time-sharded M-transform to size halo exchanges: a slice
    block only needs ``lower`` predecessor and ``upper`` successor slices.
    """
    T = M.shape[0]
    lower = 0
    upper = 0
    for i in range(T):
        nz = np.nonzero(M[i])[0]
        if nz.size:
            lower = max(lower, i - int(nz.min()))
            upper = max(upper, int(nz.max()) - i)
    return lower, upper

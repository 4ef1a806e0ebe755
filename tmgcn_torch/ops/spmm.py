"""Batched sparse-times-dense matmul over the temporal axis (port of
tmgcn_tpu.ops.spmm).

``spmm(A, X)`` computes ``Y[k] = A[k] @ X[k]`` for every time slice k of a
:class:`TemporalCOO` tensor — the hot op of the model (capability
reference: the ``for k in range(T): torch.sparse.mm`` loops in IBM/TM-GCN,
TensorGCN-master/embedding_help_functions.py:203-208). All T slices run as
one flat gather and one segment sum over the row-sorted entry stream:

    Y = segment_sum(vals[:, None] * X_flat[t*N + col], t*N + row)

The segment sum is ``torch.segment_reduce`` over the sorted rows, whose
reduction order is fixed (no atomics, unlike ``index_add_`` on CUDA), and
its backward is the same reduction over the column-sorted transpose. The
``"pallas"`` impl runs the hand-written CUDA kernel K1
(kernels/spmm_cuda.py) instead.
"""

from __future__ import annotations

import torch

from tmgcn_torch.core.sparse import TemporalCOO

# Impls of tmgcn_tpu.ops.spmm not ported yet, and where ROADMAP.md tracks them.
_NOT_PORTED = {
    "pallas_bf16": "queue 2, K1 bf16-gather tier",
    "pallas_tiled": "queue 2, K3",
    "pallas_tiled_bf16": "queue 2, K3",
    "rowsplit": "queue 1, item 3",
    "blockdense": "queue 1, item 5",
    "blockdense_bf16": "queue 1, item 5",
}


def _segment_sum(
    flat_x: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_out: int,
) -> torch.Tensor:
    """out[r] = Σ_{i: rows[i] = r} vals[i] * flat_x[cols[i]]; rows sorted."""
    gathered = flat_x.index_select(0, cols) * vals[:, None]
    lengths = torch.bincount(rows, minlength=n_out)
    return torch.segment_reduce(gathered, "sum", lengths=lengths, axis=0, unsafe=True)


class _SegmentSpmm(torch.autograd.Function):
    """Flat SpMM whose backward dX = Aᵀ dY is again a sorted segment sum."""

    @staticmethod
    def forward(ctx, flat_x, rows, cols, vals, n_out):
        ctx.save_for_backward(rows, cols, vals)
        ctx.n_in = flat_x.shape[0]
        return _segment_sum(flat_x, rows, cols, vals, n_out)

    @staticmethod
    def backward(ctx, dY):
        rows, cols, vals = ctx.saved_tensors
        order = torch.argsort(cols, stable=True)
        dX = _segment_sum(dY, cols[order], rows[order], vals[order], ctx.n_in)
        return dX, None, None, None, None


def spmm(A, X: torch.Tensor, impl: str = "jnp") -> torch.Tensor:
    """Batched per-slice SpMM: Y[k] = A[k] @ X[k].

    Args:
        A: temporal sparse tensor, T slices of N x N (host or device
            arrays), or a prepacked operator such as
            ``kernels.spmm_cuda.PallasSpmmOperator``.
        X: dense (T, N, F) features.
        impl: "jnp" (gather + sorted segment sum, the name kept from the
            JAX package) or "pallas" (the CUDA kernel K1).

    Returns:
        (T, N, F) dense result, dtype of X.
    """
    if not isinstance(A, TemporalCOO):
        # A prepacked operator: the adapters decide at build time.
        return A(X)
    if impl == "pallas":
        from tmgcn_torch.kernels.spmm_cuda import spmm_pallas

        return spmm_pallas(A, X)
    if impl in _NOT_PORTED:
        raise NotImplementedError(
            f"spmm impl {impl!r} is not ported yet (ROADMAP {_NOT_PORTED[impl]})"
        )
    if impl != "jnp":
        raise ValueError(f"unknown spmm impl: {impl!r}")
    T, P = A.rows.shape
    N = A.n_nodes
    F = X.shape[-1]
    device = X.device
    rows = torch.as_tensor(A.rows, device=device).long()
    cols = torch.as_tensor(A.cols, device=device).long()
    vals = torch.as_tensor(A.vals, device=device).to(X.dtype)
    nnz = torch.as_tensor(A.nnz, device=device).long()
    # Drop the padding (it trails each slice) so the global row stream
    # t*N + row is sorted end to end.
    real = torch.arange(P, device=device)[None, :] < nnz[:, None]
    offsets = (torch.arange(T, device=device) * N)[:, None]
    flat_rows = (rows + offsets)[real]
    flat_cols = (cols + offsets)[real]
    out = _SegmentSpmm.apply(X.reshape(T * N, F), flat_rows, flat_cols, vals[real], T * N)
    return out.reshape(T, N, F)


def spmm_dense_reference(A_dense: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Dense oracle for tests: einsum over materialized (T, N, N)."""
    return torch.einsum("tij,tjf->tif", A_dense, X)

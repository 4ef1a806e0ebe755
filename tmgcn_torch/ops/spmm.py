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
other impls pack A into an operator first, with the JAX package's
arguments: ``"pallas"`` / ``"pallas_bf16"`` run the hand-written CUDA
kernel K1 (float32 / bf16 gathers), ``"pallas_tiled"`` /
``"pallas_tiled_bf16"`` run K3 (kernels/spmm_cuda.py); ``"rowsplit"`` and
``"blockdense"`` / ``"blockdense_bf16"`` are the operators of
ops/spmm_rowsplit.py and ops/spmm_blockdense.py.
"""

from __future__ import annotations

import torch

from tmgcn_torch.core.sparse import TemporalCOO


def _segment_sum(
    flat_x: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_out: int,
) -> torch.Tensor:
    """out[r] = Σ_{i: rows[i] = r} vals[i] * flat_x[cols[i]]; rows sorted.

    The segment lengths come from a search of the sorted rows, not a
    bincount, whose output size the host would have to read off the card
    (that would stall, and break the capture of, a training step)."""
    gathered = flat_x.index_select(0, cols) * vals[:, None]
    bounds = torch.searchsorted(rows, torch.arange(n_out + 1, device=rows.device))
    return torch.segment_reduce(gathered, "sum", lengths=bounds.diff(), axis=0, unsafe=True)


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


def spmm_slice(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    x: torch.Tensor,
    n_nodes: int,
) -> torch.Tensor:
    """One-slice SpMM: (P,) coo arrays x (N, F) dense -> (N, F).

    The entries stably sorted by row (the padding, row 0 and value 0,
    trails each slice), so each row sums its entries in stream order, as
    the JAX package's ``segment_sum`` does; forward and backward are
    sorted segment sums, with no atomics and no host sync.
    """
    rows = torch.as_tensor(rows, device=x.device).long()
    order = torch.argsort(rows, stable=True)
    cols = torch.as_tensor(cols, device=x.device).long()[order]
    vals = torch.as_tensor(vals, device=x.device)[order].to(x.dtype)
    return _SegmentSpmm.apply(x, rows[order], cols, vals, n_nodes)


def pack_operator(A: TemporalCOO, impl: str):
    """The host-packed operator of one of spmm's packing impls, with the
    JAX package's arguments; move it to the device with ``.to``."""
    bf16 = impl.endswith("_bf16")
    if impl in ("pallas", "pallas_bf16"):
        from tmgcn_torch.kernels.spmm_cuda import make_operator

        if impl == "pallas":
            return make_operator(A)
        return make_operator(A, chunk=512, window=256, gather_dtype="bfloat16", sort_cols=True)
    if impl in ("pallas_tiled", "pallas_tiled_bf16"):
        from tmgcn_torch.kernels.spmm_cuda import make_operator

        return make_operator(
            A, chunk=512, window=256, tile_dedup=True, gather_dtype="bfloat16" if bf16 else None
        )
    if impl == "rowsplit":
        from tmgcn_torch.ops.spmm_rowsplit import make_operator

        return make_operator(A)
    if impl in ("blockdense", "blockdense_bf16"):
        from tmgcn_torch.ops.spmm_blockdense import make_operator

        return make_operator(A, mode="bf16" if bf16 else "exact")
    raise ValueError(f"unknown spmm impl: {impl!r}")


def spmm(A, X: torch.Tensor, impl: str = "jnp") -> torch.Tensor:
    """Batched per-slice SpMM: Y[k] = A[k] @ X[k].

    Args:
        A: temporal sparse tensor, T slices of N x N (host or device
            arrays), or a prepacked operator such as
            ``kernels.spmm_cuda.PallasSpmmOperator``.
        X: dense (T, N, F) features.
        impl: "jnp" (gather + sorted segment sum, the name kept from the
            JAX package), or an impl that packs A first (one-shot: the
            packing is not kept): "pallas", "pallas_bf16", "pallas_tiled",
            "pallas_tiled_bf16", "rowsplit", "blockdense",
            "blockdense_bf16".

    Returns:
        (T, N, F) dense result, dtype of X.
    """
    if not isinstance(A, TemporalCOO):
        # A prepacked operator: the adapters decide at build time.
        return A(X)
    if impl != "jnp":
        return pack_operator(A, impl).to(X.device)(X)
    T, P = A.rows.shape
    N = A.n_nodes
    F = X.shape[-1]
    device = X.device
    rows = torch.as_tensor(A.rows, device=device).long()
    cols = torch.as_tensor(A.cols, device=device).long()
    vals = torch.as_tensor(A.vals, device=device).to(X.dtype)
    nnz = torch.as_tensor(A.nnz, device=device).long()
    # The padding trails each slice with value 0: pointed at the slice's
    # last row, it keeps the global row stream t*N + row sorted end to end
    # and adds only zeros, with no mask whose size the host must read.
    real = torch.arange(P, device=device)[None, :] < nnz[:, None]
    offsets = (torch.arange(T, device=device) * N)[:, None]
    flat_rows = torch.where(real, rows + offsets, offsets + N - 1).reshape(-1)
    flat_cols = (cols + offsets).reshape(-1)
    flat_vals = torch.where(real, vals, 0).reshape(-1)
    out = _SegmentSpmm.apply(X.reshape(T * N, F), flat_rows, flat_cols, flat_vals, T * N)
    return out.reshape(T, N, F)


def spmm_dense_reference(A_dense: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Dense oracle for tests: einsum over materialized (T, N, N)."""
    return torch.einsum("tij,tjf->tif", A_dense, X)

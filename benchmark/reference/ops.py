"""The reference's products and sparse helpers, in plain PyTorch.

``tf32=True`` rounds both operands of every product to TF32 (10 explicit
mantissa bits, round to nearest even) and accumulates in float32: what a
tensor-core TF32 product computes. The benchmark never runs it; the
control test and the calibration do.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, nearest even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + (((i >> 13) & 1) + 0x0FFF)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32).view(x.shape)


class _TF32Matmul(torch.autograd.Function):
    """a @ b with every operand rounded to TF32, the backward's included."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """a @ b in float32 (TF32 operands when asked)."""
    return _TF32Matmul.apply(a, b) if tf32 else a @ b


def _spmm(rows, cols, vals, dense, n_rows):
    out = dense.new_zeros((n_rows, dense.shape[-1]))
    return out.index_add(0, rows, dense.index_select(0, cols) * vals[:, None])


class _TF32Spmm(torch.autograd.Function):
    """The sparse product with its values, its dense operand and, in the
    backward, the incoming gradient rounded to TF32."""

    @staticmethod
    def forward(ctx, rows, cols, vals, dense, n_rows):
        vals = round_tf32(vals)
        ctx.save_for_backward(rows, cols, vals)
        ctx.n_in = dense.shape[0]
        return _spmm(rows, cols, vals, round_tf32(dense), n_rows)

    @staticmethod
    def backward(ctx, g):
        rows, cols, vals = ctx.saved_tensors
        return None, None, None, _spmm(cols, rows, vals, round_tf32(g), ctx.n_in), None


def spmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, dense: torch.Tensor,
         n_rows: int, tf32: bool = False) -> torch.Tensor:
    """out[r] = sum of vals[e] * dense[cols[e]] over the entries e of row r:
    a gather, a product and a scatter-add, differentiable in ``dense``."""
    if tf32:
        return _TF32Spmm.apply(rows, cols, vals, dense, n_rows)
    return _spmm(rows, cols, vals, dense, n_rows)


def coalesce(keys: torch.Tensor, vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted unique keys and the float64 sums of their values."""
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    acc = torch.zeros(uniq.shape[0], dtype=torch.float64, device=vals.device)
    return uniq, acc.index_add_(0, inv, vals.to(torch.float64))


def m_matrix(n_slices: int, n_diagonals: int, weight: str = "inverse") -> torch.Tensor:
    """The banded lower-triangular mixing matrix: weight 1/(d+1) (or 1) on
    the d-th diagonal below the main one, for d < n_diagonals (float64)."""
    if weight not in ("inverse", "ones"):
        raise ValueError(f"unknown M weight {weight!r}")
    M = torch.zeros((n_slices, n_slices), dtype=torch.float64)
    for d in range(min(n_diagonals, n_slices)):
        idx = torch.arange(n_slices - d)
        M[idx + d, idx] = 1.0 / (d + 1) if weight == "inverse" else 1.0
    return M


def degree_features(t, r, c, v, n_slices: int, n_nodes: int) -> torch.Tensor:
    """(T, N, 2) float64: [:, :, 0] the column sums (in-degree), [:, :, 1]
    the row sums (out-degree) of each slice's values."""
    v = v.to(torch.float64)
    cols = torch.zeros(n_slices * n_nodes, dtype=torch.float64, device=v.device)
    rows = torch.zeros_like(cols)
    cols.index_add_(0, t * n_nodes + c, v)
    rows.index_add_(0, t * n_nodes + r, v)
    return torch.stack([cols, rows], dim=-1).reshape(n_slices, n_nodes, 2)

"""Row-split segmented SpMM (port of tmgcn_tpu.ops.spmm_rowsplit).

A two-level reduction of the sparse product:

  * Host-side, the row-sorted global nonzero stream is cut into *segments*
    of at most K entries that never span two output rows
    (``pack_rowsplit``). A row with d nonzeros gives ceil(d/K) segments.
  * Each segment reduces densely: gather its K feature rows, scale by the
    K values, sum over K — an (S, K, F) -> (S, F) contraction.
  * The per-segment partials are summed per output row by a sorted
    ``torch.segment_reduce`` (fixed order, no atomics), as the port's
    ``spmm(impl="jnp")`` does.

The backward dX = Aᵀ dY runs the same forward on the transposed packing
(a ``torch.autograd.Function``), as in the JAX package. With no kernel of
its own, this is the port's CPU choice for the restricted layer 2 (the JAX
package's ``auto`` off the TPU).

Capability reference: the ``for k in range(T): torch.sparse.mm`` loops of
IBM/TM-GCN (TensorGCN-master/embedding_help_functions.py:301-312).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tmgcn_torch.core.sparse import TemporalCOO, as_numpy, to_device

DEFAULT_K = 16


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class RowSplitPlan:
    """Host-packed segment plan.

    seg_rows: (S,) int32 — global output row of each segment (0 on padding
        segments, whose values are all zero).
    cols: (S, K) int32 — global gather rows (0 on padding).
    vals: (S, K) float — nonzero values (0 on padding).
    n_rows_out: the flattened output length.
    k: segment width.
    n_real: the real segments, which come first; the padding segments
        after them are left out of the sorted reduction.

    The arrays are numpy on the host, or torch tensors after ``to``.
    """

    seg_rows: np.ndarray | torch.Tensor
    cols: np.ndarray | torch.Tensor
    vals: np.ndarray | torch.Tensor
    n_rows_out: int
    k: int
    n_real: int

    @property
    def n_segments(self) -> int:
        return self.seg_rows.shape[0]

    def to(self, device: str | torch.device) -> "RowSplitPlan":
        return dataclasses.replace(
            self,
            seg_rows=to_device(self.seg_rows, device),
            cols=to_device(self.cols, device),
            vals=to_device(self.vals, device),
        )


def flatten_stream(A: TemporalCOO) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A's true nonzeros as row-sorted global (t*N + r, t*N + c, v)."""
    rows_np = as_numpy(A.rows)
    cols_np = as_numpy(A.cols)
    vals_np = as_numpy(A.vals)
    nnz_np = as_numpy(A.nnz)
    T, N = A.n_slices, A.n_nodes
    parts_r, parts_c, parts_v = [], [], []
    for t in range(T):
        n = int(nnz_np[t])
        parts_r.append(rows_np[t, :n].astype(np.int64) + t * N)
        parts_c.append(cols_np[t, :n].astype(np.int64) + t * N)
        parts_v.append(vals_np[t, :n])
    g_rows = np.concatenate(parts_r) if parts_r else np.zeros(0, np.int64)
    g_cols = np.concatenate(parts_c) if parts_c else np.zeros(0, np.int64)
    g_vals = np.concatenate(parts_v) if parts_v else np.zeros(0, vals_np.dtype)
    return g_rows, g_cols, g_vals


def pack_rowsplit_stream(
    g_rows: np.ndarray,
    g_cols: np.ndarray,
    g_vals: np.ndarray,
    n_rows_out: int,
    k: int = DEFAULT_K,
    pad_multiple: int = 8,
) -> RowSplitPlan:
    """Cut a ROW-SORTED flat nonzero stream into K-entry segments."""
    g_vals = np.asarray(g_vals)
    P = len(g_rows)
    if P == 0:
        S = pad_multiple
        return RowSplitPlan(
            seg_rows=np.zeros(S, np.int32),
            cols=np.zeros((S, k), np.int32),
            vals=np.zeros((S, k), g_vals.dtype),
            n_rows_out=n_rows_out,
            k=k,
            n_real=0,
        )
    g_rows = np.asarray(g_rows)
    change = np.empty(P, bool)
    change[0] = True
    change[1:] = g_rows[1:] != g_rows[:-1]
    row_start = np.maximum.accumulate(np.where(change, np.arange(P), 0))
    pos = np.arange(P) - row_start
    seg_id = np.cumsum(change | (pos % k == 0)) - 1
    within = pos % k
    S = int(seg_id[-1]) + 1
    S_pad = _round_up(S, pad_multiple)

    cols_pad = np.zeros((S_pad, k), np.int32)
    vals_pad = np.zeros((S_pad, k), g_vals.dtype)
    seg_rows = np.zeros(S_pad, np.int32)
    cols_pad[seg_id, within] = g_cols
    vals_pad[seg_id, within] = g_vals
    seg_rows[seg_id] = g_rows
    return RowSplitPlan(
        seg_rows=seg_rows, cols=cols_pad, vals=vals_pad, n_rows_out=n_rows_out, k=k, n_real=S
    )


def pack_rowsplit(A: TemporalCOO, k: int = DEFAULT_K, pad_multiple: int = 8) -> RowSplitPlan:
    """Cut A's row-sorted global nonzero stream into K-entry segments."""
    g_rows, g_cols, g_vals = flatten_stream(A)
    return pack_rowsplit_stream(g_rows, g_cols, g_vals, A.n_slices * A.n_nodes, k, pad_multiple)


def apply_plan(plan: RowSplitPlan, flat: torch.Tensor) -> torch.Tensor:
    """(n_in, F) features -> (n_rows_out, F) segment-reduced product."""
    K, F = plan.k, flat.shape[-1]
    cols = torch.as_tensor(plan.cols, device=flat.device)[: plan.n_real].long()
    vals = torch.as_tensor(plan.vals, device=flat.device)[: plan.n_real].to(flat.dtype)
    seg_rows = torch.as_tensor(plan.seg_rows, device=flat.device)[: plan.n_real].long()
    g = flat.index_select(0, cols.reshape(-1)).reshape(plan.n_real, K, F)
    part = torch.sum(g * vals[:, :, None], dim=1)
    lengths = torch.bincount(seg_rows, minlength=plan.n_rows_out)
    return torch.segment_reduce(part, "sum", lengths=lengths, axis=0, unsafe=True)


class _RowSplitSpmm(torch.autograd.Function):
    """(n_in, F) -> (n_out, F) through ``plan``; dX = Aᵀ dY through ``plan_t``."""

    @staticmethod
    def forward(ctx, flat, plan, plan_t):
        ctx.plan_t = plan_t
        return apply_plan(plan, flat)

    @staticmethod
    def backward(ctx, dY):
        return apply_plan(ctx.plan_t, dY), None, None


@dataclasses.dataclass(frozen=True)
class RowSplitSpmmOperator:
    """Prepacked row-split SpMM operator: call on (T, N, F) features."""

    T: int
    N: int
    plan: RowSplitPlan
    plan_t: RowSplitPlan

    @property
    def n_slices(self) -> int:
        return self.T

    @property
    def n_nodes(self) -> int:
        return self.N

    def to(self, device: str | torch.device) -> "RowSplitSpmmOperator":
        return dataclasses.replace(self, plan=self.plan.to(device), plan_t=self.plan_t.to(device))

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        F = X.shape[-1]
        out = _RowSplitSpmm.apply(X.reshape(self.T * self.N, F), self.plan, self.plan_t)
        return out.reshape(self.T, self.N, F)


def make_operator(A: TemporalCOO, k: int = DEFAULT_K) -> RowSplitSpmmOperator:
    """Prepack forward + transpose segment plans for A (host-side)."""
    return RowSplitSpmmOperator(
        T=A.n_slices, N=A.n_nodes, plan=pack_rowsplit(A, k), plan_t=pack_rowsplit(A.transpose(), k)
    )


@dataclasses.dataclass(frozen=True)
class FlatRowSplitOperator:
    """(n_out x n_in) sparse operator: (n_in, F) -> (n_out, F)."""

    n_in: int
    n_out: int
    plan: RowSplitPlan
    plan_t: RowSplitPlan

    def to(self, device: str | torch.device) -> "FlatRowSplitOperator":
        return dataclasses.replace(self, plan=self.plan.to(device), plan_t=self.plan_t.to(device))

    def __call__(self, X_flat: torch.Tensor) -> torch.Tensor:
        return _RowSplitSpmm.apply(X_flat, self.plan, self.plan_t)


def make_flat_operator(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_in: int,
    n_out: int,
    k: int = DEFAULT_K,
) -> FlatRowSplitOperator:
    """Build a rectangular operator from (row, col, val) triples.

    Entries need not be pre-sorted; both the forward (row-sorted) and
    transposed (col-sorted) segment plans are packed host-side.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    plan = pack_rowsplit_stream(rows[order], cols[order], vals[order], n_out, k)
    order_t = np.lexsort((rows, cols))
    plan_t = pack_rowsplit_stream(cols[order_t], rows[order_t], vals[order_t], n_in, k)
    return FlatRowSplitOperator(n_in=int(n_in), n_out=int(n_out), plan=plan, plan_t=plan_t)

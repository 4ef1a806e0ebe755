"""Temporal sparse tensor container (port of tmgcn_tpu.core.sparse).

A T x N x N sparse tensor holding one (typically normalized) adjacency
matrix per time slice, as three padded (T, P) arrays — rows, cols, vals —
plus the per-slice nonzero count.

  * Every slice is padded to a common capacity P; padding entries use
    row = col = 0 with val = 0.0 and sit after the slice's true entries,
    so they contribute nothing to any accumulation.
  * True entries are sorted by (row, col) within each slice, so row
    segments are contiguous and segment reductions are deterministic.
  * Constructors produce host (numpy) arrays. ``to(device)`` is the one
    explicit move to torch tensors on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from tmgcn_torch.utils.profiling import spanned


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def as_numpy(x) -> np.ndarray:
    """Host numpy view of a numpy array or a (CPU or device) tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_device(x, device: str | torch.device) -> torch.Tensor:
    """A numpy array or a tensor as a tensor on ``device`` (dtype kept)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@dataclasses.dataclass(frozen=True)
class TemporalCOO:
    """A T x N x N temporal sparse tensor in padded, row-sorted COO form.

    Attributes:
        rows: (T, P) int32 — row index per entry; 0 on padding.
        cols: (T, P) int32 — col index per entry; 0 on padding.
        vals: (T, P) float — value per entry; 0.0 on padding.
        nnz:  (T,)   int32 — true nonzero count per slice.
        n_nodes: int — N.

    The arrays are numpy on the host, or torch tensors after ``to``.
    """

    rows: np.ndarray | torch.Tensor
    cols: np.ndarray | torch.Tensor
    vals: np.ndarray | torch.Tensor
    nnz: np.ndarray | torch.Tensor
    n_nodes: int

    @property
    def n_slices(self) -> int:
        return self.rows.shape[0]

    @property
    def capacity(self) -> int:
        return self.rows.shape[1]

    @property
    def dtype(self):
        return self.vals.dtype

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @staticmethod
    @spanned("data.coo", result_attrs=lambda coo: {"nnz": int(coo.nnz.sum())})
    def from_slices(
        slices: Sequence[tuple[np.ndarray, np.ndarray, np.ndarray]],
        n_nodes: int,
        dtype=np.float32,
        pad_multiple: int = 128,
        capacity: int | None = None,
    ) -> "TemporalCOO":
        """Build from per-slice (rows, cols, vals) numpy triples.

        Duplicate (row, col) entries within a slice are summed (the analog
        of ``coalesce``). Entries are then sorted by (row, col). Each call
        is a ``data.coo`` span, with the entries kept (``nnz``).
        """
        T = len(slices)
        coalesced = []
        max_nnz = 1
        for r, c, v in slices:
            r = np.asarray(r, dtype=np.int64)
            c = np.asarray(c, dtype=np.int64)
            v = np.asarray(v, dtype=np.float64)
            if r.size:
                flat = r * n_nodes + c
                uniq, inv = np.unique(flat, return_inverse=True)
                acc = np.zeros(uniq.shape[0], dtype=np.float64)
                np.add.at(acc, inv, v)
                r, c, v = uniq // n_nodes, uniq % n_nodes, acc
            coalesced.append((r, c, v))
            max_nnz = max(max_nnz, r.size)

        P = capacity if capacity is not None else _round_up(max_nnz, pad_multiple)
        if P < max_nnz:
            raise ValueError(f"capacity {P} < max nnz {max_nnz}")

        rows = np.zeros((T, P), dtype=np.int32)
        cols = np.zeros((T, P), dtype=np.int32)
        vals = np.zeros((T, P), dtype=np.float64)
        nnz = np.zeros((T,), dtype=np.int32)
        for k, (r, c, v) in enumerate(coalesced):
            n = r.size
            rows[k, :n] = r
            cols[k, :n] = c
            vals[k, :n] = v
            nnz[k] = n

        return TemporalCOO(
            rows=rows,
            cols=cols,
            vals=vals.astype(dtype),
            nnz=nnz,
            n_nodes=int(n_nodes),
        )

    @staticmethod
    def from_global_coo(
        time_idx: np.ndarray,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        n_slices: int,
        n_nodes: int,
        dtype=np.float32,
        pad_multiple: int = 128,
        capacity: int | None = None,
    ) -> "TemporalCOO":
        """Build from global (t, i, j, v) coordinate lists."""
        time_idx = np.asarray(time_idx, dtype=np.int64)
        slices = []
        for k in range(n_slices):
            m = time_idx == k
            slices.append((np.asarray(rows)[m], np.asarray(cols)[m], np.asarray(vals)[m]))
        return TemporalCOO.from_slices(
            slices, n_nodes, dtype=dtype, pad_multiple=pad_multiple, capacity=capacity
        )

    @staticmethod
    def from_dense(dense: np.ndarray, dtype=np.float32, pad_multiple: int = 128) -> "TemporalCOO":
        """Build from a dense (T, N, N) array (testing / small graphs)."""
        dense = np.asarray(dense)
        T, N, _ = dense.shape
        slices = []
        for k in range(T):
            r, c = np.nonzero(dense[k])
            slices.append((r, c, dense[k][r, c]))
        return TemporalCOO.from_slices(slices, N, dtype=dtype, pad_multiple=pad_multiple)

    # ------------------------------------------------------------------
    # Views / conversions
    # ------------------------------------------------------------------

    def to(self, device: str | torch.device) -> "TemporalCOO":
        """The same tensor as torch tensors on ``device`` (dtypes kept)."""
        return TemporalCOO(
            rows=to_device(self.rows, device),
            cols=to_device(self.cols, device),
            vals=to_device(self.vals, device),
            nnz=to_device(self.nnz, device),
            n_nodes=self.n_nodes,
        )

    def to_dense(self) -> torch.Tensor:
        """Materialize as a dense (T, N, N) tensor (testing / small N).

        On the device of the arrays (the CPU for host arrays). Padding
        entries add 0.0 at (0, 0).
        """
        rows = torch.as_tensor(self.rows).long()
        cols = torch.as_tensor(self.cols).long()
        vals = torch.as_tensor(self.vals)
        T, P = rows.shape
        N = self.n_nodes
        t = torch.arange(T, device=rows.device)[:, None].expand(T, P)
        out = torch.zeros((T, N, N), dtype=vals.dtype, device=vals.device)
        return out.index_put_(
            (t.reshape(-1), rows.reshape(-1), cols.reshape(-1)),
            vals.reshape(-1),
            accumulate=True,
        )

    def transpose(self) -> "TemporalCOO":
        """Per-slice transpose (swap rows/cols), re-sorted by new rows.

        Host-side helper (numpy sort) — used when precomputing the adjoint
        operator for backward passes.
        """
        rows = as_numpy(self.rows)
        cols = as_numpy(self.cols)
        vals = as_numpy(self.vals)
        nnz = as_numpy(self.nnz)
        T, P = rows.shape
        new_rows = np.zeros_like(rows)
        new_cols = np.zeros_like(cols)
        new_vals = np.zeros_like(vals)
        for k in range(T):
            n = int(nnz[k])
            order = np.lexsort((rows[k, :n], cols[k, :n]))
            new_rows[k, :n] = cols[k, :n][order]
            new_cols[k, :n] = rows[k, :n][order]
            new_vals[k, :n] = vals[k, :n][order]
        return TemporalCOO(
            rows=new_rows,
            cols=new_cols,
            vals=new_vals,
            nnz=nnz,
            n_nodes=self.n_nodes,
        )

    def edge_list(self, with_values: bool = False):
        """Host-side (3, E) [slice, row, col] of all true nonzeros."""
        rows = as_numpy(self.rows)
        cols = as_numpy(self.cols)
        vals = as_numpy(self.vals)
        nnz = as_numpy(self.nnz)
        parts, vparts = [], []
        for k in range(self.n_slices):
            n = int(nnz[k])
            parts.append(
                np.stack([np.full(n, k, dtype=np.int64), rows[k, :n], cols[k, :n]])
            )
            if with_values:
                vparts.append(vals[k, :n])
        edges = np.concatenate(parts, axis=1) if parts else np.zeros((3, 0), np.int64)
        if with_values:
            return edges, (np.concatenate(vparts) if vparts else np.zeros(0))
        return edges

    def slice_window(self, start: int, end: int) -> "TemporalCOO":
        """Select slices [start, end) along the time axis."""
        return TemporalCOO(
            rows=self.rows[start:end],
            cols=self.cols[start:end],
            vals=self.vals[start:end],
            nnz=self.nnz[start:end],
            n_nodes=self.n_nodes,
        )

    def astype(self, dtype) -> "TemporalCOO":
        """Cast vals: a numpy dtype on host arrays, a torch dtype on tensors."""
        if isinstance(self.vals, torch.Tensor):
            return dataclasses.replace(self, vals=self.vals.to(dtype))
        return dataclasses.replace(self, vals=self.vals.astype(dtype))

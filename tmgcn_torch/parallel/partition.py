"""Row partitioning of temporal sparse tensors across the graph axis (port
of tmgcn_tpu.parallel.partition; host numpy, as there).

Each graph shard owns a contiguous block of adjacency rows (nodes) for
every time slice. Entries are re-bucketed host-side into a (T, G, Pg)
layout — time-shardable on axis 0, graph-shardable on axis 1, padded to
a common per-shard capacity Pg — with *local* row indices and *global*
column indices: the local SpMM reduces into the shard's row block while
gathering from the (replicated or gathered) feature matrix.

The padding (row 0, column 0, value 0) trails each (t, g) stream's sorted
entries, so a padded stream is not sorted: ``shard_stream`` cuts each
stream to its ``nnz`` before a sorted segment sum reads it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tmgcn_torch.core.sparse import TemporalCOO, as_numpy


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ShardedTemporalCOO:
    """Row-partitioned temporal COO: numpy arrays of shape (T, G, Pg).

    rows are shard-local (in [0, n_local_rows)); cols are global.
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    nnz: np.ndarray  # (T, G)
    n_nodes: int
    n_local_rows: int
    n_graph_shards: int

    @property
    def n_slices(self) -> int:
        return self.rows.shape[0]


def partition_rows(A: TemporalCOO, n_graph: int, pad_multiple: int = 128) -> ShardedTemporalCOO:
    """Bucket entries by row block; returns host-side sharded arrays."""
    rows = as_numpy(A.rows)
    cols = as_numpy(A.cols)
    vals = as_numpy(A.vals)
    nnz = as_numpy(A.nnz)
    T = A.n_slices
    n_local = -(-A.n_nodes // n_graph)  # ceil

    buckets = [[None] * n_graph for _ in range(T)]
    max_nnz = 1
    for k in range(T):
        n = int(nnz[k])
        r, c, v = rows[k, :n], cols[k, :n], vals[k, :n]
        shard = r // n_local
        for g in range(n_graph):
            m = shard == g
            buckets[k][g] = (r[m] - g * n_local, c[m], v[m])
            max_nnz = max(max_nnz, int(m.sum()))

    Pg = _round_up(max_nnz, pad_multiple)
    out_rows = np.zeros((T, n_graph, Pg), dtype=np.int32)
    out_cols = np.zeros((T, n_graph, Pg), dtype=np.int32)
    out_vals = np.zeros((T, n_graph, Pg), dtype=vals.dtype)
    out_nnz = np.zeros((T, n_graph), dtype=np.int32)
    for k in range(T):
        for g in range(n_graph):
            r, c, v = buckets[k][g]
            n = len(r)
            out_rows[k, g, :n] = r
            out_cols[k, g, :n] = c
            out_vals[k, g, :n] = v
            out_nnz[k, g] = n

    return ShardedTemporalCOO(
        rows=out_rows,
        cols=out_cols,
        vals=out_vals,
        nnz=out_nnz,
        n_nodes=A.n_nodes,
        n_local_rows=n_local,
        n_graph_shards=n_graph,
    )


def pad_time(A: ShardedTemporalCOO, n_time: int) -> ShardedTemporalCOO:
    """Pad the slice axis to a multiple of the time-mesh size."""
    T = A.n_slices
    Tp = _round_up(T, n_time)
    if Tp == T:
        return A
    pad = Tp - T

    def padz(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), widths)

    return dataclasses.replace(
        A, rows=padz(A.rows), cols=padz(A.cols), vals=padz(A.vals), nnz=padz(A.nnz)
    )


def shard_stream(A: ShardedTemporalCOO, t0: int, t_loc: int, g: int,
                 in_stride: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Graph shard g's entries of slices [t0, t0 + t_loc) as one flat,
    row-sorted stream with no padding: (rows, cols, vals), row k * n_local
    + r and column k * in_stride + c for local slice k. ``in_stride``: the
    input rows per slice (N for the features, the graph-gathered n_local *
    G for layer 2)."""
    rs, cs, vs = [], [], []
    for k in range(t_loc):
        n = int(A.nnz[t0 + k, g])
        rs.append(A.rows[t0 + k, g, :n].astype(np.int64) + k * A.n_local_rows)
        cs.append(A.cols[t0 + k, g, :n].astype(np.int64) + k * in_stride)
        vs.append(A.vals[t0 + k, g, :n])
    if not rs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, A.vals.dtype)
    return np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)

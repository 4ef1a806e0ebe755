"""Sharded TM-GCN training steps over a (graph, time) mesh (port of
tmgcn_tpu.parallel.tmgcn_sharded): the standalone steps that the JAX
package's dry run holds, one process per device.

Each rank calls these with its own shard (``shard_batch``): the adjacency's
(time, graph) block as one sorted entry stream, its time slices of X,
and the replicated M, edges and targets.

v1 data movement (``make_sharded_forward``): the M-transform gathers X
along ``time`` and computes this shard's rows of M ×₁ X; the local SpMM
reduces into the shard's row block (no communication); the embeddings
are gathered along ``graph`` then ``time`` and every rank scores every
edge. Only W feeds the sharded part, so only W's gradient is summed over
the world (``collectives.copy_params``); U is used alike on every rank, so
each rank's gradient of it is already the whole one.

The production layout (``make_sharded_train_step_halo`` and
``parallel/adapter.py``) uses :func:`readout_partitioned` — owner-computes
partial logits + one (Eb, C) sum over ``graph`` — so no shard
materializes the full edge set or embedding tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tmgcn_torch.ops.spmm import _SegmentSpmm
from tmgcn_torch.parallel import collectives
from tmgcn_torch.parallel.halo import banded_m_transform_local
from tmgcn_torch.parallel.mesh import Mesh
from tmgcn_torch.parallel.partition import ShardedTemporalCOO, shard_stream
from tmgcn_torch.train.loop import TrainConfig, _optimizer, _tree_leaves
from tmgcn_torch.train.losses import weighted_cross_entropy


def local_spmm(stream: dict, x_flat: torch.Tensor, n_out: int, cols: str = "cols") -> torch.Tensor:
    """One shard's SpMM: gather ``x_flat[cols]``, reduce into its ``n_out``
    local rows. ``stream``: the shard's unpadded, row-sorted "rows",
    ``cols`` and "vals" tensors (``partition.shard_stream``) — the sorted
    segment sum of ops/spmm.py, the port of the JAX package's
    ``segment_sum``."""
    vals = stream["vals"].to(x_flat.dtype)
    return _SegmentSpmm.apply(x_flat, stream["rows"], stream[cols], vals, n_out)


def shard_batch(mesh: Mesh, A: ShardedTemporalCOO, X, M, edges, targets=None) -> dict:
    """This rank's part of a batch, on its device: its (time, graph)
    block of A as a sorted stream ("rows", "cols", "vals"; columns index
    the flattened (T_loc, N) feature rows), its time slices of X; M,
    edges and targets whole."""
    T = A.n_slices
    if T % mesh.n_time:
        raise ValueError(f"T={T} not divisible by n_time={mesh.n_time}")
    t_loc = T // mesh.n_time
    t0 = mesh.t * t_loc
    r, c, v = shard_stream(A, t0, t_loc, mesh.g, A.n_nodes)
    dev = mesh.device
    out = {
        "rows": torch.as_tensor(r, device=dev),
        "cols": torch.as_tensor(c, device=dev),
        "vals": torch.as_tensor(v, dtype=torch.float32, device=dev),
        "X": torch.as_tensor(np.asarray(X)[t0 : t0 + t_loc], dtype=torch.float32, device=dev),
        "M": torch.as_tensor(np.asarray(M), dtype=torch.float32, device=dev),
        "edges": torch.as_tensor(np.asarray(edges), dtype=torch.long, device=dev),
    }
    if targets is not None:
        out["targets"] = torch.as_tensor(np.asarray(targets), dtype=torch.long, device=dev)
    return out


def make_sharded_forward(mesh: Mesh, n_local_rows: int):
    """The v1 TM-GCN 1-layer forward: forward(params, batch) -> (E, C)
    logits, the same on every rank (``batch`` from ``shard_batch``)."""

    def forward(params: dict, batch: dict) -> torch.Tensor:
        W = collectives.copy_params({"W": params["W"]}, mesh.world)["W"]
        U = params["U"]
        X_loc, M = batch["X"], batch["M"]
        T, (T_loc, N, F0) = M.shape[0], X_loc.shape
        # M-transform: gather the features over time, apply this shard's rows of M.
        X_full = collectives.gather_from(X_loc, mesh.time_group).reshape(T, N * F0)
        M_rows = M[mesh.t * T_loc : (mesh.t + 1) * T_loc]
        Xt_loc = torch.matmul(M_rows.to(X_full.dtype), X_full)
        # Local SpMM into this shard's row block.
        Y_loc = local_spmm(batch, Xt_loc.reshape(T_loc * N, F0), T_loc * n_local_rows)
        Y_loc = torch.matmul(Y_loc.reshape(T_loc, n_local_rows, F0), W.to(Y_loc.dtype))
        # Assemble the full embeddings for the readout.
        F1 = Y_loc.shape[-1]
        Y_rows = collectives.gather_from(Y_loc, mesh.graph_group)  # (G, T_loc, N_loc, F1)
        Y_rows = Y_rows.permute(1, 0, 2, 3).reshape(T_loc, -1, F1)
        Y_full = collectives.gather_from(Y_rows, mesh.time_group)  # (n_time, T_loc, N_pad, F1)
        n_pad = Y_rows.shape[1]
        flat = Y_full.reshape(-1, F1)
        e = batch["edges"]
        src = flat[e[0] * n_pad + e[1]]
        trg = flat[e[0] * n_pad + e[2]]
        U = U.to(flat.dtype)
        return src @ U[:F1] + trg @ U[F1:]

    return forward


def make_sharded_train_step(mesh: Mesh, n_local_rows: int, params: dict, cfg: TrainConfig):
    """The v1 sharded step: step(batch, class_weights) -> loss. ``params``
    ({"W", "U"}, requires_grad, the same on every rank) and the optimizer
    of ``cfg`` (the loop's SGD or Adam) are updated in place."""
    forward = make_sharded_forward(mesh, n_local_rows)
    opt = _optimizer(cfg, _tree_leaves(params))

    def train_step(batch: dict, class_weights: torch.Tensor) -> torch.Tensor:
        logits = forward(params, batch)
        loss = weighted_cross_entropy(logits, batch["targets"], class_weights)
        opt.step(list(torch.autograd.grad(loss, opt.params)))
        return loss.detach()

    return train_step


def partition_edges_by_time(
    edges: np.ndarray,
    targets: np.ndarray,
    n_slices: int,
    n_time: int,
    pad_multiple: int = 128,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bucket labeled edges by time shard (host-side).

    Returns (edges_sh, targets_sh, mask_sh) with shapes (n_time, 3, E),
    (n_time, E), (n_time, E); slice ids are shard-local.
    """
    edges = np.asarray(edges)
    targets = np.asarray(targets)
    if n_slices % n_time:
        raise ValueError(f"T={n_slices} not divisible by n_time={n_time}")
    t_loc = n_slices // n_time
    shard_of = edges[0] // t_loc
    counts = [np.sum(shard_of == i) for i in range(n_time)]
    E = max(1, max(counts))
    E = ((E + pad_multiple - 1) // pad_multiple) * pad_multiple
    edges_sh = np.zeros((n_time, 3, E), np.int32)
    targets_sh = np.zeros((n_time, E), targets.dtype)
    mask_sh = np.zeros((n_time, E), bool)
    for i in range(n_time):
        m = shard_of == i
        k = int(m.sum())
        e = edges[:, m].copy()
        e[0] -= i * t_loc
        edges_sh[i, :, :k] = e
        targets_sh[i, :k] = targets[m]
        mask_sh[i, :k] = True
    return edges_sh, targets_sh, mask_sh


def readout_partitioned(flat: torch.Tensor, edges_b: torch.Tensor, mask: torch.Tensor,
                        U: torch.Tensor, n_local_rows: int, mesh: Mesh) -> torch.Tensor:
    """Owner-computes split-U edge readout on this shard's row block.

    Each graph shard scores only the edge endpoints whose node rows it
    owns (masked local gather); one sum of the (Eb, C) partial logits over
    ``graph`` assembles the full logits — no shard ever gathers the
    embedding tensor or materializes remote rows.

    Args:
        flat: (T_loc * N_loc, F) this shard's embedding rows.
        edges_b: (3, Eb) this time shard's edges — local slice ids,
            global node ids.
        mask: (Eb,) valid-edge mask (padding excluded).
        U: (2F, C) split readout weights (reference concat convention).
    Returns:
        (Eb, C) logits, identical on every graph shard.
    """
    F1 = flat.shape[-1]
    n0 = mesh.g * n_local_rows
    # An endpoint this shard does not own reads a row whose value it then
    # zeroes: edge e reads row e mod rows, not row 0. The gather's backward
    # (a sorted accumulate) sums each row's duplicates one after another,
    # so one shared row would serialize (G - 1)/G of the bucket.
    spread = torch.arange(edges_b.shape[1], device=flat.device) % flat.shape[0]

    def side(nodes, Upart):
        own = mask & (nodes >= n0) & (nodes < n0 + n_local_rows)
        idx = torch.where(own, edges_b[0] * n_local_rows + (nodes - n0), spread)
        rows = torch.where(own[:, None], flat[idx], torch.zeros((), dtype=flat.dtype,
                                                                device=flat.device))
        return rows @ Upart

    part = side(edges_b[1], U[:F1]) + side(edges_b[2], U[F1:])
    return collectives.reduce_from(part, mesh.graph_group)


def masked_loss_sums(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                     class_weights: torch.Tensor) -> torch.Tensor:
    """[Σ w·nll, Σ w] of this shard's edges: the two sums of the weighted
    cross-entropy (train/losses.py) over the masked ones."""
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(targets.long(), logits.shape[-1]).to(logits.dtype)
    nll = -torch.sum(logp * onehot, dim=-1)
    w = (onehot @ class_weights.to(logits.dtype)) * mask.to(logits.dtype)
    return torch.stack([torch.sum(w * nll), torch.sum(w)])


def make_sharded_train_step_halo(mesh: Mesh, n_local_rows: int, params: dict,
                                 cfg: TrainConfig, m_blocks: np.ndarray, halo: int):
    """Optimized sharded step: banded halo exchange + partitioned edges.

    vs the v1 step: the M-transform moves only its predecessors' tails
    between time shards instead of gathering X; each time shard scores
    only its own edges; and the readout is owner-computes — one sum of
    (Eb, C) partial logits over ``graph``. The loss reduces with one sum of
    two scalars over ``time``.

    Returns step(batch, edges_b, targets_b, mask_b, class_weights) -> loss,
    with this rank's time bucket of the edges (``partition_edges_by_time``)
    and ``m_blocks`` from ``halo.local_banded_m``; params and the optimizer
    of ``cfg`` are updated in place.
    """
    opt = _optimizer(cfg, _tree_leaves(params))
    m_block = torch.as_tensor(m_blocks[mesh.t], dtype=torch.float32, device=mesh.device)

    def loss_fn(batch, edges_b, targets_b, mask_b, class_weights):
        p = collectives.copy_params(params, mesh.world)
        X_loc = batch["X"]
        T_loc, N, F0 = X_loc.shape
        Xt_loc = banded_m_transform_local(X_loc, m_block, halo, mesh.time_group)
        Y_loc = local_spmm(batch, Xt_loc.reshape(T_loc * N, F0), T_loc * n_local_rows)
        Y_loc = torch.matmul(Y_loc, p["W"].to(Y_loc.dtype))
        logits = readout_partitioned(Y_loc, edges_b, mask_b, p["U"].to(Y_loc.dtype),
                                     n_local_rows, mesh)
        sums = collectives.reduce_from(
            masked_loss_sums(logits, targets_b, mask_b, class_weights), mesh.time_group)
        return sums[0] / sums[1]

    def train_step(batch, edges_b, targets_b, mask_b, class_weights) -> torch.Tensor:
        loss = loss_fn(batch, edges_b, targets_b, mask_b, class_weights)
        opt.step(list(torch.autograd.grad(loss, opt.params)))
        return loss.detach()

    return train_step

"""Edge readout: gather per-edge endpoint embeddings and classify (port of
the plain readouts of tmgcn_tpu.ops.edge_readout).

For each labeled edge (k, i, j), read node embeddings Y[k, i] and Y[k, j]
from the (T, N, F) embedding tensor and apply the final linear classifier
(capability reference: the edge_src_nodes/edge_trg_nodes gather + concat +
``@ U`` in IBM/TM-GCN, TensorGCN-master/embedding_help_functions.py:
196-198,228-233). The concat is avoided by splitting U into source and
target halves. ``ReadoutPlan`` (the kernel-backed backward) is not ported
yet (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import torch


def edge_flat_indices(edges: torch.Tensor, n_nodes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat (T*N) indices of edge endpoints; edges is (3, E) [slice, src, trg]."""
    return edges[0] * n_nodes + edges[1], edges[0] * n_nodes + edges[2]


def edge_readout(Y: torch.Tensor, edges: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Per-edge logits concat(Y[k,i], Y[k,j]) @ U without the concat.

    Y: (T, N, F) node embeddings; edges: (3, E); U: (2F, C). Returns (E, C).
    """
    T, N, F = Y.shape
    flat = Y.reshape(T * N, F)
    src_idx, trg_idx = edge_flat_indices(edges, N)
    U = U.to(Y.dtype)
    return flat[src_idx] @ U[:F] + flat[trg_idx] @ U[F:]


def edge_readout_bilinear(Y: torch.Tensor, edges: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Per-edge logits (Y[k,i] ⊙ Y[k,j]) @ U with U in R^{F x C}.

    A framework extension beyond the reference's additive concat readout,
    able to express endpoint affinity (see configs/schema.ExperimentConfig
    .readout).
    """
    T, N, F = Y.shape
    flat = Y.reshape(T * N, F)
    src_idx, trg_idx = edge_flat_indices(edges, N)
    return (flat[src_idx] * flat[trg_idx]) @ U.to(Y.dtype)

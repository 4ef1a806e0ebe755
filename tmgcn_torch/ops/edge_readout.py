"""Edge readout: gather per-edge endpoint embeddings and classify (port of
the plain readouts of tmgcn_tpu.ops.edge_readout).

For each labeled edge (k, i, j), read node embeddings Y[k, i] and Y[k, j]
from the (T, N, F) embedding tensor and apply the final linear classifier
(capability reference: the edge_src_nodes/edge_trg_nodes gather + concat +
``@ U`` in IBM/TM-GCN, TensorGCN-master/embedding_help_functions.py:
196-198,228-233). The concat is avoided by splitting U into source and
target halves.

``ReadoutPlan`` / ``apply_readout`` give the same logits with a backward
through the hand-written kernels: the gradient of the endpoint gather is a
scatter-add into (T·N, F), which runs as K1 over a host-sorted packing of
the endpoint rows, or as its lane-major twin K2 past ``LANE_MAJOR_BYTES``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tmgcn_torch.kernels.spmm_cuda import (
    PackedSpmm,
    pack_windowed_flat,
    windowed_segment_matmul,
    windowed_segment_matmul_t,
)


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


def edge_embeddings(Y: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """The explicit (E, 2F) concatenated edge embeddings [Y[k,i], Y[k,j]]:
    what ``edge_readout`` multiplies by U without forming (for tests)."""
    T, N, F = Y.shape
    flat = Y.reshape(T * N, F)
    src_idx, trg_idx = edge_flat_indices(edges, N)
    return torch.cat([flat[src_idx], flat[trg_idx]], dim=1)


@dataclasses.dataclass(frozen=True)
class ReadoutPlan:
    """Prepacked kernel backward of the edge readout.

    The endpoint gather's backward is a scatter-add of 2E gradient rows
    into (T·N, F). The plan sorts the combined (src ++ trg) flat indices
    once, host-side, and packs them for the windowed segment kernel;
    ``sort_cols`` composes the sort permutation with the chunk layout, so
    gradient rows are gathered once, directly into chunk order (padding
    slots carry val 0).

    lane_major: run the backward through K2, whose (F, T·N) output keeps
    the JAX package's layout choice for huge T·N (its (T·N, F~6) layout
    pads 21x on the TPU). The port keeps the same rule, so both packages
    run the same kernel on the same input.

    Tensors are on the CPU after ``make_readout_plan``; ``to`` moves them.
    """

    src: torch.Tensor  # (E,) int32 flat src ids
    trg: torch.Tensor  # (E,) int32 flat trg ids
    sort_cols: torch.Tensor  # (J*C,) int32 indices into the unsorted (2E,) grads
    packed: PackedSpmm  # scatter packing over the sorted rows
    n_rows: int  # T*N
    lane_major: bool = False

    def to(self, device: str | torch.device) -> "ReadoutPlan":
        return dataclasses.replace(
            self,
            src=self.src.to(device),
            trg=self.trg.to(device),
            sort_cols=self.sort_cols.to(device),
            packed=self.packed.to(device),
        )


# Past this padded-bytes budget for the standard kernel's (T*N, F)
# cotangent (~rows/8 * 4 kB in the TPU's tiled layout), the plan switches
# to the lane-major kernel. The JAX package's rule, kept as it is; whether
# the switch pays on the H100 is an open question (ROADMAP queue 2).
LANE_MAJOR_BYTES = 2 << 30


def make_readout_plan(
    edges,
    n_slices: int,
    n_nodes: int,
    chunk: int = 256,
    window: int = 256,
    lane_major: bool | None = None,
) -> ReadoutPlan:
    """Build the plan host-side (numpy), once per edge set.

    edges: (3, E) [slice, src, trg]. lane_major=None auto-selects K2 past
    LANE_MAJOR_BYTES of padded standard-layout cotangent.
    """
    if lane_major is None:
        lane_major = (n_slices * n_nodes // 8 + 1) * 4096 > LANE_MAJOR_BYTES
    edges_np = np.asarray(edges)
    E = edges_np.shape[1]
    src = edges_np[0].astype(np.int64) * n_nodes + edges_np[1]
    trg = edges_np[0].astype(np.int64) * n_nodes + edges_np[2]
    both = np.concatenate([src, trg])  # (2E,)
    perm = np.argsort(both, kind="stable")
    # The SpMM packer over the sorted scatter targets, whose cols index the
    # sorted gradient stream. all_windows=False: the scatter touches ~2E
    # of T*N rows, so only windows with entries get chunks and the
    # backward passes a zero init as the output store.
    packed = pack_windowed_flat(
        both[perm],
        np.arange(2 * E, dtype=np.int64),
        np.ones(2 * E, np.float32),
        n_slices * n_nodes,
        chunk=chunk,
        window=window,
        all_windows=False,
    )
    sort_cols = perm[np.asarray(packed.cols).reshape(-1)].astype(np.int32)
    return ReadoutPlan(
        src=torch.from_numpy(src.astype(np.int32)),
        trg=torch.from_numpy(trg.astype(np.int32)),
        sort_cols=torch.from_numpy(sort_cols),
        packed=packed.to("cpu"),
        n_rows=n_slices * n_nodes,
        lane_major=bool(lane_major),
    )


class _ApplyReadout(torch.autograd.Function):
    """Logits flat[src] @ U_src + flat[trg] @ U_trg; backward through K1/K2."""

    @staticmethod
    def forward(ctx, Y, U, plan):
        F = Y.shape[-1]
        flat = Y.reshape(plan.n_rows, F)
        U2 = U.to(Y.dtype)
        ctx.plan = plan
        ctx.save_for_backward(Y, U)
        return flat.index_select(0, plan.src) @ U2[:F] + flat.index_select(0, plan.trg) @ U2[F:]

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        Y, U = ctx.saved_tensors
        F = Y.shape[-1]
        flat = Y.reshape(plan.n_rows, F)
        U2 = U.to(Y.dtype)
        dY = dU = None
        if ctx.needs_input_grad[1]:
            dU = torch.cat(
                [flat.index_select(0, plan.src).T @ g, flat.index_select(0, plan.trg).T @ g]
            ).to(U.dtype)
        if ctx.needs_input_grad[0]:
            packed = plan.packed
            if plan.lane_major:
                # Every big intermediate keeps rows on the last axis: (F, 2E)
                # gradient rows, (J, F, C) chunks, (F, n_rows_out) output.
                d_both_t = torch.cat([U2[:F] @ g.T, U2[F:] @ g.T], dim=1)  # (F, 2E)
                gathered_t = (
                    d_both_t.index_select(1, plan.sort_cols)
                    .reshape(F, packed.n_chunks, packed.chunk)
                    .permute(1, 0, 2)
                    .contiguous()
                )
                dflat_t = windowed_segment_matmul_t(
                    packed, gathered_t,
                    init=torch.zeros((F, packed.n_rows_out), dtype=g.dtype, device=g.device),
                )
                dY = dflat_t[:, : plan.n_rows].T.reshape(Y.shape)
            else:
                d_both = torch.cat([g @ U2[:F].T, g @ U2[F:].T])  # (2E, F)
                gathered = d_both.index_select(0, plan.sort_cols).reshape(
                    packed.n_chunks, packed.chunk, F
                )
                dflat = windowed_segment_matmul(
                    packed, gathered,
                    init=torch.zeros((packed.n_rows_out, F), dtype=g.dtype, device=g.device),
                )
                dY = dflat[: plan.n_rows].reshape(Y.shape)
        return dY, dU, None


def apply_readout(plan: ReadoutPlan, Y: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """(E, C) logits of ``edge_readout`` with the plan's kernel backward."""
    return _ApplyReadout.apply(Y, U, plan)


def readout_operator(plan: ReadoutPlan):
    """Bind a plan into op(Y, U) -> logits."""
    return lambda Y, U: apply_readout(plan, Y, U)


def make_readout_operator(
    edges, n_slices: int, n_nodes: int, chunk: int = 256, window: int = 256,
    *, device: str | torch.device,
):
    """Closure form of the plan on ``device``: op(Y, U) -> logits."""
    return readout_operator(make_readout_plan(edges, n_slices, n_nodes, chunk, window).to(device))

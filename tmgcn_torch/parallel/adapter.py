"""Sharded ModelAdapter: TM-GCN, TM-GCN 2 and KW-GCN on a (graph x time)
mesh behind the standard loops (port of the banded half of
tmgcn_tpu.parallel.adapter).

Builds a :class:`tmgcn_torch.tasks.adapters.ModelAdapter` whose ``apply``
runs this rank's part of the forward with explicit collectives
(``collectives``), so the *unmodified* training loops (train/loop.py —
evaluation cadence, the captured step on a card) train sharded. Every rank
runs the same loop; the loss, the logits the loop scores and the
parameters are the same on every rank.

Data movement per training step (the JAX package's layout):

  * the parameter-independent layer-1 propagation AtXt = Ct ⊛ (M ×₁ X) is
    computed ONCE at adapter build (banded halo exchange along ``time``
    for the M-transform, row-local SpMM along ``graph``) and cached: each
    rank keeps its (T_loc, N_loc, F0) block, the single-device cached
    propagation including the reference's f32 buffer truncation.
  * a step's forward reads the cached block, applies W (and for 2 layers:
    nonlin -> all-gather of the rows along ``graph`` -> layer-2 local SpMM
    -> W2), then the **partitioned edge readout**: labelled edges are
    bucketed by time shard host-side; each shard scores the endpoint rows
    it owns and one sum over ``graph`` assembles its bucket's logits. A
    gather of the (Eb, C) bucket logits along ``time`` and a precomputed
    inverse permutation restore the original edge order for ``apply``;
    ``train_stats`` (the loop's plain epochs) reduces loss and confusion
    counts over the buckets instead, with no gather.

A rank holds only its (time, graph) shard of every bundle tensor; ``pos``
and ``n_edges`` are replicated. The shard-local SpMMs are the port's
sorted segment sum (ops/spmm.py) on each shard's unpadded entry stream,
or, for layer 2, the shard's own block-dense operator (ops/spmm_blockdense,
``torch.matmul``): the JAX package's ``segment_sum`` and XLA block-dense
dots, no hand-written kernel.

The recurrent families (EvolveGCN-H, WD-GCN) recur over time, so they
shard over ``graph`` only (``n_time`` 1): the features X stay replicated,
the cached A @ X, the (T, N, F1) embeddings and the edge readout are
sharded. A step issues no collective for WD-GCN (the LSTM is node-local)
and none for 1-layer EvolveGCN besides the readout's sum and the gradient
sum (the GRU's summaries read the replicated X, so every rank evolves the
same weights); 2-layer EvolveGCN adds a distributed top-k (each shard's
candidates, gathered over ``graph``) and one all-gather of the hidden
layer for its layer-2 SpMM.

``make_sharded_regression_adapter``: TM-GCN regression over the whole
mesh (the cached banded propagation, a node-local head), WD-GCN and
EvolveGCN-H regression over ``graph``; ``apply`` reassembles the whole
(T, N) output on every rank, so the unmodified ``run_regression`` trains
sharded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tmgcn_torch.core.mmatrix import band_offsets
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.common import nonlinearity
from tmgcn_torch.models.evolvegcn import (
    EvolveGCN,
    EvolveGCNReg,
    _scores,
    _top_k,
    apply_slice_weights,
    evolve_from_summaries,
    evolve_weight_stack,
)
from tmgcn_torch.models.gcn import KWGCN
from tmgcn_torch.models.tmgcn import TMGCN, TMGCN2, TMGCNReg
from tmgcn_torch.models.wdgcn import WDGCN, WDGCNReg, lstm_scan
from tmgcn_torch.ops import spmm_blockdense
from tmgcn_torch.parallel import collectives
from tmgcn_torch.parallel.halo import banded_m_transform_local, local_banded_m
from tmgcn_torch.parallel.mesh import Mesh
from tmgcn_torch.parallel.partition import pad_time, partition_rows, shard_stream
from tmgcn_torch.parallel.tmgcn_sharded import local_spmm, masked_loss_sums, readout_partitioned
from tmgcn_torch.tasks.adapters import ModelAdapter

WINDOWS = ("train", "val", "test")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_edges_by_time(
    edges: np.ndarray, T_pad: int, n_time: int, pad_multiple: int = 128
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bucket (3, E) edges by time shard; local slice ids.

    Returns (edges_b (n_time, 3, Eb), mask (n_time, Eb), pos (E,)) where
    ``pos[e]`` is edge e's index in the bucket-concatenated order —
    ``stacked.reshape(n_time * Eb, C)[pos]`` restores original order.
    """
    edges = np.asarray(edges)
    E = edges.shape[1]
    t_loc = T_pad // n_time
    shard_of = edges[0] // t_loc
    counts = [int(np.sum(shard_of == i)) for i in range(n_time)]
    Eb = _round_up(max(1, max(counts)), pad_multiple)
    edges_b = np.zeros((n_time, 3, Eb), np.int32)
    mask = np.zeros((n_time, Eb), bool)
    pos = np.zeros(E, np.int64)
    for i in range(n_time):
        m = shard_of == i
        k = int(m.sum())
        e = edges[:, m].copy()
        e[0] -= i * t_loc
        edges_b[i, :, :k] = e
        mask[i, :k] = True
        pos[np.nonzero(m)[0]] = i * Eb + np.arange(k)
    return edges_b, mask, pos


def _prepare_banded_window(A: TemporalCOO, X: np.ndarray, Mw: np.ndarray, mesh: Mesh,
                           halo: int):
    """This rank's tensors of one window for the banded propagation: its
    (time, graph) block of the row-partitioned adjacency as one sorted
    stream, its time slices of the features and its banded M block.
    Returns (bundle, T_pad, A_sh)."""
    T = A.n_slices
    T_pad = _round_up(T, mesh.n_time)
    if T_pad != T:
        X = np.concatenate([X, np.zeros((T_pad - T,) + X.shape[1:], X.dtype)], axis=0)
        M_full = np.zeros((T_pad, T_pad), Mw.dtype)
        M_full[:T, :T] = Mw
        Mw = M_full
    A_sh = pad_time(partition_rows(A, mesh.n_graph), mesh.n_time)
    m_blocks = local_banded_m(Mw, mesh.n_time, halo)
    t_loc = T_pad // mesh.n_time
    t0 = mesh.t * t_loc
    rows, cols, vals = shard_stream(A_sh, t0, t_loc, mesh.g, A.n_nodes)
    dev = mesh.device
    # float32: the JAX package's default float (x64 off).
    bundle = {
        "rows": torch.as_tensor(rows, device=dev),
        "cols": torch.as_tensor(cols, device=dev),
        "vals": torch.as_tensor(vals, dtype=torch.float32, device=dev),
        "X": torch.as_tensor(X[t0 : t0 + t_loc], dtype=torch.float32, device=dev),
        "m_block": torch.as_tensor(m_blocks[mesh.t], dtype=torch.float32, device=dev),
    }
    return bundle, T_pad, A_sh


@dataclasses.dataclass(frozen=True)
class _ShardCfg:
    n_local_rows: int
    halo: int
    n_layers: int
    nonlin2: str
    dtype: torch.dtype
    # Layer-2 M-mixing (the UCI apply_M_twice / apply_M_three_times
    # configuration, embedding_help_functions.py:342-346): each extra
    # mixing is one more banded halo exchange along ``time``.
    m2: bool = False
    m3: bool = False


def _l2_shard_streams(A_sh, n_time: int):
    """Each (time, graph) shard's flat layer-2 entry stream, time-major.

    Rows are shard-local over its T_loc slices; columns index the
    graph-gathered per-slice feature rows. Returns the common (n_in,
    n_out) too.
    """
    T_pad, G, _ = A_sh.rows.shape
    t_loc = T_pad // n_time
    N_pad = A_sh.n_local_rows * G  # graph-gathered row count per slice
    streams = [shard_stream(A_sh, ti * t_loc, t_loc, gi, N_pad)
               for ti in range(n_time) for gi in range(G)]
    return streams, t_loc * N_pad, t_loc * A_sh.n_local_rows


def _l2_blockdense_ratio(A_sh, n_time: int) -> float:
    """Stacked-block bytes vs tile-gather floor, summed over shards (the
    same on every rank)."""
    streams, _, _ = _l2_shard_streams(A_sh, n_time)
    ests = [spmm_blockdense.estimate(r, c) for r, c, _ in streams if len(r)]
    if not ests:
        return float("inf")
    bytes_ = sum(e["block_bytes"] for e in ests)
    floor = sum(e["gather_floor_bytes"] for e in ests)
    return bytes_ / max(floor, 1)


def _layer2(A_sh, mesh: Mesh, blockdense: bool) -> dict:
    """This shard's layer-2 operator: its own block-dense operator
    ("exact") as {"l2op"}, or its entry stream's columns into the
    graph-gathered rows as {"l2_cols"} for the sorted segment sum. A shard
    with no entry takes the segment sum: an empty block-dense operator
    would not read its input, and every rank's backward must reach the
    gather before it.

    The JAX package forces the incidences dense, so that the shards'
    operators stack into arrays of one shape; a rank here holds its own
    operator alone, so large incidences nest as ``make_flat_operator``
    nests them by default (dense, they would be (blocks x block columns)
    matrices: 1 GB each at chess's 1 x 1 train window)."""
    T_pad, G, _ = A_sh.rows.shape
    t_loc = T_pad // mesh.n_time
    N_pad = A_sh.n_local_rows * G
    r, c, v = shard_stream(A_sh, mesh.t * t_loc, t_loc, mesh.g, N_pad)
    if blockdense and len(r):
        op = spmm_blockdense.make_flat_operator(
            r, c, v, n_in=t_loc * N_pad, n_out=t_loc * A_sh.n_local_rows, mode="exact",
            max_bytes=None,
        )
        return {"l2op": op.to(mesh.device)}
    return {"l2_cols": torch.as_tensor(c, device=mesh.device)}


def _make_propagate(mesh: Mesh, sc: _ShardCfg):
    """AtXt = Ct ⊛ (M ×₁ X) of this rank's block: run once, cached."""

    @torch.no_grad()
    def propagate(bundle: dict) -> torch.Tensor:
        Xt = banded_m_transform_local(bundle["X"], bundle["m_block"], sc.halo, mesh.time_group)
        T_loc, N, F0 = Xt.shape
        out = local_spmm(bundle, Xt.reshape(T_loc * N, F0), T_loc * sc.n_local_rows)
        return out.reshape(T_loc, sc.n_local_rows, F0)

    return propagate


def _make_step_forward(mesh: Mesh, sc: _ShardCfg):
    """A step's forward on this rank: cached AtXt block -> (Eb, C) logits
    of its time bucket (the same on every rank of its graph group)."""
    nonlin = nonlinearity(sc.nonlin2)
    dtype = sc.dtype

    def step_forward(p: dict, bundle: dict) -> torch.Tensor:
        H = bundle["cached"].to(dtype)  # reference f32 buffer truncation
        U = p["U"].to(dtype)
        if sc.n_layers == 1:
            Y_loc = torch.matmul(H, p["W"].to(dtype))
        else:
            Y = nonlin(torch.matmul(H, p["W1"].to(dtype)))
            if sc.m2:
                # apply_M_twice: re-mix the layer-1 output through M before
                # the layer-2 propagation — node-local, so it runs on the
                # sharded tensor with one more banded halo exchange.
                Y = banded_m_transform_local(Y, bundle["m_block"], sc.halo, mesh.time_group)
            # Layer 2 gathers full-graph rows of this shard's slices: one
            # all-gather along graph (F1-wide — small).
            T_loc, N_loc, F1 = Y.shape
            Y_rows = collectives.all_gather(Y, mesh.graph_group)  # (G, T_loc, N_loc, F1)
            Y_rows = Y_rows.permute(1, 0, 2, 3).reshape(-1, F1)
            if "l2op" in bundle:
                Z = bundle["l2op"](Y_rows)
            else:
                Z = local_spmm(bundle, Y_rows, T_loc * N_loc, cols="l2_cols")
            Y_loc = torch.matmul(Z.to(dtype).reshape(T_loc, N_loc, F1), p["W2"].to(dtype))
            if sc.m3:
                # apply_M_three_times: one final banded mixing after layer 2
                # (native dtype — the reference's f64 upcast is its
                # interlayer_dtype parity quirk, unsupported here).
                Y_loc = banded_m_transform_local(Y_loc, bundle["m_block"], sc.halo,
                                                 mesh.time_group)
        flat = Y_loc.reshape(-1, Y_loc.shape[-1])
        return readout_partitioned(flat, bundle["edges_b"], bundle["mask"], U,
                                   sc.n_local_rows, mesh)

    return step_forward


def _model_plan(model, n_slices: int, M):
    """(n_layers, nonlin2, m2, m3, M, remap_params) of a supported model;
    the JAX package's refusals, with its messages."""
    if isinstance(model, KWGCN):
        # KWGCN = the TM-GCN pipeline with no temporal mixing: the same
        # sharded machinery under an identity M (halo 0 — the banded
        # exchange degenerates to a local copy).
        if model.interlayer_dtype is not None:
            raise NotImplementedError(
                "sharded KWGCN does not reproduce interlayer_dtype (the "
                "f64 parity cast); use the single-device adapter"
            )
        # 1-layer KWGCN names its weight W1 (models/gcn.py); the step reads W.
        remap = (lambda p: {"W": p["W1"], "U": p["U"]}) if model.n_layers == 1 else None
        return model.n_layers, model.nonlin2, False, False, np.eye(n_slices), remap
    if isinstance(model, TMGCN2):
        if model.use_Minv or not model.condensed_W:
            raise NotImplementedError("sharded TMGCN2 supports condensed_W without Minv")
        if model.interlayer_dtype is not None:
            raise NotImplementedError(
                "sharded TMGCN2 does not reproduce interlayer_dtype (the "
                "f64 parity cast); use the single-device adapter"
            )
        return 2, model.nonlin2, model.apply_M_twice, model.apply_M_three_times, M, None
    if isinstance(model, TMGCN):
        if model.use_Minv or not model.condensed_W:
            raise NotImplementedError("sharded TMGCN supports condensed_W without Minv")
        if model.readout != "concat":
            raise NotImplementedError(
                "sharded TMGCN supports the concat readout (the "
                "partitioned readout splits U into src/trg halves)"
            )
        return 1, "relu", False, False, M, None
    raise TypeError(f"unsupported sharded model: {type(model).__name__}")


def make_sharded_edge_adapter(
    model,
    adj: dict[str, TemporalCOO],
    feats: dict[str, np.ndarray],
    edges: dict[str, np.ndarray],
    M: np.ndarray | None,
    mesh: Mesh,
    drop_last_slice: bool = False,
    l2_impl: str = "auto",
) -> ModelAdapter:
    """Sharded drop-in for tasks.adapters.make_edge_adapter, on this rank.

    Supports TMGCN and TMGCN2 (condensed_W, use_Minv=False; layer-2 default
    path AND the UCI apply_M_twice/apply_M_three_times mixing, each extra
    mixing one more banded halo exchange) and KWGCN (the no-M baseline:
    the same machinery with an identity M, so the banded exchange
    degenerates to a copy with halo 0) over a (graph x time) mesh.

    EvolveGCN and WDGCN shard over ``graph`` alone
    (``_make_recurrent_sharded_adapter``).

    l2_impl selects the per-epoch layer-2 SpMM: "blockdense" (each shard
    applies its own block-dense operator), "gather" (the sorted segment
    sum), or "auto" (block-dense whenever the shards' block tensors move
    fewer bytes than half the tile-gather floor — the JAX package's rule).
    """
    if isinstance(model, (EvolveGCN, WDGCN)):
        return _make_recurrent_sharded_adapter(model, adj, feats, edges, mesh, drop_last_slice)
    n_layers, nonlin2, m2, m3, M, remap_params = _model_plan(model, adj["train"].n_slices, M)
    M = np.asarray(M)
    halo = band_offsets(M)[0]

    bundles = {}
    shards = {}
    for w in WINDOWS:
        A, X = adj[w], np.asarray(feats[w])
        # KWGCN baselines use DISJOINT windows whose widths differ
        # (s_train vs s_val/s_test); size each window's identity M to it.
        Mw = np.eye(A.n_slices) if isinstance(model, KWGCN) else M
        if drop_last_slice:
            A = A.slice_window(0, A.n_slices - 1)
            X = X[:-1]
            Mw = Mw[:-1, :-1]
        bundle, T_pad, A_sh = _prepare_banded_window(A, X, Mw, mesh, halo)
        shards[w] = A_sh
        e_b, e_mask, e_pos = bucket_edges_by_time(edges[w], T_pad, mesh.n_time)
        bundle.update(
            edges_b=torch.as_tensor(e_b[mesh.t], dtype=torch.long, device=mesh.device),
            mask=torch.as_tensor(e_mask[mesh.t], device=mesh.device),
            pos=torch.as_tensor(e_pos, device=mesh.device),
            n_edges=int(np.asarray(edges[w]).shape[1]),
        )
        bundles[w] = bundle

    if n_layers == 2:
        if l2_impl == "auto":
            ratio = _l2_blockdense_ratio(shards["train"], mesh.n_time)
            l2_impl = "blockdense" if ratio < 0.5 else "gather"
        if l2_impl not in ("blockdense", "gather"):
            raise ValueError(f"unknown l2_impl: {l2_impl!r}")
        for w in WINDOWS:
            bundles[w].update(_layer2(shards[w], mesh, l2_impl == "blockdense"))

    sc = _ShardCfg(
        n_local_rows=shards["train"].n_local_rows,
        halo=halo,
        n_layers=n_layers,
        nonlin2=nonlin2,
        dtype=model.dtype,
        m2=m2,
        m3=m3,
    )
    propagate = _make_propagate(mesh, sc)
    step_forward = _make_step_forward(mesh, sc)

    # Cache the parameter-independent layer-1 propagation of this rank's
    # block (the single-device adapters do the same — the reference caches
    # AtXt at model init, embedding_help_functions.py:195).
    for b in bundles.values():
        b["cached"] = propagate(b)
        del b["X"]

    def bucket_logits(variables: dict, bundle: dict) -> torch.Tensor:
        p = collectives.copy_params(variables["params"], mesh.world)
        if remap_params is not None:
            p = remap_params(p)
        return step_forward(p, bundle)

    def apply(variables, bundle, carry):
        stacked = collectives.gather_from(bucket_logits(variables, bundle), mesh.time_group)
        flat = stacked.reshape(-1, stacked.shape[-1])
        return flat.index_select(0, bundle["pos"]), carry

    def train_stats(variables, bundle, tgt, cw, logit_transform=None, confusion=True):
        """Loss and (with ``confusion``) the tp/fp/fn counts WITHOUT
        restoring edge order.

        ``apply``'s ``flat[pos]`` gathers the (E, C) logits along ``time``.
        Loss and confusion counts are permutation-invariant sums, so the
        loop's plain epochs take them on this rank's bucket logits: its
        targets are scattered into bucket order (tiny, the same on every
        rank) and the masked sums are summed over ``time``.
        """
        flat = bucket_logits(variables, bundle)
        if logit_transform is not None:
            flat = logit_transform(flat)
        Eb = flat.shape[0]
        tgt_b = torch.zeros(mesh.n_time * Eb, dtype=tgt.dtype, device=tgt.device)
        tgt_b = tgt_b.index_copy(0, bundle["pos"], tgt)[mesh.t * Eb : (mesh.t + 1) * Eb]
        mask = bundle["mask"]
        sums = collectives.reduce_from(masked_loss_sums(flat, tgt_b, mask, cw), mesh.time_group)
        if not confusion:
            return sums[0] / sums[1], ()
        guess = torch.argmax(flat, dim=1)
        counts = torch.stack([
            torch.sum((guess == 0) & (tgt_b == 0) & mask),
            torch.sum((guess == 0) & (tgt_b != 0) & mask),
            torch.sum((guess != 0) & (tgt_b == 0) & mask),
        ])
        counts = collectives.all_reduce_(counts, mesh.time_group)
        return sums[0] / sums[1], tuple(counts)

    def init(generator):
        return model.init(generator, mesh.device)

    return ModelAdapter(init, apply, bundles, mesh.device, train_stats=train_stats)


# ---------------------------------------------------------------------------
# Recurrent families (EvolveGCN-H, WD-GCN) over the graph axis (the JAX
# package's tmgcn_tpu/parallel/adapter.py:572-830).
# ---------------------------------------------------------------------------


def _recurrent_window(A: TemporalCOO, X: np.ndarray, mesh: Mesh, layer2: bool) -> tuple[dict, int]:
    """This rank's tensors of one window for the graph-only families: its
    row block of every slice as one sorted stream whose columns index the
    replicated (T, N) feature rows, X whole, and with ``layer2`` the same
    entries' columns into the graph-gathered (T, N_pad) hidden rows
    ("l2_cols"). Returns (bundle, n_local_rows)."""
    A_sh = partition_rows(A, mesh.n_graph)
    T = A.n_slices
    rows, cols, vals = shard_stream(A_sh, 0, T, mesh.g, A.n_nodes)
    dev = mesh.device
    # float32: the JAX package's default float (x64 off).
    bundle = {
        "rows": torch.as_tensor(rows, device=dev),
        "cols": torch.as_tensor(cols, device=dev),
        "vals": torch.as_tensor(vals, dtype=torch.float32, device=dev),
        "X": torch.as_tensor(X, dtype=torch.float32, device=dev),
    }
    if layer2:
        n_pad = A_sh.n_local_rows * mesh.n_graph
        bundle["l2_cols"] = torch.as_tensor(shard_stream(A_sh, 0, T, mesh.g, n_pad)[1],
                                            device=dev)
    return bundle, A_sh.n_local_rows


@torch.no_grad()
def _recurrent_propagate(bundle: dict, n_local_rows: int) -> torch.Tensor:
    """(T, N_loc, F0): this rank's rows of the per-slice A @ X, X replicated."""
    T, N, F0 = bundle["X"].shape
    out = local_spmm(bundle, bundle["X"].reshape(T * N, F0), T * n_local_rows)
    return out.reshape(T, n_local_rows, F0)


def _wdgcn_embed(model, p: dict, b: dict, AX: torch.Tensor) -> torch.Tensor:
    """WD-GCN's (T, N_loc, F1) LSTM outputs of this rank's rows: the LSTM is
    node-local, so it needs no collective."""
    AX = AX.to(model.dtype)  # reference f32 buffer truncation
    Y = torch.relu(torch.matmul(AX, p["W"].to(AX.dtype)))
    return lstm_scan(p["lstm"], b["h_init"], b["c_init"], Y)


def _distributed_summaries(H1: torch.Tensor, p2: torch.Tensor, k2: int, n_real: int,
                           mesh: Mesh) -> torch.Tensor:
    """(T, F1, k2): the layer-2 GRU inputs summarize(H1_t, p2, k2)^T of the
    graph-sharded (T, N_loc, F1) hidden rows, as ``jax.lax.top_k`` orders
    the whole rows.

    Each shard takes its k_loc = min(k2, N_loc) best rows (padding rows,
    global id >= ``n_real``, scored -inf) in ``_top_k``'s order; the
    candidates' values and rows (one float gather) and global ids (one
    integer gather) go over ``graph``; every rank then orders the G·k_loc
    candidates by (-value, global id) with two stable sorts and keeps the
    first k2. Every global winner is among its shard's candidates, so
    this is the single-device top-k, equal scores in index order. The
    summaries feed this rank's own rows (S2 -> W2s -> its layer-2 rows), so
    the float gather takes the summing backward rule.
    """
    T, N_loc, F1 = H1.shape
    y = _scores(H1, p2)  # (T, N_loc)
    ids = mesh.g * N_loc + torch.arange(N_loc, device=H1.device)
    y = torch.where(ids < n_real, y, torch.full((), -torch.inf, dtype=y.dtype, device=y.device))
    k_loc = min(k2, N_loc)
    top_y, idx = _top_k(y, k_loc)  # (T, k_loc)
    cand = H1.gather(1, idx[..., None].expand(-1, -1, F1)).to(top_y.dtype)
    G = mesh.n_graph
    packed = collectives.all_gather(torch.cat([top_y[..., None], cand], dim=-1), mesh.graph_group)
    packed = packed.permute(1, 0, 2, 3).reshape(T, G * k_loc, 1 + F1)
    ids_c = collectives.all_gather(ids[idx], mesh.graph_group).permute(1, 0, 2).reshape(T, -1)
    order = torch.argsort(ids_c, dim=-1, stable=True)
    by_value = torch.sort(packed[..., 0].gather(-1, order), dim=-1, descending=True, stable=True)
    order = order.gather(-1, by_value.indices)[:, :k2]
    picked = packed.gather(1, order[..., None].expand(-1, -1, 1 + F1))  # (T, k2, 1 + F1)
    return (picked[..., 1:] * picked[..., :1]).transpose(1, 2)


def _evolvegcn_embed(model, p: dict, inits: tuple, bundle: dict, n_real: int,
                     mesh: Mesh) -> tuple[torch.Tensor, tuple]:
    """EvolveGCN-H's (T, N_loc, F) embeddings of this rank's rows and the
    evolved final weights (replicated). Layer 1's summaries read the
    replicated X, so every rank evolves the same W1s with no collective;
    layer 2 takes its summaries from ``_distributed_summaries`` and
    all-gathers the hidden rows once for its SpMM."""
    AX = bundle["cached_ax"]
    W_fin, W1s = evolve_weight_stack(p["cell1"], bundle["X"], inits[0])
    if model.n_layers == 1:
        return apply_slice_weights(AX, W1s).to(model.store_dtype), (W_fin,)
    H1 = torch.relu(apply_slice_weights(AX, W1s))
    S2 = _distributed_summaries(H1, p["cell2"]["p"], inits[1].shape[1], n_real, mesh)
    W2_fin, W2s = evolve_from_summaries(p["cell2"], S2, inits[1])
    T, N_loc, F1 = H1.shape
    H1_rows = collectives.all_gather(H1, mesh.graph_group)  # (G, T, N_loc, F1)
    H1_rows = H1_rows.permute(1, 0, 2, 3).reshape(-1, F1)
    Z = local_spmm(bundle, H1_rows, T * N_loc, cols="l2_cols").reshape(T, N_loc, F1)
    return apply_slice_weights(Z, W2s).to(model.store_dtype), (W_fin, W2_fin)


def _graph_only(mesh: Mesh, what: str) -> None:
    """The JAX package's refusal of a time axis for a recurrent family."""
    if mesh.n_time != 1:
        raise NotImplementedError(
            f"{what} recur over time; shard over graph only "
            f"(--mesh {mesh.n_graph * mesh.n_time}x1), got n_time={mesh.n_time}"
        )


def _make_recurrent_sharded_adapter(
    model,
    adj: dict[str, TemporalCOO],
    feats: dict[str, np.ndarray],
    edges: dict[str, np.ndarray],
    mesh: Mesh,
    drop_last_slice: bool,
) -> ModelAdapter:
    """EvolveGCN-H (1 or 2 layers) and WD-GCN over ``graph`` (n_time 1).

    A bundle holds this rank's row block of the window's adjacency, the
    replicated X, the cached A @ X of its rows and its edge bucket (every
    labelled edge: one time shard). ``apply`` returns the (E, C) logits in
    edge order, the same on every rank, and EvolveGCN's evolved final
    weights as the carry (``()``: the frozen W_init buffers). There is no
    ``train_stats``: the loops' plain epochs run ``apply``, as the JAX
    package's do.
    """
    _graph_only(mesh, "EvolveGCN/WD-GCN")
    evolve = isinstance(model, EvolveGCN)
    if evolve and model.n_layers not in (1, 2):
        raise NotImplementedError("sharded EvolveGCN supports 1 or 2 layers")

    bundles = {}
    n_local_rows = None
    for w in WINDOWS:
        A, X = adj[w], np.asarray(feats[w])
        if drop_last_slice:
            A = A.slice_window(0, A.n_slices - 1)
            X = X[:-1]
        bundle, n_loc = _recurrent_window(A, X, mesh, evolve and model.n_layers == 2)
        if w == "train":
            n_local_rows = n_loc
        e_b, e_mask, e_pos = bucket_edges_by_time(edges[w], A.n_slices, 1)
        bundle.update(
            edges_b=torch.as_tensor(e_b[0], dtype=torch.long, device=mesh.device),
            mask=torch.as_tensor(e_mask[0], device=mesh.device),
            pos=torch.as_tensor(e_pos, device=mesh.device),
            n_edges=int(np.asarray(edges[w]).shape[1]),
        )
        # The parameter-independent A @ X of this rank's rows, cached (the
        # single-device adapters cache the same).
        bundle["cached_ax"] = _recurrent_propagate(bundle, n_loc)
        if not evolve:
            del bundle["X"]  # WD-GCN reads only A @ X
        bundles[w] = bundle
    n_real = adj["train"].n_nodes

    def readout(Y: torch.Tensor, U: torch.Tensor, bundle: dict) -> torch.Tensor:
        flat = Y.reshape(-1, Y.shape[-1])
        logits = readout_partitioned(flat, bundle["edges_b"], bundle["mask"], U.to(flat.dtype),
                                     n_local_rows, mesh)
        return logits.index_select(0, bundle["pos"])

    def init(generator):
        return model.init(generator, mesh.device)

    if not evolve:

        def apply(variables, bundle, carry):
            p = collectives.copy_params(variables["params"], mesh.world)
            b = variables["buffers"]
            Z = _wdgcn_embed(model, p, b, bundle["cached_ax"])
            return readout(Z, b["U"], bundle), carry  # U: frozen, never trained

        return ModelAdapter(init, apply, bundles, mesh.device)

    names = ("W_init1", "W_init2")[: model.n_layers]

    def initial_carry(variables):
        return tuple(variables["buffers"][k] for k in names)

    def apply(variables, bundle, carry):
        p = collectives.copy_params(variables["params"], mesh.world)
        inits = carry if carry else initial_carry(variables)
        Y, finals = _evolvegcn_embed(model, p, inits, bundle, n_real, mesh)
        return readout(Y, p["U"], bundle), finals

    return ModelAdapter(init, apply, bundles, mesh.device, initial_carry)


# ---------------------------------------------------------------------------
# Regression (the SEIR task): the (T, N) node outputs (the JAX package's
# tmgcn_tpu/parallel/adapter.py:833-992).
# ---------------------------------------------------------------------------


def _window_shapes(adj: dict[str, TemporalCOO]) -> tuple[int, int]:
    """(T, N), the same in every window (same_block_size)."""
    shapes = {(adj[w].n_slices, adj[w].n_nodes) for w in WINDOWS}
    if len(shapes) != 1:
        raise NotImplementedError(f"windows differ in shape: {sorted(shapes)}")
    return shapes.pop()


def _assemble(out: torch.Tensor, mesh: Mesh, T: int, N: int) -> torch.Tensor:
    """The whole (T, N) output on every rank from this rank's (T_loc, N_loc)
    block: gathered over ``graph`` (and ``time``), cut to [:T, :N]. The loss
    reads the whole output on every rank, a replicated consumer, so each
    gather's backward takes this rank's slice and sums nothing
    (``collectives.gather_from``); ``copy_params`` then sums the
    parameters' gradient over the world."""
    rows = collectives.gather_from(out, mesh.graph_group)  # (G, T_loc, N_loc)
    rows = rows.permute(1, 0, 2).reshape(out.shape[0], -1)
    if mesh.n_time > 1:
        rows = collectives.gather_from(rows, mesh.time_group).reshape(-1, rows.shape[1])
    return rows[:T, :N]


def _head(p: dict, Y: torch.Tensor) -> torch.Tensor:
    """The per-node linear regression head: (..., F1) -> (...)."""
    out = torch.matmul(Y, p["lin_w"].to(Y.dtype)) + p["lin_b"].to(Y.dtype)
    return out[..., 0]


def make_sharded_regression_adapter(
    model,
    adj: dict[str, TemporalCOO],
    feats: dict[str, np.ndarray],
    M: np.ndarray | None,
    mesh: Mesh,
) -> ModelAdapter:
    """Sharded drop-in for tasks.adapters.make_regression_adapter, on this
    rank.

    TMGCNReg (condensed_W, without M⁻¹) over the whole (graph x time)
    mesh: the cached banded propagation of this rank's block, as the edge
    adapter caches it, and a node-local head. WDGCNReg and EvolveGCNReg
    over ``graph``: the cached A @ X of this rank's rows, the LSTM or the
    weights evolved from the replicated X. ``apply`` returns the whole
    (T, N) output on every rank and the carry unchanged (EvolveGCNReg
    evolves from ``carry[0]`` when given, else from W_init1).
    """
    T, N = _window_shapes(adj)

    def init(generator):
        return model.init(generator, mesh.device)

    if isinstance(model, TMGCNReg):
        if model.use_Minv or not model.condensed_W:
            raise NotImplementedError("sharded TMGCNReg supports condensed_W without Minv")
        M = np.asarray(M)
        halo = band_offsets(M)[0]
        bundles = {}
        for w in WINDOWS:
            bundles[w], _, A_sh = _prepare_banded_window(adj[w], np.asarray(feats[w]), M, mesh,
                                                         halo)
        sc = _ShardCfg(n_local_rows=A_sh.n_local_rows, halo=halo, n_layers=1, nonlin2="relu",
                       dtype=model.dtype)
        propagate = _make_propagate(mesh, sc)
        for b in bundles.values():
            b["cached"] = propagate(b)
            del b["X"]
        dtype = model.dtype

        def apply(variables, bundle, carry):
            p = collectives.copy_params(variables["params"], mesh.world)
            H = bundle["cached"].to(dtype)  # reference f32 buffer truncation
            Y = torch.matmul(H, p["W"].to(dtype))
            return _assemble(_head(p, Y), mesh, T, N), carry

        return ModelAdapter(init, apply, bundles, mesh.device)

    if not isinstance(model, (EvolveGCNReg, WDGCNReg)):
        raise TypeError(f"unsupported regression model: {type(model).__name__}")
    _graph_only(mesh, "EvolveGCNReg/WDGCNReg")

    bundles = {}
    for w in WINDOWS:
        bundles[w], n_local_rows = _recurrent_window(adj[w], np.asarray(feats[w]), mesh, False)
        bundles[w]["cached_ax"] = _recurrent_propagate(bundles[w], n_local_rows)

    if isinstance(model, WDGCNReg):
        for b in bundles.values():
            del b["X"]

        def apply(variables, bundle, carry):
            p = collectives.copy_params(variables["params"], mesh.world)
            Z = _wdgcn_embed(model, p, variables["buffers"], bundle["cached_ax"])
            return _assemble(_head(p, Z), mesh, T, N), carry

        return ModelAdapter(init, apply, bundles, mesh.device)

    def apply(variables, bundle, carry):
        # The GRU's summaries read the replicated X, so the evolved weights
        # are the same on every rank with no collective.
        p = collectives.copy_params(variables["params"], mesh.world)
        W0 = carry[0] if carry else variables["buffers"]["W_init1"]
        _, Ws = evolve_weight_stack(p["cell1"], bundle["X"], W0)
        Y = apply_slice_weights(bundle["cached_ax"], Ws).to(model.store_dtype)
        return _assemble(_head(p, Y), mesh, T, N), carry

    return ModelAdapter(init, apply, bundles, mesh.device)

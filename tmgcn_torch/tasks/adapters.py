"""Model-family adapters: one calling convention across architectures
(port of tmgcn_tpu.tasks.adapters: the edge branches of TM-GCN (1 and 2
layers), KW-GCN, EvolveGCN-H and WD-GCN, and the regression branches of
TM-GCN, EvolveGCN-H and WD-GCN).

Adapters prepare per-window data bundles on the device, once, and expose:

    init(generator) -> variables
    apply(variables, bundle, carry) -> (output, new_carry)
    bundles[window] -> the dict of tensors for that window

For 1-layer condensed TM-GCN the parameter-independent propagation
Ct ⊛ (M ×₁ X) is computed once per distinct window at build time (through
the SpMM impl the model names: K1 for ``"pallas"``) and only the per-edge
endpoint rows of it are kept, so a training epoch is two small matmuls —
no gather in the forward, no scatter in the backward.

2-layer condensed TM-GCN (without M⁻¹ or the second M mixing) caches the
first-layer propagation the same way, then runs layer 2 restricted to the
rows the readout reads: a rectangular (endpoint rows x used input rows)
sparse operator, built once per window from the model's impl (K1 for
``"pallas"``, K1's bf16 tier for ``"pallas_bf16"``, ``"blockdense"``,
``"rowsplit"``; ``"auto"`` otherwise), forward and backward every epoch.
With ``l2_stream_chunks`` that layer 2 is streamed instead: one K1
operator per group of time slices, run one after the other, so that the
device holds one group's gathered chunks at a time. Other 2-layer TM-GCNs,
and 1-layer TM-GCNs with per-slice weights or M⁻¹, run the model's own
layers on the cached propagation with the readout plan.

WD-GCN caches its propagation AX once per window (transposed to
(T, F0, N)) and runs the LSTM and the edge readout every epoch; the
readout's backward goes through the bundle's ``ReadoutPlan`` (K1, or K2
past ``LANE_MAJOR_BYTES``) where one is built.

KW-GCN caches AX as WD-GCN does: at 1 layer an epoch is the TM-GCN fast
path's two matmuls on the endpoint rows; at 2 layers it runs the layer-2
SpMM (the prepacked operator of the model's impl: K1 for ``"pallas"``)
and the readout plan every epoch.

EvolveGCN caches AX and takes the JAX adapter's path by its byte
budgets: at 1 layer the gather-free path (the GRU-only weight loop and
one-hot matmuls), at 2 layers the readout-restricted layer 2 with per-row
slice weights, and past either budget (or with ``embed_dtype`` set) the
model's own staged forward with the readout plan. Its carry is the
evolved final weights, threaded train -> val -> test by the loops.

The regression adapter (``make_regression_adapter``, the SEIR task)
caches TM-GCN's propagation and EvolveGCN's AX per window, as the JAX
package's does, and nothing for WD-GCN, whose AX is recomputed each step;
its carry is always ``()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tmgcn_torch.core.sparse import TemporalCOO, as_numpy
from tmgcn_torch.kernels import spmm_cuda
from tmgcn_torch.models.common import nonlinearity
from tmgcn_torch.models.evolvegcn import (
    EvolveGCN,
    EvolveGCNReg,
    apply_slice_weights,
    evolve_weight_stack,
)
from tmgcn_torch.models.gcn import KWGCN
from tmgcn_torch.models.tmgcn import TMGCN, TMGCN2, TMGCNReg
from tmgcn_torch.models.wdgcn import WDGCN, WDGCNReg
from tmgcn_torch.ops import spmm_blockdense, spmm_rowsplit
from tmgcn_torch.ops.edge_readout import make_readout_plan, readout_operator
from tmgcn_torch.ops.spmm import make_auto_operator, pack_operator
from tmgcn_torch.utils.profiling import span, spanned

WINDOWS = ("train", "val", "test")


def _cache_edge_rows(bundle: dict, dtype: torch.dtype) -> None:
    """Precompute the per-edge endpoint rows of the cached propagation.

    Stored as (E, F0) — ``cached_src`` / ``cached_trg`` — the JAX
    package's (F0, E) layout is a TPU lane-padding choice.
    """
    cached = bundle["cached"].to(dtype)  # reference f32 buffer truncation
    T, N, F0 = cached.shape
    flat = cached.reshape(T * N, F0)
    e = bundle["edges"]
    bundle["cached_src"] = flat[e[0] * N + e[1]]
    bundle["cached_trg"] = flat[e[0] * N + e[2]]


def _fast_edge_logits(W, U, bundle: dict, dtype: torch.dtype, readout: str = "concat"):
    """logits = (AtXt_src @ W) @ U_src + (AtXt_trg @ W) @ U_trg.

    Identical math to embed + edge_readout for 1-layer condensed models
    (row selection commutes with the right-matmul by W), with the tiny
    W @ U products folded first. The bilinear readout multiplies the
    endpoint embeddings elementwise instead.
    """
    W = W.to(dtype)
    F1 = W.shape[-1]
    U = U.to(dtype)
    src, trg = bundle["cached_src"], bundle["cached_trg"]
    if readout == "bilinear":
        return ((src @ W) * (trg @ W)) @ U
    return src @ (W @ U[:F1]) + trg @ (W @ U[F1:])


# The JAX package's restricted-operator rule picks the block-dense operator
# when its block bytes are under this share of the TPU gather floor
# (ops/spmm_blockdense.estimate). 0.5 is the TPU's calibration, kept as it is
# so both packages pick the same operator on their accelerator; re-deriving
# it for the H100 is open (ROADMAP queue 2).
BLOCKDENSE_RATIO = 0.5


def _build_restricted_layer2(
    bundle: dict,
    A: TemporalCOO,
    edges_np: np.ndarray,
    drop_last_slice: bool,
    operator: str = "auto",
    cached_key: str = "cached",
) -> tuple[np.ndarray, np.ndarray]:
    """Restrict the layer-2 propagation to readout-visible rows.

    The edge readout only gathers embedding rows at labelled-edge
    endpoints, so the per-epoch layer-2 SpMM A ⊛ Y only needs those output
    rows (the reference computes all N rows every epoch,
    embedding_help_functions.py:301-312,348-349). Both index spaces are
    compacted host-side: outputs to the unique endpoint rows, inputs to
    their unique in-neighbours. Layer 1 then runs on ``l2_Hin`` (the
    cached propagation at the used rows, gathered once here; rows outside
    the in-neighbourhood have zero cotangent, so dW1 is unchanged), the
    operator ``l2op`` is rectangular (endpoints x used), and the readout
    gathers from the compact rows ``l2_src`` / ``l2_trg``.

    ``operator``: "pallas", "pallas_bf16", "blockdense", "blockdense_bf16",
    "rowsplit", or "auto" / "auto_bf16": on a CUDA device the JAX
    package's accelerator rule (block-dense below ``BLOCKDENSE_RATIO``,
    else K1; block-dense over its byte budget falls back to K1), rowsplit
    elsewhere. The bundle's cached propagation fixes the device. Returns
    (uniq, used), the compacted output and input row ids.
    """
    device = bundle[cached_key].device
    est = None
    if drop_last_slice:
        A = A.slice_window(0, A.n_slices - 1)
    T, N = A.n_slices, A.n_nodes
    e = np.asarray(edges_np, np.int64)
    src_keys = e[0] * N + e[1]
    trg_keys = e[0] * N + e[2]
    uniq = np.unique(np.concatenate([src_keys, trg_keys]))
    g_rows, g_cols, g_vals = spmm_rowsplit.flatten_stream(A)
    idx = np.searchsorted(uniq, g_rows)
    idx = np.minimum(idx, len(uniq) - 1)
    member = uniq[idx] == g_rows
    used = np.unique(g_cols[member])
    rows_c = idx[member]
    cols_c = np.searchsorted(used, g_cols[member])
    vals_c = g_vals[member]
    if operator in ("auto", "auto_bf16"):
        bf = "_bf16" if operator.endswith("bf16") else ""
        if device.type == "cuda":
            est = spmm_blockdense.estimate(rows_c, cols_c, itemsize=2 if bf else 4)
            operator = ("blockdense" if est["ratio"] < BLOCKDENSE_RATIO else "pallas") + bf
        else:
            operator = "rowsplit"
    op = None
    if operator in ("blockdense", "blockdense_bf16"):
        try:
            op = spmm_blockdense.make_flat_operator(
                rows_c, cols_c, vals_c, n_in=len(used), n_out=len(uniq),
                mode="bf16" if operator.endswith("bf16") else "exact",
            )
        except ValueError:
            # Over the block tensor's byte budget; keep the precision class.
            operator = "pallas_bf16" if operator.endswith("bf16") else "pallas"
    if op is None and operator in ("pallas", "pallas_bf16"):
        op = spmm_cuda.make_flat_operator(
            rows_c, cols_c, vals_c, n_in=len(used), n_out=len(uniq), chunk=512, window=256,
            sort_cols=True, gather_dtype="bfloat16" if operator == "pallas_bf16" else None,
        )
    if op is None:
        op = spmm_rowsplit.make_flat_operator(
            rows_c, cols_c, vals_c, n_in=len(used), n_out=len(uniq), k=4
        )
    bundle["l2op"] = op.to(device)
    # The operator built and the ratio the accelerator rule saw (None where
    # it did not run), for the logs and the adapter.layer2 span (not a tensor).
    bundle["l2op_choice"] = {"operator": operator, "ratio": est["ratio"] if est else None}
    F0 = bundle[cached_key].shape[-1]
    bundle["l2_Hin"] = bundle[cached_key].reshape(T * N, F0)[
        torch.as_tensor(used, dtype=torch.long, device=device)
    ]
    bundle["l2_src"] = torch.as_tensor(np.searchsorted(uniq, src_keys), device=device)
    bundle["l2_trg"] = torch.as_tensor(np.searchsorted(uniq, trg_keys), device=device)
    return uniq, used


def _build_streamed_layer2(
    bundle: dict,
    A: TemporalCOO,
    edges_np: np.ndarray,
    drop_last_slice: bool,
    n_chunks: int,
    operator: str = "auto",
    cached_key: str = "cached",
) -> None:
    """The restricted layer 2 split into groups of time slices (streamed).

    The single restricted operator gathers its whole chunk stream every
    forward and backward; this build splits the T slices into ``n_chunks``
    groups of ``ceil(T / n_chunks)`` and packs one rectangular K1 operator
    per group, run one after the other, so that the device holds one
    group's gathered chunks at a time. All groups share the output rows
    ``U_pad`` (the most endpoint rows of a group) and the input rows
    ``S_max`` (the most used rows, at least 1). As in the JAX package the
    operators are K1 whatever ``operator`` names, in its bf16 tier for an
    impl ending in ``bf16``.

    Bundle keys: ``l2s_op`` (the groups' FlatPallasOperators, a list),
    ``l2op_choice`` (the operator's name, "pallas" or "pallas_bf16"),
    ``l2s_Hin`` (n_chunks, S_max, F0) — the cached propagation at each
    group's used rows, row 0 in the unused slots — and ``l2s_src`` /
    ``l2s_trg`` (E,): indices into the (n_chunks · U_pad, F1) stacked output.

    Each operator keeps its own chunk count: the JAX package pads the
    packings to one count only so that they stack into a ``lax.scan``
    operand. A group with no labelled edge (no slice at all, or entries
    but no endpoint) gets an operator with no entries, and its output rows
    are zeros.
    """
    device = bundle[cached_key].device
    if drop_last_slice:
        A = A.slice_window(0, A.n_slices - 1)
    T, N = A.n_slices, A.n_nodes
    t_per = -(-T // n_chunks)
    e = np.asarray(edges_np, np.int64)
    src_keys = e[0] * N + e[1]
    trg_keys = e[0] * N + e[2]
    edge_chunk = e[0] // t_per
    g_rows, g_cols, g_vals = spmm_rowsplit.flatten_stream(A)
    row_chunk = (g_rows // N) // t_per

    chunks = []
    for c in range(n_chunks):
        esel = edge_chunk == c
        uniq_c = np.unique(np.concatenate([src_keys[esel], trg_keys[esel]]))
        asel = row_chunk == c
        rows_a, cols_a, vals_a = g_rows[asel], g_cols[asel], g_vals[asel]
        if len(uniq_c):
            idx = np.minimum(np.searchsorted(uniq_c, rows_a), len(uniq_c) - 1)
            member = uniq_c[idx] == rows_a
        else:
            idx, member = np.zeros(len(rows_a), np.int64), np.zeros(len(rows_a), bool)
        used_c = np.unique(cols_a[member])
        chunks.append((uniq_c, used_c, idx[member], np.searchsorted(used_c, cols_a[member]),
                       vals_a[member]))

    U_pad = max(len(c[0]) for c in chunks)
    S_max = max(max(len(c[1]) for c in chunks), 1)
    gather_dtype = "bfloat16" if operator.endswith("bf16") else None
    bundle["l2s_op"] = [
        spmm_cuda.make_flat_operator(
            r, cc, v, n_in=S_max, n_out=U_pad, chunk=512, window=256, sort_cols=True,
            gather_dtype=gather_dtype,
        ).to(device)
        for (_, _, r, cc, v) in chunks
    ]
    hin = np.zeros((n_chunks, S_max), np.int64)
    for c, (_, used_c, *_rest) in enumerate(chunks):
        hin[c, : len(used_c)] = used_c
    F0 = bundle[cached_key].shape[-1]
    bundle["l2s_Hin"] = bundle[cached_key].reshape(T * N, F0)[
        torch.as_tensor(hin.reshape(-1), device=device)
    ].reshape(n_chunks, S_max, F0)

    def to_stream(keys):
        out = np.zeros(len(keys), np.int64)
        for c, (uniq_c, *_rest) in enumerate(chunks):
            sel = edge_chunk == c
            out[sel] = c * U_pad + np.searchsorted(uniq_c, keys[sel])
        return out

    bundle["l2s_src"] = torch.as_tensor(to_stream(src_keys), device=device)
    bundle["l2s_trg"] = torch.as_tensor(to_stream(trg_keys), device=device)
    # The operator built (K1 whatever ``operator`` names), for the logs and
    # the adapter.layer2 span (not a tensor).
    bundle["l2op_choice"] = {"operator": "pallas_bf16" if gather_dtype else "pallas",
                             "ratio": None}


def _layer2_rows(model: TMGCN2, W1: torch.Tensor, H: torch.Tensor, op) -> torch.Tensor:
    """op(nonlin2(H @ W1)) at the model's casts: the restricted layer 2's
    endpoint rows from the cached propagation's used rows ``H``."""
    dtype = model.dtype
    H = H.to(dtype)
    Y = nonlinearity(model.nonlin2)(torch.matmul(H, W1.to(H.dtype)))
    if model.interlayer_dtype is not None:
        Y = Y.to(model.interlayer_dtype)
    return op(Y).to(dtype)


def _folded_readout(p: dict, dtype: torch.dtype, Zc: torch.Tensor, src, trg) -> torch.Tensor:
    """Edge logits from layer 2's endpoint rows ``Zc`` (before W2).

    W2 @ U is folded before the per-edge gathers: the tiny (F1, C) products
    run on the endpoint rows instead of E, and the gathered width drops to C.
    """
    W2 = p["W2"].to(dtype)
    F2 = W2.shape[-1]
    U = p["U"].to(dtype)
    P1 = torch.matmul(Zc, W2 @ U[:F2])
    P2 = torch.matmul(Zc, W2 @ U[F2:])
    return P1[src] + P2[trg]


def _restricted_logits(model: TMGCN2, variables: dict, bundle: dict) -> torch.Tensor:
    """Edge logits of the readout-restricted 2-layer TM-GCN."""
    p = variables["params"]
    Zc = _layer2_rows(model, p["W1"], bundle["l2_Hin"], bundle["l2op"])
    return _folded_readout(p, model.dtype, Zc, bundle["l2_src"], bundle["l2_trg"])


def _streamed_logits(model: TMGCN2, variables: dict, bundle: dict) -> torch.Tensor:
    """Edge logits of the streamed restricted 2-layer TM-GCN: each group's
    rows in turn, stacked to (n_chunks · U_pad, F1). A group whose
    operator has no entry launches nothing: its rows are zeros, as its
    operator would write them. The groups' rows are freed once stacked
    (the list is a temporary), before the readout."""
    p = variables["params"]
    F1 = p["W1"].shape[-1]
    Zc = torch.cat([
        _layer2_rows(model, p["W1"], H_c, op_c) if op_c.packed.entry_order.shape[0]
        else H_c.new_zeros((op_c.n_out, F1), dtype=model.dtype)
        for op_c, H_c in zip(bundle["l2s_op"], bundle["l2s_Hin"].unbind(0))
    ])
    return _folded_readout(p, model.dtype, Zc, bundle["l2s_src"], bundle["l2s_trg"])


def _readout_fn(bundle: dict):
    """Bind a bundle's ReadoutPlan (if any) into an op(Y, U) callable."""
    if "readout" not in bundle:
        return None
    return readout_operator(bundle["readout"])


def _no_carry(variables: dict) -> tuple:
    return ()


@dataclasses.dataclass
class ModelAdapter:
    """Uniform (variables, bundle, carry) -> (output, carry) interface.

    ``initial_carry(variables)``: the carry a forward of the train window
    starts from when the loops' threading is replayed outside them (``cli
    predict``): EvolveGCN-H's frozen initial weights, ``()`` for the
    others.

    ``train_stats(variables, bundle, target, class_weights,
    logit_transform, confusion)``, where given (the sharded adapters of
    parallel/adapter.py), is (loss, (tp, fp, fn) or ()) of the train
    window without the full logits: the loops' plain epochs train on it.
    The single-device adapters leave it None."""

    init: Callable[[torch.Generator], dict]
    apply: Callable[[dict, dict, Any], tuple[torch.Tensor, Any]]
    bundles: dict[str, dict]
    device: torch.device
    initial_carry: Callable[[dict], tuple] = _no_carry
    train_stats: Callable | None = None


# The JAX package's prepacked-operator impls.
OPERATOR_IMPLS = (
    "pallas", "pallas_bf16", "rowsplit", "blockdense", "blockdense_bf16",
    "auto", "auto_bf16",
)


@spanned("adapter.bundles", sync=True)
def _prepare_bundles(
    adj: dict[str, TemporalCOO],
    feats: dict[str, Any],
    edges: dict[str, np.ndarray] | None,
    M: np.ndarray | None,
    drop_last_slice: bool,
    spmm_operator: str | None,
    device: str | torch.device,
    readout: bool,
) -> dict[str, dict]:
    """Per-window bundles on ``device``, moved there once.

    Windows that share the same adjacency/features/edges objects get one
    bundle (one device copy). ``readout``: the model gathers endpoint rows
    per step, so the bundles carry a ReadoutPlan where the JAX package
    builds one.
    """
    bundles = {}
    seen: dict[tuple, str] = {}
    for w in WINDOWS:
        key = (
            id(adj[w]), id(feats[w]),
            id(edges[w]) if edges is not None else None,
        )
        if key in seen:
            bundles[w] = bundles[seen[key]]
            continue
        seen[key] = w
        A, X = adj[w], np.asarray(feats[w])
        if drop_last_slice:
            A = A.slice_window(0, A.n_slices - 1)
            X = X[:-1]
        n_slices, n_nodes = A.n_slices, A.n_nodes
        choice = None
        if spmm_operator in ("auto", "auto_bf16"):
            # The full-row rule, with constants measured on the card;
            # unpacked off it, as the JAX package's off the TPU.
            A, choice = make_auto_operator(A, bf16=spmm_operator == "auto_bf16",
                                           feat=X.shape[-1], device=device)
        elif spmm_operator is not None:
            # Prepack the square operator (and its transpose) once, host-side,
            # with the arguments of spmm(impl=...).
            A = pack_operator(A, spmm_operator)
        # float32 features: the JAX package's default float (x64 off).
        bundle = {
            "adj": A.to(device),
            "X": torch.as_tensor(X, dtype=torch.float32, device=device),
        }
        if choice is not None:
            # What the full-row rule saw and picked, for the logs (not a tensor).
            bundle["op_choice"] = choice
        if edges is not None:
            bundle["edges"] = torch.as_tensor(
                np.asarray(edges[w]), dtype=torch.long, device=device
            )
            # The readout backward through the windowed kernels. The JAX
            # package builds the plan on the TPU for every edge model and
            # elsewhere only for operator-backed configs; the port reads
            # "on the TPU" as "on a CUDA device", and skips it for the
            # 1-layer fast path, whose epoch never gathers.
            if readout and (spmm_operator is not None or device.type == "cuda"):
                bundle["readout"] = make_readout_plan(
                    np.asarray(edges[w]), n_slices, n_nodes
                ).to(device)
        if M is not None:
            Mw = np.asarray(M)
            if drop_last_slice:
                Mw = Mw[:-1, :-1]
            bundle["M"] = torch.as_tensor(Mw, dtype=bundle["X"].dtype, device=device)
        bundles[w] = bundle
    return bundles


def _unique_windows(bundles: dict[str, dict]):
    """(window, bundle) for each distinct bundle dict, first window first
    (windows may share one)."""
    seen: set[int] = set()
    for w in WINDOWS:
        if id(bundles[w]) not in seen:
            seen.add(id(bundles[w]))
            yield w, bundles[w]


def _unique_bundles(bundles: dict[str, dict]):
    """Each distinct bundle dict once."""
    return (b for _, b in _unique_windows(bundles))


# The JAX package's one-hot budgets for EvolveGCN's gather-free paths: the
# (T, E) slice one-hot of the 1-layer path, and the (T, n_used + n_uniq)
# one-hots of the restricted 2-layer path, in bytes. Past them it runs the
# generic staged path with the readout plan. Chosen on a TPU and kept as
# they are, so that both packages take the same path; re-deriving them for
# the H100 is open (ROADMAP queue 2).
ONEHOT_BUDGET_1LAYER = 128 << 20
ONEHOT_BUDGET_RESTRICTED = 256 << 20


def _evolvegcn_path(
    model: EvolveGCN,
    adj: dict[str, TemporalCOO],
    edges: dict[str, np.ndarray],
    drop_last_slice: bool,
) -> str:
    """"gather_free", "restricted" or "generic": the JAX adapter's choice,
    from the same host-side byte counts (taken before anything is built)."""
    def n_slices(w):
        return adj[w].n_slices - (1 if drop_last_slice else 0)

    onehot_bytes = max(n_slices(w) * np.asarray(edges[w]).shape[1] * 4 for w in WINDOWS)
    same_dtype = model.store_dtype == model.dtype
    if model.n_layers == 1:
        if same_dtype and onehot_bytes <= ONEHOT_BUDGET_1LAYER:
            return "gather_free"
        return "generic"
    if not same_dtype:
        return "generic"
    oh_bytes = 0
    for w in WINDOWS:
        A = adj[w]
        e = np.asarray(edges[w], np.int64)
        keys = np.concatenate([e[0] * A.n_nodes + e[1], e[0] * A.n_nodes + e[2]])
        n_uniq = len(np.unique(keys))
        # n_used <= nnz: the cheap upper bound, without flattening the stream.
        n_used_bound = min(n_slices(w) * A.n_nodes, int(np.asarray(A.vals).size))
        oh_bytes = max(oh_bytes, n_slices(w) * (n_uniq + n_used_bound) * 4)
    return "restricted" if oh_bytes <= ONEHOT_BUDGET_RESTRICTED else "generic"


def _slice_onehot(slice_ids: np.ndarray, n_slices: int, device) -> torch.Tensor:
    """(T, n) float32 one-hot of each row's slice: ``W_stack @ onehot``
    maps per-slice weights to rows exactly (one product by 1, the rest 0)."""
    oh = np.zeros((n_slices, len(slice_ids)), np.float32)
    oh[slice_ids, np.arange(len(slice_ids))] = 1.0
    return torch.as_tensor(oh, device=device)


def _evolvegcn_gather_free(model: EvolveGCN, bundles: dict, edges: dict) -> Callable:
    """EvolveGCN 1-layer without gathers (the JAX adapter's fast path).

    logits[e] = ax_src[e] @ (W_{t_e} @ U_src) + ax_trg[e] @ (W_{t_e} @
    U_trg): an epoch is the GRU-only weight loop, two (C·F0, T) x (T, E)
    one-hot matmuls that map slice weights to edges, and an elementwise
    contraction over F0 — no (T, N, F1) embedding tensor, no gather, no
    scatter. The endpoint rows are kept as (F0, E), the JAX layout, so the
    contraction sums in its order.
    """
    for w, b in _unique_windows(bundles):
        ax = b["cached_ax"]
        T, N, F0 = ax.shape
        e = np.asarray(edges[w], np.int64)
        flat = ax.reshape(T * N, F0)
        b["ax_srcT"] = flat[torch.as_tensor(e[0] * N + e[1], device=ax.device)].T.contiguous()
        b["ax_trgT"] = flat[torch.as_tensor(e[0] * N + e[2], device=ax.device)].T.contiguous()
        b["edge_slice_ohT"] = _slice_onehot(e[0], T, ax.device)

    def apply(variables, bundle, carry):
        p = variables["params"]
        W0 = carry[0] if carry else variables["buffers"]["W_init1"]
        W_fin, Ws = model.evolved_weights(variables, bundle["X"], W0)
        dtype = model.dtype
        U = p["U"].to(dtype)
        F1 = Ws.shape[-1]
        Ws = Ws.to(dtype)
        oh = bundle["edge_slice_ohT"].to(dtype)
        logitsT = None
        for Upart, ax in ((U[:F1], bundle["ax_srcT"]), (U[F1:], bundle["ax_trgT"])):
            Wpart = torch.einsum("tfk,kc->cft", Ws, Upart)  # (C, F0, T)
            C, F0, T = Wpart.shape
            We = (Wpart.reshape(C * F0, T) @ oh).reshape(C, F0, -1)
            part = (We * ax.to(dtype)[None]).sum(1)  # (C, E)
            logitsT = part if logitsT is None else logitsT + part
        return logitsT.T, (W_fin,)

    return apply


def _evolvegcn_restricted(
    model: EvolveGCN, bundles: dict, adj: dict, edges: dict, drop_last_slice: bool
) -> Callable:
    """EvolveGCN 2-layer with the readout-restricted layer 2 (the JAX
    adapter's path for it).

    The layer-2 SpMM A ⊛ H1 computes only the endpoint rows, as TM-GCN 2's
    restricted path does, through the rectangular operator the ``auto``
    rule picks; but W1 and W2 differ per slice here, so they are applied
    row by row through (T, n_rows) one-hot matmuls. H1 still materializes
    in full once an epoch (one batched matmul, no SpMM), because the
    layer-2 top-k summaries score all N nodes
    (evolvegcn_functions.py:180-188).
    """
    for w, b in _unique_windows(bundles):
        uniq, used = _build_restricted_layer2(
            b, adj[w], as_numpy(edges[w]), drop_last_slice, operator="auto",
            cached_key="cached_ax",
        )
        T, N = b["cached_ax"].shape[:2]
        device = b["cached_ax"].device
        b["l2_HinT"] = b["l2_Hin"].T.contiguous()  # (F0, n_used)
        b["l2_used_ohT"] = _slice_onehot(used // N, T, device)
        b["l2_uniq_ohT"] = _slice_onehot(uniq // N, T, device)

    def apply(variables, bundle, carry):
        p, b0 = variables["params"], variables["buffers"]
        W0 = carry[0] if carry else b0["W_init1"]
        W20 = carry[1] if carry else b0["W_init2"]
        dtype = model.dtype
        W_fin, W1s = evolve_weight_stack(p["cell1"], bundle["X"], W0)
        H1 = torch.relu(apply_slice_weights(bundle["cached_ax"], W1s))
        W2_fin, W2s = evolve_weight_stack(p["cell2"], H1, W20)
        # Layer 1 at the used input rows with per-row slice weights:
        # Wrow[f, k, u] = W1s[t_u, f, k], one one-hot matmul.
        W1s = W1s.to(dtype)
        F0, F1 = W1s.shape[1], W1s.shape[2]
        Wrow = (W1s.permute(1, 2, 0).reshape(F0 * F1, -1) @ bundle["l2_used_ohT"].to(dtype))
        Wrow = Wrow.reshape(F0, F1, -1)
        HinT = bundle["l2_HinT"].to(dtype)
        H1uT = torch.relu((Wrow * HinT[:, None, :]).sum(0))  # (F1, n_used)
        Zc = bundle["l2op"](H1uT.T).to(dtype)  # (n_uniq, F1): endpoint rows only
        # W2_t @ U folded before the per-edge gathers, per slice.
        U = p["U"].to(dtype)
        W2s = W2s.to(dtype)
        F2 = W2s.shape[-1]
        oh_uniq = bundle["l2_uniq_ohT"].to(dtype)
        ZcT = Zc.T
        logitsT = None
        for Upart, idx in ((U[:F2], bundle["l2_src"]), (U[F2:], bundle["l2_trg"])):
            WU = torch.einsum("tfk,kc->fct", W2s, Upart)  # (F1, C, T)
            F1b, C = WU.shape[0], WU.shape[1]
            Wu = (WU.reshape(F1b * C, -1) @ oh_uniq).reshape(F1b, C, -1)
            part = (Wu * ZcT[:, None, :]).sum(0)[:, idx]  # (C, E)
            logitsT = part if logitsT is None else logitsT + part
        return logitsT.T, (W_fin, W2_fin)

    return apply


def make_edge_adapter(
    model,
    adj: dict[str, TemporalCOO],
    feats: dict[str, Any],
    edges: dict[str, np.ndarray],
    M: np.ndarray | None = None,
    drop_last_slice: bool = False,
    l2_stream_chunks: int | None = None,
    *,
    device: str | torch.device,
) -> ModelAdapter:
    """Adapter for edge-output models on prepared windows.

    Args:
        model: a TMGCN, TMGCN2, KWGCN, EvolveGCN or WDGCN.
        adj: per-window adjacency (Ct for TM-GCN, C for the baselines).
        feats: per-window (T, N, F) features.
        edges: per-window (3, E) model-input edges.
        M: mixing matrix (TM-GCN only).
        drop_last_slice: link-prediction convention — the model consumes
            slices [0, T-1) and M[:-1, :-1].
        l2_stream_chunks: the restricted TMGCN2 only (ignored by every
            other model): stream its layer 2 over this many groups of time
            slices, one K1 operator each (``_build_streamed_layer2``), so
            that the device holds one group's gathered chunks at a time.
            None: one operator.
        device: where the bundles live and the model runs (no default:
            the entry points resolve it, cuda unless asked otherwise).

    EvolveGCN's ``apply`` returns its evolved final weights as the carry,
    and takes them as the next window's initial weights (``()``: the
    frozen W_init buffers).
    """
    tmgcn1 = isinstance(model, TMGCN) and model.condensed_W and not model.use_Minv
    restricted2 = (
        isinstance(model, TMGCN2) and model.condensed_W and not model.use_Minv
        and not model.apply_M_twice
    )
    kwgcn1 = isinstance(model, KWGCN) and model.n_layers == 1
    evolve = (
        _evolvegcn_path(model, adj, edges, drop_last_slice)
        if isinstance(model, EvolveGCN) else None
    )
    if not isinstance(model, (TMGCN, TMGCN2, KWGCN, EvolveGCN, WDGCN)):
        raise TypeError(f"unsupported edge model: {type(model).__name__}")
    # EvolveGCN names no impl: the JAX package's propagation is plain spmm.
    impl = getattr(model, "spmm_impl", "jnp")
    # The restricted path runs the square operator once (the cached
    # propagation, through spmm(impl=...)), so it is not prepacked; the
    # impl goes to the restricted layer-2 operator instead.
    spmm_operator = impl if impl in OPERATOR_IMPLS and not restricted2 else None
    device = torch.device(device)
    bundles = _prepare_bundles(
        adj, feats, edges, M, drop_last_slice, spmm_operator, device,
        readout=not (tmgcn1 or restricted2 or kwgcn1 or evolve in ("gather_free", "restricted")),
    )

    def init(generator):
        return model.init(generator, device)

    if isinstance(model, EvolveGCN):
        # Layer-1 propagation is parameter-independent: cache A@X, so the
        # weight evolution keeps only parameter-dependent SpMMs (none for
        # 1 layer, layer 2's for 2 layers).
        with torch.no_grad():
            with span("adapter.propagate", sync=True):
                for b in _unique_bundles(bundles):
                    b["cached_ax"] = model.propagate(b["adj"], b["X"])
            if evolve == "gather_free":
                apply = _evolvegcn_gather_free(model, bundles, edges)
            elif evolve == "restricted":
                apply = _evolvegcn_restricted(model, bundles, adj, edges, drop_last_slice)
        if evolve == "generic":

            def apply(variables, bundle, carry):
                return model.apply(
                    variables, bundle["adj"], bundle["X"], bundle["edges"], *carry,
                    AX=bundle["cached_ax"], readout_op=_readout_fn(bundle),
                )

        # The gather-free path is 1-layer, the restricted one 2-layer; the
        # generic one takes either.
        names = ("W_init1", "W_init2")[: model.n_layers]

        def initial_carry(variables):
            return tuple(variables["buffers"][k] for k in names)

        return ModelAdapter(init, apply, bundles, device, initial_carry)

    if isinstance(model, (KWGCN, WDGCN)):
        with torch.no_grad(), span("adapter.propagate", sync=True):
            for b in _unique_bundles(bundles):
                b["cached"] = model.propagate(b["adj"], b["X"])

    if kwgcn1:
        # 1 layer: keep only the endpoint rows: training epochs run no SpMM.
        with torch.no_grad():
            for b in _unique_bundles(bundles):
                _cache_edge_rows(b, model.dtype)

        def apply(variables, bundle, carry):
            p = variables["params"]
            return _fast_edge_logits(p["W1"], p["U"], bundle, model.dtype), carry

        return ModelAdapter(init, apply, bundles, device)

    if isinstance(model, KWGCN):

        def apply(variables, bundle, carry):
            out = model.apply(
                variables, bundle["adj"], bundle["X"], bundle["edges"], bundle["cached"],
                readout_op=_readout_fn(bundle),
            )
            return out, carry

        return ModelAdapter(init, apply, bundles, device)

    if isinstance(model, WDGCN):
        # The cached propagation, transposed to (T, F0, N): the forward
        # then runs on the (F, N) layout (models/wdgcn.lstm_scan_t).
        with torch.no_grad(), span("adapter.propagate", sync=True):
            for b in _unique_bundles(bundles):
                b["cached_t"] = b["cached"].transpose(1, 2).contiguous()

        def apply(variables, bundle, carry):
            out = model.apply(
                variables,
                bundle["adj"],
                bundle["X"],
                bundle["edges"],
                readout_op=_readout_fn(bundle),
                AXt=bundle["cached_t"],
            )
            return out, carry

        return ModelAdapter(init, apply, bundles, device)

    # Cache the parameter-independent first-layer propagation, as the
    # reference does at model init (embedding_help_functions.py:195).
    with torch.no_grad(), span("adapter.propagate", sync=True):
        for b in _unique_bundles(bundles):
            b["cached"] = model.propagate(b["adj"], b["X"], b["M"])

    if restricted2:
        operator = impl if impl in OPERATOR_IMPLS else "auto"
        with torch.no_grad():
            # Windows that share a bundle share adj and edges: build once.
            for w, b in _unique_windows(bundles):
                with span("adapter.layer2", sync=True, window=w) as s:
                    if l2_stream_chunks:
                        _build_streamed_layer2(b, adj[w], as_numpy(edges[w]), drop_last_slice,
                                               n_chunks=l2_stream_chunks, operator=operator)
                    else:
                        _build_restricted_layer2(b, adj[w], as_numpy(edges[w]),
                                                 drop_last_slice, operator=operator)
                    choice = b["l2op_choice"]
                    ratio = choice["ratio"]
                    s.set(operator=choice["operator"],
                          ratio=float(ratio) if ratio is not None else None)
        logits = _streamed_logits if l2_stream_chunks else _restricted_logits

        def apply(variables, bundle, carry):
            return logits(model, variables, bundle), carry

        return ModelAdapter(init, apply, bundles, device)

    if not tmgcn1:
        # The model's own layers on the cached propagation, the readout
        # through the bundle's plan: TMGCN2 off the restricted path, and
        # TMGCN with per-slice weights or M⁻¹.

        def apply(variables, bundle, carry):
            out = model.apply(
                variables, bundle["adj"], bundle["X"], bundle["edges"], bundle["M"],
                bundle["cached"], readout_op=_readout_fn(bundle),
            )
            return out, carry

        return ModelAdapter(init, apply, bundles, device)

    # 1-layer: keep only the endpoint rows: training epochs run no SpMM.
    with torch.no_grad():
        for b in _unique_bundles(bundles):
            _cache_edge_rows(b, model.dtype)

    def apply(variables, bundle, carry):
        return _fast_edge_logits(
            variables["params"]["W"], variables["params"]["U"], bundle,
            model.dtype, model.readout,
        ), carry

    return ModelAdapter(init, apply, bundles, device)


def make_regression_adapter(
    model,
    adj: dict[str, TemporalCOO],
    feats: dict[str, Any],
    M: np.ndarray | None = None,
    *,
    device: str | torch.device,
) -> ModelAdapter:
    """Adapter for (T, N) regression models (the SEIR task).

    As the JAX package's: the bundles are prepacked with the model's impl
    only for TMGCNReg and WDGCNReg (``"pallas"``: K1), and carry M only for
    TMGCNReg. TMGCNReg's propagation and EvolveGCNReg's AX are computed
    once per distinct window here; WDGCNReg caches nothing, so its
    propagation runs in every step. ``apply`` returns the (T, N) outputs and
    the carry unchanged: every window starts from the model's own initial
    state. ``device``: as ``make_edge_adapter`` takes it.
    """
    if not isinstance(model, (TMGCNReg, EvolveGCNReg, WDGCNReg)):
        raise TypeError(f"unsupported regression model: {type(model).__name__}")
    impl = getattr(model, "spmm_impl", "jnp")
    spmm_operator = (
        impl if impl in OPERATOR_IMPLS and isinstance(model, (TMGCNReg, WDGCNReg)) else None
    )
    device = torch.device(device)
    bundles = _prepare_bundles(
        adj, feats, None, M if isinstance(model, TMGCNReg) else None, False, spmm_operator,
        device, readout=False,
    )

    def init(generator):
        return model.init(generator, device)

    if isinstance(model, TMGCNReg):
        with torch.no_grad(), span("adapter.propagate", sync=True):
            for b in _unique_bundles(bundles):
                b["cached"] = model.propagate(b["adj"], b["X"], b["M"])

        def apply(variables, bundle, carry):
            return (
                model.apply(variables, bundle["adj"], bundle["X"], bundle["M"], bundle["cached"]),
                carry,
            )

    elif isinstance(model, EvolveGCNReg):
        # The parameter-independent A@X, so the weight loop runs no SpMM.
        with torch.no_grad(), span("adapter.propagate", sync=True):
            for b in _unique_bundles(bundles):
                b["cached_ax"] = model.propagate(b["adj"], b["X"])

        def apply(variables, bundle, carry):
            W0 = carry[0] if carry else None
            return model.apply(variables, bundle["adj"], bundle["X"], W0,
                               AX=bundle["cached_ax"]), carry

    else:

        def apply(variables, bundle, carry):
            return model.apply(variables, bundle["adj"], bundle["X"]), carry

    return ModelAdapter(init, apply, bundles, device)

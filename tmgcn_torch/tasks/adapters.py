"""Model-family adapters: one calling convention across architectures
(port of tmgcn_tpu.tasks.adapters: the TM-GCN (1 and 2 layers) and WD-GCN
branches).

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
Other 2-layer TM-GCNs run the model's own layers with the readout plan.

WD-GCN caches its propagation AX once per window (transposed to
(T, F0, N)) and runs the LSTM and the edge readout every epoch; the
readout's backward goes through the bundle's ``ReadoutPlan`` (K1, or K2
past ``LANE_MAJOR_BYTES``) where one is built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tmgcn_torch.core.sparse import TemporalCOO, as_numpy
from tmgcn_torch.kernels import spmm_cuda
from tmgcn_torch.models.common import nonlinearity
from tmgcn_torch.models.tmgcn import TMGCN, TMGCN2
from tmgcn_torch.models.wdgcn import WDGCN
from tmgcn_torch.ops import spmm_blockdense, spmm_rowsplit
from tmgcn_torch.ops.edge_readout import make_readout_plan, readout_operator
from tmgcn_torch.ops.spmm import pack_operator

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
    F0 = bundle[cached_key].shape[-1]
    bundle["l2_Hin"] = bundle[cached_key].reshape(T * N, F0)[
        torch.as_tensor(used, dtype=torch.long, device=device)
    ]
    bundle["l2_src"] = torch.as_tensor(np.searchsorted(uniq, src_keys), device=device)
    bundle["l2_trg"] = torch.as_tensor(np.searchsorted(uniq, trg_keys), device=device)
    return uniq, used


def _restricted_logits(model: TMGCN2, variables: dict, bundle: dict) -> torch.Tensor:
    """Edge logits of the readout-restricted 2-layer TM-GCN."""
    p = variables["params"]
    dtype = model.dtype
    H = bundle["l2_Hin"].to(dtype)  # (n_used, F0) compact
    Y = nonlinearity(model.nonlin2)(torch.matmul(H, p["W1"].to(H.dtype)))
    if model.interlayer_dtype is not None:
        Y = Y.to(model.interlayer_dtype)
    Zc = bundle["l2op"](Y).to(dtype)
    # Fold W2 @ U before the per-edge gathers: the tiny (F1, C) products
    # run on n_uniq rows instead of E, and the gathered width drops to C.
    W2 = p["W2"].to(dtype)
    F2 = W2.shape[-1]
    U = p["U"].to(dtype)
    P1 = torch.matmul(Zc, W2 @ U[:F2])
    P2 = torch.matmul(Zc, W2 @ U[F2:])
    return P1[bundle["l2_src"]] + P2[bundle["l2_trg"]]


def _readout_fn(bundle: dict):
    """Bind a bundle's ReadoutPlan (if any) into an op(Y, U) callable."""
    if "readout" not in bundle:
        return None
    return readout_operator(bundle["readout"])


@dataclasses.dataclass
class ModelAdapter:
    """Uniform (variables, bundle, carry) -> (output, carry) interface."""

    init: Callable[[torch.Generator], dict]
    apply: Callable[[dict, dict, Any], tuple[torch.Tensor, Any]]
    bundles: dict[str, dict]
    device: torch.device


# The JAX package's prepacked-operator impls.
OPERATOR_IMPLS = (
    "pallas", "pallas_bf16", "rowsplit", "blockdense", "blockdense_bf16",
    "auto", "auto_bf16",
)


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
        if spmm_operator in ("auto", "auto_bf16"):
            raise NotImplementedError(
                f"the full-row {spmm_operator!r} operator (the JAX package's "
                "ops/spmm.make_auto_operator, calibrated on a TPU) is not ported yet "
                "(ROADMAP queue 2, re-derive the auto rules on the H100)"
            )
        if spmm_operator is not None:
            # Prepack the square operator (and its transpose) once, host-side,
            # with the arguments of spmm(impl=...).
            A = pack_operator(A, spmm_operator)
        # float32 features: the JAX package's default float (x64 off).
        bundle = {
            "adj": A.to(device),
            "X": torch.as_tensor(X, dtype=torch.float32, device=device),
        }
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


def _unique_bundles(bundles: dict[str, dict]):
    """Each distinct bundle dict once (windows may share one)."""
    seen: set[int] = set()
    for b in bundles.values():
        if id(b) not in seen:
            seen.add(id(b))
            yield b


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
        model: a 1-layer condensed TMGCN, a TMGCN2 or a WDGCN (the
            branches ported so far).
        adj: per-window adjacency (Ct for TM-GCN, C for WD-GCN).
        feats: per-window (T, N, F) features.
        edges: per-window (3, E) model-input edges.
        M: mixing matrix (TM-GCN only).
        drop_last_slice: link-prediction convention — the model consumes
            slices [0, T-1) and M[:-1, :-1].
        l2_stream_chunks: TMGCN2 only; not ported yet.
        device: where the bundles live and the model runs (no default:
            the entry points resolve it, cuda unless asked otherwise).
    """
    tmgcn1 = isinstance(model, TMGCN) and model.condensed_W and not model.use_Minv
    tmgcn2 = isinstance(model, TMGCN2)
    restricted2 = (
        tmgcn2 and model.condensed_W and not model.use_Minv and not model.apply_M_twice
    )
    if not (tmgcn1 or tmgcn2 or isinstance(model, WDGCN)):
        raise NotImplementedError(
            "only the TM-GCN (1-layer condensed, 2-layer) and WD-GCN adapters are ported yet "
            "(ROADMAP queue 1, items 8-9)"
        )
    if l2_stream_chunks:
        raise NotImplementedError("streamed layer 2 is not ported yet (ROADMAP queue 1, item 12)")
    impl = model.spmm_impl
    # The restricted path runs the square operator once (the cached
    # propagation, through spmm(impl=...)), so it is not prepacked; the
    # impl goes to the restricted layer-2 operator instead.
    spmm_operator = impl if impl in OPERATOR_IMPLS and not restricted2 else None
    device = torch.device(device)
    bundles = _prepare_bundles(
        adj, feats, edges, M, drop_last_slice, spmm_operator, device,
        readout=not (tmgcn1 or restricted2),
    )

    def init(generator):
        return model.init(generator, device)

    if isinstance(model, WDGCN):
        # The cached propagation, transposed to (T, F0, N): the forward
        # then runs on the (F, N) layout (models/wdgcn.lstm_scan_t).
        with torch.no_grad():
            for b in _unique_bundles(bundles):
                b["cached"] = model.propagate(b["adj"], b["X"])
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
    with torch.no_grad():
        for b in _unique_bundles(bundles):
            b["cached"] = model.propagate(b["adj"], b["X"], b["M"])

    if restricted2:
        with torch.no_grad():
            done: set[int] = set()
            for w in WINDOWS:
                # Windows that share a bundle share adj and edges: build once.
                if id(bundles[w]) in done:
                    continue
                done.add(id(bundles[w]))
                _build_restricted_layer2(
                    bundles[w], adj[w], as_numpy(edges[w]), drop_last_slice,
                    operator=impl if impl in OPERATOR_IMPLS else "auto",
                )

        def apply(variables, bundle, carry):
            return _restricted_logits(model, variables, bundle), carry

        return ModelAdapter(init, apply, bundles, device)

    if tmgcn2:

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

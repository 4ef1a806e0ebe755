"""Model-family adapters: one calling convention across architectures
(port of tmgcn_tpu.tasks.adapters, the 1-layer TM-GCN branch).

Adapters prepare per-window data bundles on the device, once, and expose:

    init(generator) -> variables
    apply(variables, bundle, carry) -> (output, new_carry)
    bundles[window] -> the dict of tensors for that window

For 1-layer condensed TM-GCN the parameter-independent propagation
Ct ⊛ (M ×₁ X) is computed once per distinct window at build time (through
the SpMM impl the model names: K1 for ``"pallas"``) and only the per-edge
endpoint rows of it are kept, so a training epoch is two small matmuls —
no gather in the forward, no scatter in the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.tmgcn import TMGCN

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


@dataclasses.dataclass
class ModelAdapter:
    """Uniform (variables, bundle, carry) -> (output, carry) interface."""

    init: Callable[[torch.Generator], dict]
    apply: Callable[[dict, dict, Any], tuple[torch.Tensor, Any]]
    bundles: dict[str, dict]
    device: torch.device


# The JAX package's prepacked-operator impls; only "pallas" is ported.
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
) -> dict[str, dict]:
    """Per-window bundles on ``device``, moved there once.

    Windows that share the same adjacency/features/edges objects get one
    bundle (one device copy).
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
        if spmm_operator == "pallas":
            # Prepack K1's chunk stream and its transpose once, host-side.
            from tmgcn_torch.kernels.spmm_cuda import make_operator

            A = make_operator(A)
        elif spmm_operator is not None:
            raise NotImplementedError(
                f"spmm operator {spmm_operator!r} is not ported yet (ROADMAP queues 1-2)"
            )
        # float32 features: the JAX package's default float (x64 off).
        bundle = {
            "adj": A.to(device),
            "X": torch.as_tensor(X, dtype=torch.float32, device=device),
        }
        if edges is not None:
            bundle["edges"] = torch.as_tensor(
                np.asarray(edges[w]), dtype=torch.long, device=device
            )
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
        model: a 1-layer condensed TMGCN (the only branch ported so far).
        adj: per-window adjacency (Ct for TM-GCN).
        feats: per-window (T, N, F) features.
        edges: per-window (3, E) model-input edges.
        M: mixing matrix.
        drop_last_slice: link-prediction convention — the model consumes
            slices [0, T-1) and M[:-1, :-1].
        l2_stream_chunks: TMGCN2 only; not ported yet.
        device: where the bundles live and the model runs (no default:
            the entry points resolve it, cuda unless asked otherwise).
    """
    if not isinstance(model, TMGCN) or not model.condensed_W or model.use_Minv:
        raise NotImplementedError(
            "only the 1-layer condensed TM-GCN adapter is ported yet "
            "(ROADMAP queue 1, items 5-10)"
        )
    if l2_stream_chunks:
        raise NotImplementedError("streamed layer 2 is not ported yet (ROADMAP queue 1, item 12)")
    impl = model.spmm_impl
    spmm_operator = impl if impl in OPERATOR_IMPLS else None
    device = torch.device(device)
    bundles = _prepare_bundles(adj, feats, edges, M, drop_last_slice, spmm_operator, device)

    # Cache the parameter-independent first-layer propagation, as the
    # reference does at model init (embedding_help_functions.py:195), then
    # keep only its endpoint rows: training epochs run no SpMM.
    with torch.no_grad():
        for b in _unique_bundles(bundles):
            b["cached"] = model.propagate(b["adj"], b["X"], b["M"])
            _cache_edge_rows(b, model.dtype)

    def init(generator):
        return model.init(generator, device)

    def apply(variables, bundle, carry):
        return _fast_edge_logits(
            variables["params"]["W"], variables["params"]["U"], bundle,
            model.dtype, model.readout,
        ), carry

    return ModelAdapter(init, apply, bundles, device)

"""Batched sparse-times-dense matmul over the temporal axis (port of
tmgcn_tpu.ops.spmm).

``spmm(A, X)`` computes ``Y[k] = A[k] @ X[k]`` for every time slice k of a
:class:`TemporalCOO` tensor — the hot op of the model (capability
reference: the ``for k in range(T): torch.sparse.mm`` loops in IBM/TM-GCN,
TensorGCN-master/embedding_help_functions.py:203-208). All T slices run as
one flat gather and one segment sum over the row-sorted entry stream:

    Y = segment_sum(vals[:, None] * X_flat[t*N + col], t*N + row)

The segment sum is ``torch.segment_reduce`` over the sorted rows, whose
reduction order is fixed (no atomics, unlike ``index_add_`` on CUDA), and
its backward is the same reduction over the column-sorted transpose. The
other impls pack A into an operator first, with the JAX package's
arguments: ``"pallas"`` / ``"pallas_bf16"`` run the hand-written CUDA
kernel K1 (float32 / bf16 gathers), ``"pallas_tiled"`` /
``"pallas_tiled_bf16"`` run K3 (kernels/spmm_cuda.py); ``"rowsplit"`` and
``"blockdense"`` / ``"blockdense_bf16"`` are the operators of
ops/spmm_rowsplit.py and ops/spmm_blockdense.py; ``"auto"`` /
``"auto_bf16"`` pick one of block-dense, K3 and K1 by the full-row rule of
``make_auto_operator``, whose constants were measured on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tmgcn_torch.core.sparse import TemporalCOO

# The full-row rule of make_auto_operator, fitted by
# ``python -m tmgcn_torch.utils.kernel_probe --sweep auto`` on one NVIDIA H100
# 80GB HBM3 at a 700.00 W power limit (PERF.md section 6: the sweep of the
# full-row auto rule).
# Block-dense when ops/spmm_blockdense.estimate's ratio is under this:
AUTO_BLOCKDENSE_RATIO = 0.005199015636482301
# K3 when the model below puts its forward and backward under this share of K1's:
AUTO_TILED_RATIO = 0.5059504083337437
# The model: ms of a forward and backward (both packings) = launch
#   + entry * entries * sectors + chunk * chunks + gather * gathered sectors,
# sectors being the 32-byte sectors of one row (F * itemsize bytes). K1's
# gather moves every slot of its chunks (AUTO_CHUNK rows a chunk, padding
# included); K3's moves each chunk's distinct 8-row tiles (the per-tile cost).
AUTO_K1_COSTS = {"launch": 0.021401905086251272, "entry": 0.0, "chunk": 0.0,
                 "gather": 3.565880582256212e-08}
AUTO_K3_COSTS = {"launch": 0.07865438408796446, "entry": 1.683725169524563e-08,
                 "chunk": 3.4105791904413314e-05, "gather": 7.631323991350376e-09}
# The packing every auto operator takes (the JAX package's).
AUTO_CHUNK, AUTO_WINDOW, AUTO_UT_CAP = 512, 256, 64


def _segment_sum(
    flat_x: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_out: int,
) -> torch.Tensor:
    """out[r] = Σ_{i: rows[i] = r} vals[i] * flat_x[cols[i]]; rows sorted.

    The segment lengths come from a search of the sorted rows, not a
    bincount, whose output size the host would have to read off the card
    (that would stall, and break the capture of, a training step)."""
    gathered = flat_x.index_select(0, cols) * vals[:, None]
    bounds = torch.searchsorted(rows, torch.arange(n_out + 1, device=rows.device))
    return torch.segment_reduce(gathered, "sum", lengths=bounds.diff(), axis=0, unsafe=True)


class _SegmentSpmm(torch.autograd.Function):
    """Flat SpMM whose backward dX = Aᵀ dY is again a sorted segment sum."""

    @staticmethod
    def forward(ctx, flat_x, rows, cols, vals, n_out):
        ctx.save_for_backward(rows, cols, vals)
        ctx.n_in = flat_x.shape[0]
        return _segment_sum(flat_x, rows, cols, vals, n_out)

    @staticmethod
    def backward(ctx, dY):
        rows, cols, vals = ctx.saved_tensors
        order = torch.argsort(cols, stable=True)
        dX = _segment_sum(dY, cols[order], rows[order], vals[order], ctx.n_in)
        return dX, None, None, None, None


def spmm_slice(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    x: torch.Tensor,
    n_nodes: int,
) -> torch.Tensor:
    """One-slice SpMM: (P,) coo arrays x (N, F) dense -> (N, F).

    The entries stably sorted by row (the padding, row 0 and value 0,
    trails each slice), so each row sums its entries in stream order, as
    the JAX package's ``segment_sum`` does; forward and backward are
    sorted segment sums, with no atomics and no host sync.
    """
    rows = torch.as_tensor(rows, device=x.device).long()
    order = torch.argsort(rows, stable=True)
    cols = torch.as_tensor(cols, device=x.device).long()[order]
    vals = torch.as_tensor(vals, device=x.device)[order].to(x.dtype)
    return _SegmentSpmm.apply(x, rows[order], cols, vals, n_nodes)


def auto_counts(g_rows, g_cols, n_in: int, n_out: int, feat: int, itemsize: int) -> dict:
    """What the full-row rule prices, counted on the host from a flat entry
    stream (rows < n_out, cols < n_in) without packing it: the entries,
    the 32-byte sectors of one gathered row and of an 8-row tile, K1's
    chunks and K3's chunks and distinct 8-row tiles over the forward and
    the transposed packing (the backward's), and the block-dense
    estimate's ratio."""
    from tmgcn_torch.kernels.spmm_cuda import tiled_counts, windowed_chunks
    from tmgcn_torch.ops.spmm_blockdense import estimate

    g_rows = np.asarray(g_rows, np.int64)
    g_cols = np.asarray(g_cols, np.int64)
    k3_fwd = tiled_counts(g_rows, g_cols, n_out, AUTO_CHUNK, AUTO_WINDOW, AUTO_UT_CAP)
    k3_bwd = tiled_counts(g_cols, g_rows, n_in, AUTO_CHUNK, AUTO_WINDOW, AUTO_UT_CAP)
    return {
        "nnz": len(g_rows),
        "sectors": max(1, math.ceil(feat * itemsize / 32)),
        "tile_sectors": max(1, math.ceil(8 * feat * itemsize / 32)),
        "k1_chunks": windowed_chunks(g_rows, n_out, AUTO_CHUNK, AUTO_WINDOW)
        + windowed_chunks(g_cols, n_in, AUTO_CHUNK, AUTO_WINDOW),
        "k3_chunks": k3_fwd[0] + k3_bwd[0],
        "k3_tiles": k3_fwd[1] + k3_bwd[1],
        "blockdense_ratio": estimate(g_rows, g_cols, itemsize=itemsize)["ratio"],
    }


def model_terms(counts: dict, kernel: str) -> dict:
    """The model's terms for ``kernel`` ("k1" or "k3") at these counts: ms =
    the sum of each term times its cost."""
    entry = 2.0 * counts["nnz"] * counts["sectors"]
    if kernel == "k1":
        return {"launch": 1.0, "entry": entry, "chunk": counts["k1_chunks"],
                "gather": counts["k1_chunks"] * AUTO_CHUNK * counts["sectors"]}
    return {"launch": 1.0, "entry": entry, "chunk": counts["k3_chunks"],
            "gather": counts["k3_tiles"] * counts["tile_sectors"]}


def model_ms(counts: dict, kernel: str, costs: dict | None = None) -> float:
    """The model's ms of a forward and backward through ``kernel``."""
    if costs is None:
        costs = AUTO_K1_COSTS if kernel == "k1" else AUTO_K3_COSTS
    return sum(costs[k] * v for k, v in model_terms(counts, kernel).items())


def tiled_ratio(counts: dict, k1_costs: dict | None = None, k3_costs: dict | None = None) -> float:
    """K3's modelled ms over K1's (inf where K1's model is not positive)."""
    k1 = model_ms(counts, "k1", k1_costs)
    return model_ms(counts, "k3", k3_costs) / k1 if k1 > 0 else math.inf


def auto_pick(blockdense_ratio: float, k3_ratio: float,
              blockdense_limit: float | None = None, tiled_limit: float | None = None) -> str:
    """The full-row rule on host counts: "blockdense" when the block-dense
    estimate's ratio is under ``blockdense_limit``, else "tiled" (K3) when
    the model puts K3 under ``tiled_limit`` of K1, else "windowed" (K1).
    The limits default to the constants fitted on the card."""
    if blockdense_limit is None:
        blockdense_limit = AUTO_BLOCKDENSE_RATIO
    if tiled_limit is None:
        tiled_limit = AUTO_TILED_RATIO
    if blockdense_ratio < blockdense_limit:
        return "blockdense"
    if k3_ratio < tiled_limit:
        return "tiled"
    return "windowed"


def make_auto_operator(A: TemporalCOO, bf16: bool = False, feat: int = 128,
                       device: str | torch.device = "cuda"):
    """Build-time operator selection for the FULL-ROW path (the JAX
    package's ``ops.spmm.make_auto_operator``, its constants measured on
    the card): (operator, the pick).

    On a CUDA device: the block-dense operator when the estimate's ratio
    (``ops/spmm_blockdense.estimate``: block bytes per entry, so its TPU
    tile constant only scales the limit) is under AUTO_BLOCKDENSE_RATIO
    and its block tensor fits the byte budget; else K3 with tile dedup when
    the model of ``model_ms`` puts K3's forward and backward under
    AUTO_TILED_RATIO of K1's; else K1 with ``sort_cols``. Every branch
    packs chunks of 512 entries in windows of 256 rows; ``bf16`` takes the
    bf16 tiers (the bf16 block tensor, bf16 gathers), f32 sums either way.
    ``feat`` is the width the operator is applied at (the model reads its
    sectors). A build or launch failure raises: nothing falls back.

    Elsewhere ``A`` is returned unpacked, as the JAX package returns it
    off the TPU: ``spmm`` then takes the sorted segment sum.

    The pick is a dict for the logs: ``branch`` ("blockdense", "tiled",
    "windowed", or "unpacked" off the card), ``bf16``, ``blockdense_ratio``
    and ``tiled_ratio`` (None off the card), and ``over_budget`` (the
    block tensor was refused and the rule went on). The operator is packed
    on the host: move it with ``.to(device)``.
    """
    from tmgcn_torch.ops.spmm_rowsplit import flatten_stream

    if torch.device(device).type != "cuda":
        return A, {"branch": "unpacked", "bf16": bf16, "blockdense_ratio": None,
                   "tiled_ratio": None, "over_budget": False}
    from tmgcn_torch.kernels import spmm_cuda
    from tmgcn_torch.ops import spmm_blockdense

    g_rows, g_cols, _ = flatten_stream(A)
    n = A.n_slices * A.n_nodes
    counts = auto_counts(g_rows, g_cols, n, n, feat, 2 if bf16 else 4)
    pick = {"branch": None, "bf16": bf16, "blockdense_ratio": counts["blockdense_ratio"],
            "tiled_ratio": tiled_ratio(counts), "over_budget": False}
    branch = auto_pick(pick["blockdense_ratio"], pick["tiled_ratio"])
    if branch == "blockdense":
        try:
            op = spmm_blockdense.make_operator(A, mode="bf16" if bf16 else "exact")
            return op, {**pick, "branch": branch}
        except ValueError:
            # Over the block tensor's byte budget: the rule goes on.
            pick["over_budget"] = True
            branch = auto_pick(math.inf, pick["tiled_ratio"])
    gather_dtype = "bfloat16" if bf16 else None
    if branch == "tiled":
        op = spmm_cuda.make_operator(A, chunk=AUTO_CHUNK, window=AUTO_WINDOW,
                                     gather_dtype=gather_dtype, tile_dedup=True,
                                     ut_cap=AUTO_UT_CAP)
    else:
        op = spmm_cuda.make_operator(A, chunk=AUTO_CHUNK, window=AUTO_WINDOW,
                                     gather_dtype=gather_dtype, sort_cols=True)
    return op, {**pick, "branch": branch}


def pack_operator(A: TemporalCOO, impl: str, device: str | torch.device = "cuda"):
    """The host-packed operator of one of spmm's packing impls, with the
    JAX package's arguments; move it to the device with ``.to``. ``device``
    is where it will run: the ``auto`` impls pick by it (and return ``A``
    unpacked off the card)."""
    bf16 = impl.endswith("_bf16")
    if impl in ("auto", "auto_bf16"):
        return make_auto_operator(A, bf16=bf16, device=device)[0]
    if impl in ("pallas", "pallas_bf16"):
        from tmgcn_torch.kernels.spmm_cuda import make_operator

        if impl == "pallas":
            return make_operator(A)
        return make_operator(A, chunk=512, window=256, gather_dtype="bfloat16", sort_cols=True)
    if impl in ("pallas_tiled", "pallas_tiled_bf16"):
        from tmgcn_torch.kernels.spmm_cuda import make_operator

        return make_operator(
            A, chunk=512, window=256, tile_dedup=True, gather_dtype="bfloat16" if bf16 else None
        )
    if impl == "rowsplit":
        from tmgcn_torch.ops.spmm_rowsplit import make_operator

        return make_operator(A)
    if impl in ("blockdense", "blockdense_bf16"):
        from tmgcn_torch.ops.spmm_blockdense import make_operator

        return make_operator(A, mode="bf16" if bf16 else "exact")
    raise ValueError(f"unknown spmm impl: {impl!r}")


def spmm(A, X: torch.Tensor, impl: str = "jnp") -> torch.Tensor:
    """Batched per-slice SpMM: Y[k] = A[k] @ X[k].

    Args:
        A: temporal sparse tensor, T slices of N x N (host or device
            arrays), or a prepacked operator such as
            ``kernels.spmm_cuda.PallasSpmmOperator``.
        X: dense (T, N, F) features.
        impl: "jnp" (gather + sorted segment sum, the name kept from the
            JAX package), or an impl that packs A first (one-shot: the
            packing is not kept): "pallas", "pallas_bf16", "pallas_tiled",
            "pallas_tiled_bf16", "rowsplit", "blockdense",
            "blockdense_bf16", "auto", "auto_bf16" (unpacked off the card).

    Returns:
        (T, N, F) dense result, dtype of X.
    """
    if not isinstance(A, TemporalCOO):
        # A prepacked operator: the adapters decide at build time.
        return A(X)
    if impl in ("auto", "auto_bf16"):
        op, _ = make_auto_operator(A, bf16=impl == "auto_bf16", feat=X.shape[-1], device=X.device)
        return spmm(op, X) if op is A else op.to(X.device)(X)
    if impl != "jnp":
        return pack_operator(A, impl).to(X.device)(X)
    T, P = A.rows.shape
    N = A.n_nodes
    F = X.shape[-1]
    device = X.device
    rows = torch.as_tensor(A.rows, device=device).long()
    cols = torch.as_tensor(A.cols, device=device).long()
    vals = torch.as_tensor(A.vals, device=device).to(X.dtype)
    nnz = torch.as_tensor(A.nnz, device=device).long()
    # The padding trails each slice with value 0: pointed at the slice's
    # last row, it keeps the global row stream t*N + row sorted end to end
    # and adds only zeros, with no mask whose size the host must read.
    real = torch.arange(P, device=device)[None, :] < nnz[:, None]
    offsets = (torch.arange(T, device=device) * N)[:, None]
    flat_rows = torch.where(real, rows + offsets, offsets + N - 1).reshape(-1)
    flat_cols = (cols + offsets).reshape(-1)
    flat_vals = torch.where(real, vals, 0).reshape(-1)
    out = _SegmentSpmm.apply(X.reshape(T * N, F), flat_rows, flat_cols, flat_vals, T * N)
    return out.reshape(T, N, F)


def spmm_dense_reference(A_dense: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Dense oracle for tests: einsum over materialized (T, N, N)."""
    return torch.einsum("tij,tjf->tif", A_dense, X)

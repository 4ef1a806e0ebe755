"""Windowed segment-matmul SpMM on Hopper (port of tmgcn_tpu.kernels.spmm_pallas).

The SpMM ``Y = A @ X`` of a temporal sparse tensor runs as a gather of X
rows by column id (a PyTorch index) followed by K1,
``windowed_segment_matmul``, the kernel written by hand in CUDA C++ in
``csrc/windowed_segment_matmul.cu``. K1 replaces the Pallas kernel
``windowed_segment_matmul`` (body ``_scatter_kernel``,
tmgcn_tpu/kernels/spmm_pallas.py:608-721) and takes the same host packing:

  * Nonzeros are cut host-side into chunks of ``chunk`` entries whose
    output rows all fall in one ``window``-row output window
    (``pack_windowed``); chunks are sorted by window, so ``window_ptr``
    gives each window's chunk range.
  * Per window, K1 sums ``vals * gathered`` into the (window, F) output
    rows, each output element by one thread in entry order — bitwise
    deterministic, no float atomics. What bounds it, and what its design
    does about that, is noted at the top of the CUDA source.

``windowed_segment_matmul`` launches the kernel for a CUDA tensor and
raises where it cannot; it takes the plain PyTorch version
``windowed_segment_matmul_reference`` only for a tensor on the CPU. The
operator's ``torch.autograd.Function`` runs the backward dX = Aᵀ dY as the
same kernel on the transposed packing.

K2, ``windowed_segment_matmul_t``, is the same sums with the layout
transposed — (J, F, C) chunks in, (F, n_rows_out) out — and replaces the
Pallas kernel ``windowed_segment_matmul_t`` (body ``_scatter_kernel_t``,
tmgcn_tpu/kernels/spmm_pallas.py:724-824). Its one user is the
``ReadoutPlan`` backward past ``LANE_MAJOR_BYTES`` (ops/edge_readout.py).
Its plain version is ``windowed_segment_matmul_t_reference``.

Ported so far: the exact float32 tier of K1, and K2. The ``fast`` and
bf16-gather tiers of K1 and the tile-dedup K3 are still to port (ROADMAP
queue 2); asking for them raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from tmgcn_torch.core.sparse import TemporalCOO, as_numpy
from tmgcn_torch.kernels.build import load_library

DEFAULT_CHUNK = 256
DEFAULT_WINDOW = 256
MAX_WINDOW = 1024  # one thread per output row of a window


@dataclasses.dataclass(frozen=True)
class PackedSpmm:
    """Host-packed chunk stream for the windowed segment kernel.

    rows: (J, C) int32 — window-relative output row per entry (0 on
        padding, with val 0).
    cols: (J, C) int32 — global gather row (flattened t*N + col).
    vals: (J, C) float — nonzero values; 0 on padding.
    window_id: (J,) int32 — output window of each chunk, nondecreasing.
    is_first: (J,) int32 — 1 iff the chunk is the first of its window.
    window_ptr: (n_windows + 1,) int32 — chunks of window w are
        [window_ptr[w], window_ptr[w + 1]); derived from window_id.
    n_rows_out: padded output rows (a multiple of window).

    The arrays are numpy on the host, or torch tensors after ``to``.
    """

    rows: np.ndarray | torch.Tensor
    cols: np.ndarray | torch.Tensor
    vals: np.ndarray | torch.Tensor
    window_id: np.ndarray | torch.Tensor
    is_first: np.ndarray | torch.Tensor
    window_ptr: np.ndarray | torch.Tensor
    n_rows_out: int
    chunk: int
    window: int

    @property
    def n_chunks(self) -> int:
        return self.rows.shape[0]

    @property
    def n_windows(self) -> int:
        return self.n_rows_out // self.window

    def to(self, device: str | torch.device) -> "PackedSpmm":
        """The same packing as torch tensors on ``device`` (dtypes kept)."""

        def move(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        return dataclasses.replace(
            self,
            rows=move(self.rows),
            cols=move(self.cols),
            vals=move(self.vals),
            window_id=move(self.window_id),
            is_first=move(self.is_first),
            window_ptr=move(self.window_ptr),
        )


def pack_windowed(
    A: TemporalCOO,
    chunk: int = DEFAULT_CHUNK,
    window: int = DEFAULT_WINDOW,
    sort_cols: bool = False,
) -> PackedSpmm:
    """Pack a temporal COO tensor for the kernel (host-side, once).

    Flattens slices (global rows t*N + r, global cols t*N + c), then
    packs the flat stream (see pack_windowed_flat).
    """
    rows_np = as_numpy(A.rows)
    cols_np = as_numpy(A.cols)
    vals_np = as_numpy(A.vals)
    nnz_np = as_numpy(A.nnz)
    T = A.n_slices
    N = A.n_nodes

    parts_r, parts_c, parts_v = [], [], []
    for t in range(T):
        n = int(nnz_np[t])
        parts_r.append(rows_np[t, :n].astype(np.int64) + t * N)
        parts_c.append(cols_np[t, :n].astype(np.int64) + t * N)
        parts_v.append(vals_np[t, :n])
    g_rows = np.concatenate(parts_r) if parts_r else np.zeros(0, np.int64)
    g_cols = np.concatenate(parts_c) if parts_c else np.zeros(0, np.int64)
    g_vals = np.concatenate(parts_v) if parts_v else np.zeros(0, vals_np.dtype)
    return pack_windowed_flat(g_rows, g_cols, g_vals, T * N, chunk, window, sort_cols)


def pack_windowed_flat(
    g_rows: np.ndarray,
    g_cols: np.ndarray,
    g_vals: np.ndarray,
    n_out: int,
    chunk: int = DEFAULT_CHUNK,
    window: int = DEFAULT_WINDOW,
    sort_cols: bool = False,
    all_windows: bool = True,
) -> PackedSpmm:
    """Pack a flat (row, col, val) entry stream for the kernel.

    Rows must be sorted ascending and < n_out (the logical output row
    count; cols may index a different input space). The stream is cut into
    chunks of ``chunk`` entries that never cross a ``window``-aligned
    output boundary. Every window gets at least one chunk, so every output
    row is written — unless ``all_windows=False``: then only non-empty
    windows get chunks and the caller passes a zero ``init`` to
    ``windowed_segment_matmul``.

    sort_cols=True reorders entries within each output window by column
    id (gather locality); rows inside a window are then unsorted, which
    the kernel allows.

    The same packing as tmgcn_tpu's Python packer, computed with
    vectorized numpy instead of a loop over chunks.
    """
    g_rows = np.asarray(g_rows, np.int64)
    g_cols = np.asarray(g_cols, np.int64)
    g_vals = np.asarray(g_vals)
    n_rows_out = ((n_out + window - 1) // window) * window
    n_windows = n_rows_out // window
    P = len(g_rows)
    if P and (g_rows.min() < 0 or g_rows.max() >= n_out):
        raise ValueError(f"rows must lie in [0, {n_out})")

    if sort_cols and P:
        # Stable (window, col) order: window ids stay monotonic, rows within
        # a window are free to permute.
        order = np.lexsort((g_cols, g_rows // window))
        g_rows, g_cols, g_vals = g_rows[order], g_cols[order], g_vals[order]

    # Runs of equal window id; each run is cut into ceil(len / chunk) chunks.
    wid_of_entry = g_rows // window
    starts = np.flatnonzero(np.r_[True, wid_of_entry[1:] != wid_of_entry[:-1]]) if P \
        else np.zeros(0, np.int64)
    lens = np.diff(np.r_[starts, P])
    run_of_entry = np.repeat(np.arange(len(starts)), lens)
    pos = np.arange(P) - starts[run_of_entry]
    chunks_per_run = (lens + chunk - 1) // chunk
    first_chunk_of_run = np.r_[0, np.cumsum(chunks_per_run)[:-1]].astype(np.int64)
    chunk_of_entry = first_chunk_of_run[run_of_entry] + pos // chunk
    slot = pos % chunk
    chunk_wid = np.repeat(wid_of_entry[starts], chunks_per_run)

    if all_windows:
        # One empty chunk for each window no entry touches.
        touched = np.zeros(n_windows, bool)
        touched[chunk_wid] = True
        chunk_wid = np.r_[chunk_wid, np.flatnonzero(~touched)]

    # Chunks sorted by window, same-window chunks in stream order.
    order = np.argsort(chunk_wid, kind="stable")
    J = len(order)
    position = np.empty(J, np.int64)
    position[order] = np.arange(J)
    j_of_entry = position[chunk_of_entry]

    rows_out = np.zeros((J, chunk), np.int32)
    cols_out = np.zeros((J, chunk), np.int32)
    vals_out = np.zeros((J, chunk), g_vals.dtype)
    rows_out[j_of_entry, slot] = g_rows - wid_of_entry * window
    cols_out[j_of_entry, slot] = g_cols
    vals_out[j_of_entry, slot] = g_vals
    wid_out = chunk_wid[order].astype(np.int32)
    first_out = np.r_[True, wid_out[1:] != wid_out[:-1]].astype(np.int32)[:J]
    window_ptr = np.searchsorted(wid_out, np.arange(n_windows + 1), side="left")

    return PackedSpmm(
        rows=rows_out,
        cols=cols_out,
        vals=vals_out,
        window_id=wid_out,
        is_first=first_out,
        window_ptr=window_ptr.astype(np.int32),
        n_rows_out=int(n_rows_out),
        chunk=chunk,
        window=window,
    )


def windowed_segment_matmul_reference(
    packed: PackedSpmm,
    gathered: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1: (J, C, F) gathered -> (n_rows_out, F).

    out[w*W + r] = Σ over the chunks of window w and their entries with
    row r of vals * gathered. Windows without a chunk are 0, or, with
    ``init``, keep init's content: init is written in place and returned,
    as the kernel does.
    """
    J, C = packed.rows.shape
    F = gathered.shape[-1]
    W = packed.window
    out_dtype = gathered.dtype if out_dtype is None else out_dtype
    rows = torch.as_tensor(packed.rows, device=gathered.device).long()
    wid = torch.as_tensor(packed.window_id, device=gathered.device).long()
    vals = torch.as_tensor(packed.vals, device=gathered.device).to(gathered.dtype)
    out_rows = (wid[:, None] * W + rows).reshape(J * C)
    scaled = (gathered * vals[..., None]).reshape(J * C, F).to(out_dtype)
    acc = torch.zeros((packed.n_rows_out, F), dtype=out_dtype, device=gathered.device)
    acc.index_add_(0, out_rows, scaled)
    if init is None:
        return acc
    visited = torch.zeros(packed.n_windows, dtype=torch.bool, device=gathered.device)
    visited[wid] = True
    mask = visited.repeat_interleave(W)
    init[mask] = acc[mask]
    return init


def windowed_segment_matmul_t_reference(
    packed: PackedSpmm,
    gathered_t: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K2: (J, F, C) gathered_t -> (F, n_rows_out).

    The sums of ``windowed_segment_matmul_reference`` on the transposed
    layout. ``init`` as there: an (F, n_rows_out) tensor written in place
    (visited windows only, through its transposed view) and returned.
    """
    out = windowed_segment_matmul_reference(
        packed, gathered_t.transpose(1, 2), out_dtype, None if init is None else init.T
    )
    return out.T.contiguous() if init is None else init


@functools.cache
def _kernel(symbol: str):
    """The ctypes entry point of K1 or K2, with its argument types."""
    fn = getattr(load_library("windowed_segment_matmul.cu"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}; move the packing with .to()")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def windowed_segment_matmul(
    packed: PackedSpmm,
    gathered: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    init: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1: (J, C, F) gathered chunks -> (n_rows_out, F) window segment sums.

    On a CUDA tensor this launches the CUDA kernel (float32 in and out)
    and raises on anything it does not take; on a CPU tensor it runs the
    plain version. ``init``: a zero (n_rows_out, F) tensor used as the
    output itself — windows without a chunk are not written. Required
    with ``all_windows=False`` packings.
    """
    if gathered.device.type == "cpu":
        return windowed_segment_matmul_reference(packed, gathered, out_dtype, init)
    if gathered.device.type != "cuda":
        raise ValueError(f"no kernel for device {gathered.device}")
    F = gathered.shape[-1]
    J, C = packed.rows.shape
    if gathered.shape != (J, C, F) or F < 1:
        raise ValueError(f"gathered must be ({J}, {C}, F>=1), got {tuple(gathered.shape)}")
    out = _launch(
        "tmgcn_windowed_segment_matmul_f32", packed, gathered, F, (packed.n_rows_out, F),
        out_dtype, init,
    )
    windowed_segment_matmul.launches += 1
    return out


windowed_segment_matmul.launches = 0  # kernel launches, for run accounting


def windowed_segment_matmul_t(
    packed: PackedSpmm,
    gathered_t: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    init: torch.Tensor | None = None,
) -> torch.Tensor:
    """K2: (J, F, C) transposed chunks -> (F, n_rows_out) window segment sums.

    The lane-major twin of ``windowed_segment_matmul``: the same sums, the
    same ``init`` semantics (an (F, n_rows_out) zero tensor used as the
    output itself; windows without a chunk are not written), the same
    device policy (the kernel on a CUDA tensor, the plain version on a CPU
    tensor, an error otherwise).
    """
    if gathered_t.device.type == "cpu":
        return windowed_segment_matmul_t_reference(packed, gathered_t, out_dtype, init)
    if gathered_t.device.type != "cuda":
        raise ValueError(f"no kernel for device {gathered_t.device}")
    J, C = packed.rows.shape
    F = gathered_t.shape[1] if gathered_t.dim() == 3 else 0
    if gathered_t.shape != (J, F, C) or F < 1:
        raise ValueError(f"gathered_t must be ({J}, F>=1, {C}), got {tuple(gathered_t.shape)}")
    out = _launch(
        "tmgcn_windowed_segment_matmul_t_f32", packed, gathered_t, F, (F, packed.n_rows_out),
        out_dtype, init,
    )
    windowed_segment_matmul_t.launches += 1
    return out


windowed_segment_matmul_t.launches = 0  # kernel launches, for run accounting


def _launch(
    symbol: str,
    packed: PackedSpmm,
    gathered: torch.Tensor,
    F: int,
    out_shape: tuple[int, int],
    out_dtype: torch.dtype | None,
    init: torch.Tensor | None,
) -> torch.Tensor:
    """Check the arguments of K1 or K2 and launch it on the current stream."""
    out_dtype = gathered.dtype if out_dtype is None else out_dtype
    if gathered.dtype != torch.float32 or out_dtype != torch.float32:
        raise NotImplementedError(
            "the CUDA kernels take float32 in and out; the bf16-gather tier is "
            "not ported yet (ROADMAP queue 2, K1)"
        )
    device = gathered.device
    if packed.window > MAX_WINDOW:
        raise ValueError(f"window {packed.window} > {MAX_WINDOW}")
    _check_cuda("gathered", gathered, torch.float32, device)
    _check_cuda("packed.rows", packed.rows, torch.int32, device)
    _check_cuda("packed.vals", packed.vals, torch.float32, device)
    _check_cuda("packed.window_ptr", packed.window_ptr, torch.int32, device)
    if packed.window_ptr.shape != (packed.n_windows + 1,):
        raise ValueError("packed.window_ptr must have n_windows + 1 entries")
    if init is not None:
        _check_cuda("init", init, torch.float32, device)
        if tuple(init.shape) != out_shape:
            raise ValueError(f"init must be {out_shape}")
        out = init
    else:
        out = torch.empty(out_shape, dtype=torch.float32, device=device)
    if packed.n_windows == 0:
        return out
    with torch.cuda.device(device):
        err = _kernel(symbol)(
            packed.rows.data_ptr(),
            packed.vals.data_ptr(),
            gathered.data_ptr(),
            packed.window_ptr.data_ptr(),
            out.data_ptr(),
            packed.n_windows,
            packed.chunk,
            F,
            packed.window,
            0 if init is not None else 1,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    return out


def _flat_fwd_impl(n_out: int, packed: PackedSpmm, flat: torch.Tensor) -> torch.Tensor:
    """(n_in, F) -> (n_out, F): gather rows by column id, then K1."""
    F = flat.shape[-1]
    cols = torch.as_tensor(packed.cols, device=flat.device)
    gathered = flat.index_select(0, cols.reshape(-1)).reshape(packed.n_chunks, packed.chunk, F)
    return windowed_segment_matmul(packed, gathered, out_dtype=flat.dtype)[:n_out]


class _SpmmPacked(torch.autograd.Function):
    """Y = A ⊛ X through the packing; dX = Aᵀ dY through the transpose's."""

    @staticmethod
    def forward(ctx, X, op):
        ctx.op = op
        T, N, F = X.shape
        return _flat_fwd_impl(T * N, op.packed, X.reshape(T * N, F)).reshape(T, N, F)

    @staticmethod
    def backward(ctx, dY):
        op = ctx.op
        T, N, F = dY.shape
        dX = _flat_fwd_impl(T * N, op.packed_t, dY.reshape(T * N, F))
        return dX.reshape(T, N, F), None


@dataclasses.dataclass(frozen=True)
class PallasSpmmOperator:
    """A prepacked SpMM operator: call on (T, N, F) features.

    The name is the JAX package's; here it runs the CUDA K1 (or its plain
    version for CPU tensors), exact float32 tier.
    """

    T: int
    N: int
    packed: PackedSpmm
    packed_t: PackedSpmm

    @property
    def n_slices(self) -> int:
        return self.T

    @property
    def n_nodes(self) -> int:
        return self.N

    def to(self, device: str | torch.device) -> "PallasSpmmOperator":
        return dataclasses.replace(
            self, packed=self.packed.to(device), packed_t=self.packed_t.to(device)
        )

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        if tuple(X.shape[:2]) != (self.T, self.N):
            raise ValueError(f"X must be ({self.T}, {self.N}, F), got {tuple(X.shape)}")
        return _SpmmPacked.apply(X, self)


def make_operator(
    A: TemporalCOO,
    chunk: int = DEFAULT_CHUNK,
    window: int = DEFAULT_WINDOW,
    fast: bool = False,
    gather_dtype: str | None = None,
    sort_cols: bool = False,
    tile_dedup: bool = False,
    ut_cap: int = 64,
) -> PallasSpmmOperator:
    """Prepack forward + transpose packings for A (host-side, numpy).

    Move the operator to the device once with ``.to(device)``.
    """
    if fast or gather_dtype is not None:
        raise NotImplementedError(
            "the fast and bf16-gather tiers of K1 are not ported yet (ROADMAP queue 2, K1)"
        )
    if tile_dedup:
        raise NotImplementedError(
            "the tile-dedup kernel K3 is not ported yet (ROADMAP queue 2, K3)"
        )
    del ut_cap  # K3's budget; unused until K3 is ported
    return PallasSpmmOperator(
        T=A.n_slices,
        N=A.n_nodes,
        packed=pack_windowed(A, chunk, window, sort_cols),
        packed_t=pack_windowed(A.transpose(), chunk, window, sort_cols),
    )


def spmm_pallas(A: TemporalCOO, X: torch.Tensor) -> torch.Tensor:
    """One-shot SpMM through K1 (packs on every call — prefer make_operator)."""
    return make_operator(A).to(X.device)(X)

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
  * At pack time the real entries are also indexed by global output row
    (``entry_order``, ``row_ptr``: a CSR view of the chunk slots, in chunk
    then entry order within each row). K1 walks that index: each output
    element is summed by one thread over its row's entries, in that order —
    bitwise deterministic, no float atomics, no scan of a chunk's slots.
    What bounds it, and what its design does about that, is noted at the
    top of ``csrc/row_segment_matmul.cuh``.

K1 has the JAX package's three tiers, entry points of one kernel template
with a launch count each: the exact float32 tier (``.launches``); the
bf16-gather tier (``gather_dtype="bfloat16"``: X is cast to bf16 before the
gather, each product is rounded to bf16 and summed in float32, the output
is float32; ``.launches_bf16``); and the ``fast`` tier (float32 chunks at
the TPU's DEFAULT matrix precision: each float32 product rounded to bf16,
summed in float32; ``.launches_fast``), which the JAX package reaches from
utils/spmm_bench.py and tools/kernel_probe.py. ``fast`` with bf16 gathers
is the bf16 tier (DEFAULT either way in the JAX package).

K2, ``windowed_segment_matmul_t``, is the same sums with the layout
transposed — (J, F, C) chunks in, (F, n_rows_out) out — and replaces the
Pallas kernel ``windowed_segment_matmul_t`` (body ``_scatter_kernel_t``,
tmgcn_tpu/kernels/spmm_pallas.py:724-824). It walks the same row index as
K1, with consecutive threads on consecutive rows so that its transposed
stores coalesce, and takes any window. Its one user is the ``ReadoutPlan``
backward past ``LANE_MAJOR_BYTES`` (ops/edge_readout.py).

K3, ``windowed_tiled_segment_matmul`` (``csrc/windowed_tiled_segment_matmul.cu``),
replaces the Pallas kernel of the same name (body ``_tiled_scatter_kernel``,
tmgcn_tpu/kernels/spmm_pallas.py:510-605) over the tile-dedup packing
``PackedTiled``: each chunk's distinct 8-row tiles of X are gathered once,
and the kernel reads each entry's row from that block by ``uidx``, walking
the same row index as K1. Float32, bf16 and fast tiers, launch counts
``.launches``, ``.launches_bf16`` and ``.launches_fast``; K3's fast tier
rounds the value and the features to bf16 and their product again (the
TPU's DEFAULT expand and scatter matmuls), so it is the bf16 tier on the
features cast to bf16.

Every kernel wrapper launches its kernel for a CUDA tensor and raises where
it cannot; it takes its plain PyTorch version (``*_reference``) only for a
tensor on the CPU. Each tier's launch count (``.launches`` and the like on
the wrapper) counts the kernels that ran: under a CUDA graph capture a call
counts nothing, and each replay adds the launches the capture recorded
(``LaunchLog``). The operators' ``torch.autograd.Function`` runs the
backward dX = Aᵀ dY as the same kernel on the transposed packing.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from tmgcn_torch import native
from tmgcn_torch.core.sparse import TemporalCOO, to_device
from tmgcn_torch.kernels.build import load_library
from tmgcn_torch.ops.spmm_rowsplit import flatten_stream

DEFAULT_CHUNK = 256
DEFAULT_WINDOW = 256
GATHER_DTYPES = {None: None, "bfloat16": torch.bfloat16}


def _window_ptr(wid: np.ndarray, n_windows: int) -> np.ndarray:
    """Chunk offsets of each window in a window-sorted chunk stream."""
    return np.searchsorted(wid, np.arange(n_windows + 1), side="left").astype(np.int32)


def _row_index(
    rows: np.ndarray, vals: np.ndarray, wid: np.ndarray, window: int, n_rows_out: int
) -> tuple[np.ndarray, np.ndarray]:
    """(entry_order, row_ptr): the real slots of a packing grouped by output row.

    entry_order lists the flat slot ids j*C + c of the real entries (val
    != 0; a padding slot adds 0 to no sum), stably sorted by global output
    row wid[j]*W + rows[j, c]: within a row, chunk order then entry order,
    the order in which the TPU kernel sums them. Row r's entries are
    entry_order[row_ptr[r]:row_ptr[r + 1]].
    """
    J, C = rows.shape
    if J * C >= 2**31:
        raise ValueError(f"{J} x {C} slots do not fit int32 slot ids")
    slots = np.flatnonzero(np.asarray(vals).reshape(-1) != 0)
    g_row = wid.astype(np.int64)[slots // C] * window + rows.reshape(-1)[slots]
    entry_order = slots[np.argsort(g_row, kind="stable")].astype(np.int32)
    row_ptr = np.zeros(n_rows_out + 1, np.int32)
    np.cumsum(np.bincount(g_row, minlength=n_rows_out), out=row_ptr[1:])
    return entry_order, row_ptr


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
    entry_order: (nnz,) int32 — flat slot ids j*C + c of the real entries,
        grouped by global output row (``_row_index``); K1's and K2's
        work list.
    row_ptr: (n_rows_out + 1,) int32 — row r's entries are
        entry_order[row_ptr[r]:row_ptr[r + 1]].
    n_rows_out: padded output rows (a multiple of window).

    The arrays are numpy on the host, or torch tensors after ``to``.
    """

    rows: np.ndarray | torch.Tensor
    cols: np.ndarray | torch.Tensor
    vals: np.ndarray | torch.Tensor
    window_id: np.ndarray | torch.Tensor
    is_first: np.ndarray | torch.Tensor
    window_ptr: np.ndarray | torch.Tensor
    entry_order: np.ndarray | torch.Tensor
    row_ptr: np.ndarray | torch.Tensor
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
        return dataclasses.replace(
            self,
            rows=to_device(self.rows, device),
            cols=to_device(self.cols, device),
            vals=to_device(self.vals, device),
            window_id=to_device(self.window_id, device),
            is_first=to_device(self.is_first, device),
            window_ptr=to_device(self.window_ptr, device),
            entry_order=to_device(self.entry_order, device),
            row_ptr=to_device(self.row_ptr, device),
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
    g_rows, g_cols, g_vals = flatten_stream(A)
    return pack_windowed_flat(
        g_rows, g_cols, g_vals, A.n_slices * A.n_nodes, chunk, window, sort_cols
    )


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

    With every window (``all_windows``) the chunks are cut by the native
    host runtime (``tmgcn_torch.native.pack_chunks``, the JAX package's
    C++ packer, which it takes wherever its library loads); without every
    window by ``pack_chunks_numpy``, the plain version: the same packing as
    tmgcn_tpu's Python packer, computed with vectorized numpy instead of a
    loop over chunks. Either way the row index (``entry_order``,
    ``row_ptr``) is built after the packing.
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

    if all_windows:
        rows_out, cols_out, vals_out, wid_out, first_out = native.pack_chunks(
            g_rows, g_cols, g_vals.astype(np.float64), window, chunk, n_windows
        )
        vals_out = vals_out.astype(g_vals.dtype)
    else:
        rows_out, cols_out, vals_out, wid_out, first_out = pack_chunks_numpy(
            g_rows, g_cols, g_vals, window, chunk, n_windows, all_windows=False
        )
    entry_order, row_ptr = _row_index(rows_out, vals_out, wid_out, window, n_rows_out)
    return PackedSpmm(
        rows=rows_out,
        cols=cols_out,
        vals=vals_out,
        window_id=wid_out,
        is_first=first_out,
        window_ptr=_window_ptr(wid_out, n_windows),
        entry_order=entry_order,
        row_ptr=row_ptr,
        n_rows_out=int(n_rows_out),
        chunk=chunk,
        window=window,
    )


def pack_chunks_numpy(g_rows, g_cols, g_vals, window: int, chunk: int, n_windows: int,
                      all_windows: bool = True):
    """The plain version of ``native.pack_chunks``: (rows, cols, vals,
    window_id, is_first), vals in their own dtype; with ``all_windows``
    False only non-empty windows get chunks."""
    P = len(g_rows)
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
    return rows_out, cols_out, vals_out, wid_out, first_out


@dataclasses.dataclass(frozen=True)
class PackedTiled:
    """Tile-deduplicated chunk stream for K3 (the JAX package's PackedTiled).

    Entries are (window, col)-sorted and each chunk gathers its distinct
    8-row tiles of X once, as contiguous (8, F) row groups.

    rows: (J, C) int32 — window-relative output row per entry (0 pad).
    uidx: (J, C) int32 — per-entry row in the chunk's gathered tile block:
        tile_position * 8 + (col % 8); 0 on padding (val 0).
    tiles: (J, ut_cap) int32 — distinct global tile ids (col // 8) of the
        chunk, padded with 0 (padded tiles are never referenced by uidx).
    vals / window_id / is_first / window_ptr / entry_order / row_ptr /
        n_rows_out / chunk / window: as PackedSpmm. ut_cap: the per-chunk
        distinct-tile budget; a chunk is cut early where one more entry
        would exceed it.

    The arrays are numpy on the host, or torch tensors after ``to``.
    """

    rows: np.ndarray | torch.Tensor
    uidx: np.ndarray | torch.Tensor
    tiles: np.ndarray | torch.Tensor
    vals: np.ndarray | torch.Tensor
    window_id: np.ndarray | torch.Tensor
    is_first: np.ndarray | torch.Tensor
    window_ptr: np.ndarray | torch.Tensor
    entry_order: np.ndarray | torch.Tensor
    row_ptr: np.ndarray | torch.Tensor
    n_rows_out: int
    chunk: int
    window: int
    ut_cap: int

    @property
    def n_chunks(self) -> int:
        return self.rows.shape[0]

    @property
    def n_windows(self) -> int:
        return self.n_rows_out // self.window

    def to(self, device: str | torch.device) -> "PackedTiled":
        """The same packing as torch tensors on ``device`` (dtypes kept)."""
        return dataclasses.replace(
            self,
            rows=to_device(self.rows, device),
            uidx=to_device(self.uidx, device),
            tiles=to_device(self.tiles, device),
            vals=to_device(self.vals, device),
            window_id=to_device(self.window_id, device),
            is_first=to_device(self.is_first, device),
            window_ptr=to_device(self.window_ptr, device),
            entry_order=to_device(self.entry_order, device),
            row_ptr=to_device(self.row_ptr, device),
        )


def _tiled_chunk_starts(wid: np.ndarray, tid: np.ndarray, chunk: int,
                        ut_cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Where the tile-dedup packing cuts a (window, col)-sorted stream, given
    each entry's window and 8-row tile: (the chunks' first entries, each
    entry's run of equal (window, tile)). A chunk ends at ``chunk`` entries,
    at a window boundary, or where one more entry would bring its distinct
    tiles past ``ut_cap``."""
    P = len(wid)
    # Runs of equal (window, tile): a stretch of one window holds as many
    # distinct tiles as the runs it meets.
    new_run = np.r_[True, (wid[1:] != wid[:-1]) | (tid[1:] != tid[:-1])] if P \
        else np.zeros(0, bool)
    run_of = np.cumsum(new_run) - 1
    run_start = np.flatnonzero(new_run)
    seg_start = np.flatnonzero(np.r_[True, wid[1:] != wid[:-1]]) if P else np.zeros(0, np.int64)
    seg_end = np.r_[seg_start[1:], P].astype(np.int64)

    starts = []
    n_runs = len(run_start)
    for s, e in zip(seg_start.tolist(), seg_end.tolist()):
        cs = s
        while cs < e:
            ce = min(cs + chunk, e)
            k = int(run_of[cs]) + ut_cap  # the first run past the budget
            if k < n_runs and run_start[k] < ce:
                ce = int(run_start[k])
            starts.append(cs)
            cs = ce
    return np.asarray(starts, np.int64), run_of


def tiled_counts(g_rows: np.ndarray, g_cols: np.ndarray, n_out: int,
                 chunk: int = DEFAULT_CHUNK, window: int = DEFAULT_WINDOW,
                 ut_cap: int = 64) -> tuple[int, int]:
    """(chunks, distinct 8-row tiles summed over the chunks) of the packing
    ``pack_windowed_tiled_flat`` makes of this stream (rows in any order,
    < n_out), counted without filling it: K3 gathers that many tiles."""
    g_rows = np.asarray(g_rows, np.int64)
    g_cols = np.asarray(g_cols, np.int64)
    n_windows = -(-n_out // window)
    P = len(g_rows)
    if not P:
        return n_windows, 0
    order = np.lexsort((g_cols, g_rows // window))
    wid, tid = g_rows[order] // window, g_cols[order] // 8
    starts, run_of = _tiled_chunk_starts(wid, tid, chunk, ut_cap)
    ends = np.r_[starts[1:], P]
    tiles = int(np.sum(run_of[ends - 1] - run_of[starts] + 1))
    return len(starts) + n_windows - len(np.unique(wid)), tiles


def windowed_chunks(g_rows: np.ndarray, n_out: int, chunk: int = DEFAULT_CHUNK,
                    window: int = DEFAULT_WINDOW) -> int:
    """The chunks of ``pack_windowed_flat``'s packing of a stream with these
    rows (< n_out), with or without ``sort_cols``: each window's entries in
    ceil(count / chunk) chunks, and one for a window with none."""
    counts = np.bincount(np.asarray(g_rows, np.int64) // window,
                         minlength=-(-n_out // window))
    return int(np.sum(np.maximum(1, -(-counts // chunk))))


def pack_windowed_tiled_flat(
    g_rows: np.ndarray,
    g_cols: np.ndarray,
    g_vals: np.ndarray,
    n_out: int,
    chunk: int = DEFAULT_CHUNK,
    window: int = DEFAULT_WINDOW,
    ut_cap: int = 64,
    all_windows: bool = True,
) -> PackedTiled:
    """Pack a flat entry stream with per-chunk distinct-tile budgeting.

    Rows must be sorted ascending and < n_out. Entries are re-sorted by
    (window, col): distinct tiles are then runs. Chunks are cut at
    ``chunk`` entries, at a window boundary, or where the distinct-tile
    count would exceed ``ut_cap``. The same packing as the JAX package's,
    with the chunk cuts found from run offsets and the arrays filled with
    vectorized numpy.
    """
    if ut_cap < 1:
        raise ValueError(f"ut_cap must be >= 1, got {ut_cap}")
    g_rows = np.asarray(g_rows, np.int64)
    g_cols = np.asarray(g_cols, np.int64)
    g_vals = np.asarray(g_vals)
    n_rows_out = ((n_out + window - 1) // window) * window
    n_windows = n_rows_out // window
    P = len(g_rows)
    if P and (g_rows.min() < 0 or g_rows.max() >= n_out):
        raise ValueError(f"rows must lie in [0, {n_out})")
    if P:
        order = np.lexsort((g_cols, g_rows // window))
        g_rows, g_cols, g_vals = g_rows[order], g_cols[order], g_vals[order]
    wid = g_rows // window
    tid = g_cols // 8
    starts, run_of = _tiled_chunk_starts(wid, tid, chunk, ut_cap)
    lens = np.diff(np.r_[starts, P]).astype(np.int64)
    chunk_wid = wid[starts]
    if all_windows:
        touched = np.zeros(n_windows, bool)
        touched[chunk_wid] = True
        chunk_wid = np.r_[chunk_wid, np.flatnonzero(~touched)]

    order = np.argsort(chunk_wid, kind="stable")
    J = len(order)
    position = np.empty(J, np.int64)
    position[order] = np.arange(J)
    chunk_of_entry = np.repeat(np.arange(len(starts)), lens)
    j_of_entry = position[chunk_of_entry]
    slot = np.arange(P) - starts[chunk_of_entry]
    local_run = run_of - run_of[starts][chunk_of_entry]

    rows_out = np.zeros((J, chunk), np.int32)
    uidx_out = np.zeros((J, chunk), np.int32)
    tiles_out = np.zeros((J, ut_cap), np.int32)
    vals_out = np.zeros((J, chunk), g_vals.dtype)
    rows_out[j_of_entry, slot] = g_rows - wid * window
    uidx_out[j_of_entry, slot] = local_run * 8 + g_cols % 8
    tiles_out[j_of_entry, local_run] = tid
    vals_out[j_of_entry, slot] = g_vals
    wid_out = chunk_wid[order].astype(np.int32)
    first_out = np.r_[True, wid_out[1:] != wid_out[:-1]].astype(np.int32)[:J]

    entry_order, row_ptr = _row_index(rows_out, vals_out, wid_out, window, n_rows_out)
    return PackedTiled(
        rows=rows_out,
        uidx=uidx_out,
        tiles=tiles_out,
        vals=vals_out,
        window_id=wid_out,
        is_first=first_out,
        window_ptr=_window_ptr(wid_out, n_windows),
        entry_order=entry_order,
        row_ptr=row_ptr,
        n_rows_out=int(n_rows_out),
        chunk=chunk,
        window=window,
        ut_cap=ut_cap,
    )


def pack_windowed_tiled(
    A: TemporalCOO,
    chunk: int = DEFAULT_CHUNK,
    window: int = DEFAULT_WINDOW,
    ut_cap: int = 64,
) -> PackedTiled:
    """Tile-dedup packing of a temporal COO tensor (host-side, once)."""
    g_rows, g_cols, g_vals = flatten_stream(A)
    return pack_windowed_tiled_flat(
        g_rows, g_cols, g_vals, A.n_slices * A.n_nodes, chunk, window, ut_cap
    )


def windowed_segment_matmul_reference(
    packed: PackedSpmm,
    gathered: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    init: torch.Tensor | None = None,
    fast: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K1: (J, C, F) gathered -> (n_rows_out, F).

    out[w*W + r] = Σ over the chunks of window w and their entries with
    row r of vals * gathered, each product rounded to gathered's type
    (bf16 products for bf16 chunks, as the TPU kernel's bf16 ``g * v``),
    and with ``fast`` then rounded to bf16 (the TPU kernel's DEFAULT
    one-hot matmul), then summed in ``out_dtype``. Windows without a chunk
    are 0, or, with ``init``, keep init's content: init is written in place
    and returned, as the kernel does.
    """
    J, C = packed.rows.shape
    F = gathered.shape[-1]
    W = packed.window
    out_dtype = gathered.dtype if out_dtype is None else out_dtype
    rows = torch.as_tensor(packed.rows, device=gathered.device).long()
    wid = torch.as_tensor(packed.window_id, device=gathered.device).long()
    vals = torch.as_tensor(packed.vals, device=gathered.device).to(gathered.dtype)
    out_rows = (wid[:, None] * W + rows).reshape(J * C)
    scaled = gathered * vals[..., None]
    if fast:
        scaled = scaled.to(torch.bfloat16)
    scaled = scaled.reshape(J * C, F).to(out_dtype)
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


def windowed_tiled_segment_matmul_reference(
    packed: PackedTiled,
    gathered: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    fast: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K3: (J, U8, F) tile blocks -> (n_rows_out, F).

    Each entry's row is read from its chunk's block by ``uidx`` (the TPU
    kernel's one-hot expand), then K1's plain version sums them: the same
    products, rounded to gathered's type, summed in ``out_dtype``. With
    ``fast`` the blocks are rounded to bf16 first (the DEFAULT expand
    rounds both of its operands), which makes it the bf16 tier.
    """
    if fast:
        out_dtype = gathered.dtype if out_dtype is None else out_dtype
        gathered = gathered.to(torch.bfloat16)
    J, C = packed.rows.shape
    F = gathered.shape[-1]
    uidx = torch.as_tensor(packed.uidx, device=gathered.device).long()
    per_entry = torch.gather(gathered, 1, uidx[..., None].expand(J, C, F))
    return windowed_segment_matmul_reference(packed, per_entry, out_dtype)


@functools.cache
def _kernel(source: str, symbol: str, n_ptr: int, n_int: int):
    """The ctypes entry point of a kernel, with its argument types."""
    fn = getattr(load_library(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}; move the packing with .to()")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tier(gathered: torch.Tensor, out_dtype: torch.dtype | None, tiers) -> None:
    """The kernels read float32 or bf16 (where ``tiers`` has it) and write float32."""
    out_dtype = gathered.dtype if out_dtype is None else out_dtype
    if gathered.dtype not in tiers or out_dtype != torch.float32:
        raise NotImplementedError(
            f"no kernel tier reads {gathered.dtype} and writes {out_dtype}: the kernels read "
            f"{' or '.join(str(t) for t in tiers)} and write torch.float32"
        )


def _output(
    packed, out_shape: tuple[int, int], init: torch.Tensor | None, device: torch.device
) -> torch.Tensor:
    """Check the window layout; the caller's init, or a new float32 output."""
    _check_cuda("packed.vals", packed.vals, torch.float32, device)
    _check_cuda("packed.window_ptr", packed.window_ptr, torch.int32, device)
    if packed.window_ptr.shape != (packed.n_windows + 1,):
        raise ValueError("packed.window_ptr must have n_windows + 1 entries")
    if init is None:
        return torch.empty(out_shape, dtype=torch.float32, device=device)
    _check_cuda("init", init, torch.float32, device)
    if tuple(init.shape) != out_shape:
        raise ValueError(f"init must be {out_shape}")
    return init


def _launch_rows(
    symbol: str, packed: PackedSpmm | PackedTiled, gathered: torch.Tensor,
    init: torch.Tensor | None, counter: tuple[object, str], lane_major: bool = False,
) -> torch.Tensor:
    """Check the arguments of K1, K2 (``lane_major``: (J, F, C) in, (F,
    n_rows_out) out) or K3 (by the packing's type) and launch it on the
    current stream: one launch over the packing's row index, counted in
    ``counter`` (the wrapper and the name of its tier's count) by
    ``count_launch``."""
    device = gathered.device
    F = gathered.shape[1 if lane_major else -1]
    _check_cuda("gathered", gathered, gathered.dtype, device)
    _check_cuda("packed.entry_order", packed.entry_order, torch.int32, device)
    _check_cuda("packed.row_ptr", packed.row_ptr, torch.int32, device)
    if packed.row_ptr.shape != (packed.n_rows_out + 1,):
        raise ValueError("packed.row_ptr must have n_rows_out + 1 entries")
    out_shape = (F, packed.n_rows_out) if lane_major else (packed.n_rows_out, F)
    out = _output(packed, out_shape, init, device)
    source, tile_ptrs, tile_ints = "windowed_segment_matmul.cu", [], []
    if isinstance(packed, PackedTiled):
        _check_cuda("packed.uidx", packed.uidx, torch.int32, device)
        source = "windowed_tiled_segment_matmul.cu"
        tile_ptrs, tile_ints = [packed.uidx.data_ptr()], [packed.chunk, gathered.shape[1]]
    elif lane_major:
        tile_ints = [packed.chunk]
    if packed.n_rows_out == 0:
        return out
    ptrs = [packed.entry_order.data_ptr(), packed.row_ptr.data_ptr(), *tile_ptrs,
            packed.vals.data_ptr(), gathered.data_ptr(), packed.window_ptr.data_ptr(),
            out.data_ptr()]
    ints = [packed.n_rows_out, *tile_ints, F, packed.window, 0 if init is not None else 1]
    with torch.cuda.device(device):
        err = _kernel(source, symbol, len(ptrs), len(ints))(
            *ptrs, *ints, torch.cuda.current_stream(device).cuda_stream
        )
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    count_launch(counter, torch.cuda.is_current_stream_capturing())
    return out


class LaunchLog:
    """The kernel launches that one CUDA graph capture recorded.

    A capture runs the wrappers' Python once and launches nothing: the
    launches happen at each replay of the graph, where no Python runs. So
    inside ``recording()`` a wrapper called under capture files its launch
    here instead of counting it, and ``replayed(n)`` adds the recorded
    launches to the counts once for each of n replays.
    """

    def __init__(self):
        self.launches: list[tuple[object, str]] = []

    @contextlib.contextmanager
    def recording(self):
        global _RECORDING
        if _RECORDING is not None:
            raise RuntimeError("a launch log is already recording")
        _RECORDING = self
        try:
            yield self
        finally:
            _RECORDING = None

    def replayed(self, n: int = 1) -> None:
        for wrapper, name in self.launches:
            setattr(wrapper, name, getattr(wrapper, name) + n)


# The log of the capture in progress. A capture holds the whole process
# (torch.cuda.graph's default error mode), so one slot is enough.
_RECORDING: LaunchLog | None = None


def count_launch(counter: tuple[object, str], capturing: bool) -> None:
    """The launch-accounting rule: an eager launch adds one to ``counter``
    (the wrapper and the name of its tier's count); a launch recorded by a
    capture counts 0 here and is added by ``LaunchLog.replayed`` at each
    replay. A capture outside ``LaunchLog.recording`` raises: its replays
    would launch kernels that no count sees."""
    if not capturing:
        wrapper, name = counter
        setattr(wrapper, name, getattr(wrapper, name) + 1)
        return
    if _RECORDING is None:
        raise RuntimeError(
            f"{counter[1]} of {counter[0].__name__} was captured into a CUDA graph outside "
            "LaunchLog.recording(): its replays would not be counted"
        )
    _RECORDING.launches.append(counter)


def _tier(gathered: torch.Tensor, fast: bool) -> str:
    """The kernel tier for these chunks: bf16 chunks take the bf16 tier
    whatever ``fast`` says (the JAX package runs them at DEFAULT either way)."""
    if gathered.dtype == torch.bfloat16:
        return "bf16"
    return "fast" if fast else "f32"


# The launch counter of each tier.
_COUNTER = {"f32": "launches", "bf16": "launches_bf16", "fast": "launches_fast"}


def windowed_segment_matmul(
    packed: PackedSpmm,
    gathered: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    init: torch.Tensor | None = None,
    fast: bool = False,
) -> torch.Tensor:
    """K1: (J, C, F) gathered chunks -> (n_rows_out, F) window segment sums.

    On a CUDA tensor this launches the CUDA kernel — float32 chunks (with
    ``fast``, each product rounded to bf16), or bf16 chunks (the
    bf16-gather tier), float32 out — and raises on anything it does not
    take; on a CPU tensor it runs the plain version. ``init``: a zero
    (n_rows_out, F) float32 tensor used as the output itself — windows
    without a chunk are not written. Required with ``all_windows=False``
    packings.
    """
    if gathered.device.type == "cpu":
        return windowed_segment_matmul_reference(packed, gathered, out_dtype, init, fast)
    if gathered.device.type != "cuda":
        raise ValueError(f"no kernel for device {gathered.device}")
    _check_tier(gathered, out_dtype, (torch.float32, torch.bfloat16))
    F = gathered.shape[-1]
    J, C = packed.rows.shape
    if gathered.shape != (J, C, F) or F < 1:
        raise ValueError(f"gathered must be ({J}, {C}, F>=1), got {tuple(gathered.shape)}")
    tier = _tier(gathered, fast)
    return _launch_rows("tmgcn_windowed_segment_matmul_" + tier, packed, gathered, init,
                        (windowed_segment_matmul, _COUNTER[tier]))


# Kernel launches of each tier, for run accounting.
windowed_segment_matmul.launches = 0
windowed_segment_matmul.launches_bf16 = 0
windowed_segment_matmul.launches_fast = 0


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
    tensor, an error otherwise), the same row walk, any window. Float32
    only.
    """
    if gathered_t.device.type == "cpu":
        return windowed_segment_matmul_t_reference(packed, gathered_t, out_dtype, init)
    if gathered_t.device.type != "cuda":
        raise ValueError(f"no kernel for device {gathered_t.device}")
    _check_tier(gathered_t, out_dtype, (torch.float32,))
    J, C = packed.rows.shape
    F = gathered_t.shape[1] if gathered_t.dim() == 3 else 0
    if gathered_t.shape != (J, F, C) or F < 1:
        raise ValueError(f"gathered_t must be ({J}, F>=1, {C}), got {tuple(gathered_t.shape)}")
    return _launch_rows("tmgcn_windowed_segment_matmul_t_f32", packed, gathered_t, init,
                        (windowed_segment_matmul_t, "launches"), lane_major=True)


windowed_segment_matmul_t.launches = 0  # kernel launches, for run accounting


def windowed_tiled_segment_matmul(
    packed: PackedTiled,
    gathered: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    fast: bool = False,
) -> torch.Tensor:
    """K3: (J, ut_cap * 8, F) distinct-tile blocks -> (n_rows_out, F) sums.

    On a CUDA tensor this launches the CUDA kernel — float32 blocks (with
    ``fast``, rounded as the bf16 tier after a bf16 rounding of each
    feature) or bf16 blocks, float32 out, every window written (0 where it
    has no chunk) — and raises on anything it does not take; on a CPU
    tensor it runs the plain version.
    """
    if gathered.device.type == "cpu":
        return windowed_tiled_segment_matmul_reference(packed, gathered, out_dtype, fast)
    if gathered.device.type != "cuda":
        raise ValueError(f"no kernel for device {gathered.device}")
    _check_tier(gathered, out_dtype, (torch.float32, torch.bfloat16))
    J = packed.n_chunks
    U8 = 8 * packed.ut_cap
    F = gathered.shape[-1] if gathered.dim() == 3 else 0
    if gathered.shape != (J, U8, F) or F < 1:
        raise ValueError(f"gathered must be ({J}, {U8}, F>=1), got {tuple(gathered.shape)}")
    tier = _tier(gathered, fast)
    return _launch_rows("tmgcn_windowed_tiled_segment_matmul_" + tier, packed, gathered, None,
                        (windowed_tiled_segment_matmul, _COUNTER[tier]))


# Kernel launches of each tier, for run accounting.
windowed_tiled_segment_matmul.launches = 0
windowed_tiled_segment_matmul.launches_bf16 = 0
windowed_tiled_segment_matmul.launches_fast = 0


def _gather_dtype(name: str | None) -> torch.dtype | None:
    if name not in GATHER_DTYPES:
        raise ValueError(f"gather_dtype must be one of {list(GATHER_DTYPES)}, got {name!r}")
    return GATHER_DTYPES[name]


def gather_chunks(flat: torch.Tensor, packed: PackedSpmm | PackedTiled) -> torch.Tensor:
    """The kernel input gathered from (n_in, F) rows: K1's (J, C, F) rows by
    column id, or for a tiled packing K3's (J, ut_cap * 8, F) blocks of each
    chunk's distinct 8-row tiles."""
    F = flat.shape[-1]
    if isinstance(packed, PackedTiled):
        # Tiles are rows of a (rows / 8, 8F) view; the JAX package pads the
        # rows to a multiple of 64 (a TPU gather fault), where the view
        # needs only 8.
        pad = (-flat.shape[0]) % 64
        if pad:
            flat = torch.cat([flat, flat.new_zeros((pad, F))])
        J, U_t = packed.tiles.shape
        tiles = torch.as_tensor(packed.tiles, device=flat.device)
        return flat.reshape(-1, 8 * F).index_select(0, tiles.reshape(-1)).reshape(J, U_t * 8, F)
    cols = torch.as_tensor(packed.cols, device=flat.device)
    return flat.index_select(0, cols.reshape(-1)).reshape(packed.n_chunks, packed.chunk, F)


def _flat_fwd_impl(
    n_out: int, fast: bool, gather_dtype: str | None, packed: PackedSpmm | PackedTiled,
    flat: torch.Tensor,
) -> torch.Tensor:
    """(n_in, F) -> (n_out, F): gather, then K1 (or K3 for a tiled packing)
    in the tier that ``fast`` and ``gather_dtype`` name."""
    out_dtype = flat.dtype
    gdt = _gather_dtype(gather_dtype)
    if gdt is not None:
        # Cast before the gather, as the JAX package does: the gathered
        # chunks, the kernel's largest input, move in bf16.
        flat = flat.to(gdt)
    gathered = gather_chunks(flat, packed)
    if isinstance(packed, PackedTiled):
        return windowed_tiled_segment_matmul(packed, gathered, out_dtype, fast)[:n_out]
    return windowed_segment_matmul(packed, gathered, out_dtype, fast=fast)[:n_out]


class _FlatSpmm(torch.autograd.Function):
    """(n_in, F) -> (n_out, F) through the packing; dX = Aᵀ dY through the
    transpose's, in the same tier (as the JAX package's ``_flat_spmm_bwd``)."""

    @staticmethod
    def forward(ctx, flat, op):
        ctx.op = op
        return _flat_fwd_impl(op.n_out, op.fast, op.gather_dtype, op.packed, flat)

    @staticmethod
    def backward(ctx, dY):
        op = ctx.op
        return _flat_fwd_impl(op.n_in, op.fast, op.gather_dtype, op.packed_t, dY), None


@dataclasses.dataclass(frozen=True)
class FlatPallasOperator:
    """A prepacked rectangular flat operator: (n_in, F) -> (n_out, F).

    The name is the JAX package's. The same kernels as
    PallasSpmmOperator over an arbitrary (row, col) entry stream whose
    rows index another space than its columns — the readout-restricted
    layer-2 operator of tasks/adapters.py.
    """

    n_in: int
    n_out: int
    packed: PackedSpmm | PackedTiled
    packed_t: PackedSpmm | PackedTiled
    fast: bool = False
    gather_dtype: str | None = None

    def __post_init__(self):
        _gather_dtype(self.gather_dtype)

    def to(self, device: str | torch.device) -> "FlatPallasOperator":
        return dataclasses.replace(
            self, packed=self.packed.to(device), packed_t=self.packed_t.to(device)
        )

    def __call__(self, flat: torch.Tensor) -> torch.Tensor:
        return _FlatSpmm.apply(flat, self)


def make_flat_operator(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_in: int,
    n_out: int,
    chunk: int = DEFAULT_CHUNK,
    window: int = DEFAULT_WINDOW,
    fast: bool = False,
    gather_dtype: str | None = None,
    sort_cols: bool = False,
    tile_dedup: bool = False,
    ut_cap: int = 64,
) -> FlatPallasOperator:
    """Prepack a rectangular flat operator (host-side, once).

    rows (< n_out) need not be pre-sorted; the stream is row-sorted here.
    The transpose packing (cols as rows, < n_in) powers the backward.
    tile_dedup packs for K3 (PackedTiled); sort_cols is implied there.
    fast runs K1's (or K3's) fast tier, forward and backward.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    order = np.argsort(rows, kind="stable")
    order_t = np.argsort(cols, kind="stable")
    if tile_dedup:
        packed = pack_windowed_tiled_flat(
            rows[order], cols[order], vals[order], n_out, chunk, window, ut_cap
        )
        packed_t = pack_windowed_tiled_flat(
            cols[order_t], rows[order_t], vals[order_t], n_in, chunk, window, ut_cap
        )
    else:
        packed = pack_windowed_flat(
            rows[order], cols[order], vals[order], n_out, chunk, window, sort_cols
        )
        packed_t = pack_windowed_flat(
            cols[order_t], rows[order_t], vals[order_t], n_in, chunk, window, sort_cols
        )
    return FlatPallasOperator(
        n_in=int(n_in), n_out=int(n_out), packed=packed, packed_t=packed_t, fast=fast,
        gather_dtype=gather_dtype,
    )


@dataclasses.dataclass(frozen=True)
class PallasSpmmOperator:
    """A prepacked SpMM operator: call on (T, N, F) features.

    The name is the JAX package's; here it runs the CUDA kernels (or their
    plain versions for CPU tensors): K1 (float32, its fast tier with
    ``fast``, or bf16 gathers with ``gather_dtype="bfloat16"``), or K3 for
    a tiled packing, in the same tiers.
    """

    T: int
    N: int
    packed: PackedSpmm | PackedTiled
    packed_t: PackedSpmm | PackedTiled
    fast: bool = False
    gather_dtype: str | None = None

    def __post_init__(self):
        _gather_dtype(self.gather_dtype)

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
        T, N, F = X.shape
        flat_op = FlatPallasOperator(
            n_in=T * N, n_out=T * N, packed=self.packed, packed_t=self.packed_t,
            fast=self.fast, gather_dtype=self.gather_dtype,
        )
        return flat_op(X.reshape(T * N, F)).reshape(T, N, F)


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

    gather_dtype="bfloat16" runs K1's (or K3's) bf16 tier, and fast (with
    float32 gathers) their fast tier; tile_dedup packs for K3 (PackedTiled,
    budget ``ut_cap`` distinct tiles per chunk). Move the operator to the
    device once with ``.to(device)``.
    """
    if tile_dedup:
        packed = pack_windowed_tiled(A, chunk, window, ut_cap)
        packed_t = pack_windowed_tiled(A.transpose(), chunk, window, ut_cap)
    else:
        packed = pack_windowed(A, chunk, window, sort_cols)
        packed_t = pack_windowed(A.transpose(), chunk, window, sort_cols)
    return PallasSpmmOperator(
        T=A.n_slices, N=A.n_nodes, packed=packed, packed_t=packed_t, fast=fast,
        gather_dtype=gather_dtype,
    )


def spmm_pallas(A: TemporalCOO, X: torch.Tensor) -> torch.Tensor:
    """One-shot SpMM through K1 (packs on every call — prefer make_operator)."""
    return make_operator(A).to(X.device)(X)

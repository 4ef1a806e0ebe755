"""ctypes bindings of the native host runtime (port of tmgcn_tpu.native).

Three entry points with the JAX module's signatures:

* ``sample_negatives`` — one slice's negative edges for link prediction,
  the splitmix64 stream (``tasks.sampling``'s default);
* ``pack_chunks`` — the windowed chunk packing of every window
  (``kernels.spmm_cuda.pack_windowed_flat``'s all-windows case);
* ``parse_edges`` — a raw edge-list file's selected columns
  (``preprocess.datasets.load_raw``).

The library is built from ``tmgcn_native.cpp`` at first use
(``native.build``). Where it does not build or load, the call raises with
the reason; nothing falls back. The plain versions the tests hold these
against are ``sampling.sample_negatives_splitmix64``,
``spmm_cuda.pack_chunks_numpy`` and ``datasets.parse_edges_numpy``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if either fails."""
    from tmgcn_torch.native.build import build

    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"native runtime {path} did not load: {e}") from e
    lib.tmgcn_sample_negatives.argtypes = [
        _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, _I32P, _I32P,
    ]
    lib.tmgcn_sample_negatives.restype = None
    lib.tmgcn_pack_count.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64]
    lib.tmgcn_pack_count.restype = ctypes.c_int64
    lib.tmgcn_pack_fill.argtypes = [
        _I64P, _I64P, _F64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _I32P, _I32P, _F64P, _I32P, _I32P,
    ]
    lib.tmgcn_pack_fill.restype = None
    lib.tmgcn_parse_edges.argtypes = [
        ctypes.c_char_p, _I32P, ctypes.c_int32, ctypes.c_char, ctypes.c_int32, ctypes.c_char,
        _F64P, ctypes.c_int64,
    ]
    lib.tmgcn_parse_edges.restype = ctypes.c_int64
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def sample_negatives(
    real_keys: np.ndarray, n_nodes: int, to_add: int, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """``to_add`` uniform (src, dst) int32 pairs avoiding ``real_keys``
    (src * n_nodes + dst), drawn from splitmix64 started at ``seed``."""
    lib = load()
    real_keys = np.ascontiguousarray(real_keys, dtype=np.int64)
    src = np.empty(to_add, np.int32)
    dst = np.empty(to_add, np.int32)
    lib.tmgcn_sample_negatives(
        _ptr(real_keys, ctypes.c_int64), len(real_keys), n_nodes, to_add,
        int(seed) & 0xFFFFFFFFFFFFFFFF, _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
    )
    return src, dst


def pack_chunks(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    window: int, chunk: int, n_windows: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The windowed chunk packing with a chunk for every window:
    (rows (J, chunk) window-relative int32, cols int32, vals float64,
    window_id (J,) int32, is_first (J,) int32). ``rows // window`` must
    never decrease and lie in [0, n_windows)."""
    lib = load()
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    n = len(rows)
    J = int(lib.tmgcn_pack_count(_ptr(rows, ctypes.c_int64), n, window, chunk, n_windows))
    out_rows = np.empty((J, chunk), np.int32)
    out_cols = np.empty((J, chunk), np.int32)
    out_vals = np.empty((J, chunk), np.float64)
    out_wid = np.empty(J, np.int32)
    out_first = np.empty(J, np.int32)
    lib.tmgcn_pack_fill(
        _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64), _ptr(vals, ctypes.c_double),
        n, window, chunk, n_windows, J,
        _ptr(out_rows, ctypes.c_int32), _ptr(out_cols, ctypes.c_int32),
        _ptr(out_vals, ctypes.c_double), _ptr(out_wid, ctypes.c_int32),
        _ptr(out_first, ctypes.c_int32),
    )
    return out_rows, out_cols, out_vals, out_wid, out_first


def parse_edges(
    path: str | Path, columns, delimiter: str | None, skiprows: int, comment: str
) -> np.ndarray:
    """A numeric edge list's ``columns``, (n_rows, len(columns)) float64.

    Fields are split by ``delimiter`` (None: whitespace) and by any
    whitespace; the first ``skiprows`` lines, blank lines and lines
    starting with ``comment`` are skipped, and so is a row with too few
    fields."""
    lib = load()
    cols = np.asarray(columns, np.int32)
    delim = (delimiter or " ").encode()[0]
    com = (comment or "#").encode()[0]
    name = str(path).encode()
    n = int(lib.tmgcn_parse_edges(name, _ptr(cols, ctypes.c_int32), len(cols), delim, skiprows,
                                  com, None, 0))
    if n < 0:
        raise FileNotFoundError(path)
    out = np.empty((n, len(cols)), np.float64)
    lib.tmgcn_parse_edges(name, _ptr(cols, ctypes.c_int32), len(cols), delim, skiprows, com,
                          _ptr(out, ctypes.c_double), n)
    return out

""".mat artifact IO, byte-compatible with the reference pipeline.

Port of tmgcn_tpu.preprocess.matio: the same keys and layouts, so a
``saved_content_<dataset>.mat`` written by either package loads in both.

The reference persists preprocessing as a MATLAB .mat file with 1-based
subscript arrays (keys: A_subs/A_vals, A_labels_subs/A_labels_vals,
C_subs/C_vals, C_{train,val,test}_subs/vals, Ct_{train,val,test}_subs/
vals, M — read_data.m:211-232) that the experiment scripts re-load and
shift to 0-based (experiment_bitcoin_our.py:44-48). This module writes
artifacts in that exact schema and loads either ours or
reference-generated files, so parity runs can consume byte-identical
inputs.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import scipy.io as sio

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.preprocess.pipeline import PreprocessedData


def _subs_vals(A: TemporalCOO) -> tuple[np.ndarray, np.ndarray]:
    """(nnz, 3) 1-based subscripts and (nnz,) values, MATLAB layout.

    Subscripts are stored as int64 (modern torch rejects float sizes in
    the reference loaders; int arrays satisfy both loaders).
    """
    edges, vals = A.edge_list(with_values=True)
    return (edges.T + 1).astype(np.int64), vals


def save_artifact(path: str | Path, data: PreprocessedData) -> None:
    out = {}
    for key, tensor in [
        ("A", data.A),
        ("A_labels", data.A_labels),
        ("C", data.C),
        ("C_train", data.C_windows["train"]),
        ("C_val", data.C_windows["val"]),
        ("C_test", data.C_windows["test"]),
        ("Ct_train", data.Ct_windows["train"]),
        ("Ct_val", data.Ct_windows["val"]),
        ("Ct_test", data.Ct_windows["test"]),
    ]:
        subs, vals = _subs_vals(tensor)
        out[f"{key}_subs"] = subs
        out[f"{key}_vals"] = vals.reshape(-1, 1)
    out["M"] = np.asarray(data.M)
    # Aliases some reference scripts read instead of A_labels_*
    # (experiment_chess_our.py:38-45 loads tensor_idx/tensor_labels).
    out["tensor_idx"] = out["A_labels_subs"].astype(np.int64)
    out["tensor_labels"] = out["A_labels_vals"]
    # Explicit subscript convention (extra keys are ignored by the
    # reference scripts); load_artifact skips base auto-detection.
    out["subs_base"] = np.asarray([[1]], np.int64)
    # Written beside the target and renamed over it: the ranks of a sharded
    # run may build the same cache at once, and a reader never sees half.
    tmp = Path(f"{path}.{os.getpid()}.tmp")
    try:
        sio.savemat(str(tmp), out, appendmat=False)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _tensor_from_keys(
    content: dict, key: str, n_slices: int, n_nodes: int, pad_multiple: int = 128,
    base: int = 1,
) -> TemporalCOO:
    subs = np.asarray(content[f"{key}_subs"], dtype=np.int64)
    vals = np.asarray(content[f"{key}_vals"], dtype=np.float64).ravel()
    if subs.shape[0] == 3 and subs.shape[1] != 3:
        subs = subs.T  # tolerate (3, nnz) layouts
    t, r, c = subs[:, 0] - base, subs[:, 1] - base, subs[:, 2] - base
    return TemporalCOO.from_global_coo(
        t, r, c, vals, n_slices, n_nodes, pad_multiple=pad_multiple
    )


def load_artifact(
    path: str | Path, s_train: int, pad_multiple: int = 128,
    min_slices: int | None = None,
) -> dict:
    """Load a reference-schema .mat artifact.

    Returns dict with A, A_labels (full tensors), Ct windows (width
    s_train each), M, n_nodes, n_slices — the exact inputs the
    experiment scripts consume (experiment_bitcoin_our.py:36-64).
    """
    content = sio.loadmat(str(path))
    labels_subs = np.asarray(content["A_labels_subs"], dtype=np.int64)
    if labels_subs.shape[0] == 3 and labels_subs.shape[1] != 3:
        labels_subs = labels_subs.T
    # MATLAB-convention artifacts (read_data.m, and ours) store 1-based
    # subscripts; the reference's own Python port saves raw torch
    # indices, which are 0-based (read_data.py:229-246). Our own
    # artifacts carry an explicit sentinel; foreign files are detected
    # by the minimum over EVERY subscript column of every tensor (a
    # 0-based file has node id 0 or slice id 0 somewhere — keying on
    # the label slice column alone misreads files whose first slice
    # happens to carry no labeled edges).
    if "subs_base" in content:
        base = int(np.asarray(content["subs_base"]).ravel()[0])
    else:
        lo = int(labels_subs.min())
        for k in ("A_subs", "C_subs"):
            if k in content:
                lo = min(lo, int(np.asarray(content[k], dtype=np.int64).min()))
        base = 0 if lo == 0 else 1
    # Max subscript undercounts T when trailing slices carry no labeled
    # edges; min_slices (s_train+s_val+s_test) restores the true extent.
    T = int(labels_subs[:, 0].max()) + 1 - base
    if min_slices is not None:
        T = max(T, min_slices)
    N = int(max(labels_subs[:, 1].max(), labels_subs[:, 2].max())) + 1 - base

    out = {
        "A_labels": _tensor_from_keys(
            content, "A_labels", T, N, pad_multiple, base
        ),
        "M": np.asarray(content["M"], dtype=np.float64),
        "n_nodes": N,
        "n_slices": T,
    }
    if "A_subs" in content:
        out["A"] = _tensor_from_keys(content, "A", T, N, pad_multiple, base)
    # The scripts rebuild A as ones on A_labels' support
    # (experiment_bitcoin_our.py:50); replicate for degree-feature parity.
    t_ = labels_subs[:, 0] - base
    r_ = labels_subs[:, 1] - base
    c_ = labels_subs[:, 2] - base
    out["A_binary"] = TemporalCOO.from_global_coo(
        t_, r_, c_, np.ones(len(t_)), T, N, pad_multiple=pad_multiple
    )
    out["Ct"] = {
        w: _tensor_from_keys(content, f"Ct_{w}", s_train, N, pad_multiple, base)
        for w in ("train", "val", "test")
    }
    if "C_subs" in content:
        out["C"] = _tensor_from_keys(content, "C", T, N, pad_multiple, base)
    return out

"""Structured metric logging and run summaries.

The reference's observability is stdout prints plus pickled per-epoch
metric arrays (SURVEY.md §5). This module keeps those array layouts (the
pickles stay directly comparable) and adds structured JSONL records per
evaluation epoch plus end-of-run summaries. Port of
tmgcn_tpu.train.logging (host-side, unchanged in substance).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

F1_COLUMNS = [
    "precision_train", "recall_train", "f1_train", "loss_train",
    "precision_val", "recall_val", "f1_val", "loss_val",
    "precision_test", "recall_test", "f1_test", "loss_test",
]
MAPMRR_COLUMNS = [
    "map_train", "mrr_train", "loss_train",
    "map_val", "mrr_val", "loss_val",
    "map_test", "mrr_test", "loss_test",
]


def _columns_for(results: np.ndarray) -> list[str]:
    if results.shape[1] == 12:
        return F1_COLUMNS
    if results.shape[1] == 9:
        return MAPMRR_COLUMNS
    raise ValueError(f"unexpected results width {results.shape[1]}")


def write_metrics_jsonl(
    path: str | Path,
    results: np.ndarray,
    eval_every: int,
    run_info: dict | None = None,
) -> None:
    """One JSON record per evaluation epoch (plus the final epoch)."""
    cols = _columns_for(results)
    info = run_info or {}
    n = results.shape[0]
    epochs = sorted(set(range(0, n, eval_every)) | {n - 1})
    with open(path, "w") as f:
        for ep in epochs:
            rec = {"epoch": ep, "timestamp": time.time(), **info}
            rec.update({c: float(v) for c, v in zip(cols, results[ep])})
            f.write(json.dumps(rec) + "\n")


def summarize(results: np.ndarray, eval_every: int) -> dict:
    """Best-val-epoch summary in the reference's model-selection style.

    Classification: epoch with best val F1; LP: best val MAP. Reports the
    corresponding test metrics at that epoch plus finals.
    """
    cols = _columns_for(results)
    is_f1 = results.shape[1] == 12
    sel_col = cols.index("f1_val" if is_f1 else "map_val")
    eval_rows = list(range(0, results.shape[0], eval_every))
    vals = np.nan_to_num(results[eval_rows, sel_col], nan=-1.0)
    best = eval_rows[int(np.argmax(vals))]
    out = {
        "best_epoch": int(best),
        "n_epochs": int(results.shape[0]),
    }
    for c, v in zip(cols, results[best]):
        out[f"best_{c}"] = float(v)
    for c, v in zip(cols, results[-1]):
        out[f"final_{c}"] = float(v)
    return out

"""Temporal windowing and train/val/test splitting.

The framework reproduces the reference's two windowing schemes
(capability reference: IBM/TM-GCN TensorGCN-master/
embedding_help_functions.py — create_node_features :597-609, split_data
:612-655; edge-classification splits experiment_bitcoin_our.py:74-95):

  * same_block_size=True (TM-GCN): every window has width S_train; val
    shifts by S_val, test by S_val+S_test. Evaluation only scores edges
    in the *new tail* slices of each shifted window.
  * same_block_size=False (baselines on classification): disjoint
    windows [0,S_train), [S_train,S_train+S_val), ...

Link prediction additionally shifts features/targets by one slice: the
model consumes slices [0, S-1) and predicts the edges of slices [1, S)
(edges re-indexed down by one -> the ``model_edges`` fields).

All of this is host-side numpy data preparation (port of
tmgcn_tpu.tasks.windows: the classification half).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    s_train: int
    s_val: int
    s_test: int
    same_block_size: bool = True

    @property
    def total(self) -> int:
        return self.s_train + self.s_val + self.s_test

    def bounds(self, which: str) -> tuple[int, int]:
        """[start, end) slice range of a window in absolute slice indices."""
        s, v, te = self.s_train, self.s_val, self.s_test
        if which == "train":
            return 0, s
        if self.same_block_size:
            if which == "val":
                return v, s + v
            if which == "test":
                return v + te, s + v + te
        else:
            if which == "val":
                return s, s + v
            if which == "test":
                return s + v, self.total
        raise ValueError(f"unknown window: {which!r}")


def window_features(X: np.ndarray, spec: WindowSpec) -> dict[str, np.ndarray]:
    """Split (T, N, F) features into the three windows."""
    out = {}
    for which in ("train", "val", "test"):
        a, b = spec.bounds(which)
        out[which] = X[a:b]
    return out


@dataclasses.dataclass(frozen=True)
class EdgeSplit:
    """One window's labeled edges for edge classification."""

    edges: np.ndarray  # (3, E) [slice (rebased), src, trg]
    target: np.ndarray  # (E,) int class labels
    eval_mask: np.ndarray  # (E,) bool — edges scored during evaluation


def split_edges_classification(
    edge_index: np.ndarray,
    edge_values: np.ndarray,
    spec: WindowSpec,
    n_classes: int = 2,
) -> dict[str, EdgeSplit]:
    """Labeled-edge windows for edge classification.

    Targets: binary -> (sign(v) != -1), i.e. class 0 = negative edges
    (the minority class); 3-class (chess) -> sign(v) + 1.
    Evaluation masks: train scores everything; shifted val/test windows
    only score their new tail slices (edges_val[0] >= S_train - S_val).
    """
    edge_index = np.asarray(edge_index)
    vals = np.asarray(edge_values)
    sign = np.sign(vals)
    if n_classes == 2:
        target_all = (sign != -1).astype(np.int64)
    elif n_classes == 3:
        target_all = (sign + 1).astype(np.int64)
    else:
        raise ValueError("n_classes must be 2 or 3")

    out = {}
    for which in ("train", "val", "test"):
        a, b = spec.bounds(which)
        m = (edge_index[0] >= a) & (edge_index[0] < b)
        edges = edge_index[:, m].copy()
        edges[0] -= a
        target = target_all[m]
        if which == "train" or not spec.same_block_size:
            eval_mask = np.ones(target.shape[0], dtype=bool)
        else:
            new_start = spec.s_train - (spec.s_val if which == "val" else spec.s_test)
            eval_mask = edges[0] >= new_start
        out[which] = EdgeSplit(edges=edges, target=target, eval_mask=eval_mask)
    return out

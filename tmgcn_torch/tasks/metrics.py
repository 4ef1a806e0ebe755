"""Evaluation metrics with numerics identical to the reference protocol
(port of tmgcn_tpu.tasks.metrics, the classification metrics).

Class 0 is the positive/minority class throughout (capability reference:
IBM/TM-GCN TensorGCN-master/embedding_help_functions.py compute_f1
:530-538). These run host-side in numpy/float64 on fetched logits.
"""

from __future__ import annotations

import numpy as np


def precision_recall_f1(guess: np.ndarray, target: np.ndarray) -> tuple[float, float, float]:
    """P/R/F1 with class 0 as the positive class."""
    guess = np.asarray(guess)
    target = np.asarray(target)
    tp = np.float64(np.sum((guess == 0) & (target == 0)))
    fp = np.float64(np.sum((guess == 0) & (target != 0)))
    fn = np.float64(np.sum((guess != 0) & (target == 0)))
    with np.errstate(invalid="ignore", divide="ignore"):
        precision = tp / (tp + fp)
        recall = tp / (tp + fn)
        f1 = 2 * (precision * recall) / (precision + recall)
    return float(precision), float(recall), float(f1)


def weighted_ce_loss_np(logits: np.ndarray, target: np.ndarray, weights: np.ndarray) -> float:
    """Numpy oracle of torch's weighted CrossEntropyLoss (mean reduction)."""
    logits = np.asarray(logits, dtype=np.float64)
    target = np.asarray(target)
    weights = np.asarray(weights, dtype=np.float64)
    z = logits - logits.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    w = weights[target]
    return float(-(w * logp[np.arange(len(target)), target]).sum() / w.sum())

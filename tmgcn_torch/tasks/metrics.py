"""Evaluation metrics with numerics identical to the reference protocol
(port of tmgcn_tpu.tasks.metrics: classification, link prediction and
node regression).

Class 0 is the positive/minority class throughout (existing edges for
link prediction) — capability reference: IBM/TM-GCN TensorGCN-master/
embedding_help_functions.py — compute_f1 :530-538, get_row_MRR :669-681,
get_MRR :684-701, get_MAP :704-711, compute_MAP_MRR :714-729; the SEIR
scripts' L1 / L1-ratio protocol, test_graph_SEIR.py:172-200. These run
host-side in numpy/float64 on fetched logits.
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


def average_precision_pos0(scores: np.ndarray, target: np.ndarray) -> float:
    """Average precision with label 0 as positive.

    Matches sklearn's ``average_precision_score(target, scores,
    pos_label=0)``: AP = Σ_n (R_n − R_{n−1}) P_n over descending unique
    score thresholds.
    """
    scores = np.asarray(scores, dtype=np.float64)
    pos = np.asarray(target) == 0
    order = np.argsort(-scores, kind="stable")
    scores_s = scores[order]
    pos_s = pos[order].astype(np.float64)

    tp_cum = np.cumsum(pos_s)
    n_pred = np.arange(1, len(scores_s) + 1, dtype=np.float64)
    # Evaluate at the last index of each tied-score block.
    distinct = np.nonzero(np.diff(scores_s))[0]
    idx = np.concatenate([distinct, [len(scores_s) - 1]])
    precision = tp_cum[idx] / n_pred[idx]
    recall = tp_cum[idx] / max(tp_cum[-1], 1.0)
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))


def row_mrr(probs: np.ndarray, true_classes: np.ndarray) -> float:
    """Mean reciprocal rank of the existing edges within one node's row."""
    existing = np.asarray(true_classes) == 0
    order = np.flip(np.argsort(probs, kind="stable"))
    existing_sorted = existing[order]
    ranks = np.arange(1, len(true_classes) + 1, dtype=np.float64)[existing_sorted]
    return float(np.sum(1.0 / ranks) / ranks.shape[0])


def _mrr_from_edges_dense(
    probs: np.ndarray, true_classes: np.ndarray, adj: np.ndarray
) -> float:
    """Reference-literal dense MRR (test oracle for mrr_from_edges).

    O(rows x Ncols log Ncols) and hundreds of MB at chess scale — the
    sparse closed form below replaces it in production.
    """
    import scipy.sparse as sp

    probs = np.asarray(probs, dtype=np.float64)
    true_classes = np.asarray(true_classes, dtype=np.float64)
    adj = np.asarray(adj)
    shape = (int(adj[0].max()) + 1, int(adj[1].max()) + 1)
    pred = sp.coo_matrix((probs, (adj[0], adj[1])), shape=shape).toarray()
    true = sp.coo_matrix((true_classes, (adj[0], adj[1])), shape=shape).toarray()
    keep = np.nonzero((true == 1).any(axis=1))[0]
    if keep.size == 0:
        return float("nan")
    pred = pred[keep]
    true = true[keep]
    order = np.flip(np.argsort(pred, axis=1, kind="stable"), axis=1)
    existing_sorted = np.take_along_axis(true == 0, order, axis=1)
    ranks = np.arange(1, shape[1] + 1, dtype=np.float64)[None, :]
    inv_sum = np.where(existing_sorted, 1.0 / ranks, 0.0).sum(axis=1)
    counts = existing_sorted.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return float(np.mean(inv_sum / counts))


def mrr_from_edges(probs: np.ndarray, true_classes: np.ndarray, adj: np.ndarray) -> float:
    """Slice MRR: average row_mrr over rows that contain a negative edge.

    Numerically identical to the reference's dense construction
    (duplicate (i, j) pairs sum; the row filter is ``isin(1, true[i])``;
    implicit zero entries count as label-0 "existing" positions — a
    reference quirk preserved as a contract), but computed from the
    explicit entries alone: a row's zero-valued block contributes a
    harmonic-number difference in closed form, so the cost is
    O(E log E + Ncols) instead of materializing and argsorting dense
    (rows x Ncols) float64 matrices (208 s -> <1 s per chess LP eval).

    Rank semantics replicated exactly: ``flip(argsort(row, stable))``
    ranks by value descending with ties broken by HIGHER column first.
    """
    probs = np.asarray(probs, dtype=np.float64)
    true_classes = np.asarray(true_classes, dtype=np.float64)
    adj = np.asarray(adj, dtype=np.int64)
    n_cols = int(adj[1].max()) + 1

    # Aggregate duplicates like coo_matrix.toarray (values SUM).
    key = adj[0] * n_cols + adj[1]
    uniq, inv = np.unique(key, return_inverse=True)
    v = np.bincount(inv, weights=probs, minlength=len(uniq))
    t = np.bincount(inv, weights=true_classes, minlength=len(uniq))
    rows = uniq // n_cols
    cols = uniq % n_cols

    # Rows kept: any aggregated entry EXACTLY 1 (the reference tests
    # the summed matrix against 1).
    keep_rows = np.unique(rows[t == 1.0])
    if keep_rows.size == 0:
        return float("nan")
    m = np.isin(rows, keep_rows)
    v, t, cols = v[m], t[m], cols[m]
    # Compact row ids 0..R-1 in sorted order.
    rows = np.searchsorted(keep_rows, rows[m])
    R = keep_rows.size

    n_exp = np.bincount(rows, minlength=R)  # explicit entries per row
    P = np.bincount(rows[v > 0], minlength=R)  # positives per row
    Zexp = np.bincount(rows[v == 0], minlength=R)
    Zimp = n_cols - n_exp  # implicit zero columns per row
    Z = Zexp + Zimp  # total zero-valued columns per row

    # Explicit ranks. Sort within each row by (value desc, col desc) —
    # the flip(argsort) tie order.
    order = np.lexsort((-cols, -v, rows))
    rs, vs, cs, ts = rows[order], v[order], cols[order], t[order]
    row_start = np.searchsorted(rs, np.arange(R))
    pos_in_row = np.arange(len(rs)) - row_start[rs]

    rank = np.empty(len(rs), dtype=np.float64)
    pos_mask = vs > 0
    neg_mask = vs < 0
    zero_mask = ~pos_mask & ~neg_mask
    # v > 0: no implicit entry outranks or ties it.
    rank[pos_mask] = pos_in_row[pos_mask] + 1
    # v < 0: every zero-valued implicit column ranks above it.
    rank[neg_mask] = pos_in_row[neg_mask] + Zimp[rs[neg_mask]] + 1
    # v == 0: P + 1 + (#zero-valued columns with index > c), where
    # zero-valued columns are all columns except explicit nonzeros.
    if zero_mask.any():
        # explicit columns (any value) with index > c, per entry: one
        # global searchsorted over the (row, col)-sorted combined key.
        corder = np.lexsort((cols, rows))
        sorted_key = rows[corder] * n_cols + cols[corder]
        rstart = np.searchsorted(rows[corder], np.arange(R))
        zc, zr = cs[zero_mask], rs[zero_mask]
        flat_pos = (
            np.searchsorted(sorted_key, zr * n_cols + zc, side="right")
            - rstart[zr]
        )
        exp_gt_c = n_exp[zr] - flat_pos
        # explicit NONZERO columns > c = explicit > c minus explicit
        # ZERO columns > c; the latter from the zero-subset itself
        # (sorted by col desc within a row = our (value, col desc) order
        # restricted to the zero block).
        zero_pos_desc = pos_in_row[zero_mask] - P[zr]  # 0-based among zeros, col desc
        exp_zero_gt_c = zero_pos_desc
        exp_nonzero_gt_c = exp_gt_c - exp_zero_gt_c
        zero_cols_gt_c = (n_cols - 1 - zc) - exp_nonzero_gt_c
        rank[zero_mask] = P[zr] + 1 + zero_cols_gt_c

    inv_rank = 1.0 / rank
    # Harmonic prefix sums: the whole zero block of a row contributes
    # H(P+Z) - H(P).
    H = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, n_cols + 1))])
    block = H[P + Z] - H[P]

    sum_t0 = np.bincount(rs[ts == 0.0], weights=inv_rank[ts == 0.0], minlength=R)
    sum_zero_exp = np.bincount(rs[zero_mask], weights=inv_rank[zero_mask], minlength=R)
    inv_sum = sum_t0 + block - sum_zero_exp
    counts = Zimp + np.bincount(rs[ts == 0.0], minlength=R)
    # A kept row with NO label-0 position is 0/0 = nan in the dense
    # construction; force it (fp residue in inv_sum would give +/-inf).
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(counts > 0, inv_sum / np.maximum(counts, 1), np.nan)
    return float(np.mean(ratio))


def softmax_pos0(logits: np.ndarray) -> np.ndarray:
    """Probability of class 0 under a softmax over the logit columns."""
    logits = np.asarray(logits, dtype=np.float64)
    z = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e[:, 0] / e.sum(axis=1)


def map_mrr(
    logits: np.ndarray, target: np.ndarray, edges: np.ndarray
) -> tuple[float, float]:
    """Slice-weighted MAP and MRR over a labeled edge set.

    Args:
        logits: (E, C) model outputs.
        target: (E,) labels, 0 = real edge.
        edges: (3, E) [slice, src, trg].
    """
    target = np.asarray(target)
    edges = np.asarray(edges)
    logits = np.asarray(logits, dtype=np.float64)
    probs = softmax_pos0(logits)
    E = len(target)
    MAP = 0.0
    MRR = 0.0
    for k in np.unique(edges[0]):
        m = edges[0] == k
        w = float(np.sum(m)) / E
        MAP += average_precision_pos0(probs[m], target[m]) * w
        # The reference ranks MRR by the RAW class-0 logit, not the
        # softmax probability (compute_MAP_MRR passes do_softmax=False,
        # embedding_help_functions.py:725) — the rankings differ.
        MRR += mrr_from_edges(logits[m, 0], target[m], edges[1:3, m]) * w
    return MAP, MRR


def l1_and_ratio(pred: np.ndarray, truth: np.ndarray) -> tuple[float, float]:
    """SEIR regression evaluation: the per-slice summed L1 and L1/||y||_1,
    each averaged over slices, in float64 on the host."""
    pred = np.asarray(pred, dtype=np.float64)
    truth = np.asarray(truth, dtype=np.float64)
    T = pred.shape[0]
    loss = 0.0
    ratio = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        for ts in range(T):
            l1 = np.float64(np.abs(pred[ts] - truth[ts]).sum())
            loss += l1
            # A slice with ||y||_1 = 0 yields inf, as the reference's
            # division does (test_graph_SEIR.py:179).
            ratio += l1 / np.float64(np.abs(truth[ts]).sum())
    return float(loss / T), float(ratio / T)


def weighted_ce_loss_np(logits: np.ndarray, target: np.ndarray, weights: np.ndarray) -> float:
    """Numpy oracle of torch's weighted CrossEntropyLoss (mean reduction)."""
    logits = np.asarray(logits, dtype=np.float64)
    target = np.asarray(target)
    weights = np.asarray(weights, dtype=np.float64)
    z = logits - logits.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    w = weights[target]
    return float(-(w * logp[np.arange(len(target)), target]).sum() / w.sum())

"""Loss functions matching the reference training objectives (port of
tmgcn_tpu.train.losses).

Capability reference: weighted ``nn.CrossEntropyLoss`` in every
classification/link-prediction script (e.g. TensorGCN-master/
experiment_bitcoin_our.py:113) — weighted mean: Σ w[y_i]·ce_i / Σ w[y_i];
the per-slice-summed MSE of the SEIR regression scripts
(test_graph_SEIR.py:135-140); and the sigmoid loss_type of the
link-prediction scripts (unused by the presets but supported).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def weighted_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    class_weights: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Torch-semantics weighted CE with mean reduction.

    Written as one-hot contractions, as in the JAX package, so the two
    compute the same sums in the same order.
    """
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(targets.long(), logits.shape[-1]).to(logits.dtype)
    nll = -torch.sum(logp * onehot, dim=-1)
    w = onehot @ class_weights.to(logits.dtype)
    if mask is not None:
        w = w * mask.to(logits.dtype)
    return torch.sum(w * nll) / torch.sum(w)


def sigmoid_pair_logits(out: torch.Tensor) -> torch.Tensor:
    """loss_type='sigmoid': map (E, 1) outputs to (E, 2) as [p, 1-p]."""
    p = torch.sigmoid(out)
    return torch.cat([p, 1.0 - p], dim=1)


def summed_per_slice_mse(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Σ over slices of the mean squared error within the slice -> scalar."""
    return torch.sum(torch.mean((pred - truth) ** 2, dim=tuple(range(1, pred.ndim))))

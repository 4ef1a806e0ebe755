"""Loss functions matching the reference training objectives (port of
tmgcn_tpu.train.losses, the classification loss).

Capability reference: weighted ``nn.CrossEntropyLoss`` in every
classification script (e.g. TensorGCN-master/experiment_bitcoin_our.py:113)
— weighted mean: Σ w[y_i]·ce_i / Σ w[y_i].
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

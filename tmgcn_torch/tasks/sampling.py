"""Negative edge sampling for link prediction (port of
tmgcn_tpu.tasks.sampling).

Capability reference: augment_edges in IBM/TM-GCN (TensorGCN-master/
embedding_help_functions.py:500-526): per slice j, append
``beta * (#real edges in j)`` uniformly random (src, trg) pairs that do
not coincide with a real edge of that slice; real edges get label 0
(positive class), fakes label 1; the result is stably sorted by slice.
Fakes may duplicate each other and may be self-loops, as in the reference.

Two streams, both the JAX package's:

* ``"splitmix64"`` (the default): the stream of the JAX package's C++
  sampler, which it uses wherever its shared library loads. Per slice j
  the state starts at ``(seed * 0x9e3779b9 + j) ^ 0xda3e39cb94b95bdb``;
  draws alternate src and trg, each ``splitmix64(state) % n_nodes``; a
  pair that hits a real key is rejected. The port draws it with its own
  native runtime (``tmgcn_torch.native.sample_negatives``, the same C++);
  ``sample_negatives_splitmix64`` is its plain version: draw k depends only
  on ``state0 + k * 0x9e3779b97f4a7c15``, so whole batches of draws are
  computed at once in uint64 arrays.
* ``"default_rng"``: the JAX package's numpy fallback — one
  ``np.random.default_rng(seed)`` across slices, oversampled batches of
  ``max(64, int(1.2 * remaining))`` pairs, src drawn before trg.
"""

from __future__ import annotations

import numpy as np

from tmgcn_torch import native

_MASK64 = (1 << 64) - 1
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_SEED_MIX = 0xDA3E39CB94B95BDB


def _splitmix64(state0: int, k: np.ndarray) -> np.ndarray:
    """Output of draw k (k = 1, 2, ...) of a splitmix64 state started at state0."""
    with np.errstate(over="ignore"):
        z = np.uint64(state0) + k.astype(np.uint64) * _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def sample_negatives_splitmix64(
    real_keys: np.ndarray, n_nodes: int, to_add: int, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """``to_add`` (src, trg) int32 pairs avoiding ``real_keys``
    (src * n_nodes + trg): the C++ sampler's stream, draw for draw."""
    state0 = (seed & _MASK64) ^ _SEED_MIX
    real_keys = np.unique(np.asarray(real_keys, dtype=np.int64))
    n = np.uint64(n_nodes)
    src_parts, trg_parts = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    added, pair0 = 0, 0
    # Acceptance rate of a pair, for the batch size; every batch continues
    # the stream where the last one stopped, so the size changes nothing.
    accept = max(1.0 - len(real_keys) / float(n_nodes) ** 2, 1e-3)
    while added < to_add:
        batch = max(64, int((to_add - added) / accept * 1.1))
        k = 2 * np.arange(pair0, pair0 + batch, dtype=np.uint64) + np.uint64(1)
        src = (_splitmix64(state0, k) % n).astype(np.int64)
        trg = (_splitmix64(state0, k + np.uint64(1)) % n).astype(np.int64)
        ok = ~np.isin(src * n_nodes + trg, real_keys)
        take = min(int(ok.sum()), to_add - added)
        src_parts.append(src[ok][:take])
        trg_parts.append(trg[ok][:take])
        added += take
        pair0 += batch
    return (np.concatenate(src_parts).astype(np.int32),
            np.concatenate(trg_parts).astype(np.int32))


def augment_edges(
    edges: np.ndarray,
    n_nodes: int,
    beta1: int,
    beta2: int,
    cutoff: int,
    seed: int = 0,
    sampler: str = "splitmix64",
) -> tuple[np.ndarray, np.ndarray]:
    """Augment real edges with sampled negatives.

    Args:
        edges: (3, E) int [slice, src, trg] of real edges.
        n_nodes: N.
        beta1: negatives per real edge for slices < cutoff.
        beta2: negatives per real edge for slices >= cutoff.
        cutoff: slice index where beta switches.
        seed: the stream's seed.
        sampler: ``"splitmix64"`` (the JAX package's C++ stream) or
            ``"default_rng"`` (its numpy fallback).

    Returns:
        (edges_aug, labels): (3, E') augmented edges stably sorted by
        slice, and (E',) labels with 0 = real, 1 = fake.
    """
    if sampler not in ("splitmix64", "default_rng"):
        raise ValueError(f"unknown sampler {sampler!r}")
    edges = np.asarray(edges)
    rng = np.random.default_rng(seed)
    new_edges = []
    for j in range(int(edges[0].max()) + 1):
        beta = beta1 if j < cutoff else beta2
        slice_mask = edges[0] == j
        to_add = beta * int(np.sum(slice_mask))
        if to_add == 0:
            continue
        key_arr = edges[1, slice_mask].astype(np.int64) * n_nodes + edges[2, slice_mask]
        if sampler == "splitmix64":
            src, trg = native.sample_negatives(key_arr, n_nodes, to_add, seed * 0x9E3779B9 + j)
            new_edges.append(np.stack([np.full(to_add, j, dtype=edges.dtype), src, trg]))
            continue
        added = 0
        while added < to_add:
            batch = max(64, int((to_add - added) * 1.2))
            src = rng.integers(0, n_nodes, batch)
            trg = rng.integers(0, n_nodes, batch)
            ok = ~np.isin(src.astype(np.int64) * n_nodes + trg, key_arr)
            src, trg = src[ok], trg[ok]
            take = min(len(src), to_add - added)
            if take:
                new_edges.append(
                    np.stack([np.full(take, j, dtype=edges.dtype), src[:take], trg[:take]])
                )
                added += take

    if new_edges:
        edges_aug = np.concatenate([edges, np.concatenate(new_edges, axis=1)], axis=1)
    else:
        edges_aug = edges
    labels = np.concatenate(
        [np.zeros(edges.shape[1], dtype=np.int64),
         np.ones(edges_aug.shape[1] - edges.shape[1], dtype=np.int64)]
    )
    order = np.argsort(edges_aug[0], kind="stable")
    return edges_aug[:, order], labels[order]

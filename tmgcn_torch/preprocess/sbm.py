"""Dynamic stochastic-block-model graph generator (port of
tmgcn_tpu.preprocess.sbm, numpy throughout).

Capability reference: SBM_our.py:98-139 in IBM/TM-GCN, which generates a
2-community dynamic SBM via the external ``dynamicgem`` package
(``get_community_diminish_series_v2(N, 2, T, 1, node_change_num)``) —
community 1 diminishes as ``node_change_num`` nodes migrate to community 0
at every step. The JAX package writes a self-contained seeded generator
with the same structure: fixed within/between-community edge
probabilities, a community assignment that shifts by migration each step,
and an independently resampled undirected adjacency per step. This module
draws the same numbers from the same ``default_rng`` stream, so its graphs
are bitwise the JAX package's.
"""

from __future__ import annotations

import numpy as np

from tmgcn_torch.core.sparse import TemporalCOO


def dynamic_sbm_series(
    n_nodes: int,
    n_slices: int,
    n_communities: int = 2,
    node_change_num: int = 10,
    p_in: float = 0.01,
    p_out: float = 0.001,
    seed: int = 0,
) -> tuple[list[np.ndarray], np.ndarray]:
    """Per-slice adjacency matrices of a diminishing-community SBM.

    Returns:
        (adjacencies, communities): T dense symmetric 0/1 (N, N) arrays
        with zero diagonal, and the (T, N) community assignment history.
    """
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_communities, n_nodes)
    adjs = []
    history = np.zeros((n_slices, n_nodes), dtype=np.int64)
    for t in range(n_slices):
        if t > 0:
            # Migrate nodes out of the perturbed community (community 1).
            members = np.nonzero(comm == 1)[0]
            take = min(node_change_num, len(members))
            if take:
                comm[rng.choice(members, size=take, replace=False)] = 0
        history[t] = comm
        probs = np.where(comm[:, None] == comm[None, :], p_in, p_out)
        upper = np.triu(rng.random((n_nodes, n_nodes)) < probs, k=1)
        adjs.append((upper | upper.T).astype(np.float64))
    return adjs, history


def sbm_temporal_adjacency(
    n_nodes: int,
    n_slices: int,
    node_change_num: int = 10,
    p_in: float = 0.01,
    p_out: float = 0.001,
    seed: int = 0,
    dtype=np.float32,
) -> TemporalCOO:
    """The (T, N, N) temporal adjacency of a dynamic SBM as TemporalCOO."""
    adjs, _ = dynamic_sbm_series(
        n_nodes, n_slices, node_change_num=node_change_num, p_in=p_in, p_out=p_out, seed=seed
    )
    return TemporalCOO.from_dense(np.stack(adjs), dtype=dtype)

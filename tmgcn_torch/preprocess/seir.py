"""Synthetic SEIR epidemic on a temporal graph, the node-regression task
(port of tmgcn_tpu.preprocess.seir, numpy throughout).

Capability reference: test_graph_SEIR.py:89-133 in IBM/TM-GCN loads
``data/Graph_SEIR.mat`` (a dynamic graph ``DyG`` plus per-node SEIR state
time series ``ys``); that artifact is stripped from the reference
snapshot, so the JAX package generates an equivalent dataset: a temporal
contact graph and a stochastic SEIR simulation on it. This module draws
the same numbers from the same ``default_rng`` stream, draw for draw, so
its data are bitwise the JAX package's. Feature/target construction
mirrors the reference's get_features: the target is the *next step's*
chosen compartment (out_idx) per node, and features are [in-degree,
out-degree] ⊕ the current step's remaining compartments.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tmgcn_torch.core.sparse import TemporalCOO


@dataclasses.dataclass(frozen=True)
class SEIRData:
    adjacency: np.ndarray  # (T, N, N) temporal contact graph
    states: np.ndarray  # (T+1, 4, N) SEIR one-hot states over time


def simulate_seir(
    n_nodes: int = 200,
    n_slices: int = 100,
    edge_prob: float = 0.03,
    rewire_prob: float = 0.1,
    beta: float = 0.3,
    sigma: float = 0.25,
    gamma: float = 0.05,
    initial_infected: int = 10,
    seed: int = 0,
) -> SEIRData:
    """Stochastic SEIR on a slowly rewiring random contact graph.

    S --(beta per infected neighbor)--> E --(sigma)--> I --(gamma)--> R
    """
    rng = np.random.default_rng(seed)
    N, T = n_nodes, n_slices

    base = np.triu(rng.random((N, N)) < edge_prob, k=1)
    adj = np.zeros((T, N, N))
    for t in range(T):
        if t > 0:
            flip = np.triu(rng.random((N, N)) < rewire_prob * edge_prob, k=1)
            base = base ^ flip
        adj[t] = (base | base.T).astype(np.float64)

    # States: 0=S, 1=E, 2=I, 3=R.
    state = np.zeros(N, dtype=np.int64)
    state[rng.choice(N, size=initial_infected, replace=False)] = 2
    states = np.zeros((T + 1, 4, N))
    states[0, state, np.arange(N)] = 1.0
    for t in range(T):
        infected = (state == 2).astype(np.float64)
        p_exposed = 1.0 - (1.0 - beta) ** (adj[t] @ infected)
        new_state = state.copy()
        new_state[(state == 0) & (rng.random(N) < p_exposed)] = 1
        new_state[(state == 1) & (rng.random(N) < sigma)] = 2
        new_state[(state == 2) & (rng.random(N) < gamma)] = 3
        state = new_state
        states[t + 1, state, np.arange(N)] = 1.0

    return SEIRData(adjacency=adj, states=states)


def seir_features_targets(data: SEIRData, out_idx: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Reference get_features semantics.

    Returns:
        X: (T, N, 2 + 3) — [in-deg, out-deg] ⊕ current-step compartments
           excluding out_idx.
        y: (T, N) — next-step out_idx compartment per node.
    """
    adj = data.adjacency
    T = adj.shape[0]
    deg = np.stack([adj.sum(axis=1), adj.sum(axis=2)], axis=-1)  # (T, N, 2)
    y = data.states[1:, out_idx, :]  # (T, N)
    rest = np.delete(data.states, out_idx, axis=1)[:T]  # (T, 3, N)
    X = np.concatenate([deg, rest.transpose(0, 2, 1)], axis=-1)
    return X, y


def seir_temporal_adjacency(data: SEIRData, dtype=np.float32) -> TemporalCOO:
    """The contact graph as a TemporalCOO (float32 values by default)."""
    return TemporalCOO.from_dense(data.adjacency, dtype=dtype)

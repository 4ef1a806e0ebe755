"""Typed experiment configuration.

One config schema covering every reference experiment (the union of the
per-script ``# Settings`` blocks catalogued in SURVEY.md §5): the 32
``experiment_*`` scripts, the SBM link-prediction scripts, and the SEIR
regression scripts all become instances of :class:`ExperimentConfig`
(see ``tmgcn_torch.configs.presets``).

Port of tmgcn_tpu.configs.schema: the same fields, defaults and strings.
In the port, ``spmm_impl="pallas"`` selects the hand-written CUDA
windowed segment kernel (kernels/spmm_cuda.py), the counterpart of the
Pallas kernel the string names in the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    dataset: str  # registry key, "sbm", or "seir"
    method: str  # "tmgcn" | "gcn" | "evolvegcn" | "wdgcn"
    task: str  # "edge_cls" | "link_pred" | "regression"

    # Model
    n_layers: int = 1
    hidden_feat: tuple[int, ...] = (6, 2)
    condensed_W: bool = True
    use_Minv: bool = False
    apply_M_twice: bool = False
    apply_M_three_times: bool = False
    nonlin2: str = "selu"

    # Training
    alpha_vec: tuple[float, ...] = (0.9,)
    n_epochs: int = 1000
    n_trials: int = 1
    lr: float = 0.01
    momentum: float = 0.9
    optimizer: str = "sgd"  # "sgd" (reference) | "adam"
    grad_clip: float | None = None
    eval_every: int = 100

    # Link prediction (negative sampling)
    beta1: int = 19
    beta2: int = 19
    cutoff: int = 95
    loss_type: str = "softmax"  # "softmax" | "sigmoid"
    eval_type: str = "MAP-MRR"  # "MAP-MRR" | "F1"

    # Windowing — TM-GCN uses width-S_train shifted windows; baselines on
    # classification (and LP in the reference) use disjoint windows.
    same_block_size: bool = True

    # Data
    n_classes: int = 2
    seed: int = 0
    dtype: str = "float32"
    spmm_impl: str = "jnp"

    # Synthetic-data parameters (sbm / seir)
    sbm_n_nodes: int = 1000
    sbm_n_slices: int = 50
    sbm_node_change: int = 10
    # The reference feeds the RAW SBM adjacency to the model (SBM_our.py
    # :130-138, no normalization) — which diverges at lr=0.01.
    # sbm_normalize=True applies the standard D^{-1/2}(A+I)D^{-1/2}
    # instead (the framework's recommended configuration).
    sbm_normalize: bool = False
    # "degree" = the reference's [in-deg, out-deg] features (which carry
    # no community signal on SBM — trained MAP stays at the 0.05
    # negative-sampling base rate); "degree_spectral" appends top-2
    # eigenvectors of the aggregated normalized adjacency so link
    # prediction has something to learn (ops/degree.spectral_features_np).
    sbm_features: str = "degree"
    # Edge-readout head (1-layer TM-GCN): "concat" = the reference's
    # additive [Y_src, Y_trg] @ U; "bilinear" = (Y_src ⊙ Y_trg) @ U —
    # a framework extension that expresses endpoint affinity, which an
    # additive head cannot (needed for SBM community link prediction).
    readout: str = "concat"
    seir_n_nodes: int = 200
    seir_n_slices: int = 100
    seir_out_idx: int = 2
    # Like sbm_normalize: the reference feeds the raw SEIR contact graph
    # to the models (test_graph_SEIR.py:104-112); normalization makes the
    # regression well-conditioned.
    seir_normalize: bool = False
    # Standardize node features to zero mean / unit variance using the
    # training window's statistics (the reference trains on raw degree
    # scales, which is ill-conditioned on synthetic data).
    standardize_features: bool = False

    # Regression head feature count is inferred from the data.

    def __post_init__(self):
        if self.method not in ("tmgcn", "gcn", "evolvegcn", "wdgcn"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.task not in ("edge_cls", "link_pred", "regression"):
            raise ValueError(f"unknown task {self.task!r}")
        if len(self.hidden_feat) != self.n_layers + 1:
            raise ValueError("hidden_feat must have n_layers + 1 entries")
        if self.apply_M_three_times and not self.apply_M_twice:
            raise ValueError("apply_M_three_times requires apply_M_twice")


ALPHA_SWEEP_CLS = tuple(round(0.75 + 0.01 * i, 2) for i in range(21))

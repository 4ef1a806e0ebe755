"""Preset configs reproducing every reference experiment.

The reference's 37 experiment scripts (SURVEY.md §1: {bitcoin_otc,
bitcoin_alpha, chess, reddit, uci, amlsim} x {tmgcn, gcn, evolvegcn,
wdgcn} x {edge classification, link prediction} minus nonexistent cells,
plus SBM link prediction and SEIR regression) collapse into this
generated registry. ``get_preset(name)`` returns the exact reference
hyperparameters; runners may override epochs/alphas for smoke runs.
Port of tmgcn_tpu.configs.presets: the same registry, name for name.
"""

from __future__ import annotations

from tmgcn_torch.configs.schema import ALPHA_SWEEP_CLS, ExperimentConfig

METHODS = ("tmgcn", "gcn", "evolvegcn", "wdgcn")
CLS_DATASETS = ("bitcoin_otc", "bitcoin_alpha", "chess", "reddit", "amlsim")
LP_DATASETS = ("bitcoin_otc", "bitcoin_alpha", "chess", "reddit", "uci")


def _build_registry() -> dict[str, ExperimentConfig]:
    registry: dict[str, ExperimentConfig] = {}

    for ds in CLS_DATASETS:
        n_classes = 3 if ds == "chess" else 2
        for method in METHODS:
            name = f"{ds}_{method}_cls"
            # Chess uses fixed [1/3, 1/3, 1/3] class weights (its script
            # has no alpha sweep, experiment_chess_our.py:23); a sweep
            # would rerun identical configs under different tags.
            alphas = (0.33,) if n_classes == 3 else ALPHA_SWEEP_CLS
            registry[name] = ExperimentConfig(
                name=name,
                dataset=ds,
                method=method,
                task="edge_cls",
                hidden_feat=(6, n_classes),
                n_classes=n_classes,
                alpha_vec=alphas,
                n_epochs=10_000,
                cutoff=95,
                same_block_size=(method == "tmgcn"),
            )

    # 2-layer chess classification: the per-epoch-SpMM benchmark config
    # ([6,6,3], selu — the reference's 2-layer settings, e.g.
    # experiment_bitcoin_our_link_prediction.py's no_layers=2 branch,
    # applied to the in-repo chess dataset).
    registry["chess_tmgcn2_cls"] = ExperimentConfig(
        name="chess_tmgcn2_cls",
        dataset="chess",
        method="tmgcn",
        task="edge_cls",
        n_layers=2,
        hidden_feat=(6, 6, 3),
        nonlin2="selu",
        n_classes=3,
        alpha_vec=(0.33,),
        n_epochs=10_000,
        cutoff=95,
        same_block_size=True,
    )

    # 2-layer chess EvolveGCN (framework extra): benchmarks the staged
    # 2-layer evolution (two GRU-only scans + one batched layer-2 SpMM)
    # on the in-repo dataset; the reference's 2-layer EvolveGCN configs
    # target the external bitcoin datasets.
    registry["chess_evolvegcn2_cls"] = ExperimentConfig(
        name="chess_evolvegcn2_cls",
        dataset="chess",
        method="evolvegcn",
        task="edge_cls",
        n_layers=2,
        hidden_feat=(6, 6, 3),
        n_classes=3,
        alpha_vec=(0.33,),
        n_epochs=10_000,
        cutoff=95,
        same_block_size=False,  # baselines use disjoint windows
    )

    for ds in LP_DATASETS:
        for method in METHODS:
            name = f"{ds}_{method}_lp"
            extra = {}
            if ds == "uci" and method == "tmgcn":
                # The one 2-layer + M^2/M^3 configuration
                # (experiment_uci_our_link_prediction.py:69).
                extra = dict(
                    n_layers=2,
                    hidden_feat=(6, 6, 2),
                    apply_M_twice=True,
                    apply_M_three_times=True,
                )
            registry[name] = ExperimentConfig(
                name=name,
                dataset=ds,
                method=method,
                task="link_pred",
                alpha_vec=(0.9,),
                n_epochs=1_000,
                beta1=19,
                beta2=19,
                cutoff=95,
                same_block_size=(method == "tmgcn"),
                **extra,
            )

    for method in ("tmgcn", "evolvegcn"):
        name = f"sbm_{method}_lp"
        registry[name] = ExperimentConfig(
            name=name,
            dataset="sbm",
            method=method,
            task="link_pred",
            alpha_vec=(0.9,),
            n_epochs=100,
            beta1=19,
            beta2=19,
            cutoff=35,
        )
        # Recommended variant: normalized adjacency + lr that converges
        # (the reference's raw-adjacency lr=0.01 setup diverges to NaN
        # and only ever evaluates at epoch 0).
        registry[f"{name}_tuned"] = ExperimentConfig(
            name=f"{name}_tuned",
            dataset="sbm",
            method=method,
            task="link_pred",
            alpha_vec=(0.9,),
            n_epochs=300,
            eval_every=50,
            beta1=19,
            beta2=19,
            cutoff=35,
            lr=1e-3,
            optimizer="adam",
            grad_clip=1.0,
            sbm_normalize=True,
            standardize_features=True,
            spmm_impl="pallas",
        )

    # Discriminative variant: spectral community features make SBM link
    # prediction learnable (MAP above the 0.05 base rate), turning it
    # into a real accuracy regression guard. The degree-feature presets
    # above keep the reference's protocol for parity.
    registry["sbm_tmgcn_lp_spectral"] = ExperimentConfig(
        name="sbm_tmgcn_lp_spectral",
        dataset="sbm",
        method="tmgcn",
        task="link_pred",
        alpha_vec=(0.9,),
        n_epochs=300,
        eval_every=50,
        beta1=19,
        beta2=19,
        cutoff=35,
        lr=1e-3,
        optimizer="adam",
        grad_clip=1.0,
        sbm_normalize=True,
        sbm_features="degree_spectral",
        standardize_features=True,
        readout="bilinear",
    )

    for method in ("tmgcn", "evolvegcn", "wdgcn"):
        name = f"seir_{method}_reg"
        registry[name] = ExperimentConfig(
            name=name,
            dataset="seir",
            method=method,
            task="regression",
            hidden_feat=(6, 2),
            n_epochs=100,
        )
        # Recommended variant: normalized contact graph + converging lr
        # (the reference's raw-graph lr=0.01 diverges on comparable data).
        registry[f"{name}_tuned"] = ExperimentConfig(
            name=f"{name}_tuned",
            dataset="seir",
            method=method,
            task="regression",
            hidden_feat=(6, 2),
            n_epochs=300,
            lr=1e-3,
            optimizer="adam",
            grad_clip=1.0,
            seir_normalize=True,
            standardize_features=True,
            spmm_impl="pallas",
        )

    return registry


PRESETS: dict[str, ExperimentConfig] = _build_registry()


def get_preset(name: str) -> ExperimentConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {', '.join(sorted(PRESETS))}"
        ) from None

"""Experiment assembly: config -> data -> adapter -> training run (port of
tmgcn_tpu.configs.build, registry datasets and edge classification).

Turns an :class:`ExperimentConfig` into a run, reproducing the reference
experiment-script semantics: tmgcn consumes the M-transformed windows Ct with shifted
(same-block) windowing; baselines consume the untransformed C with
disjoint windows.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from tmgcn_torch.configs.schema import ExperimentConfig
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.tmgcn import TMGCN
from tmgcn_torch.ops.degree import degree_features_np
from tmgcn_torch.preprocess import datasets as dsets
from tmgcn_torch.preprocess.matio import load_artifact, save_artifact
from tmgcn_torch.preprocess.pipeline import preprocess
from tmgcn_torch.tasks.adapters import make_edge_adapter
from tmgcn_torch.tasks.windows import WindowSpec, split_edges_classification, window_features
from tmgcn_torch.train.loop import TrainConfig, run_edge_classification

WINDOWS = ("train", "val", "test")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``cuda`` unless told otherwise; never drops to the CPU quietly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return device


def _standardize(feats: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Zero-mean/unit-variance per feature, fit on the training window."""
    mu = feats["train"].mean(axis=(0, 1), keepdims=True)
    sd = feats["train"].std(axis=(0, 1), keepdims=True) + 1e-8
    return {w: (x - mu) / sd for w, x in feats.items()}


@dataclasses.dataclass
class ExperimentData:
    """Everything a run needs, prepared host-side."""

    spec: WindowSpec
    adj: dict[str, TemporalCOO]  # per-window adjacency the model consumes
    feats: dict[str, np.ndarray]
    M: np.ndarray | None
    edge_index: np.ndarray | None  # (3, E) labeled edges
    edge_values: np.ndarray | None


def _disjoint_windows(C: TemporalCOO, spec: WindowSpec) -> dict[str, TemporalCOO]:
    s, v = spec.s_train, spec.s_val
    return {
        "train": C.slice_window(0, s),
        "val": C.slice_window(s, s + v),
        "test": C.slice_window(s + v, spec.total),
    }


def build_data(
    cfg: ExperimentConfig,
    data_dir: str | Path | None = None,
    artifact: str | Path | None = None,
) -> ExperimentData:
    """Prepare windows/features/edges for a registry dataset (host-side).

    Loads a .mat artifact if given or cached in ``data_dir``, else
    preprocesses the raw file and caches the artifact there, in the same
    schema as the JAX package (either package reads the other's cache).
    """
    if cfg.dataset in ("sbm", "seir"):
        raise NotImplementedError(
            f"synthetic dataset {cfg.dataset!r} is not ported yet (ROADMAP queue 1, item 11)"
        )
    if cfg.task == "link_pred":
        raise NotImplementedError("link prediction is not ported yet (ROADMAP queue 1, item 6)")
    spec_entry = dsets.REGISTRY[cfg.dataset]
    p = spec_entry.preprocess
    spec = WindowSpec(p.s_train, p.s_val, p.s_test, same_block_size=cfg.same_block_size)

    if artifact is None and data_dir is not None:
        cached = Path(data_dir) / f"saved_content_{cfg.dataset}.mat"
        if cached.exists():
            artifact = cached

    if artifact is not None and Path(artifact).exists():
        loaded = load_artifact(artifact, s_train=p.s_train, min_slices=spec.total)
        A_bin = loaded["A_binary"]
        A_labels = loaded["A_labels"]
        M = loaded["M"]
        Ct = loaded["Ct"]
        C_full = loaded.get("C")
    else:
        if data_dir is None:
            raise FileNotFoundError(
                f"dataset {cfg.dataset!r} needs --data-dir with {spec_entry.filename} "
                "or --artifact pointing at a preprocessed .mat"
            )
        raw = dsets.load_raw(spec_entry, data_dir)
        pre = preprocess(raw, p)
        cached = Path(data_dir) / f"saved_content_{cfg.dataset}.mat"
        try:
            save_artifact(cached, pre)
        except OSError:
            pass  # a read-only data dir only loses the cache
        # Mirror the reference scripts: A for features is ones on A_labels support.
        labels_edges = pre.A_labels.edge_list()
        A_bin = TemporalCOO.from_global_coo(
            labels_edges[0],
            labels_edges[1],
            labels_edges[2],
            np.ones(labels_edges.shape[1]),
            pre.A_labels.n_slices,
            pre.A_labels.n_nodes,
        )
        A_labels = pre.A_labels
        M = pre.M
        Ct = pre.Ct_windows
        C_full = pre.C

    X = degree_features_np(A_bin)
    if X.shape[0] < spec.total:
        # Raw data spanning fewer slices than the window total: pad with
        # empty slices, mirroring the pipeline's C padding.
        pad = np.zeros((spec.total - X.shape[0],) + X.shape[1:])
        X = np.concatenate([X, pad], axis=0)
    feats = window_features(X, spec)
    if cfg.standardize_features:
        feats = _standardize(feats)

    if cfg.method == "tmgcn":
        adj = Ct
    else:
        if C_full is None:
            raise ValueError("artifact lacks C (untransformed) needed by baselines")
        adj = _disjoint_windows(C_full, spec)

    edge_index, edge_values = A_labels.edge_list(with_values=True)
    return ExperimentData(
        spec=spec, adj=adj, feats=feats, M=M, edge_index=edge_index, edge_values=edge_values
    )


def _check_ported(cfg: ExperimentConfig) -> None:
    if cfg.task != "edge_cls" or cfg.method != "tmgcn" or cfg.n_layers != 1:
        raise NotImplementedError(
            f"only 1-layer TM-GCN edge classification is ported yet, not "
            f"{cfg.method} ({cfg.n_layers} layers) {cfg.task} (ROADMAP queue 1)"
        )


def build_model(cfg: ExperimentConfig, n_slices: int, in_feat: int) -> TMGCN:
    _check_ported(cfg)
    return TMGCN(
        n_slices=n_slices,
        in_feat=in_feat,
        hidden_feat=tuple(cfg.hidden_feat),
        condensed_W=cfg.condensed_W,
        use_Minv=cfg.use_Minv,
        dtype=getattr(torch, cfg.dtype),
        spmm_impl=cfg.spmm_impl,
        readout=cfg.readout,
    )


def params_from_jax(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX package's parameters (as numpy arrays) as the port's.

    TMGCN keeps the same names and layouts on both sides — W (F0, F1) and
    U (2·F1, C) — so each array is copied as it is, dtype kept, onto the
    CPU; the training loop moves them to its device.
    """
    return {name: torch.tensor(np.asarray(value)) for name, value in params.items()}


def run_tag(trial: int, alpha: float | None) -> str:
    """Results tag for one (trial, alpha) run."""
    return f"tr{trial}" + (f"_w{round((alpha or 0) * 100)}" if alpha else "")


def run_experiment(
    cfg: ExperimentConfig,
    data_dir: str | Path | None = None,
    artifact: str | Path | None = None,
    n_epochs: int | None = None,
    alpha_vec: tuple[float, ...] | None = None,
    verbose: bool = True,
    checkpoint_dir: str | Path | None = None,
    mesh_shape: tuple[int, int] | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Run the full (trials x alpha) sweep of one experiment config.

    Returns {"results": {(trial, alpha): (epochs, 12) array}, "spec": ...,
    "seconds": {"data", "adapter", "train"}} — host-clock seconds of the
    data build, the adapter build (packing, device upload, cached
    propagation) and the training runs.
    """
    device = resolve_device(device)
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP queue 1, item 13)")
    if mesh_shape is not None:
        raise NotImplementedError("multi-device runs are not ported yet (ROADMAP queue 1, item 14)")
    _check_ported(cfg)  # before the data build
    t0 = time.perf_counter()
    data = build_data(cfg, data_dir=data_dir, artifact=artifact)
    t_data = time.perf_counter() - t0
    n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
    alphas = alpha_vec if alpha_vec is not None else cfg.alpha_vec
    tcfg = TrainConfig(
        n_epochs=n_epochs,
        lr=cfg.lr,
        momentum=cfg.momentum,
        eval_every=cfg.eval_every,
        verbose=verbose,
        optimizer=cfg.optimizer,
        grad_clip=cfg.grad_clip,
    )

    t0 = time.perf_counter()
    splits = split_edges_classification(
        data.edge_index, data.edge_values, data.spec, n_classes=cfg.n_classes
    )
    in_feat = data.feats["train"].shape[-1]
    model = build_model(cfg, data.spec.s_train, in_feat)
    adapter = make_edge_adapter(
        model, data.adj, data.feats, {w: splits[w].edges for w in WINDOWS},
        M=data.M, device=device,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_adapter = time.perf_counter() - t0

    t0 = time.perf_counter()
    generator = torch.Generator().manual_seed(cfg.seed)
    results: dict = {}
    for tr in range(cfg.n_trials):
        for alpha in alphas:
            if cfg.n_classes == 3:
                cw = np.array([1 / 3, 1 / 3, 1 / 3])
            else:
                cw = np.array([alpha, 1.0 - alpha])
            res, _ = run_edge_classification(adapter, splits, cw, tcfg, generator=generator)
            results[(tr, alpha)] = res
    t_train = time.perf_counter() - t0
    return {
        "results": results,
        "spec": data.spec,
        "seconds": {"data": t_data, "adapter": t_adapter, "train": t_train},
    }

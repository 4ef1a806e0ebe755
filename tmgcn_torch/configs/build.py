"""Experiment assembly: config -> data -> adapter -> training run (port of
tmgcn_tpu.configs.build: registry datasets and the synthetic SBM and SEIR
data; edge classification and link prediction with TM-GCN (1 or 2
layers), KW-GCN, EvolveGCN-H or WD-GCN; node regression with TM-GCN,
EvolveGCN-H or WD-GCN).

Turns an :class:`ExperimentConfig` into a run, reproducing the reference
experiment-script semantics:

  * tmgcn consumes the M-transformed windows Ct with shifted (same-block)
    windowing; link prediction drops the last slice.
  * gcn/evolvegcn/wdgcn on registry datasets consume the untransformed C
    with disjoint windows.
  * SBM and SEIR runs feed every method the transformed Ct windows
    (SBM_EvovleGCN.py:181, graph_SEIR_wd_gcn.py:155).

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
from tmgcn_torch.core.mmatrix import make_m_matrix
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.evolvegcn import EvolveGCN, EvolveGCNReg
from tmgcn_torch.models.gcn import KWGCN
from tmgcn_torch.models.tmgcn import TMGCN, TMGCN2, TMGCNReg
from tmgcn_torch.models.wdgcn import WDGCN, WDGCNReg
from tmgcn_torch.ops.degree import degree_features_np, spectral_features_np
from tmgcn_torch.ops.mtransform import m_transform_coo
from tmgcn_torch.preprocess import datasets as dsets
from tmgcn_torch.preprocess.matio import load_artifact, save_artifact
from tmgcn_torch.preprocess.pipeline import normalize_laplacian, preprocess
from tmgcn_torch.preprocess.sbm import sbm_temporal_adjacency
from tmgcn_torch.preprocess.seir import (
    seir_features_targets,
    seir_temporal_adjacency,
    simulate_seir,
)
from tmgcn_torch.tasks.adapters import ModelAdapter, make_edge_adapter, make_regression_adapter
from tmgcn_torch.tasks.sampling import augment_edges
from tmgcn_torch.tasks.windows import (
    WindowSpec,
    split_data_link_prediction,
    split_edges_classification,
    window_features,
)
from tmgcn_torch.train.checkpoint import RunCheckpointer
from tmgcn_torch.train.loop import (
    TrainConfig,
    run_edge_classification,
    run_link_prediction,
    run_regression,
    train_chunks,
)
from tmgcn_torch.utils.profiling import span

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
    edge_index: np.ndarray | None  # (3, E) labeled edges (cls) or None
    edge_values: np.ndarray | None
    lp_edges: np.ndarray | None = None  # augmented edges (LP) or None
    lp_labels: np.ndarray | None = None
    reg_targets: dict[str, np.ndarray] | None = None  # per-window (T, N) (regression)


def _disjoint_windows(C: TemporalCOO, spec: WindowSpec) -> dict[str, TemporalCOO]:
    s, v = spec.s_train, spec.s_val
    return {
        "train": C.slice_window(0, s),
        "val": C.slice_window(s, s + v),
        "test": C.slice_window(s + v, spec.total),
    }


def _sbm_window_spec(cfg: ExperimentConfig) -> WindowSpec:
    """35/5/10 at the canonical T=50 (SBM_our.py:38-43), scaled for other T."""
    T = cfg.sbm_n_slices
    s_train = round(0.7 * T)
    s_val = round(0.1 * T)
    return WindowSpec(s_train, s_val, T - s_train - s_val, same_block_size=True)


def _seir_window_spec(cfg: ExperimentConfig) -> WindowSpec:
    """80/10/10 at the canonical T=100 (test_graph_SEIR.py:33), scaled."""
    T = cfg.seir_n_slices
    s_train = round(0.8 * T)
    s_val = round(0.1 * T)
    return WindowSpec(s_train, s_val, T - s_train - s_val, same_block_size=True)


def _synthetic_data(cfg: ExperimentConfig) -> ExperimentData:
    """The SBM (link prediction) or SEIR (regression) data of a config,
    generated from ``cfg.seed`` as the JAX package generates it: every
    method gets the M-transformed windows Ct, M = make_m_matrix(s_train, 20)."""
    if cfg.dataset == "sbm":
        spec = _sbm_window_spec(cfg)
        A = sbm_temporal_adjacency(
            cfg.sbm_n_nodes, cfg.sbm_n_slices, node_change_num=cfg.sbm_node_change,
            seed=cfg.seed,
        )
        X = degree_features_np(A)
        if cfg.sbm_features == "degree_spectral":
            X = np.concatenate([X, spectral_features_np(A, k=2)], axis=-1)
        lp_edges, lp_labels = augment_edges(
            A.edge_list(), A.n_nodes, cfg.beta1, cfg.beta2, cfg.cutoff, seed=cfg.seed
        )
        targets = None
        if cfg.sbm_normalize:
            A = normalize_laplacian(A)
    else:
        spec = _seir_window_spec(cfg)
        sim = simulate_seir(n_nodes=cfg.seir_n_nodes, n_slices=cfg.seir_n_slices, seed=cfg.seed)
        X, y = seir_features_targets(sim, out_idx=cfg.seir_out_idx)
        A = seir_temporal_adjacency(sim)
        if cfg.seir_normalize:
            A = normalize_laplacian(A)
        lp_edges = lp_labels = None
        targets = window_features(y, spec)
    M = make_m_matrix(spec.s_train, 20)
    feats = window_features(X, spec)
    if cfg.standardize_features:
        feats = _standardize(feats)
    Ct = {w: m_transform_coo(A.slice_window(*spec.bounds(w)), M) for w in WINDOWS}
    return ExperimentData(
        spec=spec, adj=Ct, feats=feats, M=M, edge_index=None, edge_values=None,
        lp_edges=lp_edges, lp_labels=lp_labels, reg_targets=targets,
    )


def build_data(
    cfg: ExperimentConfig,
    data_dir: str | Path | None = None,
    artifact: str | Path | None = None,
) -> ExperimentData:
    """Prepare windows/features/edges for a config (host-side).

    SBM and SEIR data are generated from the config (no file is read).
    A registry dataset loads a .mat artifact if given or cached in
    ``data_dir``, else preprocesses the raw file and caches the artifact
    there, in the same schema as the JAX package (either package reads the
    other's cache).
    """
    if cfg.dataset in ("sbm", "seir"):
        return _synthetic_data(cfg)
    spec_entry = dsets.REGISTRY[cfg.dataset]
    p = spec_entry.preprocess
    spec = WindowSpec(p.s_train, p.s_val, p.s_test, same_block_size=cfg.same_block_size)

    if artifact is None and data_dir is not None:
        cached = Path(data_dir) / f"saved_content_{cfg.dataset}.mat"
        if cached.exists():
            artifact = cached

    from_artifact = artifact is not None and Path(artifact).exists()
    with span("data.load", cached=from_artifact):
        if from_artifact:
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
    lp_edges = lp_labels = None
    if cfg.task == "link_pred":
        lp_edges, lp_labels = augment_edges(
            edge_index, A_labels.n_nodes, cfg.beta1, cfg.beta2, cfg.cutoff, seed=cfg.seed
        )
    return ExperimentData(
        spec=spec, adj=adj, feats=feats, M=M, edge_index=edge_index, edge_values=edge_values,
        lp_edges=lp_edges, lp_labels=lp_labels,
    )


def build_model(cfg: ExperimentConfig, n_slices: int, in_feat: int):
    """The model a config names: TMGCN, TMGCN2, KWGCN, EvolveGCN or WDGCN,
    or for regression TMGCNReg, EvolveGCNReg or WDGCNReg."""
    hf = tuple(cfg.hidden_feat)
    dtype = getattr(torch, cfg.dtype)
    if cfg.task == "regression":
        if cfg.method == "tmgcn":
            return TMGCNReg(
                n_slices=n_slices, in_feat=in_feat, hidden_feat=hf,
                condensed_W=cfg.condensed_W, use_Minv=cfg.use_Minv, dtype=dtype,
                spmm_impl=cfg.spmm_impl,
            )
        if cfg.method == "evolvegcn":
            return EvolveGCNReg(n_slices=n_slices, in_feat=in_feat, hidden_feat=hf, dtype=dtype)
        if cfg.method == "wdgcn":
            return WDGCNReg(
                n_slices=n_slices, in_feat=in_feat, hidden_feat=hf, dtype=dtype,
                spmm_impl=cfg.spmm_impl,
            )
        raise ValueError(f"no regression variant for method {cfg.method!r}")
    if cfg.method == "wdgcn":
        return WDGCN(
            n_slices=n_slices, in_feat=in_feat, hidden_feat=hf, dtype=dtype,
            spmm_impl=cfg.spmm_impl,
        )
    if cfg.method == "gcn":
        return KWGCN(
            n_slices=n_slices, in_feat=in_feat, hidden_feat=hf, nonlin2=cfg.nonlin2,
            dtype=dtype, spmm_impl=cfg.spmm_impl,
        )
    if cfg.method == "evolvegcn":
        # No spmm_impl, as in the JAX package: EvolveGCN propagates with
        # the plain spmm.
        return EvolveGCN(n_slices=n_slices, in_feat=in_feat, hidden_feat=hf, dtype=dtype)
    if cfg.n_layers == 2:
        return TMGCN2(
            n_slices=n_slices,
            in_feat=in_feat,
            hidden_feat=hf,
            condensed_W=cfg.condensed_W,
            use_Minv=cfg.use_Minv,
            apply_M_twice=cfg.apply_M_twice,
            apply_M_three_times=cfg.apply_M_three_times,
            nonlin2=cfg.nonlin2,
            dtype=dtype,
            spmm_impl=cfg.spmm_impl,
        )
    return TMGCN(
        n_slices=n_slices,
        in_feat=in_feat,
        hidden_feat=hf,
        condensed_W=cfg.condensed_W,
        use_Minv=cfg.use_Minv,
        dtype=dtype,
        spmm_impl=cfg.spmm_impl,
        readout=cfg.readout,
    )


def params_from_jax(tree: dict) -> dict:
    """The JAX package's variables (arrays, in nested dicts) as the port's.

    Takes a flat parameter dict, or a whole variable tree such as WD-GCN's
    ``{"params": {"W", "lstm": {...}}, "buffers": {...}}``, and returns the
    same tree of tensors. The ported models keep the JAX package's names
    and layouts (TMGCN's W (F0, F1) and U (2·F1, C); TMGCN2's and KWGCN's
    W1, W2 and U; EvolveGCN's ``cell1``/``cell2`` GRU cells and U, and its
    frozen W_init1/W_init2; WDGCN's W, per-gate LSTM weights and frozen U,
    h_init, c_init; the regression models' head ``lin_w`` (F1, 1) and
    ``lin_b`` (1,) beside TMGCNReg's W, EvolveGCNReg's ``cell1`` and
    W_init1, WDGCNReg's W and LSTM), so each array is copied as
    it is, dtype kept, onto the CPU; the training loop moves them to its
    device.
    """
    return {
        name: params_from_jax(value) if isinstance(value, dict) else torch.tensor(np.asarray(value))
        for name, value in tree.items()
    }


def run_tag(trial: int, alpha: float | None) -> str:
    """Results tag for one (trial, alpha) run."""
    return f"tr{trial}" + (f"_w{round((alpha or 0) * 100)}" if alpha else "")


@dataclasses.dataclass(frozen=True)
class Experiment:
    """One config built on its device: the data, the windows' splits (for
    regression the windows' (T, N) targets) and the adapter (bundles packed
    and moved, cached propagation done), with the host seconds of the data
    and the adapter builds (the ``setup.data`` and ``setup.adapter`` spans;
    the adapter's ends in a synchronise)."""

    cfg: ExperimentConfig
    data: ExperimentData
    splits: dict
    adapter: ModelAdapter
    seconds: dict

    @property
    def link_pred(self) -> bool:
        return self.cfg.task == "link_pred"


def _make_edge_adapter(cfg, model, data, model_edges, link_pred: bool, device,
                       mesh) -> ModelAdapter:
    """Single-device or sharded adapter, depending on mesh (the JAX
    package's ``_make_adapter``)."""
    if mesh is None:
        return make_edge_adapter(
            model, data.adj, data.feats, model_edges,
            M=data.M if cfg.method == "tmgcn" else None, drop_last_slice=link_pred,
            device=device,
        )
    from tmgcn_torch.parallel.adapter import make_sharded_edge_adapter

    return make_sharded_edge_adapter(
        model, data.adj, data.feats, model_edges, data.M, mesh, drop_last_slice=link_pred,
    )


def _check_mesh_run(cfg: ExperimentConfig) -> None:
    """The JAX package's one refusal of a sharded run (its ``_make_adapter``):
    an edge task of a method with no sharded adapter."""
    if cfg.task != "regression" and cfg.method not in ("tmgcn", "gcn", "evolvegcn", "wdgcn"):
        raise NotImplementedError(
            f"--mesh supports tmgcn/gcn/evolvegcn/wdgcn models, not {cfg.method!r}"
        )


def build_experiment(
    cfg: ExperimentConfig,
    data_dir: str | Path | None = None,
    artifact: str | Path | None = None,
    device: str | torch.device | None = None,
    mesh=None,
) -> Experiment:
    """The data, splits and adapter of one config, on ``device`` (cuda
    unless told otherwise). With a ``parallel.mesh.Mesh``, the sharded
    adapter on the mesh's device (this rank's)."""
    device = resolve_device(device) if mesh is None else mesh.device
    if mesh is not None:
        _check_mesh_run(cfg)
    with span("setup.data") as data_span:
        data = build_data(cfg, data_dir=data_dir, artifact=artifact)
    with span("setup.adapter") as adapter_span:
        in_feat = data.feats["train"].shape[-1]
        link_pred = cfg.task == "link_pred"
        if cfg.task == "regression":
            # The adapter reads M only for TM-GCN, as the JAX package's does.
            splits = data.reg_targets
            model = build_model(cfg, data.spec.s_train, in_feat)
            if mesh is None:
                adapter = make_regression_adapter(model, data.adj, data.feats, M=data.M,
                                                  device=device)
            else:
                from tmgcn_torch.parallel.adapter import make_sharded_regression_adapter

                adapter = make_sharded_regression_adapter(
                    model, data.adj, data.feats, data.M if cfg.method == "tmgcn" else None,
                    mesh)
        else:
            if link_pred:
                # The model consumes slices [0, S-1) and predicts the edges of [1, S).
                splits = split_data_link_prediction(data.lp_edges, data.lp_labels, data.spec)
                model_edges = {w: splits[w].model_edges for w in WINDOWS}
                model = build_model(cfg, data.spec.s_train - 1, in_feat)
            else:
                splits = split_edges_classification(
                    data.edge_index, data.edge_values, data.spec, n_classes=cfg.n_classes
                )
                model_edges = {w: splits[w].edges for w in WINDOWS}
                model = build_model(cfg, data.spec.s_train, in_feat)
            adapter = _make_edge_adapter(cfg, model, data, model_edges, link_pred, device, mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return Experiment(cfg, data, splits, adapter,
                      {"data": data_span.seconds, "adapter": adapter_span.seconds})


def class_weights(cfg: ExperimentConfig, alpha: float) -> np.ndarray:
    """The loss's class weights of one alpha: [alpha, 1 - alpha], or equal
    weights for 3-class edge classification."""
    if cfg.task != "link_pred" and cfg.n_classes == 3:
        return np.array([1 / 3, 1 / 3, 1 / 3])
    return np.array([alpha, 1.0 - alpha])


def train_config(cfg: ExperimentConfig, n_epochs: int | None = None,
                 verbose: bool = False, debug_nans: bool = False) -> TrainConfig:
    """The loop's settings of a config (its own n_epochs unless given)."""
    return TrainConfig(
        n_epochs=n_epochs if n_epochs is not None else cfg.n_epochs,
        lr=cfg.lr,
        momentum=cfg.momentum,
        eval_every=cfg.eval_every,
        verbose=verbose,
        optimizer=cfg.optimizer,
        grad_clip=cfg.grad_clip,
        debug_nans=debug_nans,
    )


def run_trial(exp: Experiment, tcfg: TrainConfig, alpha: float | None,
              generator: torch.Generator, checkpointer=None) -> np.ndarray | dict:
    """One training run of the experiment's task at one alpha: its rows, or
    for regression (alpha None) ``run_regression``'s result dict.
    ``checkpointer``: the run's ``RunCheckpointer`` (saves, and resumes from
    its newest checkpoint), or None."""
    if exp.cfg.task == "regression":
        res, _ = run_regression(exp.adapter, exp.splits, tcfg, generator=generator,
                                checkpointer=checkpointer)
        return res
    cw = class_weights(exp.cfg, alpha)
    if exp.link_pred:
        res, _ = run_link_prediction(
            exp.adapter, exp.splits, cw, tcfg, generator=generator, checkpointer=checkpointer,
            loss_type=exp.cfg.loss_type, eval_type=exp.cfg.eval_type,
        )
    else:
        res, _ = run_edge_classification(exp.adapter, exp.splits, cw, tcfg, generator=generator,
                                         checkpointer=checkpointer)
    return res


def trial_chunks(exp: Experiment, tcfg: TrainConfig, alpha: float | None,
                 generator: torch.Generator, capacity: int | None = None,
                 phase_events: bool = False):
    """The chunk runner of the step that ``run_trial`` trains, from the
    same parameters (``train.loop.train_chunks``'s ``chunks``, with its
    ``phase_events``), for timing plain epochs alone."""
    lp = {"loss_type": exp.cfg.loss_type} if exp.link_pred else {}
    cw = None if exp.cfg.task == "regression" else class_weights(exp.cfg, alpha)
    chunks, _, _ = train_chunks(exp.adapter, exp.splits["train"], cw, tcfg, task=exp.cfg.task,
                                generator=generator, capacity=capacity,
                                phase_events=phase_events, **lp)
    return chunks


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
    debug_nans: bool = False,
) -> dict:
    """Run the full (trials x alpha) sweep of one experiment config.

    Returns {"results": {(trial, alpha): array}, "spec": ...,
    "seconds": {"data", "adapter", "train"}} — host-clock seconds of the
    data build, the adapter build (packing, device upload, cached
    propagation) and the training runs. The arrays are (epochs, 12) for
    edge classification and link prediction with eval_type "F1", (epochs,
    9) for link prediction with "MAP-MRR". Regression runs once per trial,
    keyed (trial, None), as the JAX package runs it; its result is
    ``run_regression``'s dict. With ``checkpoint_dir`` each run saves under
    ``checkpoint_dir/<cfg.name>/<run_tag(trial, alpha)>`` and resumes from
    the newest checkpoint there; every run still draws its initial
    parameters from the shared generator, so later runs start as they
    would have.

    ``mesh_shape`` (n_graph, n_time) trains through the sharded (graph x
    time) path (parallel/adapter.py), one process per device: TM-GCN (1 or
    2 layers) and KW-GCN on the whole mesh, EvolveGCN-H and WD-GCN over
    ``graph`` alone (n_time 1), every task. Under ``torchrun`` each rank
    calls this, and every rank returns the same rows; without its
    environment the world is this process alone, so only a 1 x 1 mesh
    fits. NCCL on ``cuda`` (this rank's card), gloo on ``cpu``. With
    ``checkpoint_dir`` rank 0 alone writes, every rank waits for each save
    and restores the same file.

    ``debug_nans`` (``cli run --debug-nans``, the JAX package's
    ``jax_debug_nans``): the training steps run eagerly, and the first NaN
    in a loss or a gradient raises ``FloatingPointError`` naming the epoch
    and the tensor (``train.loop._NanCheckedChunks``). Off, the steps are
    captured on a card as always.
    """
    device = resolve_device(device)
    mesh = None
    if mesh_shape is not None:
        from tmgcn_torch.parallel import distributed
        from tmgcn_torch.parallel.mesh import make_mesh

        _check_mesh_run(cfg)
        mesh = make_mesh(*mesh_shape, device=distributed.initialize(device))
    exp = build_experiment(cfg, data_dir, artifact, device, mesh)
    tcfg = train_config(cfg, n_epochs, verbose, debug_nans)
    alphas = alpha_vec if alpha_vec is not None else cfg.alpha_vec

    t0 = time.perf_counter()
    generator = torch.Generator().manual_seed(cfg.seed)
    results: dict = {}
    for tr in range(cfg.n_trials):
        for alpha in (None,) if cfg.task == "regression" else alphas:
            ck = None
            if checkpoint_dir is not None:
                ck = RunCheckpointer(Path(checkpoint_dir) / cfg.name / run_tag(tr, alpha),
                                     group=mesh.world if mesh is not None else None)
            results[(tr, alpha)] = run_trial(exp, tcfg, alpha, generator, ck)
    t_train = time.perf_counter() - t0
    return {
        "results": results,
        "spec": exp.data.spec,
        "seconds": {**exp.seconds, "train": t_train},
    }

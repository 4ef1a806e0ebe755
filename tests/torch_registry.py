"""Shared by the tests of the 32 presets on the registry's other datasets
(tests/test_torch_registry_*.py): bitcoin_otc, bitcoin_alpha, reddit and
amlsim edge classification, bitcoin_otc, bitcoin_alpha, reddit and uci link
prediction, each with TM-GCN, KW-GCN, EvolveGCN-H and WD-GCN.

Their raw files are the in-repo stand-ins in data/synthetic/<name>/ (the
port's ``cli synth --seed 0`` writes them byte for byte); each test copies
them into a temporary directory, once per package (``raw_copies``), so the
.mat caches that ``build_data`` writes never land in the repository, and
removes them when it ends.

``loop_pair`` trains one preset 5 epochs with two evaluations (epochs 0 and
3) in both packages from the same initial variables, the JAX side on its
preset's operator, the port on the CPU; ``assert_rows_close`` holds the
rows at the suite's tolerances: losses rtol 1e-4; F1 within 1e-3, or for
EvolveGCN-H its val/test F1 within the range the port's evaluation logits
allow once their tied edges go either way; MAP and MRR rtol 1e-3; NaN where
the other side is NaN.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
from pathlib import Path

import jax
import numpy as np

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.test_torch_evolvegcn_slice import _assert_f1_close, _recording
from tmgcn_tpu.configs import build as jbuild
from tmgcn_tpu.configs import presets as jpresets
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.tasks.windows import split_data_link_prediction as j_lp_split
from tmgcn_tpu.tasks.windows import split_edges_classification as j_split
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.preprocess.datasets import REGISTRY
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks.windows import split_data_link_prediction as t_lp_split
from tmgcn_torch.tasks.windows import split_edges_classification as t_split
from tmgcn_torch.train import loop as tloop

SYNTHETIC = Path(__file__).resolve().parents[1] / "data" / "synthetic"
DATASETS = ("bitcoin_otc", "bitcoin_alpha", "reddit", "amlsim", "uci")
PRESETS = tuple(sorted(n for n, c in tpresets.PRESETS.items() if c.dataset in DATASETS))
WINDOWS = ("train", "val", "test")
EPOCHS, EVAL_EVERY = 5, 3


def raw_copy(root: Path, dataset: str) -> Path:
    """A directory under ``root`` holding a copy of the dataset's raw file."""
    d = Path(root) / dataset
    d.mkdir(parents=True, exist_ok=True)
    name = REGISTRY[dataset].filename
    shutil.copy(SYNTHETIC / dataset / name, d / name)
    return d


@contextlib.contextmanager
def raw_copies(root: Path, datasets, sides=("torch", "jax")):
    """{side: {dataset: raw copy}} under ``root``, removed on exit with the
    .mat caches that ``build_data`` writes there (100-160 MB a dataset and
    side)."""
    try:
        yield {side: {d: raw_copy(Path(root) / side, d) for d in datasets} for side in sides}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def loop_pair(preset: str, dirs: dict, spmm_impl: str | None = None, epochs: int = EPOCHS,
              eval_every: int = EVAL_EVERY):
    """(res_t, res_j, eval_logits, splits_t, cfg_t): ``epochs`` (5) of the
    preset in both packages at its first alpha, from the JAX adapter's
    initial variables, evaluating every ``eval_every`` (3). ``dirs`` maps "torch" and "jax" to each side's raw copy.
    ``spmm_impl`` overrides the port's operator (the JAX side keeps the
    preset's). EvolveGCN's JAX adapter gets float32 features, as the JAX
    package holds them with x64 off (see tests/test_torch_evolvegcn_slice.py)."""
    cfg_j = jpresets.get_preset(preset)
    cfg_t = tpresets.get_preset(preset)
    if spmm_impl is not None:
        cfg_t = dataclasses.replace(cfg_t, spmm_impl=spmm_impl)
    data_j = jbuild.build_data(cfg_j, data_dir=dirs["jax"])
    data_t = tbuild.build_data(cfg_t, data_dir=dirs["torch"])
    lp = cfg_t.task == "link_pred"
    if lp:
        s_j = j_lp_split(data_j.lp_edges, data_j.lp_labels, data_j.spec)
        s_t = t_lp_split(data_t.lp_edges, data_t.lp_labels, data_t.spec)
        edges_j = {w: s_j[w].model_edges for w in WINDOWS}
        edges_t = {w: s_t[w].model_edges for w in WINDOWS}
        n_slices = data_t.spec.s_train - 1
    else:
        s_j = j_split(data_j.edge_index, data_j.edge_values, data_j.spec, cfg_j.n_classes)
        s_t = t_split(data_t.edge_index, data_t.edge_values, data_t.spec, cfg_t.n_classes)
        edges_j = {w: s_j[w].edges for w in WINDOWS}
        edges_t = {w: s_t[w].edges for w in WINDOWS}
        n_slices = data_t.spec.s_train
    feats_j = data_j.feats
    if cfg_j.method == "evolvegcn":
        feats_j = {w: f.astype(np.float32) for w, f in feats_j.items()}
    in_feat = data_t.feats["train"].shape[-1]
    tmgcn = cfg_t.method == "tmgcn"
    adapter_j = jad.make_edge_adapter(
        jbuild.build_model(cfg_j, n_slices, in_feat), data_j.adj, feats_j, edges_j,
        M=data_j.M if tmgcn else None, drop_last_slice=lp)
    adapter_t = tad.make_edge_adapter(
        tbuild.build_model(cfg_t, n_slices, in_feat), data_t.adj, data_t.feats, edges_t,
        M=data_t.M if tmgcn else None, drop_last_slice=lp, device="cpu")
    adapter_t, eval_logits = _recording(adapter_t)
    variables = adapter_j.init(jax.random.PRNGKey(cfg_j.seed))
    cw = tbuild.class_weights(cfg_t, cfg_t.alpha_vec[0])
    jcfg = jloop.TrainConfig(n_epochs=epochs, eval_every=eval_every)
    tcfg = tloop.TrainConfig(n_epochs=epochs, eval_every=eval_every)
    tvars = params_from_jax(_np_tree(variables))
    if lp:
        res_j, _ = jloop.run_link_prediction(adapter_j, s_j, cw, jcfg, variables=variables)
        res_t, _ = tloop.run_link_prediction(adapter_t, s_t, cw, tcfg, variables=tvars)
    else:
        res_j, _ = jloop.run_edge_classification(adapter_j, s_j, cw, jcfg, variables=variables)
        res_t, _ = tloop.run_edge_classification(adapter_t, s_t, cw, tcfg, variables=tvars)
    return res_t, res_j, eval_logits, s_t, cfg_t


def assert_rows_close(res_t, res_j, eval_logits, splits_t, cfg) -> None:
    """The rows of ``loop_pair`` at the suite's tolerances."""
    if cfg.task == "link_pred":
        assert res_t.shape == res_j.shape == (EPOCHS, 9)
        np.testing.assert_allclose(res_t[:, [2, 5, 8]], res_j[:, [2, 5, 8]], rtol=1e-4)
        rates = [0, 1, 3, 4, 6, 7]
        np.testing.assert_array_equal(np.isnan(res_t[:, rates]), np.isnan(res_j[:, rates]))
        np.testing.assert_allclose(res_t[:, rates], res_j[:, rates], rtol=1e-3)
        return
    assert res_t.shape == res_j.shape == (EPOCHS, 12)
    np.testing.assert_allclose(res_t[:, [3, 7, 11]], res_j[:, [3, 7, 11]], rtol=1e-4)
    if cfg.method == "evolvegcn":
        _assert_f1_close(res_t, res_j, eval_logits, splits_t)
        return
    rates = [0, 1, 2, 4, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(np.isnan(res_t[:, rates]), np.isnan(res_j[:, rates]))
    np.testing.assert_allclose(res_t[:, rates], res_j[:, rates], atol=1e-3)


def assert_run_sane(rows: np.ndarray, task: str, n_epochs: int) -> None:
    """A run's rows: the loop's layout, finite losses, rates in [0, 1] or
    NaN where undefined."""
    if task == "link_pred":
        losses, rates = [2, 5, 8], [0, 1, 3, 4, 6, 7]
        assert rows.shape == (n_epochs, 9)
    else:
        losses, rates = [3, 7, 11], [0, 1, 2, 4, 5, 6, 8, 9, 10]
        assert rows.shape == (n_epochs, 12)
    assert np.all(np.isfinite(rows[:, losses]))
    r = rows[:, rates]
    assert np.all(np.isnan(r) | ((r >= 0) & (r <= 1)))


def run_twice(preset: str, data_dir: Path, n_epochs: int = 3) -> np.ndarray:
    """``run_experiment`` of the preset on the CPU at its first alpha, twice
    (the second from the .mat cache): the rows, asserted equal bitwise."""
    cfg = tpresets.get_preset(preset)
    rows = []
    for _ in range(2):
        out = tbuild.run_experiment(cfg, data_dir=data_dir, n_epochs=n_epochs,
                                    alpha_vec=cfg.alpha_vec[:1], verbose=False, device="cpu")
        assert list(out["results"]) == [(0, cfg.alpha_vec[0])]
        rows.append(out["results"][(0, cfg.alpha_vec[0])])
    np.testing.assert_array_equal(rows[0], rows[1])
    assert_run_sane(rows[0], cfg.task, n_epochs)
    return rows[0]

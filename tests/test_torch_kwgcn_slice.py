"""The chess KW-GCN slices at full width against the JAX package:
chess_gcn_cls at 1 layer and at 2 (hidden (6, 6, 3), which the JAX
build_model accepts) and chess_gcn_lp, 5 epochs with two evaluations from
the same variables; and both presets through the port's CLI on the CPU.

Both packages build the chess data from a copy of data/chess/out.chess.csv
in a temporary directory; link prediction draws its negatives on both sides
from ``cfg.seed``. Tolerances as tests/test_torch_wdgcn.py and
tests/test_torch_lp_slice.py hold their slices: losses rtol 1e-4, F1 within
1e-3, MAP and MRR rtol 1e-3, NaN where the other side is NaN.
"""

import dataclasses
import pickle
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tmgcn_tpu import native
from tmgcn_tpu.configs import build as jbuild
from tmgcn_tpu.configs import presets as jpresets
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.tasks.windows import split_data_link_prediction as j_lp_split
from tmgcn_tpu.tasks.windows import split_edges_classification as j_split
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch import cli
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.models import gcn as tgcn
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks.windows import split_data_link_prediction as t_lp_split
from tmgcn_torch.tasks.windows import split_edges_classification as t_split
from tmgcn_torch.train import loop as tloop

WINDOWS = ("train", "val", "test")


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


CHESS = Path(__file__).resolve().parents[1] / "data" / "chess" / "out.chess.csv"
EPOCHS, EVAL_EVERY = 5, 3


def _f1_close(res_t, res_j, cols):
    np.testing.assert_array_equal(np.isnan(res_t[:, cols]), np.isnan(res_j[:, cols]))
    np.testing.assert_allclose(res_t[:, cols], res_j[:, cols], atol=1e-3)


@pytest.fixture(scope="module")
def chess_dirs(tmp_path_factory):
    dirs = {}
    for side in ("torch", "jax"):
        d = tmp_path_factory.mktemp(f"chess_gcn_{side}")
        shutil.copy(CHESS, d / CHESS.name)
        dirs[side] = d
    return dirs


@pytest.mark.parametrize("spmm_impl,hidden", [("pallas", None), ("pallas", (6, 6, 3))],
                         ids=["preset-pallas", "2layer-pallas"])
def test_chess_cls_short_run_matches_jax(chess_dirs, spmm_impl, hidden):
    """5 epochs of chess_gcn_cls at full width (two evaluations), and the
    same at 2 layers, hidden (6, 6, 3) (which the JAX build_model accepts),
    from the same variables. The port runs K1's plain version, the JAX side
    its preset's "jnp" (the Pallas interpreter over the chess windows is too
    slow here; the JAX suite holds its operator equal to "jnp")."""
    extra = {} if hidden is None else {"n_layers": 2, "hidden_feat": hidden}
    cfg_j = dataclasses.replace(jpresets.get_preset("chess_gcn_cls"), **extra)
    cfg_t = dataclasses.replace(tpresets.get_preset("chess_gcn_cls"), spmm_impl=spmm_impl, **extra)
    assert cfg_j.spmm_impl == "jnp" and not cfg_j.same_block_size
    data_j = jbuild.build_data(cfg_j, data_dir=chess_dirs["jax"])
    data_t = tbuild.build_data(cfg_t, data_dir=chess_dirs["torch"])
    s_j = j_split(data_j.edge_index, data_j.edge_values, data_j.spec, cfg_j.n_classes)
    s_t = t_split(data_t.edge_index, data_t.edge_values, data_t.spec, cfg_t.n_classes)
    model_j = jbuild.build_model(cfg_j, data_j.spec.s_train, 2)
    adapter_j = jad.make_edge_adapter(
        model_j, data_j.adj, data_j.feats, {w: s_j[w].edges for w in WINDOWS})
    variables = adapter_j.init(jax.random.PRNGKey(cfg_j.seed))
    cw = np.array([1 / 3, 1 / 3, 1 / 3])
    res_j, _ = jloop.run_edge_classification(
        adapter_j, s_j, cw, jloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=variables)

    model_t = tbuild.build_model(cfg_t, data_t.spec.s_train, 2)
    assert isinstance(model_t, tgcn.KWGCN) and model_t.n_layers == cfg_t.n_layers
    adapter_t = tad.make_edge_adapter(
        model_t, data_t.adj, data_t.feats, {w: s_t[w].edges for w in WINDOWS}, device="cpu")
    res_t, _ = tloop.run_edge_classification(
        adapter_t, s_t, cw, tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=params_from_jax(_np_tree(variables)))
    assert res_t.shape == res_j.shape == (EPOCHS, 12)
    np.testing.assert_allclose(res_t[:, [3, 7, 11]], res_j[:, [3, 7, 11]], rtol=1e-4)
    _f1_close(res_t, res_j, [0, 1, 2, 4, 5, 6, 8, 9, 10])


def test_chess_lp_short_run_matches_jax(chess_dirs):
    """5 epochs of chess_gcn_lp (link prediction on disjoint windows),
    negatives drawn on both sides from cfg.seed, from the same variables."""
    if not native.available():
        pytest.skip("the JAX package's C++ sampler did not load: it draws other negatives")
    cfg_j = jpresets.get_preset("chess_gcn_lp")
    cfg_t = dataclasses.replace(tpresets.get_preset("chess_gcn_lp"), spmm_impl="pallas")
    data_j = jbuild.build_data(cfg_j, data_dir=chess_dirs["jax"])
    data_t = tbuild.build_data(cfg_t, data_dir=chess_dirs["torch"])
    np.testing.assert_array_equal(data_t.lp_edges, data_j.lp_edges)
    s_j = j_lp_split(data_j.lp_edges, data_j.lp_labels, data_j.spec)
    s_t = t_lp_split(data_t.lp_edges, data_t.lp_labels, data_t.spec)
    T_ = data_j.spec.s_train - 1
    adapter_j = jad.make_edge_adapter(
        jbuild.build_model(cfg_j, T_, 2), data_j.adj, data_j.feats,
        {w: s_j[w].model_edges for w in WINDOWS}, drop_last_slice=True)
    variables = adapter_j.init(jax.random.PRNGKey(cfg_j.seed))
    cw = np.array([0.9, 0.1])
    res_j, _ = jloop.run_link_prediction(
        adapter_j, s_j, cw, jloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=variables)
    adapter_t = tad.make_edge_adapter(
        tbuild.build_model(cfg_t, T_, 2), data_t.adj, data_t.feats,
        {w: s_t[w].model_edges for w in WINDOWS}, drop_last_slice=True, device="cpu")
    res_t, _ = tloop.run_link_prediction(
        adapter_t, s_t, cw, tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=params_from_jax(_np_tree(variables)))
    assert res_t.shape == res_j.shape == (EPOCHS, 9)
    np.testing.assert_allclose(res_t[:, [2, 5, 8]], res_j[:, [2, 5, 8]], rtol=1e-4)
    rates = [0, 1, 3, 4, 6, 7]
    np.testing.assert_array_equal(np.isnan(res_t[:, rates]), np.isnan(res_j[:, rates]))
    np.testing.assert_allclose(res_t[:, rates], res_j[:, rates], rtol=1e-3)


@pytest.mark.parametrize("preset", ["chess_gcn_cls", "chess_gcn_lp"])
def test_cli_runs_the_preset_on_the_cpu(chess_dirs, tmp_path, preset):
    """``cli run <preset> --epochs 5 --device cpu``: the results pickle."""
    argv = ["run", preset, "--data-dir", str(chess_dirs["torch"]), "--epochs", "5",
            "--device", "cpu", "--out", str(tmp_path), "--quiet"]
    assert cli.main(argv) == 0
    (pkl,) = tmp_path.glob(f"results_{preset}_*.pkl")
    with open(pkl, "rb") as f:
        res = pickle.load(f)
    lp = preset.endswith("_lp")
    assert res.shape == (5, 9 if lp else 12)
    assert np.all(np.isfinite(res[:, [2, 5, 8] if lp else [3, 7, 11]]))

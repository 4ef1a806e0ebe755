"""EvolveGCN-H link prediction and the scale benchmark's evolvegcn family
against the JAX package: chess_evolvegcn_lp at full width (the generic path,
its slice one-hot over the gather-free budget) and the family's model on
tools/bench_scale.py's inputs at a small size; and the three chess
EvolveGCN presets through the port's CLI on the CPU.

Both packages build the chess data from a copy of data/chess/out.chess.csv
in a temporary directory and draw the negatives from ``cfg.seed`` (the
port's splitmix64 stream is the JAX package's C++ sampler's); JAX's initial
variables are carried across with ``params_from_jax``; the JAX adapters get
float32 features, as the JAX package holds them with x64 off (see
tests/test_torch_evolvegcn_slice.py). Tolerances: losses rtol 1e-4, MAP and
MRR rtol 1e-3, NaN where the other side is NaN (tests/test_torch_lp_slice.py).
"""

import importlib.util
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
from tmgcn_tpu.models import evolvegcn as jev
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.tasks.windows import split_data_link_prediction as j_lp_split
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch import cli
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks.windows import split_data_link_prediction as t_lp_split
from tmgcn_torch.train import loop as tloop
from tmgcn_torch.utils import scale_bench

WINDOWS = ("train", "val", "test")
EPOCHS, EVAL_EVERY = 5, 3
CHESS = Path(__file__).resolve().parents[1] / "data" / "chess" / "out.chess.csv"


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def chess_dirs(tmp_path_factory):
    dirs = {}
    for side in ("torch", "jax"):
        d = tmp_path_factory.mktemp(f"chess_evolvegcn_lp_{side}")
        shutil.copy(CHESS, d / CHESS.name)
        dirs[side] = d
    return dirs


def test_chess_lp_short_run_matches_jax(chess_dirs):
    """5 epochs of chess_evolvegcn_lp: 772,520 training edges put the slice
    one-hot at 232.8 MiB, over the 1-layer budget, so both packages run the
    generic path; negatives drawn on both sides from cfg.seed."""
    if not native.available():
        pytest.skip("the JAX package's C++ sampler did not load: it draws other negatives")
    cfg_j, cfg_t = (p.get_preset("chess_evolvegcn_lp") for p in (jpresets, tpresets))
    data_j = jbuild.build_data(cfg_j, data_dir=chess_dirs["jax"])
    data_t = tbuild.build_data(cfg_t, data_dir=chess_dirs["torch"])
    np.testing.assert_array_equal(data_t.lp_edges, data_j.lp_edges)
    s_j = j_lp_split(data_j.lp_edges, data_j.lp_labels, data_j.spec)
    s_t = t_lp_split(data_t.lp_edges, data_t.lp_labels, data_t.spec)
    T_ = data_j.spec.s_train - 1
    feats_j = {w: f.astype(np.float32) for w, f in data_j.feats.items()}
    adapter_j = jad.make_edge_adapter(
        jbuild.build_model(cfg_j, T_, 2), data_j.adj, feats_j,
        {w: s_j[w].model_edges for w in WINDOWS}, drop_last_slice=True)
    model_t = tbuild.build_model(cfg_t, T_, 2)
    edges_t = {w: s_t[w].model_edges for w in WINDOWS}
    adapter_t = tad.make_edge_adapter(model_t, data_t.adj, data_t.feats, edges_t,
                                      drop_last_slice=True, device="cpu")
    assert "ax_srcT" not in adapter_j.bundles["train"]  # the JAX generic path
    assert tad._evolvegcn_path(model_t, data_t.adj, edges_t, True) == "generic"
    assert T_ * edges_t["train"].shape[1] * 4 == 244_116_320  # 232.8 MiB
    variables = adapter_j.init(jax.random.PRNGKey(cfg_j.seed))
    cw = np.array([0.9, 0.1])
    res_j, _ = jloop.run_link_prediction(
        adapter_j, s_j, cw, jloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=variables)
    res_t, _ = tloop.run_link_prediction(
        adapter_t, s_t, cw, tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=params_from_jax(_np_tree(variables)))
    assert res_t.shape == res_j.shape == (EPOCHS, 9)
    np.testing.assert_allclose(res_t[:, [2, 5, 8]], res_j[:, [2, 5, 8]], rtol=1e-4)
    rates = [0, 1, 3, 4, 6, 7]
    np.testing.assert_array_equal(np.isnan(res_t[:, rates]), np.isnan(res_j[:, rates]))
    np.testing.assert_allclose(res_t[:, rates], res_j[:, rates], rtol=1e-3)


TOOL = Path(__file__).resolve().parents[1] / "tools" / "bench_scale.py"


def test_scale_family_matches_the_tool_s_model():
    """The evolvegcn family at a small size: the tool's model (EvolveGCN,
    hidden (6, 2), no M) on the tool's inputs, 4 SGD steps from the same
    variables (lr 0.01, momentum 0.9, class weights [0.9, 0.1])."""
    spec = importlib.util.spec_from_file_location("bench_scale_tool", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    inputs = scale_bench.build_inputs(300, 4, 900, 200, 3)
    A, _, X, edges, tgt, cw = inputs
    model, Mw = scale_bench.build_model("evolvegcn", A.n_slices, X.shape[-1], inputs[1])
    assert Mw is None and model.hidden_feat == (6, 2) and model.n_layers == 1
    A_j, _, X_j, edges_j, tgt_j, _ = tool.build_inputs(300, 4, 900, 200, 3)
    jmodel = jev.EvolveGCN(n_slices=A.n_slices, in_feat=X.shape[-1], hidden_feat=(6, 2))
    ja = jad.make_edge_adapter(jmodel, {w: A_j for w in WINDOWS}, {w: X_j for w in WINDOWS},
                               {w: edges_j for w in WINDOWS})
    ta = tad.make_edge_adapter(model, {w: A for w in WINDOWS}, {w: X for w in WINDOWS},
                               {w: edges for w in WINDOWS}, device="cpu")
    split = scale_bench.labelled_edges(inputs)
    splits = {w: split for w in WINDOWS}
    variables = ja.init(jax.random.PRNGKey(0))
    cfg = dict(n_epochs=4, eval_every=100)
    res_j, _ = jloop.run_edge_classification(ja, splits, cw, jloop.TrainConfig(**cfg),
                                             variables=variables)
    res_t, _ = tloop.run_edge_classification(ta, splits, cw, tloop.TrainConfig(**cfg),
                                             variables=params_from_jax(_np_tree(variables)))
    np.testing.assert_allclose(res_t[:, 3], res_j[:, 3], rtol=1e-4)
    out = scale_bench.run_family("evolvegcn", inputs, 4, "cpu")
    assert out["steps"] == 6 and np.all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("preset", ["chess_evolvegcn_cls", "chess_evolvegcn2_cls",
                                    "chess_evolvegcn_lp"])
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

"""The link-prediction slice at full width: chess_tmgcn_lp, port against JAX,
and both chess LP presets through the port's CLI on the CPU.

Both packages build the chess data from a copy of data/chess/out.chess.csv
in a temporary directory (no .mat cache lands in the repository); each
draws its negatives from ``cfg.seed`` (the port's splitmix64 stream is the
JAX package's C++ sampler's), and the augmented edge sets are asserted
bitwise equal before anything else is compared. Both train 5 epochs
(eval_every=3: an evaluation epoch, a chunk of plain epochs, a second
evaluation epoch and chunk) from the same initial parameters, carried over
with ``params_from_jax``.

The port runs spmm_impl="pallas" (K1's plain version on the CPU), the JAX
side its preset's "jnp" (the Pallas interpreter over the chess windows is
too slow here; the JAX suite holds its Pallas operator equal to "jnp").

Tolerances: tests/conftest.py turns on x64, so the JAX propagation runs in
float64 before the model's float32 truncation of the cached rows, while the
port's runs in float32 — the cached rows differ by float32 rounding. Losses
to rtol 1e-4; MAP and MRR to rtol 1e-3, NaN where the other side is NaN.
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
from tmgcn_tpu.tasks.windows import split_data_link_prediction as j_split
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch import cli
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.kernels import spmm_cuda
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks.windows import split_data_link_prediction as t_split
from tmgcn_torch.train import loop as tloop

CHESS = Path(__file__).resolve().parents[1] / "data" / "chess" / "out.chess.csv"
WINDOWS = ("train", "val", "test")
EPOCHS, EVAL_EVERY = 5, 3
CW = np.array([0.9, 0.1])


@pytest.fixture(scope="module")
def chess(tmp_path_factory):
    if not native.available():
        pytest.skip("the JAX package's C++ sampler did not load: it draws other negatives")
    dirs = {}
    for side in ("torch", "jax"):
        d = tmp_path_factory.mktemp(f"chess_lp_{side}")
        shutil.copy(CHESS, d / CHESS.name)
        dirs[side] = d
    cfg_t = dataclasses.replace(tpresets.get_preset("chess_tmgcn_lp"), spmm_impl="pallas")
    cfg_j = jpresets.get_preset("chess_tmgcn_lp")
    assert cfg_j.spmm_impl == "jnp" and cfg_j.alpha_vec == (0.9,)
    data_t = tbuild.build_data(cfg_t, data_dir=dirs["torch"])
    data_j = jbuild.build_data(cfg_j, data_dir=dirs["jax"])
    return dirs, cfg_t, cfg_j, data_t, data_j


def test_build_data_matches_jax(chess):
    _, _, _, data_t, data_j = chess
    for f in ("lp_edges", "lp_labels", "edge_index"):
        a, b = getattr(data_t, f), getattr(data_j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    for w in WINDOWS:
        np.testing.assert_array_equal(data_t.feats[w], data_j.feats[w])
    st = t_split(data_t.lp_edges, data_t.lp_labels, data_t.spec)
    sj = j_split(data_j.lp_edges, data_j.lp_labels, data_j.spec)
    for w in WINDOWS:
        for f in ("edges", "target", "model_edges"):
            np.testing.assert_array_equal(getattr(st[w], f), getattr(sj[w], f))
        assert st[w].n_eval_tail == sj[w].n_eval_tail
    assert [st[w].model_edges.shape[1] for w in WINDOWS] == [772_520, 778_020, 1_062_060]
    # 19 negatives per real edge: labels are 1/20 real.
    assert int((data_t.lp_labels == 0).sum()) * 20 == data_t.lp_labels.size


def test_short_run_matches_jax(chess):
    _, cfg_t, cfg_j, data_t, data_j = chess
    s_t = t_split(data_t.lp_edges, data_t.lp_labels, data_t.spec)
    s_j = j_split(data_j.lp_edges, data_j.lp_labels, data_j.spec)
    T = data_j.spec.s_train - 1

    model_j = jbuild.build_model(cfg_j, T, 2)
    adapter_j = jad.make_edge_adapter(
        model_j, data_j.adj, data_j.feats, {w: s_j[w].model_edges for w in WINDOWS},
        M=data_j.M, drop_last_slice=True,
    )
    variables = adapter_j.init(jax.random.PRNGKey(cfg_j.seed))
    res_j, _ = jloop.run_link_prediction(
        adapter_j, s_j, CW, jloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=variables,
    )

    before = spmm_cuda.windowed_segment_matmul.launches
    model_t = tbuild.build_model(cfg_t, T, 2)
    adapter_t = tad.make_edge_adapter(
        model_t, data_t.adj, data_t.feats, {w: s_t[w].model_edges for w in WINDOWS},
        M=data_t.M, drop_last_slice=True, device="cpu",
    )
    params = tbuild.params_from_jax({k: np.asarray(v) for k, v in variables["params"].items()})
    res_t, _ = tloop.run_link_prediction(
        adapter_t, s_t, CW, tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables={"params": params, "buffers": {}},
    )
    assert spmm_cuda.windowed_segment_matmul.launches == before  # plain version on the CPU

    assert res_t.shape == res_j.shape == (EPOCHS, 9)
    losses = [2, 5, 8]
    np.testing.assert_allclose(res_t[:, losses], res_j[:, losses], rtol=1e-4)
    rates = [0, 1, 3, 4, 6, 7]
    np.testing.assert_array_equal(np.isnan(res_t[:, rates]), np.isnan(res_j[:, rates]))
    np.testing.assert_allclose(res_t[:, rates], res_j[:, rates], rtol=1e-3)


@pytest.mark.parametrize("preset", ["chess_tmgcn_lp", "chess_wdgcn_lp"])
def test_cli_runs_link_prediction_on_the_cpu(chess, tmp_path, preset):
    """``cli run <preset> --epochs 5 --device cpu`` on the cached chess data:
    the results pickle holds the (5, 9) MAP-MRR rows."""
    dirs = chess[0]
    argv = ["run", preset, "--data-dir", str(dirs["torch"]), "--epochs", "5",
            "--device", "cpu", "--out", str(tmp_path), "--quiet"]
    assert cli.main(argv) == 0
    (pkl,) = tmp_path.glob(f"results_{preset}_*.pkl")
    with open(pkl, "rb") as f:
        res = pickle.load(f)
    assert res.shape == (5, 9)
    assert np.all(np.isfinite(res[:, [2, 5, 8]]))
    for col in (0, 1, 3, 4, 6, 7):
        v = res[:, col]
        assert np.all(np.isnan(v) | ((v >= 0) & (v <= 1)))

"""The whole slice at full width: chess_tmgcn_cls, port against JAX.

Both packages build the chess data from a copy of data/chess/out.chess.csv
in a temporary directory (so no .mat cache lands in the repository), and
train 5 epochs (eval_every=3: an evaluation epoch, a chunk of plain
epochs, a second evaluation epoch and chunk) from the same initial
parameters, carried over with ``params_from_jax``.

The port runs spmm_impl="pallas" (K1's plain version on the CPU). The
JAX side runs spmm_impl="jnp": the Pallas interpreter over the ~31k
chunks of the three windows is too slow here, and the JAX suite already
holds its Pallas operator equal to "jnp" (tests/test_pallas_spmm.py).

Tolerances: tests/conftest.py turns on x64, so the JAX propagation runs
in float64 before the model's float32 truncation of the cached rows,
while the port's runs in float32 — the cached rows differ by float32
rounding (~1e-7 relative). Losses are compared to rtol 1e-4; precision,
recall and F1 to within 1e-3 (a handful of argmax flips among ~39k
edges), NaN where the other side is NaN.
"""

import dataclasses
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

from tmgcn_tpu.configs import build as jbuild
from tmgcn_tpu.configs import presets as jpresets
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.tasks.windows import split_edges_classification as j_split
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.kernels import spmm_cuda
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks.windows import split_edges_classification as t_split
from tmgcn_torch.train import loop as tloop

CHESS = Path(__file__).resolve().parents[1] / "data" / "chess" / "out.chess.csv"
WINDOWS = ("train", "val", "test")
EPOCHS, EVAL_EVERY = 5, 3
CW = np.array([1 / 3, 1 / 3, 1 / 3])


@pytest.fixture(scope="module")
def chess(tmp_path_factory):
    dirs = {}
    for side in ("torch", "jax"):
        d = tmp_path_factory.mktemp(f"chess_{side}")
        shutil.copy(CHESS, d / CHESS.name)
        dirs[side] = d
    cfg_t = dataclasses.replace(tpresets.get_preset("chess_tmgcn_cls"), spmm_impl="pallas")
    cfg_j = jpresets.get_preset("chess_tmgcn_cls")
    assert cfg_j.spmm_impl == "jnp"
    data_t = tbuild.build_data(cfg_t, data_dir=dirs["torch"])
    data_j = jbuild.build_data(cfg_j, data_dir=dirs["jax"])
    return dirs, cfg_t, cfg_j, data_t, data_j


def _assert_coo_equal(a, b):
    for f in ("rows", "cols", "vals", "nnz"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), f)
    assert a.n_nodes == b.n_nodes


def _assert_data_equal(data_t, data_j):
    assert dataclasses.asdict(data_t.spec) == dataclasses.asdict(data_j.spec)
    np.testing.assert_array_equal(data_t.M, data_j.M)
    np.testing.assert_array_equal(data_t.edge_index, data_j.edge_index)
    np.testing.assert_array_equal(data_t.edge_values, data_j.edge_values)
    for w in WINDOWS:
        _assert_coo_equal(data_t.adj[w], data_j.adj[w])
        np.testing.assert_array_equal(data_t.feats[w], data_j.feats[w])


def test_build_data_matches_jax(chess):
    _, cfg_t, cfg_j, data_t, data_j = chess
    assert data_t.adj["train"].n_nodes == 7301 and data_t.adj["train"].n_slices == 80
    assert int(np.sum(data_t.adj["train"].nnz)) == 2_321_464
    _assert_data_equal(data_t, data_j)
    st = t_split(data_t.edge_index, data_t.edge_values, data_t.spec, cfg_t.n_classes)
    sj = j_split(data_j.edge_index, data_j.edge_values, data_j.spec, cfg_j.n_classes)
    for w in WINDOWS:
        for f in ("edges", "target", "eval_mask"):
            np.testing.assert_array_equal(getattr(st[w], f), getattr(sj[w], f))
    assert st["train"].target.size == 39_192


def test_port_reads_the_jax_cache(chess):
    """build_data caches into data_dir; the port loads the JAX package's file."""
    dirs, cfg_t, _, data_t, _ = chess
    assert (dirs["jax"] / "saved_content_chess.mat").exists()
    _assert_data_equal(tbuild.build_data(cfg_t, data_dir=dirs["jax"]), data_t)


def test_short_run_matches_jax(chess):
    _, cfg_t, cfg_j, data_t, data_j = chess
    s_t = t_split(data_t.edge_index, data_t.edge_values, data_t.spec, cfg_t.n_classes)
    s_j = j_split(data_j.edge_index, data_j.edge_values, data_j.spec, cfg_j.n_classes)

    model_j = jbuild.build_model(cfg_j, data_j.spec.s_train, 2)
    adapter_j = jad.make_edge_adapter(
        model_j, data_j.adj, data_j.feats, {w: s_j[w].edges for w in WINDOWS}, M=data_j.M
    )
    variables = adapter_j.init(jax.random.PRNGKey(cfg_j.seed))
    res_j, _ = jloop.run_edge_classification(
        adapter_j, s_j, CW, jloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=variables,
    )

    before = spmm_cuda.windowed_segment_matmul.launches
    model_t = tbuild.build_model(cfg_t, data_t.spec.s_train, 2)
    adapter_t = tad.make_edge_adapter(
        model_t, data_t.adj, data_t.feats, {w: s_t[w].edges for w in WINDOWS},
        M=data_t.M, device="cpu",
    )
    params = tbuild.params_from_jax({k: np.asarray(v) for k, v in variables["params"].items()})
    res_t, _ = tloop.run_edge_classification(
        adapter_t, s_t, CW, tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables={"params": params, "buffers": {}},
    )
    assert spmm_cuda.windowed_segment_matmul.launches == before  # plain version on the CPU

    assert res_t.shape == res_j.shape == (EPOCHS, 12)
    losses = [3, 7, 11]
    np.testing.assert_allclose(res_t[:, losses], res_j[:, losses], rtol=1e-4)
    rates = [0, 1, 2, 4, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(np.isnan(res_t[:, rates]), np.isnan(res_j[:, rates]))
    np.testing.assert_allclose(res_t[:, rates], res_j[:, rates], atol=1e-3)

"""The synthetic data of the port against the JAX package: the SEIR
simulation and the dynamic SBM (drawn from the same numpy stream, so
bitwise equal), the spectral features, ``build_data`` of the SEIR and SBM
configs, and the five SBM link-prediction presets run through
``run_experiment`` at a small size.

Sizes as the JAX suite's: SEIR 60 nodes x 20 slices (tests/test_tasks.py),
SBM 50 nodes x 10 slices with beta1 = beta2 = 2 (tests/test_configs.py).
Both packages draw their LP negatives from ``cfg.seed`` (the port's
splitmix64 stream is the JAX package's C++ sampler's). Each run_experiment
pair starts from the same parameters: the port's adapter draws the JAX
package's initial variables (``params_from_jax``) for the key the JAX
run_experiment uses, and the JAX side gets float32 features, as the JAX
package holds them with x64 off (tests/conftest.py turns x64 on, which
would change the type of EvolveGCN's GRU carry). Tolerances: the data
bitwise; losses rtol 1e-4 over the epochs where the JAX loss is finite and
below 1e6, both sides non-finite from the same epoch on; MAP and MRR rtol
1e-3, NaN where the other side is NaN.
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tmgcn_tpu import native
from tmgcn_tpu.configs import build as jbuild
from tmgcn_tpu.configs import presets as jpresets
from tmgcn_tpu.ops import degree as jdeg
from tmgcn_tpu.preprocess import sbm as jsbm
from tmgcn_tpu.preprocess import seir as jseir
from tmgcn_torch import cli
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.ops import degree as tdeg
from tmgcn_torch.preprocess import sbm as tsbm
from tmgcn_torch.preprocess import seir as tseir
from tmgcn_torch.tasks import adapters as tad

WINDOWS = ("train", "val", "test")
SMALL_SEIR = {"seir_n_nodes": 60, "seir_n_slices": 20}
SMALL_SBM = {"sbm_n_nodes": 50, "sbm_n_slices": 10, "beta1": 2, "beta2": 2}
SBM_PRESETS = ("sbm_tmgcn_lp", "sbm_tmgcn_lp_tuned", "sbm_evolvegcn_lp",
               "sbm_evolvegcn_lp_tuned", "sbm_tmgcn_lp_spectral")
EPOCHS, EVAL_EVERY = 5, 3


def _assert_coo_equal(a, b, what=""):
    for f in ("rows", "cols", "vals", "nnz"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, (what, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
    assert a.n_nodes == b.n_nodes


@pytest.mark.parametrize("seed", [0, 3])
def test_seir_simulation_is_bitwise_the_jax_package_s(seed):
    kw = {"n_nodes": 60, "n_slices": 20, "seed": seed}
    t, j = tseir.simulate_seir(**kw), jseir.simulate_seir(**kw)
    np.testing.assert_array_equal(t.adjacency, j.adjacency)
    np.testing.assert_array_equal(t.states, j.states)
    for out_idx in (2, 0):
        for a, b in zip(tseir.seir_features_targets(t, out_idx),
                        jseir.seir_features_targets(j, out_idx)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    _assert_coo_equal(tseir.seir_temporal_adjacency(t), jseir.seir_temporal_adjacency(j))


def test_seir_at_the_preset_size():
    """N = 200, 100 slices (the seir_* presets): states one-hot, the same
    numbers on both sides."""
    t, j = tseir.simulate_seir(seed=0), jseir.simulate_seir(seed=0)
    assert t.adjacency.shape == (100, 200, 200) and t.states.shape == (101, 4, 200)
    np.testing.assert_array_equal(t.states.sum(axis=1), 1.0)
    np.testing.assert_array_equal(t.states, j.states)
    np.testing.assert_array_equal(t.adjacency, j.adjacency)


@pytest.mark.parametrize("seed,change", [(0, 10), (2, 3)])
def test_sbm_series_is_bitwise_the_jax_package_s(seed, change):
    kw = {"node_change_num": change, "seed": seed}
    ta, th = tsbm.dynamic_sbm_series(80, 12, **kw)
    ja, jh = jsbm.dynamic_sbm_series(80, 12, **kw)
    np.testing.assert_array_equal(th, jh)
    assert len(ta) == len(ja) == 12
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, a.T)
    _assert_coo_equal(tsbm.sbm_temporal_adjacency(80, 12, **kw),
                      jsbm.sbm_temporal_adjacency(80, 12, **kw))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_spectral_features_are_bitwise_the_jax_package_s(k):
    A_t = tsbm.sbm_temporal_adjacency(60, 6, seed=1, p_in=0.1, p_out=0.01)
    A_j = jsbm.sbm_temporal_adjacency(60, 6, seed=1, p_in=0.1, p_out=0.01)
    got, ref = tdeg.spectral_features_np(A_t, k), jdeg.spectral_features_np(A_j, k)
    assert got.shape == (6, 60, k) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], got[-1])  # constant across slices


def _configs(name, **small):
    return (dataclasses.replace(tpresets.get_preset(name), **small),
            dataclasses.replace(jpresets.get_preset(name), **small))


@pytest.mark.parametrize("name,small", [
    ("seir_tmgcn_reg", SMALL_SEIR), ("seir_wdgcn_reg_tuned", SMALL_SEIR),
    ("sbm_tmgcn_lp", SMALL_SBM), ("sbm_evolvegcn_lp_tuned", SMALL_SBM),
    ("sbm_tmgcn_lp_spectral", SMALL_SBM),
])
def test_build_data_matches_jax(name, small):
    """Windows, Ct of every window, M, features, and the LP edges or the
    regression targets: the same arrays (Ct and standardized features are
    host float64/float32 arithmetic in the same order)."""
    cfg_t, cfg_j = _configs(name, **small)
    dt, dj = tbuild.build_data(cfg_t), jbuild.build_data(cfg_j)
    assert dataclasses.astuple(dt.spec) == dataclasses.astuple(dj.spec)
    np.testing.assert_array_equal(dt.M, dj.M)
    for w in WINDOWS:
        _assert_coo_equal(dt.adj[w], dj.adj[w], w)
        assert dt.feats[w].dtype == dj.feats[w].dtype
        np.testing.assert_array_equal(dt.feats[w], dj.feats[w])
    assert dt.edge_index is dj.edge_index is None
    if cfg_t.dataset == "seir":
        assert dt.lp_edges is dj.lp_edges is None
        for w in WINDOWS:
            np.testing.assert_array_equal(dt.reg_targets[w], dj.reg_targets[w])
    else:
        assert dt.reg_targets is dj.reg_targets is None
        if not native.available():
            pytest.skip("the JAX package's C++ sampler did not load: it draws other negatives")
        np.testing.assert_array_equal(dt.lp_edges, dj.lp_edges)
        np.testing.assert_array_equal(dt.lp_labels, dj.lp_labels)


def test_sbm_window_spec_scales_with_t():
    """35/5/10 at T = 50, 7/1/2 at T = 10; SEIR 80/10/10 and 16/2/2."""
    spec = tbuild._sbm_window_spec(tpresets.get_preset("sbm_tmgcn_lp"))
    assert (spec.s_train, spec.s_val, spec.s_test, spec.same_block_size) == (35, 5, 10, True)
    cfg = dataclasses.replace(tpresets.get_preset("sbm_tmgcn_lp"), **SMALL_SBM)
    assert (tbuild._sbm_window_spec(cfg).s_train, tbuild._sbm_window_spec(cfg).s_val) == (7, 1)
    spec = tbuild._seir_window_spec(tpresets.get_preset("seir_tmgcn_reg"))
    assert (spec.s_train, spec.s_val, spec.s_test) == (80, 10, 10)
    cfg = dataclasses.replace(tpresets.get_preset("seir_tmgcn_reg"), **SMALL_SEIR)
    assert tbuild._seir_window_spec(cfg).s_train == 16


def _float32_feats(build_data):
    """The JAX build_data with float32 features (and regression targets):
    what the JAX package holds with x64 off, its default."""
    def built(cfg, *args, **kwargs):
        data = build_data(cfg, *args, **kwargs)
        data.feats = {w: f.astype(np.float32) for w, f in data.feats.items()}
        if data.reg_targets is not None:
            data.reg_targets = {w: y.astype(np.float32) for w, y in data.reg_targets.items()}
        return data

    return built


def jax_initial_variables(cfg_j, n_slices: int, in_feat: int) -> dict:
    """The variables the JAX run_experiment draws for its first run: the
    model's init under the first split of PRNGKey(seed)."""
    _, sub = jax.random.split(jax.random.PRNGKey(cfg_j.seed))
    model = jbuild.build_model(cfg_j, n_slices, in_feat)
    return jax.tree.map(np.asarray, model.init(sub))


def run_both(monkeypatch, cfg_t, cfg_j, n_epochs: int, data_dirs: dict | None = None,
             alpha_vec: tuple | None = None):
    """run_experiment of each package on the CPU from the JAX package's
    initial variables; (port's results, JAX's results, port's adapter).
    ``data_dirs`` maps "torch" and "jax" to each side's raw copy (none for
    the generated SEIR and SBM data); ``alpha_vec`` as run_experiment's."""
    monkeypatch.setattr(jbuild, "build_data", _float32_feats(jbuild.build_data))
    seen = {}
    for maker in ("make_edge_adapter", "make_regression_adapter"):
        real = getattr(tbuild, maker)

        def wrapped(model, adj, feats, *args, _real=real, **kwargs):
            in_feat = feats["train"].shape[-1]
            variables = params_from_jax(jax_initial_variables(cfg_j, model.n_slices, in_feat))
            adapter = _real(model, adj, feats, *args, **kwargs)
            seen["adapter"] = adapter
            return dataclasses.replace(adapter, init=lambda generator: variables)

        monkeypatch.setattr(tbuild, maker, wrapped)
    dirs = data_dirs or {}
    res_t = tbuild.run_experiment(cfg_t, data_dir=dirs.get("torch"), n_epochs=n_epochs,
                                  alpha_vec=alpha_vec, verbose=False, device="cpu")
    res_j = jbuild.run_experiment(cfg_j, data_dir=dirs.get("jax"), n_epochs=n_epochs,
                                  alpha_vec=alpha_vec, verbose=False)
    assert res_t["results"].keys() == res_j["results"].keys()
    return res_t["results"], res_j["results"], seen["adapter"]


def assert_losses_close(got, ref, rtol=1e-4):
    """Losses within rtol where the JAX loss is finite and below 1e6; both
    sides non-finite from the same epoch on (a diverging preset)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ok = np.isfinite(ref) & (np.abs(ref) < 1e6)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=rtol)
    bad_t, bad_j = np.flatnonzero(~np.isfinite(got)), np.flatnonzero(~np.isfinite(ref))
    assert bad_t[:1].tolist() == bad_j[:1].tolist()


@pytest.mark.parametrize("preset", SBM_PRESETS)
def test_sbm_preset_runs_like_jax(monkeypatch, preset):
    """Each SBM LP preset at the small size, 5 epochs (evaluations at 0 and
    3): the port's run_experiment against the JAX package's."""
    if not native.available():
        pytest.skip("the JAX package's C++ sampler did not load: it draws other negatives")
    cfg_t, cfg_j = _configs(preset, **SMALL_SBM)
    cfg_t = dataclasses.replace(cfg_t, eval_every=EVAL_EVERY)
    cfg_j = dataclasses.replace(cfg_j, eval_every=EVAL_EVERY)
    res_t, res_j, adapter = run_both(monkeypatch, cfg_t, cfg_j, EPOCHS)
    if cfg_t.method == "evolvegcn":
        assert "ax_srcT" in adapter.bundles["train"]  # the gather-free path at this size
    (key,) = res_t
    got, ref = res_t[key], np.asarray(res_j[key])
    assert got.shape == ref.shape == (EPOCHS, 9)
    for col in (2, 5, 8):
        assert_losses_close(got[:, col], ref[:, col])
    rates = [0, 1, 3, 4, 6, 7]
    finite = np.isfinite(ref[:, 2])[:, None]
    np.testing.assert_array_equal(np.isnan(got[:, rates]) & finite,
                                  np.isnan(ref[:, rates]) & finite)
    np.testing.assert_allclose(np.where(finite, got[:, rates], 0),
                               np.where(finite, ref[:, rates], 0), rtol=1e-3)


def test_sbm_evolvegcn_takes_the_generic_path_at_full_width():
    """N = 1,000, 50 slices (sbm_evolvegcn_lp_tuned): the (T, E) one-hot of
    a window is far over the 1-layer budget, so the adapter takes the
    generic path with the readout plan (K1 in its backward on the card)."""
    cfg = tpresets.get_preset("sbm_evolvegcn_lp_tuned")
    spec = tbuild._sbm_window_spec(cfg)
    # Every window's model edges: ~19 negatives for each of ~2,500 edges a
    # slice (p_in 0.01, p_out 0.001 over 1,000 nodes), 34 slices a window.
    edges = np.zeros((3, 34 * 50_000), np.int64)
    A = tsbm.sbm_temporal_adjacency(40, spec.s_train)
    model = tbuild.build_model(cfg, spec.s_train - 1, 2)
    assert tad._evolvegcn_path(model, {w: A for w in WINDOWS}, {w: edges for w in WINDOWS},
                               True) == "generic"


def test_cli_runs_an_sbm_preset_without_a_data_dir(monkeypatch, tmp_path):
    """``cli run sbm_tmgcn_lp_tuned --epochs 2 --device cpu`` (no
    --data-dir: the data are generated), at the small size: the results
    pickle holds (2, 9) MAP-MRR rows."""
    small = dataclasses.replace(tpresets.get_preset("sbm_tmgcn_lp_tuned"), **SMALL_SBM)
    monkeypatch.setitem(tpresets.PRESETS, "sbm_tmgcn_lp_tuned", small)
    argv = ["run", "sbm_tmgcn_lp_tuned", "--epochs", "2", "--device", "cpu", "--out",
            str(tmp_path), "--quiet"]
    assert cli.main(argv) == 0
    (pkl,) = tmp_path.glob("results_sbm_tmgcn_lp_tuned_*.pkl")
    with open(pkl, "rb") as f:
        res = pickle.load(f)
    assert res.shape == (2, 9) and np.all(np.isfinite(res[:, 2]))

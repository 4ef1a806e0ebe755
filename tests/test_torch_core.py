"""The port's host-side modules against the JAX package's.

TemporalCOO, the M-matrix constructors, the M-transform, degree features,
preprocessing, windows, .mat artifacts, presets and metrics. Inputs are
made with numpy from a seed and fed to both sides. Integer arrays must be
identical; float arrays identical too where both sides run the same numpy
or scipy code, and within 1e-12 where only the summation order differs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.configs import presets as jpresets
from tmgcn_tpu.core import mmatrix as jmm
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.ops import degree as jdeg
from tmgcn_tpu.ops import mtransform as jmt
from tmgcn_tpu.preprocess import datasets as jds
from tmgcn_tpu.preprocess import matio as jmatio
from tmgcn_tpu.preprocess import pipeline as jpipe
from tmgcn_tpu.tasks import metrics as jmetrics
from tmgcn_tpu.tasks import windows as jwin
from tmgcn_tpu.train import logging as jlog
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.configs.schema import ExperimentConfig
from tmgcn_torch.core import mmatrix as tmm
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.ops import degree as tdeg
from tmgcn_torch.ops import mtransform as tmt
from tmgcn_torch.preprocess import datasets as tds
from tmgcn_torch.preprocess import matio as tmatio
from tmgcn_torch.preprocess import pipeline as tpipe
from tmgcn_torch.tasks import metrics as tmetrics
from tmgcn_torch.tasks import windows as twin
from tmgcn_torch.train import logging as tlog

COO_FIELDS = ("rows", "cols", "vals", "nnz")


def assert_coo_equal(ours, ref, exact=True):
    assert ours.n_nodes == ref.n_nodes
    for f in COO_FIELDS:
        a, b = np.asarray(getattr(ours, f)), np.asarray(getattr(ref, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if exact or f != "vals":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=f)


def _slices(seed=0, T=4, N=30):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(T):
        n = int(rng.integers(0, 60)) if k != 2 else 0  # slice 2 empty
        out.append((rng.integers(0, N, n), rng.integers(0, N, n), rng.standard_normal(n)))
    return out, N


@pytest.fixture(scope="module")
def coo_pair():
    slices, N = _slices()
    return TemporalCOO.from_slices(slices, N, pad_multiple=16), JaxCOO.from_slices(
        slices, N, pad_multiple=16
    )


class TestTemporalCOO:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_from_slices(self, dtype):
        slices, N = _slices(1)
        assert_coo_equal(
            TemporalCOO.from_slices(slices, N, dtype=dtype),
            JaxCOO.from_slices(slices, N, dtype=dtype),
        )

    def test_from_slices_capacity(self):
        slices, N = _slices(2)
        assert_coo_equal(
            TemporalCOO.from_slices(slices, N, capacity=100),
            JaxCOO.from_slices(slices, N, capacity=100),
        )
        with pytest.raises(ValueError):
            TemporalCOO.from_slices(slices, N, capacity=1)

    def test_from_global_coo(self):
        rng = np.random.default_rng(3)
        t, r, c, v = (rng.integers(0, 5, 200), rng.integers(0, 20, 200),
                      rng.integers(0, 20, 200), rng.standard_normal(200))
        assert_coo_equal(
            TemporalCOO.from_global_coo(t, r, c, v, 6, 20, pad_multiple=8),
            JaxCOO.from_global_coo(t, r, c, v, 6, 20, pad_multiple=8),
        )

    def test_from_dense_and_to_dense(self):
        rng = np.random.default_rng(4)
        dense = (rng.random((3, 15, 15)) < 0.2) * rng.standard_normal((3, 15, 15))
        ours, ref = TemporalCOO.from_dense(dense), JaxCOO.from_dense(dense)
        assert_coo_equal(ours, ref)
        d = ours.to_dense()
        assert isinstance(d, torch.Tensor) and d.dtype == torch.float32
        np.testing.assert_array_equal(d.numpy(), np.asarray(ref.to_dense()))
        np.testing.assert_array_equal(ours.to("cpu").to_dense().numpy(), d.numpy())

    def test_transpose(self, coo_pair):
        assert_coo_equal(coo_pair[0].transpose(), coo_pair[1].transpose())

    @pytest.mark.parametrize("with_values", [False, True])
    def test_edge_list(self, coo_pair, with_values):
        ours = coo_pair[0].edge_list(with_values)
        ref = coo_pair[1].edge_list(with_values)
        if with_values:
            np.testing.assert_array_equal(ours[0], ref[0])
            np.testing.assert_array_equal(ours[1], ref[1])
        else:
            np.testing.assert_array_equal(ours, ref)

    def test_slice_window_and_astype(self, coo_pair):
        assert_coo_equal(coo_pair[0].slice_window(1, 3), coo_pair[1].slice_window(1, 3))
        assert_coo_equal(coo_pair[0].astype(np.float64), coo_pair[1].astype(np.float64))
        moved = coo_pair[0].to("cpu")
        assert moved.astype(torch.float64).vals.dtype == torch.float64
        assert moved.n_slices == 4 and moved.capacity == coo_pair[1].capacity


class TestMMatrix:
    @pytest.mark.parametrize(
        "weight,row_normalize", [("inverse", False), ("ones", True), ("ones", False)]
    )
    @pytest.mark.parametrize("T,n_diag", [(80, 20), (7, 20), (10, 3)])
    def test_make_m_matrix(self, weight, row_normalize, T, n_diag):
        np.testing.assert_array_equal(
            tmm.make_m_matrix(T, n_diag, weight, row_normalize),
            jmm.make_m_matrix(T, n_diag, weight, row_normalize),
        )

    def test_make_m_dct_and_band_offsets(self):
        np.testing.assert_array_equal(tmm.make_m_dct(9), jmm.make_m_dct(9))
        M = jmm.make_m_matrix(12, 4)
        assert tmm.band_offsets(M) == jmm.band_offsets(M) == (3, 0)
        with pytest.raises(ValueError):
            tmm.make_m_matrix(4, weight="nope")


class TestMTransform:
    def test_m_transform_coo(self):
        slices, N = _slices(5, T=8)
        C_t = TemporalCOO.from_slices(slices, N, dtype=np.float64)
        C_j = JaxCOO.from_slices(slices, N, dtype=np.float64)
        M = jmm.make_m_matrix(8, 4)
        ours, ref = tmt.m_transform_coo(C_t, M), jmt.m_transform_coo(C_j, M)
        assert int(np.sum(ours.nnz)) == int(np.sum(ref.nnz))
        assert_coo_equal(ours, ref, exact=False)

    @pytest.mark.parametrize("family", ["banded", "dct"])
    def test_m_transform_and_inverse(self, family):
        rng = np.random.default_rng(6)
        T = 7
        M = jmm.make_m_matrix(T, 3) if family == "banded" else jmm.make_m_dct(T)
        X = rng.standard_normal((T, 5, 3))
        out = tmt.m_transform(torch.from_numpy(M), torch.from_numpy(X))
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jmt.m_transform(jnp.asarray(M), jnp.asarray(X))), atol=1e-12
        )
        inv = tmt.m_transform_inverse(torch.from_numpy(M), out)
        np.testing.assert_allclose(
            inv.numpy(), np.asarray(jmt.m_transform_inverse(jnp.asarray(M), jnp.asarray(out.numpy()))),
            atol=1e-10,
        )
        np.testing.assert_allclose(inv.numpy(), X, atol=1e-10)


def test_degree_features(coo_pair):
    np.testing.assert_array_equal(
        tdeg.degree_features_np(coo_pair[0]), jdeg.degree_features_np(coo_pair[1])
    )


def _raw_inputs(seed=7, E=400):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, 41, E)
    dst = rng.integers(1, 41, E)
    w = rng.choice([-1.0, 1.0, 2.0], E)
    ts = rng.integers(0, 30, E).astype(np.float64) * 3600.0
    return src, dst, w, ts


class TestPipeline:
    @pytest.mark.parametrize("time_delta,cap", [(None, None), (7200.0, None), (3600.0, 12)])
    def test_bin_edges(self, time_delta, cap):
        args = _raw_inputs()
        ours = tpipe.bin_edges(*args, time_delta, cap)
        ref = jpipe.bin_edges(*args, time_delta, cap)
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(getattr(ours, f.name), getattr(ref, f.name), f.name)

    @pytest.mark.parametrize("kind", ["sym", "col", "sym_mean"])
    def test_stages(self, kind):
        raw_t = tpipe.bin_edges(*_raw_inputs(8), None)
        raw_j = jpipe.bin_edges(*_raw_inputs(8), None)
        A_t, L_t = tpipe.build_tensors(raw_t, 16)
        A_j, L_j = jpipe.build_tensors(raw_j, 16)
        assert_coo_equal(A_t, A_j)
        assert_coo_equal(L_t, L_j)
        assert_coo_equal(tpipe.symmetrize(A_t, 16), jpipe.symmetrize(A_j, 16))
        assert_coo_equal(tpipe.apply_edge_life(A_t, 3, 16), jpipe.apply_edge_life(A_j, 3, 16))
        assert_coo_equal(
            tpipe.normalize_laplacian(A_t, 16, kind), jpipe.normalize_laplacian(A_j, 16, kind)
        )

    def test_filter_nodes_by_column_sum(self):
        raw_t = tpipe.bin_edges(*_raw_inputs(9), None)
        raw_j = jpipe.bin_edges(*_raw_inputs(9), None)
        ours = tpipe.filter_nodes_by_column_sum(raw_t, 12.0)
        ref = jpipe.filter_nodes_by_column_sum(raw_j, 12.0)
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(getattr(ours, f.name), getattr(ref, f.name), f.name)

    @pytest.mark.parametrize("m_family", ["banded", "dct"])
    def test_preprocess(self, m_family):
        cfg_kw = dict(s_train=10, s_val=3, s_test=3, time_delta=None, m_family=m_family,
                      n_diagonals=4, pad_multiple=16)
        ours = tpipe.preprocess(tpipe.bin_edges(*_raw_inputs(10), None),
                                tpipe.PreprocessConfig(**cfg_kw))
        ref = jpipe.preprocess(jpipe.bin_edges(*_raw_inputs(10), None),
                               jpipe.PreprocessConfig(**cfg_kw))
        np.testing.assert_array_equal(ours.M, ref.M)
        assert_coo_equal(ours.C, ref.C)
        for w in ("train", "val", "test"):
            assert_coo_equal(ours.C_windows[w], ref.C_windows[w])
            assert_coo_equal(ours.Ct_windows[w], ref.Ct_windows[w])


class TestArtifacts:
    def _pre(self, lib):
        cfg = lib.PreprocessConfig(10, 3, 3, time_delta=None, n_diagonals=4, pad_multiple=16)
        return lib.preprocess(lib.bin_edges(*_raw_inputs(11), None), cfg)

    @pytest.mark.parametrize("writer", ["torch", "jax"])
    def test_artifacts_interchange(self, tmp_path, writer):
        """Either package's .mat cache loads identically in both."""
        path = tmp_path / "saved_content_x.mat"
        if writer == "torch":
            tmatio.save_artifact(path, self._pre(tpipe))
        else:
            jmatio.save_artifact(path, self._pre(jpipe))
        ours = tmatio.load_artifact(path, s_train=10, min_slices=16)
        ref = jmatio.load_artifact(path, s_train=10, min_slices=16)
        for key in ("A_labels", "A_binary", "A", "C"):
            assert_coo_equal(ours[key], ref[key])
        for w in ("train", "val", "test"):
            assert_coo_equal(ours["Ct"][w], ref["Ct"][w])
        np.testing.assert_array_equal(ours["M"], ref["M"])
        assert (ours["n_nodes"], ours["n_slices"]) == (ref["n_nodes"], ref["n_slices"])

    def test_saved_files_have_the_same_content(self, tmp_path):
        import scipy.io as sio

        tmatio.save_artifact(tmp_path / "t.mat", self._pre(tpipe))
        jmatio.save_artifact(tmp_path / "j.mat", self._pre(jpipe))
        a, b = sio.loadmat(str(tmp_path / "t.mat")), sio.loadmat(str(tmp_path / "j.mat"))
        keys = {k for k in b if not k.startswith("__")}
        assert {k for k in a if not k.startswith("__")} == keys
        for k in keys:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class TestDatasets:
    def test_registry(self):
        assert set(tds.REGISTRY) == set(jds.REGISTRY)
        for name, spec in jds.REGISTRY.items():
            ours = tds.REGISTRY[name]
            assert dataclasses.asdict(ours) == dataclasses.asdict(spec), name

    def test_load_raw(self, tmp_path):
        """The numpy parser on a raw file in the chess format."""
        src, dst, w, ts = _raw_inputs(12, E=50)
        lines = ["% header"] + [f"{a} {b} {c} {d}" for a, b, c, d in zip(src, dst, w, ts)]
        (tmp_path / "out.chess.csv").write_text("\n".join(lines) + "\n")
        ours = tds.load_raw(tds.REGISTRY["chess"], tmp_path)
        ref = jds.load_raw(jds.REGISTRY["chess"], tmp_path)
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(getattr(ours, f.name), getattr(ref, f.name), f.name)


class TestWindows:
    @pytest.mark.parametrize("same_block", [True, False])
    def test_window_features_and_bounds(self, same_block):
        spec_t = twin.WindowSpec(8, 2, 3, same_block)
        spec_j = jwin.WindowSpec(8, 2, 3, same_block)
        X = np.arange(13 * 2 * 1.0).reshape(13, 2, 1)
        for w in ("train", "val", "test"):
            assert spec_t.bounds(w) == spec_j.bounds(w)
            np.testing.assert_array_equal(
                twin.window_features(X, spec_t)[w], jwin.window_features(X, spec_j)[w]
            )
        with pytest.raises(ValueError):
            spec_t.bounds("nope")

    @pytest.mark.parametrize("n_classes,same_block", [(2, True), (3, True), (3, False)])
    def test_split_edges_classification(self, n_classes, same_block):
        rng = np.random.default_rng(13)
        E = 300
        edges = np.stack([rng.integers(0, 13, E), rng.integers(0, 9, E), rng.integers(0, 9, E)])
        vals = rng.choice([-1.0, 0.0, 1.0], E)
        ours = twin.split_edges_classification(
            edges, vals, twin.WindowSpec(8, 2, 3, same_block), n_classes
        )
        ref = jwin.split_edges_classification(
            edges, vals, jwin.WindowSpec(8, 2, 3, same_block), n_classes
        )
        for w in ("train", "val", "test"):
            for f in ("edges", "target", "eval_mask"):
                np.testing.assert_array_equal(getattr(ours[w], f), getattr(ref[w], f), f)


class TestConfigs:
    def test_presets_registry(self):
        assert set(tpresets.PRESETS) == set(jpresets.PRESETS)
        for name, cfg in jpresets.PRESETS.items():
            assert dataclasses.asdict(tpresets.get_preset(name)) == dataclasses.asdict(cfg), name
        with pytest.raises(KeyError):
            tpresets.get_preset("nope")

    def test_schema_validation(self):
        with pytest.raises(ValueError):
            ExperimentConfig(name="x", dataset="chess", method="nope", task="edge_cls")
        with pytest.raises(ValueError):
            ExperimentConfig(name="x", dataset="chess", method="tmgcn", task="edge_cls",
                             hidden_feat=(6, 6, 3))


class TestMetricsAndLogging:
    def test_precision_recall_f1(self):
        rng = np.random.default_rng(14)
        guess, tgt = rng.integers(0, 3, 500), rng.integers(0, 3, 500)
        assert tmetrics.precision_recall_f1(guess, tgt) == jmetrics.precision_recall_f1(guess, tgt)
        p, r, f1 = tmetrics.precision_recall_f1(np.ones(5), np.zeros(5))
        assert np.isnan(p) and r == 0.0 and np.isnan(f1)

    def test_weighted_ce_loss_np(self):
        rng = np.random.default_rng(15)
        logits, tgt = rng.standard_normal((40, 3)), rng.integers(0, 3, 40)
        w = np.array([0.3, 0.3, 0.4])
        assert tmetrics.weighted_ce_loss_np(logits, tgt, w) == jmetrics.weighted_ce_loss_np(
            logits, tgt, w
        )

    def test_logging(self, tmp_path):
        rng = np.random.default_rng(16)
        res = rng.random((25, 12))
        assert tlog.summarize(res, 10) == jlog.summarize(res, 10)
        tlog.write_metrics_jsonl(tmp_path / "t.jsonl", res, 10, {"preset": "x"})
        jlog.write_metrics_jsonl(tmp_path / "j.jsonl", res, 10, {"preset": "x"})
        import json

        def strip(path):
            recs = [json.loads(line) for line in path.read_text().splitlines()]
            return [{k: v for k, v in r.items() if k != "timestamp"} for r in recs]

        assert strip(tmp_path / "t.jsonl") == strip(tmp_path / "j.jsonl")
        with pytest.raises(ValueError):
            tlog.summarize(rng.random((5, 4)), 2)

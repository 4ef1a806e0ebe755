"""The data path of the 32 presets on the registry's other datasets, bitwise
the JAX package's: parse -> bin -> build_data -> LP negatives.

``load_raw`` (with the port's native parser, and with its plain version
``parse_edges_numpy`` in its place) against the JAX package's on each raw format: comma CSV
(bitcoin_otc, bitcoin_alpha), the reddit TSV (a header row, columns (0, 1,
4, 3)), amlsim's ``transactions.csv`` (a header, columns (1, 2, 7, 5)) and
uci's whitespace text with fractional-day timestamps. Then ``build_data``
of every preset against the JAX package's from ``cfg.seed``: the window
spec, each window's adjacency (Ct for TM-GCN, the disjoint windows of C
for the baselines), the degree features, M, the labelled edges and their
values, and for link prediction the augmented edges and labels (19
negatives per real edge, the splitmix64 stream). Each side reads its own
copy of data/synthetic/<name>/ in a temporary directory; the first preset
of a dataset builds from the raw file and writes the .mat cache that the
later ones load, on both sides alike.
"""

import dataclasses

import numpy as np
import pytest

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.test_torch_core import assert_coo_equal
from tests.torch_registry import DATASETS, PRESETS, WINDOWS, raw_copies
from tmgcn_tpu import native as jnative
from tmgcn_tpu.configs import build as jbuild
from tmgcn_tpu.configs import presets as jpresets
from tmgcn_tpu.preprocess import datasets as jds
from tmgcn_torch import native
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.preprocess import datasets as tds


def test_the_32_presets():
    assert len(PRESETS) == 32
    by = {(c.dataset, c.task) for c in map(tpresets.get_preset, PRESETS)}
    assert by == {(d, "edge_cls") for d in DATASETS if d != "uci"} | {
        (d, "link_pred") for d in DATASETS if d != "amlsim"}
    assert set(PRESETS) == {n for n, c in jpresets.PRESETS.items() if c.dataset in DATASETS}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    with raw_copies(tmp_path_factory.mktemp("registry"), DATASETS) as copies:
        yield copies


@pytest.mark.parametrize("dataset", DATASETS)
def test_load_raw_matches_jax(dirs, dataset, monkeypatch):
    if not jnative.available():
        pytest.skip("the JAX package's native parser did not load")
    ref = jds.load_raw(jds.REGISTRY[dataset], dirs["jax"][dataset])
    for impl in ("native", "numpy"):
        if impl == "numpy":
            monkeypatch.setattr(native, "parse_edges", tds.parse_edges_numpy)
        got = tds.load_raw(tds.REGISTRY[dataset], dirs["torch"][dataset])
        for f in dataclasses.fields(ref):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            assert type(a) is type(b), f.name
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, (impl, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{impl} {f.name}")
    assert got.n_slices >= tds.REGISTRY[dataset].preprocess.s_train


def _same(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("preset", PRESETS)
def test_build_data_matches_jax(dirs, preset):
    cfg_t, cfg_j = tpresets.get_preset(preset), jpresets.get_preset(preset)
    if cfg_t.task == "link_pred" and not jnative.available():
        pytest.skip("the JAX package's C++ sampler did not load: it draws other negatives")
    got = tbuild.build_data(cfg_t, data_dir=dirs["torch"][cfg_t.dataset])
    ref = jbuild.build_data(cfg_j, data_dir=dirs["jax"][cfg_j.dataset])
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(ref.spec)
    for w in WINDOWS:
        assert_coo_equal(got.adj[w], ref.adj[w])
        _same(got.feats[w], ref.feats[w], f"feats {w}")
    for f in ("M", "edge_index", "edge_values", "lp_edges", "lp_labels"):
        _same(getattr(got, f), getattr(ref, f), f)
    assert got.reg_targets is None and ref.reg_targets is None
    if cfg_t.task == "link_pred":
        assert int((got.lp_labels == 0).sum()) * 20 == got.lp_labels.size

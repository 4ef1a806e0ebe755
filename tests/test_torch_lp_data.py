"""The port's link-prediction data and metrics against the JAX package.

Inputs are made with numpy from a seed. Comparisons:

* ``augment_edges``: bitwise (values and dtype), in both streams — the
  default splitmix64 stream against the JAX package with its C++ sampler
  loaded, the ``default_rng`` stream against the JAX package with
  ``tmgcn_tpu.native.available`` patched to return False (the patch lives in
  the test and edits nothing);
* ``split_data_link_prediction`` and ``pad_edges``: bitwise;
* the metrics: exact where the function is a count or a copy, rtol 1e-12
  otherwise (float64 sums in the same order on both sides), on inputs with
  ties, zeros, negative scores, duplicate (i, j) pairs and rows without a
  label 0; ``mrr_from_edges`` also against the dense oracle, rtol 1e-12.
"""

import numpy as np
import pytest

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tmgcn_tpu import native
from tmgcn_tpu.tasks import metrics as jm
from tmgcn_tpu.tasks import sampling as js
from tmgcn_tpu.tasks import windows as jw
from tmgcn_torch.tasks import metrics as tm
from tmgcn_torch.tasks import sampling as ts
from tmgcn_torch.tasks import windows as tw


def _real_edges(seed: int, n_nodes: int, dtype=np.int64):
    """Real edges over 7 slices, slice 2 empty, duplicates possible."""
    rng = np.random.default_rng(seed)
    E = 120
    slices = rng.choice([0, 1, 3, 4, 5, 6], E)
    return np.stack([np.sort(slices), rng.integers(0, n_nodes, E),
                     rng.integers(0, n_nodes, E)]).astype(dtype)


SAMPLER_CASES = [
    (seed, betas, n_nodes)
    for seed in (0, 3)
    for betas in ((3, 2, 2), (19, 19, 95), (1, 4, 0))
    for n_nodes in (6, 50, 7301)
]


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed,betas,n_nodes", SAMPLER_CASES)
def test_augment_edges_splitmix64_matches_jax_native(seed, betas, n_nodes):
    if not native.available():
        pytest.skip("the JAX package's C++ sampler did not load")
    edges = _real_edges(seed, n_nodes)
    _assert_same(ts.augment_edges(edges, n_nodes, *betas, seed=seed),
                 js.augment_edges(edges, n_nodes, *betas, seed=seed))


@pytest.mark.parametrize("seed,betas,n_nodes", SAMPLER_CASES)
def test_augment_edges_default_rng_matches_jax_fallback(monkeypatch, seed, betas, n_nodes):
    edges = _real_edges(seed, n_nodes)
    monkeypatch.setattr(native, "available", lambda: False)
    _assert_same(ts.augment_edges(edges, n_nodes, *betas, seed=seed, sampler="default_rng"),
                 js.augment_edges(edges, n_nodes, *betas, seed=seed))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("sampler", ["splitmix64", "default_rng"])
def test_augment_edges_dtypes_and_semantics(monkeypatch, dtype, sampler):
    edges = _real_edges(1, 9, dtype)
    aug, labels = ts.augment_edges(edges, 9, 3, 5, 4, seed=1, sampler=sampler)
    if sampler == "default_rng":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the JAX package's C++ sampler did not load")
    _assert_same((aug, labels), js.augment_edges(edges, 9, 3, 5, 4, seed=1))
    # Reals first within a slice (stable sort), labelled 0; fakes never a real key.
    for j in range(7):
        m = aug[0] == j
        real = edges[0] == j
        beta = 3 if j < 4 else 5
        assert labels[m].tolist() == [0] * int(real.sum()) + [1] * beta * int(real.sum())
        keys = set((edges[1, real] * 9 + edges[2, real]).tolist())
        fakes = m & (labels == 1)
        assert not keys & set((aug[1, fakes] * 9 + aug[2, fakes]).tolist())


def test_splitmix64_stream_is_the_c_stream():
    """The first draws of one slice, computed by hand from the C++ source."""
    mask = (1 << 64) - 1

    def c_stream(seed, n):
        state = seed ^ 0xDA3E39CB94B95BDB
        out = []
        for _ in range(n):
            state = (state + 0x9E3779B97F4A7C15) & mask
            z = state
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
            out.append(z ^ (z >> 31))
        return out

    seed = 5 * 0x9E3779B9 + 2
    draws = c_stream(seed, 40)
    src, trg = ts.sample_negatives_splitmix64(np.zeros(0, np.int64), 1000, 20, seed)
    assert src.tolist() == [d % 1000 for d in draws[0::2]]
    assert trg.tolist() == [d % 1000 for d in draws[1::2]]


def test_unknown_sampler_raises():
    with pytest.raises(ValueError, match="sampler"):
        ts.augment_edges(_real_edges(0, 5), 5, 1, 1, 0, sampler="uniform")


@pytest.mark.parametrize("same_block", [True, False])
@pytest.mark.parametrize("spec", [(8, 2, 2), (5, 1, 1)])
def test_split_data_link_prediction_matches_jax(same_block, spec):
    edges = _real_edges(2, 20)
    rng = np.random.default_rng(2)
    edges[0] = np.sort(rng.integers(0, 12, edges.shape[1]))
    aug, labels = ts.augment_edges(edges, 20, 2, 2, 12, seed=2)
    st = tw.split_data_link_prediction(aug, labels, tw.WindowSpec(*spec, same_block))
    sj = jw.split_data_link_prediction(aug, labels, jw.WindowSpec(*spec, same_block))
    for w in ("train", "val", "test"):
        for f in ("edges", "target", "model_edges"):
            a, b = getattr(st[w], f), getattr(sj[w], f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert st[w].n_eval_tail == sj[w].n_eval_tail
        assert (st[w].n_eval_tail is None) == (w == "train" or not same_block)


@pytest.mark.parametrize("E,multiple", [(0, 128), (5, 128), (128, 128), (300, 7)])
def test_pad_edges_matches_jax(E, multiple):
    rng = np.random.default_rng(E)
    edges = rng.integers(0, 9, (3, E)).astype(np.int32)
    target = rng.integers(0, 2, E)
    for a, b in zip(tw.pad_edges(edges, target, multiple), jw.pad_edges(edges, target, multiple)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _lp_case(seed: int, kind: str, n_nodes: int):
    """Edges of 3 slices with duplicate (i, j) pairs; logits with ties,
    zeros and negatives ("ties": small integers) or continuous; a third of
    the src rows hold no label 0."""
    rng = np.random.default_rng(seed)
    E = 400
    edges = np.stack([np.sort(rng.integers(0, 3, E)), rng.integers(0, n_nodes, E),
                      rng.integers(0, n_nodes, E)])
    if kind == "ties":
        logits = rng.integers(-2, 3, (E, 2)).astype(np.float64)
    else:
        logits = rng.standard_normal((E, 2))
    target = (rng.random(E) < 0.7).astype(np.int64)
    target[edges[1] % 3 == 0] = 1
    return logits, target, edges


METRIC_CASES = [(s, k, n) for s in (0, 1, 2) for k in ("ties", "continuous") for n in (4, 30)]


@pytest.mark.parametrize("seed,kind,n_nodes", METRIC_CASES)
def test_map_mrr_matches_jax(seed, kind, n_nodes):
    logits, target, edges = _lp_case(seed, kind, n_nodes)
    ours = tm.map_mrr(logits, target, edges)
    ref = jm.map_mrr(logits, target, edges)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(tm.softmax_pos0(logits), jm.softmax_pos0(logits))


@pytest.mark.parametrize("seed,kind,n_nodes", METRIC_CASES)
def test_mrr_and_ap_match_jax_and_the_dense_oracle(seed, kind, n_nodes):
    logits, target, edges = _lp_case(seed, kind, n_nodes)
    for k in range(3):
        m = edges[0] == k
        scores, t, adj = logits[m, 0], target[m], edges[1:3, m]
        ours = tm.mrr_from_edges(scores, t, adj)
        ref = jm.mrr_from_edges(scores, t, adj)
        dense = tm._mrr_from_edges_dense(scores, t, adj)
        assert np.isnan(ours) == np.isnan(ref) == np.isnan(dense)
        np.testing.assert_allclose(ours, ref, rtol=1e-12)
        np.testing.assert_allclose(ours, dense, rtol=1e-12)
        np.testing.assert_allclose(dense, jm._mrr_from_edges_dense(scores, t, adj), rtol=1e-12)
        probs = tm.softmax_pos0(logits[m])
        assert tm.average_precision_pos0(probs, t) == jm.average_precision_pos0(probs, t)
        assert tm.row_mrr(scores, t) == jm.row_mrr(scores, t)


def test_mrr_nan_cases():
    # No entry of label 1: no row kept -> NaN. A kept row with no label-0
    # position at all (every column explicit, all fake) -> 0/0 = NaN.
    adj = np.array([[0, 0], [0, 1]])
    assert np.isnan(tm.mrr_from_edges(np.array([1.0, 2.0]), np.array([0, 0]), adj))
    assert np.isnan(tm.mrr_from_edges(np.array([1.0, 2.0]), np.array([1, 1]), adj))
    assert np.isnan(jm.mrr_from_edges(np.array([1.0, 2.0]), np.array([1, 1]), adj))
    # Duplicate pairs sum: two label-1 entries at one (i, j) sum to 2, so
    # that row is not kept (the filter is t == 1).
    dup = np.array([[0, 0, 1, 1], [0, 0, 0, 1]])
    vals, tgt = np.array([0.3, -0.1, 0.2, 0.5]), np.array([1, 1, 1, 0])
    np.testing.assert_allclose(tm.mrr_from_edges(vals, tgt, dup),
                               tm._mrr_from_edges_dense(vals, tgt, dup), rtol=1e-12)
    assert tm.mrr_from_edges(vals, tgt, dup) == jm.mrr_from_edges(vals, tgt, dup)


def test_mrr_ties_rank_the_higher_column_first():
    # Row 0: columns 0 and 1 tie; flip(argsort(stable)) puts column 1 first.
    adj = np.array([[0, 0], [0, 1]])
    assert tm.mrr_from_edges(np.array([0.5, 0.5]), np.array([0, 1]), adj) == 0.5
    assert tm.mrr_from_edges(np.array([0.5, 0.5]), np.array([1, 0]), adj) == 1.0

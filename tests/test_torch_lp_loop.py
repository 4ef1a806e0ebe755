"""The port's link-prediction loop against the JAX package on a small graph.

One temporal graph made with numpy from a seed (12 slices of 30 nodes,
windows of 8/2/2 slices), its real edges augmented with the port's
sampler, split on both sides (asserted equal), and trained 5 epochs with
``eval_every=3`` (evaluation epochs 0 and 3, chunks of plain steps between)
from the same initial variables, carried over with ``params_from_jax``.

Every model runs in float64. The adjacency values are dyadic, the features
and the mixing matrix small dyadic numbers, so each side's float32
first-layer propagation is exact and both train from the same cached rows;
only the summation order of the float64 epochs differs. Tolerance: rtol
1e-9 on every column (losses, MAP, MRR, precision, recall, F1), NaN where
the other side is NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.models.tmgcn import TMGCN as JTMGCN
from tmgcn_tpu.models.tmgcn import TMGCN2 as JTMGCN2
from tmgcn_tpu.models.wdgcn import WDGCN as JWDGCN
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.tasks.windows import split_data_link_prediction as j_split_lp
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.tmgcn import TMGCN, TMGCN2
from tmgcn_torch.models.wdgcn import WDGCN
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks.sampling import augment_edges
from tmgcn_torch.tasks.windows import WindowSpec, split_data_link_prediction, window_features
from tmgcn_torch.train import loop as tloop

T_ALL, N, F0 = 12, 30, 2
WINDOWS = ("train", "val", "test")
CW = np.array([0.9, 0.1])
EPOCHS, EVAL_EVERY = 5, 3


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _graph(same_block: bool):
    rng = np.random.default_rng(0)
    dense = (rng.random((T_ALL, N, N)) < 0.12) * rng.choice([0.25, 0.5, 1.0], (T_ALL, N, N))
    X = rng.integers(0, 4, (T_ALL, N, F0)).astype(np.float32)
    E = 15 * T_ALL
    real = np.stack([np.sort(rng.integers(0, T_ALL, E)), rng.integers(0, N, E),
                     rng.integers(0, N, E)])
    spec = WindowSpec(8, 2, 2, same_block_size=same_block)
    edges, labels = augment_edges(real, N, 3, 2, 10, seed=4)
    splits = split_data_link_prediction(edges, labels, spec)
    splits_j = j_split_lp(edges, labels, spec)
    for w in WINDOWS:
        for f in ("edges", "target", "model_edges"):
            np.testing.assert_array_equal(getattr(splits[w], f), getattr(splits_j[w], f))
        assert splits[w].n_eval_tail == splits_j[w].n_eval_tail
    adj_t, adj_j = {}, {}
    for w in WINDOWS:
        a, b = spec.bounds(w)
        adj_t[w] = TemporalCOO.from_dense(dense[a:b], pad_multiple=16)
        adj_j[w] = JaxCOO.from_dense(dense[a:b], dtype=np.float32, pad_multiple=16)
    feats = window_features(X, spec)
    k = np.arange(spec.s_train)
    M = np.where((k[:, None] >= k[None, :]) & (k[:, None] - k[None, :] < 3),
                 0.5 ** (k[:, None] - k[None, :] + 1), 0.0).astype(np.float32)
    return splits, adj_t, adj_j, feats, M


# (family, hidden, model options, spmm_impl, loss_type, eval_type)
CASES = {
    "tmgcn1_softmax": ("tmgcn", (4, 2), {}, "jnp", "softmax", "MAP-MRR"),
    "tmgcn1_pallas": ("tmgcn", (4, 2), {}, "pallas", "softmax", "MAP-MRR"),
    "tmgcn1_sigmoid": ("tmgcn", (4, 1), {}, "jnp", "sigmoid", "MAP-MRR"),
    "tmgcn1_f1": ("tmgcn", (4, 2), {}, "jnp", "softmax", "F1"),
    "tmgcn2_restricted": ("tmgcn2", (5, 4, 2), {"nonlin2": "selu"}, "jnp", "softmax", "MAP-MRR"),
    "tmgcn2_generic": ("tmgcn2", (5, 4, 2), {"apply_M_twice": True}, "jnp", "softmax",
                       "MAP-MRR"),
    "wdgcn_softmax": ("wdgcn", (4, 2), {}, "pallas", "softmax", "MAP-MRR"),
    "wdgcn_sigmoid": ("wdgcn", (4, 1), {}, "jnp", "sigmoid", "MAP-MRR"),
    "wdgcn_f1": ("wdgcn", (4, 2), {}, "jnp", "softmax", "F1"),
}


def _models(family, hidden, opts, spmm_impl):
    T = 8 - 1  # drop_last_slice: the model consumes s_train - 1 slices
    kw = dict(n_slices=T, in_feat=F0, hidden_feat=hidden, spmm_impl=spmm_impl, **opts)
    if family == "tmgcn":
        return JTMGCN(dtype=jnp.float64, **kw), TMGCN(dtype=torch.float64, **kw)
    if family == "tmgcn2":
        return JTMGCN2(dtype=jnp.float64, **kw), TMGCN2(dtype=torch.float64, **kw)
    return (JWDGCN(dtype=jnp.float64, scan_unroll=1, **kw), WDGCN(dtype=torch.float64, **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_link_prediction_matches_jax(case):
    family, hidden, opts, spmm_impl, loss_type, eval_type = CASES[case]
    splits, adj_t, adj_j, feats, M = _graph(same_block=family != "wdgcn")
    Mw = M if family != "wdgcn" else None
    model_j, model_t = _models(family, hidden, opts, spmm_impl)
    edges = {w: splits[w].model_edges for w in WINDOWS}
    ad_j = jad.make_edge_adapter(model_j, adj_j, feats, edges, M=Mw, drop_last_slice=True)
    ad_t = tad.make_edge_adapter(model_t, adj_t, feats, edges, M=Mw, drop_last_slice=True,
                                 device="cpu")
    jvars = ad_j.init(jax.random.PRNGKey(1))
    res_j, out_j = jloop.run_link_prediction(
        ad_j, splits, CW, jloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=jvars, loss_type=loss_type, eval_type=eval_type,
    )
    res_t, out_t = tloop.run_link_prediction(
        ad_t, splits, CW, tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=params_from_jax(_np_tree(jvars)), loss_type=loss_type, eval_type=eval_type,
    )
    width = 12 if eval_type == "F1" else 9
    assert res_t.shape == res_j.shape == (EPOCHS, width)
    np.testing.assert_array_equal(np.isnan(res_t), np.isnan(res_j))
    np.testing.assert_allclose(res_t, res_j, rtol=1e-9, atol=1e-12)
    loss_cols = [3, 7, 11] if width == 12 else [2, 5, 8]
    assert np.all(np.isfinite(res_t[:, loss_cols]))
    # Every epoch trains: the training loss moves between epochs.
    assert len(np.unique(res_t[:, loss_cols[0]])) == EPOCHS
    for k, v in out_t["params"].items():
        if not isinstance(v, dict):
            np.testing.assert_allclose(v.numpy(), np.asarray(out_j["params"][k]),
                                       rtol=1e-8, atol=1e-10, err_msg=k)


def _small_adapter():
    splits, adj_t, _, feats, M = _graph(same_block=True)
    model = TMGCN(n_slices=7, in_feat=F0, hidden_feat=(4, 2), dtype=torch.float64)
    edges = {w: splits[w].model_edges for w in WINDOWS}
    return splits, tad.make_edge_adapter(model, adj_t, feats, edges, M=M,
                                         drop_last_slice=True, device="cpu")


@pytest.mark.parametrize("kwargs,error,match", [
    ({"loss_type": "hinge"}, ValueError, "loss_type"),
    ({"eval_type": "AUC"}, ValueError, "eval_type"),
    # A checkpoint past the run's 2 epochs (a 5-epoch run's, saved at 3).
    ({"checkpointer": "past"}, ValueError, "past this run's"),
])
def test_run_link_prediction_rejects(kwargs, error, match, tmp_path):
    splits, adapter = _small_adapter()
    if kwargs.get("checkpointer") == "past":
        from tmgcn_torch.train.checkpoint import RunCheckpointer

        kwargs = {"checkpointer": RunCheckpointer(tmp_path / "ck")}
        tloop.run_link_prediction(adapter, splits, CW, tloop.TrainConfig(n_epochs=5, eval_every=3),
                                  **kwargs)
    with pytest.raises(error, match=match):
        tloop.run_link_prediction(adapter, splits, CW, tloop.TrainConfig(n_epochs=2), **kwargs)


def test_sigmoid_train_rows_score_the_doubled_pairs(monkeypatch):
    """loss_type="sigmoid": the training logits reach map_mrr as the (E, 4)
    double map the JAX package scores (tmgcn_tpu/train/loop.py:316), val and
    test as (E, 2)."""
    splits, adj_t, _, feats, M = _graph(same_block=True)
    model = TMGCN(n_slices=7, in_feat=F0, hidden_feat=(4, 1), dtype=torch.float64)
    edges = {w: splits[w].model_edges for w in WINDOWS}
    adapter = tad.make_edge_adapter(model, adj_t, feats, edges, M=M, drop_last_slice=True,
                                    device="cpu")
    widths = []
    real_map_mrr = tloop.M.map_mrr

    def spy(logits, target, e):
        widths.append(np.asarray(logits).shape[1])
        return real_map_mrr(logits, target, e)

    monkeypatch.setattr(tloop.M, "map_mrr", spy)
    tloop.run_link_prediction(adapter, splits, CW, tloop.TrainConfig(n_epochs=1),
                              loss_type="sigmoid")
    assert widths == [4, 2, 2]

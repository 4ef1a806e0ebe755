"""The EvolveGCN-H slice against the JAX package: the adapter's three paths
(gather-free 1 layer, restricted 2 layers, the generic staged path) and the
chess_evolvegcn_cls and chess_evolvegcn2_cls presets at full width
(tests/test_torch_evolvegcn_lp.py holds chess_evolvegcn_lp and the scale
benchmark's evolvegcn family).

Inputs are made with numpy from a seed; JAX's initial variables are carried
across with ``params_from_jax``. The JAX adapters get float32 features, as
the JAX package holds them with x64 off (its default): with x64 on, as
tests/conftest.py sets it, float64 features would change the type of its
GRU carry. Tolerances: adapters float32 1e-5 for logits and carries, 1e-4
for gradients through the GRU loop (tests/test_torch_wdgcn.py's); slices
losses rtol 1e-4, MAP/MRR rtol 1e-3, F1 within 1e-3 (see
``_assert_f1_close`` for evaluation windows whose logits tie).
"""

import dataclasses
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.configs import build as jbuild
from tmgcn_tpu.configs import presets as jpresets
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.models import evolvegcn as jev
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.tasks.windows import split_edges_classification as j_split
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models import evolvegcn as tev
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks import metrics as M
from tmgcn_torch.tasks.windows import split_edges_classification as t_split
from tmgcn_torch.train import loop as tloop

T, N, F0, C = 6, 40, 2, 3
WINDOWS = ("train", "val", "test")
# (hidden, embed_dtype, the path both packages take)
PATHS = {
    "gather_free": ((5, C), None, "gather_free"),
    "restricted": ((5, 4, C), None, "restricted"),
    "generic1": ((5, C), jnp.float64, "generic"),
    "generic2": ((5, 4, C), jnp.float64, "generic"),
}


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _jax_path(bundle) -> str:
    """Which path the JAX adapter took, by the keys its bundles carry."""
    if "ax_srcT" in bundle:
        return "gather_free"
    return "restricted" if "l2op" in bundle else "generic"


def _small_windows():
    rng = np.random.default_rng(0)
    dense = (rng.random((T, N, N)) < 0.1) * rng.random((T, N, N))
    X = rng.integers(0, 4, (T, N, F0)).astype(np.float32)  # degree-like: ties
    edict = {w: np.stack([np.sort(rng.integers(0, T, n)), rng.integers(0, N, n),
                          rng.integers(0, N, n)]) for w, n in zip(WINDOWS, (50, 20, 30))}
    return dense, X, edict


def _adapters(path):
    hidden, embed, _ = PATHS[path]
    dense, X, edict = _small_windows()
    feats = {w: X for w in WINDOWS}
    A_t = TemporalCOO.from_dense(dense, pad_multiple=16)
    A_j = JaxCOO.from_dense(dense, pad_multiple=16)
    jmodel = jev.EvolveGCN(n_slices=T, in_feat=F0, hidden_feat=hidden, embed_dtype=embed)
    tmodel = tev.EvolveGCN(n_slices=T, in_feat=F0, hidden_feat=hidden,
                           embed_dtype=None if embed is None else torch.float64)
    ja = jad.make_edge_adapter(jmodel, {w: A_j for w in WINDOWS}, feats, edict)
    ta = tad.make_edge_adapter(tmodel, {w: A_t for w in WINDOWS}, feats, edict, device="cpu")
    return ja, ta


@pytest.mark.parametrize("path", list(PATHS))
def test_adapter_paths_match_jax(path):
    """Logits, every parameter's gradient and the carry on each window,
    train -> val -> test threaded as the loops thread it."""
    ja, ta = _adapters(path)
    assert _jax_path(ja.bundles["train"]) == PATHS[path][2]
    assert ("ax_srcT" in ta.bundles["train"]) == (PATHS[path][2] == "gather_free")
    assert ("l2op" in ta.bundles["train"]) == (PATHS[path][2] == "restricted")
    jvars = _np_tree(ja.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(9)
    tvars = params_from_jax(jvars)
    for _, v in _leaves(tvars["params"]):
        v.requires_grad_(True)
    out, carry_t = ta.apply(tvars, ta.bundles["train"], ())
    g = rng.standard_normal(out.shape).astype(np.float32)
    (out * torch.from_numpy(g).to(out.dtype)).sum().backward()

    def f(p):
        o, fin = ja.apply({"params": p, "buffers": jvars["buffers"]}, ja.bundles["train"], ())
        return jnp.vdot(o, jnp.asarray(g, o.dtype)), (o, fin)

    (_, (ref, carry_j)), grads = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, jvars["params"]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ours, theirs = dict(_leaves(tvars["params"])), dict(_leaves(_np_tree(grads)))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(ours[k].grad.numpy(), theirs[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    with torch.no_grad():
        for w in WINDOWS:
            if w != "train":
                out, carry_t = ta.apply(tvars, ta.bundles[w], carry_t)
                ref, carry_j = ja.apply(jvars, ja.bundles[w], carry_j)
                np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5,
                                           err_msg=w)
            assert len(carry_t) == len(carry_j) == len(PATHS[path][0]) - 1
            for a, b in zip(carry_t, carry_j):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                           err_msg=w)
            carry_t = tuple(c.detach() for c in carry_t)
    # The next window evolves from the carry: from W_init its logits differ.
    with torch.no_grad():
        fresh, _ = ta.apply(tvars, ta.bundles["test"], ())
    assert not torch.allclose(fresh, out)


def test_one_hot_budgets_are_the_jax_package_s():
    assert tad.ONEHOT_BUDGET_1LAYER == 128 << 20
    assert tad.ONEHOT_BUDGET_RESTRICTED == 256 << 20


def test_scale_shape_takes_the_generic_path():
    """500k nodes x 64 slices, 1M labelled edges: the (T, E) one-hot is
    244 MiB, over the 1-layer budget, so the scale step runs the generic
    path with the readout plan (K2 on the card)."""
    A = TemporalCOO(rows=np.zeros((64, 1), np.int32), cols=np.zeros((64, 1), np.int32),
                    vals=np.zeros((64, 1), np.float32), nnz=np.zeros(64, np.int32),
                    n_nodes=500_000)
    edges = np.zeros((3, 1_000_000), np.int64)
    model = tev.EvolveGCN(n_slices=64, in_feat=2, hidden_feat=(6, 2))
    adj = {w: A for w in WINDOWS}
    assert tad._evolvegcn_path(model, adj, {w: edges for w in WINDOWS}, False) == "generic"
    few = {w: edges[:, :500_000] for w in WINDOWS}  # 122 MiB: under the budget
    assert tad._evolvegcn_path(model, adj, few, False) == "gather_free"


CHESS = Path(__file__).resolve().parents[1] / "data" / "chess" / "out.chess.csv"
EPOCHS, EVAL_EVERY = 5, 3


@pytest.fixture(scope="module")
def chess_dirs(tmp_path_factory):
    dirs = {}
    for side in ("torch", "jax"):
        d = tmp_path_factory.mktemp(f"chess_evolvegcn_{side}")
        shutil.copy(CHESS, d / CHESS.name)
        dirs[side] = d
    return dirs


def _f1_range(logits: np.ndarray, target: np.ndarray, rel: float = 1e-5) -> tuple:
    """Class-0 F1 with every tied edge predicted right, and every one wrong.
    An edge is tied when its class-0 logit is within ``rel`` (of the logits'
    scale) of the best other class: its prediction is float rounding, in
    either package."""
    other = np.max(logits[:, 1:], axis=1)
    tied = np.abs(logits[:, 0] - other) <= rel * max(1.0, float(np.abs(logits).max()))
    guess = np.argmax(logits, axis=1)
    right = np.where(tied, np.where(target == 0, 0, 1), guess)
    wrong = np.where(tied, np.where(target == 0, 1, 0), guess)
    return tuple(M.precision_recall_f1(g, target)[2] for g in (right, wrong))


def _assert_f1_close(res_t, res_j, eval_logits, splits):
    """Train F1 within 1e-3. Val and test F1: the JAX package's within 1e-3
    of the range the port's own evaluation logits allow once their tied
    edges (class-0 logit within 1e-5 of the best other, relative to the
    logits' scale) go either way. NaN where the other side is NaN."""
    np.testing.assert_array_equal(np.isnan(res_t[:, 2]), np.isnan(res_j[:, 2]))
    np.testing.assert_allclose(res_t[:, 2], res_j[:, 2], atol=1e-3)
    eval_epochs = list(range(0, EPOCHS, EVAL_EVERY))
    assert len(eval_logits) == 2 * len(eval_epochs)
    for i, ep in enumerate(eval_epochs):
        for j, (wname, col) in enumerate((("val", 6), ("test", 10))):
            s = splits[wname]
            lo, hi = sorted(_f1_range(eval_logits[2 * i + j][s.eval_mask], s.target[s.eval_mask]),
                            key=lambda v: (np.isnan(v), v))
            got = res_j[ep, col]
            if np.isnan(got):
                assert np.isnan(lo) or np.isnan(hi) or np.isnan(res_t[ep, col]), (ep, wname)
            else:
                finite = [v for v in (lo, hi) if not np.isnan(v)]
                assert min(finite) - 1e-3 <= got <= max(finite) + 1e-3, (ep, wname, got, lo, hi)


def _recording(adapter):
    """The adapter with its evaluation forwards' logits recorded."""
    logits = []
    apply = adapter.apply

    def recorded(variables, bundle, carry):
        out, carry = apply(variables, bundle, carry)
        if not torch.is_grad_enabled():
            logits.append(out.numpy())
        return out, carry

    return dataclasses.replace(adapter, apply=recorded), logits


@pytest.fixture(scope="module")
def chess_cls(chess_dirs):
    """The chess classification data (the same for both presets) of each side."""
    return (jbuild.build_data(jpresets.get_preset("chess_evolvegcn_cls"),
                              data_dir=chess_dirs["jax"]),
            tbuild.build_data(tpresets.get_preset("chess_evolvegcn_cls"),
                              data_dir=chess_dirs["torch"]))


@pytest.mark.parametrize("preset", ["chess_evolvegcn_cls", "chess_evolvegcn2_cls"])
def test_chess_cls_short_run_matches_jax(chess_cls, preset):
    """5 epochs (evaluations at epochs 0 and 3, each window's evolution
    starting from the one before it) from the same variables."""
    cfg_j, cfg_t = jpresets.get_preset(preset), tpresets.get_preset(preset)
    data_j, data_t = chess_cls
    s_j = j_split(data_j.edge_index, data_j.edge_values, data_j.spec, cfg_j.n_classes)
    s_t = t_split(data_t.edge_index, data_t.edge_values, data_t.spec, cfg_t.n_classes)
    feats_j = {w: f.astype(np.float32) for w, f in data_j.feats.items()}
    adapter_j = jad.make_edge_adapter(jbuild.build_model(cfg_j, data_j.spec.s_train, 2),
                                      data_j.adj, feats_j, {w: s_j[w].edges for w in WINDOWS})
    model_t = tbuild.build_model(cfg_t, data_t.spec.s_train, 2)
    adapter_t = tad.make_edge_adapter(model_t, data_t.adj, data_t.feats,
                                      {w: s_t[w].edges for w in WINDOWS}, device="cpu")
    path = "gather_free" if cfg_t.n_layers == 1 else "restricted"
    assert _jax_path(adapter_j.bundles["train"]) == path
    assert tad._evolvegcn_path(model_t, data_t.adj, {w: s_t[w].edges for w in WINDOWS},
                               False) == path
    variables = adapter_j.init(jax.random.PRNGKey(cfg_j.seed))
    cw = np.array([1 / 3, 1 / 3, 1 / 3])
    res_j, _ = jloop.run_edge_classification(
        adapter_j, s_j, cw, jloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=variables)
    adapter_t, eval_logits = _recording(adapter_t)
    res_t, _ = tloop.run_edge_classification(
        adapter_t, s_t, cw, tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=params_from_jax(_np_tree(variables)))
    assert res_t.shape == res_j.shape == (EPOCHS, 12)
    np.testing.assert_allclose(res_t[:, [3, 7, 11]], res_j[:, [3, 7, 11]], rtol=1e-4)
    assert len(np.unique(res_t[:, 7])) == 2  # val rows from each of the two evaluations
    _assert_f1_close(res_t, res_j, eval_logits, s_t)

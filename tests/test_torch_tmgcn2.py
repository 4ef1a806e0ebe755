"""The port's 2-layer TM-GCN against the JAX package: the model, the
readout-restricted layer 2 and its adapter, and the chess_tmgcn2_cls slice.

JAX's initial parameters are carried across with ``params_from_jax``.
Inputs are made with numpy from a seed. The model's parity runs in float64
on both sides (tests/conftest.py turns on x64), tolerance 1e-10: only
summation order differs. The adapters run float32 (the preset's dtype):
1e-5 for float32 operators, the JAX suite's 2e-2 (K1 bf16) and 3e-2
(block-dense bf16) of the output's scale for the bf16 tiers.

The slice runs chess_tmgcn2_cls for 5 epochs (eval_every=3) on a copy of
data/chess in a temporary directory: the port with spmm_impl="pallas" (K1's
plain version on the CPU), the JAX package with its preset "jnp" (the
restricted layer 2 on rowsplit off the TPU; the Pallas interpreter over the
chess windows is too slow here). Losses to rtol 1e-4, precision, recall
and F1 within 1e-3, as tests/test_torch_slice.py.
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
from tmgcn_tpu.core.mmatrix import make_m_matrix
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.models.common import nonlinearity as jax_nonlinearity
from tmgcn_tpu.models.tmgcn import TMGCN2 as JaxTMGCN2
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.tasks.windows import split_edges_classification as j_split
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda
from tmgcn_torch.models.common import nonlinearity
from tmgcn_torch.models.tmgcn import TMGCN2
from tmgcn_torch.ops import spmm_blockdense, spmm_rowsplit
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks.windows import split_edges_classification as t_split
from tmgcn_torch.train import loop as tloop

T, N, F0, C, E = 6, 40, 2, 3, 60
HIDDEN = (5, 4, C)
WINDOWS = ("train", "val", "test")
CHESS = Path(__file__).resolve().parents[1] / "data" / "chess" / "out.chess.csv"


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    dense = (rng.random((T, N, N)) < 0.1) * rng.random((T, N, N))
    X = rng.standard_normal((T, N, F0))
    M = make_m_matrix(T, 3)
    edges = np.stack([rng.integers(0, T, E), rng.integers(0, N, E), rng.integers(0, N, E)])
    G = rng.standard_normal((E, C))
    return dense, X, M, edges, G


@pytest.mark.parametrize("name", ["relu", "leaky", "selu"])
def test_nonlinearity_matches_jax(name):
    x = np.linspace(-3, 3, 41)
    out = nonlinearity(name)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_nonlinearity(name)(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        nonlinearity("tanh")


def test_m_three_times_needs_m_twice():
    with pytest.raises(ValueError, match="apply_M_twice"):
        TMGCN2(n_slices=T, in_feat=F0, hidden_feat=HIDDEN, apply_M_three_times=True)


@pytest.mark.parametrize("condensed_W", [True, False])
def test_init_shapes_and_names(condensed_W):
    j = JaxTMGCN2(n_slices=T, in_feat=F0, hidden_feat=HIDDEN, condensed_W=condensed_W)
    t = TMGCN2(n_slices=T, in_feat=F0, hidden_feat=HIDDEN, condensed_W=condensed_W)
    jp = j.init(jax.random.PRNGKey(0))["params"]
    tv = t.init(torch.Generator().manual_seed(0))
    assert tv["buffers"] == {}
    assert set(tv["params"]) == set(jp) == {"W1", "W2", "U"}
    for k, v in tv["params"].items():
        assert tuple(v.shape) == jp[k].shape and v.dtype == torch.float32
    # params_from_jax takes the flat W1/W2/U dict as it is.
    params = tbuild.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp[k]))


BRANCHES = {
    "plain": {},
    "plain_per_slice_W": {"condensed_W": False},
    "use_Minv": {"use_Minv": True},
    "M_twice": {"apply_M_twice": True},
    "M_three_times": {"apply_M_twice": True, "apply_M_three_times": True},
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_apply_matches_jax_float64(case, branch):
    dense, X, M, edges, G = case
    kw = dict(n_slices=T, in_feat=F0, hidden_feat=HIDDEN, nonlin2="selu", **BRANCHES[branch])
    j = JaxTMGCN2(dtype=jnp.float64, interlayer_dtype=jnp.float64, **kw)
    t = TMGCN2(dtype=torch.float64, interlayer_dtype=torch.float64, **kw)
    jvars = j.init(jax.random.PRNGKey(1))
    params = {k: v.requires_grad_(True) for k, v in tbuild.params_from_jax(
        {k: np.asarray(v) for k, v in jvars["params"].items()}).items()}
    A_t = TemporalCOO.from_dense(dense, dtype=np.float64, pad_multiple=16)
    A_j = JaxCOO.from_dense(dense, dtype=np.float64, pad_multiple=16)

    out = t.apply({"params": params, "buffers": {}}, A_t, torch.from_numpy(X),
                  torch.from_numpy(edges), torch.from_numpy(M))
    (out * torch.from_numpy(G)).sum().backward()

    def f(p):
        o = j.apply({"params": p, "buffers": {}}, A_j, jnp.asarray(X), jnp.asarray(edges),
                    jnp.asarray(M))
        return jnp.vdot(o, jnp.asarray(G)), o

    (_, ref), grads = jax.value_and_grad(f, has_aux=True)(jvars["params"])
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
    for k in ("W1", "W2", "U"):
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(grads[k]),
                                   rtol=1e-10, atol=1e-10, err_msg=k)


def _windows(dense, X):
    """Three windows of one random graph (distinct objects, so not shared)."""
    out_t, out_j = {}, {}
    for i, w in enumerate(WINDOWS):
        d = np.roll(dense, i, axis=0)
        out_t[w] = TemporalCOO.from_dense(d, pad_multiple=16)
        out_j[w] = JaxCOO.from_dense(d, dtype=np.float32, pad_multiple=16)
    feats = {w: np.roll(X, i, axis=0) for i, w in enumerate(WINDOWS)}
    return out_t, out_j, feats


def _adapters(case, spmm_impl, **model_kw):
    dense, X, M, edges, _ = case
    adj_t, adj_j, feats = _windows(dense, X)
    ed = {w: np.roll(edges, i, axis=1) for i, w in enumerate(WINDOWS)}
    kw = dict(n_slices=T, in_feat=F0, hidden_feat=HIDDEN, nonlin2="selu",
              spmm_impl=spmm_impl, **model_kw)
    ad_j = jad.make_edge_adapter(JaxTMGCN2(**kw), adj_j, feats, ed, M=M)
    ad_t = tad.make_edge_adapter(TMGCN2(**kw), adj_t, feats, ed, M=M, device="cpu")
    return ad_t, ad_j


def _logits_and_grads(ad_t, ad_j, G, window="train"):
    jvars = ad_j.init(jax.random.PRNGKey(2))
    params = {k: v.requires_grad_(True) for k, v in tbuild.params_from_jax(
        {k: np.asarray(v) for k, v in jvars["params"].items()}).items()}
    out, _ = ad_t.apply({"params": params, "buffers": {}}, ad_t.bundles[window], ())
    (out * torch.from_numpy(G).float()).sum().backward()

    def f(p):
        o, _ = ad_j.apply({"params": p, "buffers": {}}, ad_j.bundles[window], ())
        return jnp.vdot(o, jnp.asarray(G, o.dtype)), o

    (_, ref), grads = jax.value_and_grad(f, has_aux=True)(jvars["params"])
    return out.detach().numpy(), {k: v.grad.numpy() for k, v in params.items()}, \
        np.asarray(ref), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize(
    "operator,rel",
    [("jnp", None), ("rowsplit", None), ("pallas", None), ("pallas_bf16", 2e-2),
     ("blockdense", None), ("blockdense_bf16", 3e-2)],
)
def test_restricted_adapter_matches_jax(case, operator, rel):
    """Logits and parameter gradients through each restricted operator."""
    _, _, _, _, G = case
    ad_t, ad_j = _adapters(case, operator)
    b = ad_t.bundles["train"]
    assert "readout" not in b  # the restricted apply never reads a plan
    kinds = {"jnp": spmm_rowsplit.FlatRowSplitOperator, "rowsplit": spmm_rowsplit.FlatRowSplitOperator,
             "pallas": spmm_cuda.FlatPallasOperator, "pallas_bf16": spmm_cuda.FlatPallasOperator,
             "blockdense": spmm_blockdense.BlockDenseOperator,
             "blockdense_bf16": spmm_blockdense.BlockDenseOperator}
    assert isinstance(b["l2op"], kinds[operator])  # "jnp" is auto: rowsplit on the CPU
    for w in WINDOWS:
        for key in ("l2_Hin", "l2_src", "l2_trg"):
            np.testing.assert_allclose(ad_t.bundles[w][key].numpy(),
                                       np.asarray(ad_j.bundles[w][key]), rtol=1e-6, atol=1e-6)
    out, grads, ref, grads_j = _logits_and_grads(ad_t, ad_j, G)
    np.testing.assert_allclose(out, ref, rtol=1e-5 if rel is None else 0,
                               atol=1e-5 if rel is None else rel * np.abs(ref).max())
    for k in ("W1", "W2", "U"):
        tol = 1e-4 if rel is None else rel * np.abs(grads_j[k]).max()
        np.testing.assert_allclose(grads[k], grads_j[k], rtol=1e-4 if rel is None else 0,
                                   atol=tol, err_msg=k)


def test_generic_adapter_matches_jax(case):
    """A 2-layer TM-GCN off the restricted path runs the model's own layers."""
    _, _, _, _, G = case
    ad_t, ad_j = _adapters(case, "jnp", apply_M_twice=True)
    assert "l2op" not in ad_t.bundles["train"]
    out, grads, ref, grads_j = _logits_and_grads(ad_t, ad_j, G, window="val")
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    for k in ("W1", "W2", "U"):
        np.testing.assert_allclose(grads[k], grads_j[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("drop_last_slice", [False, True])
def test_restricted_build_matches_jax(case, drop_last_slice):
    """(uniq, used), the compacted stream's plans and the bundle rows."""
    dense, X, _, edges, _ = case
    rng = np.random.default_rng(5)
    cached = rng.standard_normal((T - drop_last_slice, N, F0)).astype(np.float32)
    A_t = TemporalCOO.from_dense(dense, pad_multiple=16)
    A_j = JaxCOO.from_dense(dense, dtype=np.float32, pad_multiple=16)
    e = edges[:, edges[0] < T - 1] if drop_last_slice else edges
    b_t = {"cached": torch.from_numpy(cached)}
    b_j = {"cached": jnp.asarray(cached)}
    uniq, used = tad._build_restricted_layer2(b_t, A_t, e, drop_last_slice, "rowsplit")
    uniq_j, used_j = jad._build_restricted_layer2(b_j, A_j, e, drop_last_slice, "rowsplit")
    np.testing.assert_array_equal(uniq, uniq_j)
    np.testing.assert_array_equal(used, used_j)
    for pt, pj in ((b_t["l2op"].plan, b_j["l2op"].plan), (b_t["l2op"].plan_t, b_j["l2op"].plan_t)):
        for f in ("seg_rows", "cols", "vals"):
            np.testing.assert_array_equal(np.asarray(getattr(pt, f)), np.asarray(getattr(pj, f)), f)
    for key in ("l2_Hin", "l2_src", "l2_trg"):
        np.testing.assert_array_equal(b_t[key].numpy(), np.asarray(b_j[key]))


def test_auto_picks_by_device(case):
    """auto: rowsplit on the CPU; on a CUDA device the JAX accelerator rule."""
    dense, _, _, edges, _ = case
    A = TemporalCOO.from_dense(dense, pad_multiple=16)
    b = {"cached": torch.zeros(T, N, F0)}
    tad._build_restricted_layer2(b, A, edges, False, "auto_bf16")
    assert isinstance(b["l2op"], spmm_rowsplit.FlatRowSplitOperator)
    assert tad.BLOCKDENSE_RATIO == 0.5


@pytest.fixture(scope="module")
def chess(tmp_path_factory):
    dirs = {}
    for side in ("torch", "jax"):
        d = tmp_path_factory.mktemp(f"chess2_{side}")
        shutil.copy(CHESS, d / CHESS.name)
        dirs[side] = d
    cfg_t = dataclasses.replace(tpresets.get_preset("chess_tmgcn2_cls"), spmm_impl="pallas")
    cfg_j = jpresets.get_preset("chess_tmgcn2_cls")
    assert cfg_j.spmm_impl == "jnp"
    return cfg_t, cfg_j, tbuild.build_data(cfg_t, data_dir=dirs["torch"]), \
        jbuild.build_data(cfg_j, data_dir=dirs["jax"])


def test_chess_slice_matches_jax(chess):
    cfg_t, cfg_j, data_t, data_j = chess
    cw = np.array([1 / 3, 1 / 3, 1 / 3])
    epochs, eval_every = 5, 3
    s_t = t_split(data_t.edge_index, data_t.edge_values, data_t.spec, cfg_t.n_classes)
    s_j = j_split(data_j.edge_index, data_j.edge_values, data_j.spec, cfg_j.n_classes)

    model_j = jbuild.build_model(cfg_j, data_j.spec.s_train, 2)
    adapter_j = jad.make_edge_adapter(
        model_j, data_j.adj, data_j.feats, {w: s_j[w].edges for w in WINDOWS}, M=data_j.M
    )
    variables = adapter_j.init(jax.random.PRNGKey(cfg_j.seed))
    res_j, _ = jloop.run_edge_classification(
        adapter_j, s_j, cw, jloop.TrainConfig(n_epochs=epochs, eval_every=eval_every),
        variables=variables,
    )

    before = spmm_cuda.windowed_segment_matmul.launches
    model_t = tbuild.build_model(cfg_t, data_t.spec.s_train, 2)
    assert isinstance(model_t, TMGCN2) and model_t.nonlin2 == "selu"
    adapter_t = tad.make_edge_adapter(
        model_t, data_t.adj, data_t.feats, {w: s_t[w].edges for w in WINDOWS},
        M=data_t.M, device="cpu",
    )
    assert isinstance(adapter_t.bundles["train"]["l2op"], spmm_cuda.FlatPallasOperator)
    params = tbuild.params_from_jax({k: np.asarray(v) for k, v in variables["params"].items()})
    res_t, _ = tloop.run_edge_classification(
        adapter_t, s_t, cw, tloop.TrainConfig(n_epochs=epochs, eval_every=eval_every),
        variables={"params": params, "buffers": {}},
    )
    assert spmm_cuda.windowed_segment_matmul.launches == before  # plain version on the CPU

    assert res_t.shape == res_j.shape == (epochs, 12)
    losses = [3, 7, 11]
    np.testing.assert_allclose(res_t[:, losses], res_j[:, losses], rtol=1e-4)
    rates = [0, 1, 2, 4, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(np.isnan(res_t[:, rates]), np.isnan(res_j[:, rates]))
    np.testing.assert_allclose(res_t[:, rates], res_j[:, rates], atol=1e-3)

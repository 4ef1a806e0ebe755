"""The generic 1-layer TM-GCN edge adapter against the JAX package.

A TMGCN with per-slice weights (``condensed_W=False``) or the inverse
transform (``use_Minv=True``) cannot take the 1-layer fast path: the
adapter caches the propagation and runs the model's own layer and the
readout through the bundle's ReadoutPlan (``readout_op``), as the JAX
package's does (tmgcn_tpu/tasks/adapters.py:609-620).

JAX's initial parameters are carried across with ``params_from_jax``.
Small problems: logits and gradients at the suite's float32 tolerance,
1e-5 of max(1, |reference|). The chess runs (5 epochs, eval_every 3) are
held as tests/test_torch_slice.py holds chess_tmgcn_cls: the port with
spmm_impl="pallas" (K1's plain version on the CPU, the readout plan's
backward included), the JAX package with the preset's "jnp"; losses rtol
1e-4, precision, recall and F1 within 1e-3.
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
from tmgcn_tpu.models.tmgcn import TMGCN as JaxTMGCN
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.tasks.windows import split_edges_classification as j_split
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.tmgcn import TMGCN
from tmgcn_torch.ops.edge_readout import make_readout_plan, readout_operator
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks.windows import split_edges_classification as t_split
from tmgcn_torch.train import loop as tloop

T, N, F0, F1, C, E = 6, 40, 2, 5, 3, 50
WINDOWS = ("train", "val", "test")
VARIANTS = {
    "per_slice_W": {"condensed_W": False},
    "Minv": {"use_Minv": True},
    "per_slice_W_Minv": {"condensed_W": False, "use_Minv": True},
}
CHESS = Path(__file__).resolve().parents[1] / "data" / "chess" / "out.chess.csv"


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    dense = (rng.random((T, N, N)) < 0.1) * rng.random((T, N, N))
    X = rng.standard_normal((T, N, F0)).astype(np.float32)
    M = make_m_matrix(T, 3)
    edges = {w: np.stack([rng.integers(0, T, E), rng.integers(0, N, E), rng.integers(0, N, E)])
             for w in WINDOWS}
    G = rng.standard_normal((E, C)).astype(np.float32)
    return dense, X, M, edges, G


def _params(jvars, requires_grad=False):
    return {k: v.requires_grad_(requires_grad) for k, v in tbuild.params_from_jax(
        {k: np.asarray(v) for k, v in jvars["params"].items()}).items()}


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generic_adapter_matches_jax(case, variant, impl):
    """Logits and W/U gradients of each window against JAX's adapter;
    "pallas" prepacks the propagation and reads out through the plan."""
    dense, X, M, edges, G = case
    kw = dict(n_slices=T, in_feat=F0, hidden_feat=(F1, C), spmm_impl=impl, **VARIANTS[variant])
    adj_t = {w: TemporalCOO.from_dense(np.roll(dense, i, 0), pad_multiple=16)
             for i, w in enumerate(WINDOWS)}
    adj_j = {w: JaxCOO.from_dense(np.roll(dense, i, 0), dtype=np.float32, pad_multiple=16)
             for i, w in enumerate(WINDOWS)}
    feats = {w: np.roll(X, i, 0) for i, w in enumerate(WINDOWS)}
    ad_t = tad.make_edge_adapter(TMGCN(**kw), adj_t, feats, edges, M=M, device="cpu")
    ad_j = jad.make_edge_adapter(JaxTMGCN(**kw), adj_j, feats, edges, M=M)
    assert "cached_src" not in ad_t.bundles["train"]  # not the fast path
    assert ("readout" in ad_t.bundles["train"]) == (impl == "pallas")
    jvars = ad_j.init(jax.random.PRNGKey(4))
    for w in WINDOWS:
        params = _params(jvars, requires_grad=True)
        out, _ = ad_t.apply({"params": params, "buffers": {}}, ad_t.bundles[w], ())
        (out * torch.from_numpy(G)).sum().backward()

        def f(p, w=w):
            o, _ = ad_j.apply({"params": p, "buffers": {}}, ad_j.bundles[w], ())
            return jnp.vdot(o, jnp.asarray(G, o.dtype)), o

        (_, ref), grads = jax.value_and_grad(f, has_aux=True)(jvars["params"])
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()), err_msg=w)
        for k in ("W", "U"):
            r = np.asarray(grads[k])
            np.testing.assert_allclose(params[k].grad.numpy(), r, rtol=0,
                                       atol=1e-5 * max(1.0, np.abs(r).max()), err_msg=f"{w} {k}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_readout_op_matches_plain_readout(case, variant):
    """TMGCN.apply(readout_op=the plan's operator) against the plain
    edge_readout: the same logits and W/U gradients (float64)."""
    dense, X, M, edges, G = case
    model = TMGCN(n_slices=T, in_feat=F0, hidden_feat=(F1, C), dtype=torch.float64,
                  **VARIANTS[variant])
    variables = model.init(torch.Generator().manual_seed(2))
    A = TemporalCOO.from_dense(dense, dtype=np.float64, pad_multiple=16)
    e = edges["train"]
    op = readout_operator(make_readout_plan(e, T, N))
    args = (A, torch.from_numpy(X).double(), torch.from_numpy(e), torch.from_numpy(M))

    def run(readout_op):
        params = {k: v.clone().requires_grad_(True) for k, v in variables["params"].items()}
        out = model.apply({"params": params, "buffers": {}}, *args, readout_op=readout_op)
        (out * torch.from_numpy(G).double()).sum().backward()
        return [out.detach()] + [params[k].grad for k in ("W", "U")]

    for a, b in zip(run(op), run(None)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def chess(tmp_path_factory):
    dirs = {}
    for side in ("torch", "jax"):
        d = tmp_path_factory.mktemp(f"chess_generic_{side}")
        shutil.copy(CHESS, d / CHESS.name)
        dirs[side] = d
    cfg_t = dataclasses.replace(tpresets.get_preset("chess_tmgcn_cls"), spmm_impl="pallas")
    cfg_j = jpresets.get_preset("chess_tmgcn_cls")
    assert cfg_j.spmm_impl == "jnp"
    return cfg_t, cfg_j, tbuild.build_data(cfg_t, data_dir=dirs["torch"]), \
        jbuild.build_data(cfg_j, data_dir=dirs["jax"])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_chess_generic_matches_jax(chess, variant):
    """chess_tmgcn_cls with the variant's flags, 5 epochs (eval_every 3),
    through build_model, the adapter and run_edge_classification."""
    cfg_t, cfg_j, data_t, data_j = chess
    cfg_t = dataclasses.replace(cfg_t, **VARIANTS[variant])
    cfg_j = dataclasses.replace(cfg_j, **VARIANTS[variant])
    cw = np.array([1 / 3, 1 / 3, 1 / 3])
    tcfg = dict(n_epochs=5, eval_every=3)
    s_t = t_split(data_t.edge_index, data_t.edge_values, data_t.spec, cfg_t.n_classes)
    s_j = j_split(data_j.edge_index, data_j.edge_values, data_j.spec, cfg_j.n_classes)
    model_j = jbuild.build_model(cfg_j, data_j.spec.s_train, 2)
    adapter_j = jad.make_edge_adapter(
        model_j, data_j.adj, data_j.feats, {w: s_j[w].edges for w in WINDOWS}, M=data_j.M)
    variables = adapter_j.init(jax.random.PRNGKey(cfg_j.seed))
    res_j, _ = jloop.run_edge_classification(adapter_j, s_j, cw, jloop.TrainConfig(**tcfg),
                                             variables=variables)
    model_t = tbuild.build_model(cfg_t, data_t.spec.s_train, 2)
    assert isinstance(model_t, TMGCN)
    adapter_t = tad.make_edge_adapter(
        model_t, data_t.adj, data_t.feats, {w: s_t[w].edges for w in WINDOWS}, M=data_t.M,
        device="cpu")
    assert "readout" in adapter_t.bundles["train"]
    res_t, _ = tloop.run_edge_classification(
        adapter_t, s_t, cw, tloop.TrainConfig(**tcfg),
        variables={"params": _params(variables), "buffers": {}})
    assert res_t.shape == res_j.shape == (5, 12)
    losses = [3, 7, 11]
    np.testing.assert_allclose(res_t[:, losses], res_j[:, losses], rtol=1e-4)
    rates = [0, 1, 2, 4, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(np.isnan(res_t[:, rates]), np.isnan(res_j[:, rates]))
    np.testing.assert_allclose(res_t[:, rates], res_j[:, rates], atol=1e-3)

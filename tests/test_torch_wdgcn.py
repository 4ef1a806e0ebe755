"""The port's WD-GCN against the JAX package: LSTM scans, model, adapter,
training loop, and the chess_wdgcn_cls slice at full width.

Inputs are made with numpy from a seed; JAX's initial variables are
carried across with ``params_from_jax`` (nested: ``params.lstm`` and the
frozen ``buffers``). The JAX readout plans run ``interpret=True``, as the
JAX suite's own tests run them. Tolerances: float64 1e-10 (only summation
order differs); float32 1e-5 for values and 1e-4 for gradients through the
LSTM, as tests/test_torch_tmgcn.py holds TM-GCN.
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
from tmgcn_tpu.models import wdgcn as jwd
from tmgcn_tpu.ops import edge_readout as jro
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.tasks.windows import split_edges_classification as j_split
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda as tk
from tmgcn_torch.models import wdgcn as twd
from tmgcn_torch.models.tmgcn import TMGCN
from tmgcn_torch.ops import edge_readout as tro
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks.windows import split_edges_classification as t_split
from tmgcn_torch.train import loop as tloop

T, N, F0, F1, C, E = 6, 40, 2, 5, 3, 50
WINDOWS = ("train", "val", "test")
DTYPES = {"float64": (torch.float64, jnp.float64, 1e-10, 1e-10),
          "float32": (torch.float32, jnp.float32, 1e-5, 1e-4)}


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_tree_close(ours, ref, rtol, atol):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert ours.keys() == ref.keys()
    for k in ours:
        o = ours[k].detach().numpy() if isinstance(ours[k], torch.Tensor) else ours[k]
        np.testing.assert_allclose(o, np.asarray(ref[k]), rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    dense = (rng.random((T, N, N)) < 0.1) * rng.random((T, N, N))
    X = rng.standard_normal((T, N, F0))
    edges = np.stack([
        np.sort(rng.integers(0, T, E)), rng.integers(0, N, E), rng.integers(0, N, E),
    ])
    G = rng.standard_normal((E, C))
    return dense, X, edges, G


def _jax_variables(dtype=jnp.float64, f=F1, seed=3):
    model = jwd.WDGCN(n_slices=T, in_feat=F0, hidden_feat=(f, C), dtype=dtype)
    return _np_tree(model.init(jax.random.PRNGKey(seed)))


class TestInit:
    def test_tree_matches_jax(self):
        ref = _jax_variables()
        ours = twd.WDGCN(n_slices=T, in_feat=F0, hidden_feat=(F1, C)).init(
            torch.Generator().manual_seed(0)
        )
        assert [(k, tuple(v.shape)) for k, v in _leaves(ours)] == [
            (k, v.shape) for k, v in _leaves(ref)
        ]
        assert "U" in ours["buffers"] and "U" not in ours["params"]
        again = twd.WDGCN(n_slices=T, in_feat=F0, hidden_feat=(F1, C)).init(
            torch.Generator().manual_seed(0)
        )
        for (_, a), (_, b) in zip(_leaves(ours), _leaves(again)):
            assert torch.equal(a, b)

    def test_params_from_jax_nested(self):
        ref = _jax_variables()
        ours = params_from_jax(ref)
        _assert_tree_close(ours, ref, 0, 0)
        assert all(v.dtype == torch.float64 for _, v in _leaves(ours))

    def test_budget_matches_jax(self):
        assert twd._PRE_BUDGET_ELEMS == jwd._PRE_BUDGET_ELEMS


class TestLstmScan:
    @pytest.mark.parametrize("transposed", [False, True])
    @pytest.mark.parametrize("remat", [False, True])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_value_and_gradients_match_jax(self, transposed, remat, dtype):
        tdt, jdt, tol, gtol = DTYPES[dtype]
        rng = np.random.default_rng(1)
        Tn, Nn, F = 7, 33, 4
        variables = _jax_variables(jdt, f=F, seed=2)
        lstm, bufs = variables["params"]["lstm"], variables["buffers"]
        shape = (Tn, F, Nn) if transposed else (Tn, Nn, F)
        Y = rng.standard_normal(shape).astype(np.dtype(dtype))
        G = rng.standard_normal((Tn, Nn, F)).astype(np.dtype(dtype))
        jfn = jwd.lstm_scan_t if transposed else jwd.lstm_scan
        tfn = twd.lstm_scan_t if transposed else twd.lstm_scan

        p = params_from_jax(lstm)
        for v in p.values():
            v.requires_grad_(True)
        Yt = torch.from_numpy(Y).requires_grad_(True)
        out = tfn(p, torch.from_numpy(bufs["h_init"]), torch.from_numpy(bufs["c_init"]), Yt,
                  remat=remat)
        (out * torch.from_numpy(G)).sum().backward()

        def f(pp, y):
            o = jfn(pp, jnp.asarray(bufs["h_init"]), jnp.asarray(bufs["c_init"]), y, remat=remat)
            return jnp.vdot(o, jnp.asarray(G)), o

        (_, ref), (gp, gy) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in lstm.items()}, jnp.asarray(Y)
        )
        assert out.shape == (Tn, Nn, F) and out.dtype == tdt
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)
        np.testing.assert_allclose(Yt.grad.numpy(), np.asarray(gy), rtol=gtol, atol=gtol)
        _assert_tree_close({k: v.grad for k, v in p.items()}, gp, gtol, gtol)

    def test_unroll_is_ignored(self):
        variables = _jax_variables()
        lstm = params_from_jax(variables["params"]["lstm"])
        h0, c0 = (torch.from_numpy(variables["buffers"][k]) for k in ("h_init", "c_init"))
        Y = torch.from_numpy(np.random.default_rng(2).standard_normal((T, N, F1)))
        assert torch.equal(twd.lstm_scan(lstm, h0, c0, Y, unroll=3), twd.lstm_scan(lstm, h0, c0, Y))


def _port_model(dtype, spmm_impl="jnp"):
    return twd.WDGCN(n_slices=T, in_feat=F0, hidden_feat=(F1, C), dtype=dtype, spmm_impl=spmm_impl)


class TestModel:
    @pytest.mark.parametrize("readout", ["gather", "plan", "plan_lane_major"])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_apply_matches_jax(self, case, readout, dtype):
        dense, X, edges, G = case
        tdt, jdt, tol, gtol = DTYPES[dtype]
        jvars = _jax_variables(jdt)
        AX = np.einsum("tij,tjf->tif", dense, X)
        AXt = np.swapaxes(AX, 1, 2).copy()

        tvars = params_from_jax(jvars)
        for _, v in _leaves(tvars["params"]):
            v.requires_grad_(True)
        t_op = j_op = None
        if readout != "gather":
            lane_major = readout == "plan_lane_major"
            plan = tro.make_readout_plan(edges, T, N, 32, 64, lane_major=lane_major)
            jplan = jro.make_readout_plan(edges, T, N, 32, 64, interpret=True,
                                          lane_major=lane_major)
            t_op = lambda Y, U: tro.apply_readout(plan, Y, U)  # noqa: E731
            j_op = lambda Y, U: jro.apply_readout(jplan, Y, U)  # noqa: E731
        out = _port_model(tdt).apply(
            tvars, None, None, torch.from_numpy(edges), readout_op=t_op,
            AXt=torch.from_numpy(AXt),
        )
        (out * torch.from_numpy(G).to(tdt)).sum().backward()

        jmodel = jwd.WDGCN(n_slices=T, in_feat=F0, hidden_feat=(F1, C), dtype=jdt)

        def f(p):
            o = jmodel.apply({"params": p, "buffers": jvars["buffers"]}, None, None,
                             jnp.asarray(edges), readout_op=j_op, AXt=jnp.asarray(AXt))
            return jnp.vdot(o, jnp.asarray(G, o.dtype)), o

        (_, ref), grads = jax.value_and_grad(f, has_aux=True)(
            jax.tree.map(jnp.asarray, jvars["params"])
        )
        assert out.dtype == tdt
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)
        _assert_tree_close(
            {k: v.grad for k, v in _leaves(tvars["params"])},
            {k: v for k, v in _leaves(_np_tree(grads))}, gtol, gtol,
        )

    def test_embed_from_A_and_X_matches_jax(self, case):
        """The uncached path: propagate (spmm "jnp"), then lstm_scan."""
        dense, X, edges, _ = case
        jvars = _jax_variables()
        tvars = params_from_jax(jvars)
        A_t = TemporalCOO.from_dense(dense, dtype=np.float64, pad_multiple=16)
        A_j = JaxCOO.from_dense(dense, dtype=np.float64, pad_multiple=16)
        model = _port_model(torch.float64)
        Z = model.embed(tvars, A_t, torch.from_numpy(X))
        jmodel = jwd.WDGCN(n_slices=T, in_feat=F0, hidden_feat=(F1, C), dtype=jnp.float64)
        ref = jmodel.embed(jvars, A_j, jnp.asarray(X))
        np.testing.assert_allclose(Z.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
        AXt = model.propagate(A_t, torch.from_numpy(X)).transpose(1, 2)
        torch.testing.assert_close(model.embed(tvars, None, None, AXt=AXt), Z,
                                   rtol=1e-12, atol=1e-12)


def _adapters(case, spmm_impl):
    dense, X, edges, _ = case
    rng = np.random.default_rng(5)
    edict = {w: edges if w == "train" else np.stack([
        np.sort(rng.integers(0, T, 20)), rng.integers(0, N, 20), rng.integers(0, N, 20),
    ]) for w in WINDOWS}
    Xf = X.astype(np.float32)
    A_t = TemporalCOO.from_dense(dense, pad_multiple=16)
    A_j = JaxCOO.from_dense(dense, pad_multiple=16)
    jmodel = jwd.WDGCN(n_slices=T, in_feat=F0, hidden_feat=(F1, C), spmm_impl=spmm_impl)
    tmodel = _port_model(torch.float32, spmm_impl)
    feats = {w: Xf for w in WINDOWS}
    ja = jad.make_edge_adapter(jmodel, {w: A_j for w in WINDOWS}, feats, edict)
    ta = tad.make_edge_adapter(tmodel, {w: A_t for w in WINDOWS}, feats, edict, device="cpu")
    return ja, ta, edict


class TestAdapter:
    @pytest.mark.parametrize("spmm_impl", ["jnp", "pallas"])
    def test_bundles_and_logits_match_jax(self, case, spmm_impl):
        ja, ta, _ = _adapters(case, spmm_impl)
        jvars = _np_tree(ja.init(jax.random.PRNGKey(4)))
        tvars = params_from_jax(jvars)
        for w in WINDOWS:
            jb, tb = ja.bundles[w], ta.bundles[w]
            # A plan off the card only for operator-backed configs, as in JAX off the TPU.
            assert ("readout" in tb) == ("readout" in jb) == (spmm_impl == "pallas")
            np.testing.assert_allclose(tb["cached_t"].numpy(), np.asarray(jb["cached_t"]),
                                       rtol=1e-5, atol=1e-5)
            out, carry = ta.apply(tvars, tb, ())
            ref, _ = ja.apply(jvars, jb, ())
            assert carry == ()
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    def test_plan_only_for_the_gathering_model(self, case):
        """An operator-backed config: WD-GCN's bundles carry the plan, the
        1-layer TM-GCN's (whose epoch never gathers) do not."""
        dense, X, edges, _ = case
        A = TemporalCOO.from_dense(dense, pad_multiple=16)
        feats = {w: X.astype(np.float32) for w in WINDOWS}
        edict = {w: edges for w in WINDOWS}
        M = np.tril(np.ones((T, T), np.float32)) / np.arange(1, T + 1)[:, None]
        tm = TMGCN(n_slices=T, in_feat=F0, hidden_feat=(F1, C), spmm_impl="pallas")
        wd = _port_model(torch.float32, "pallas")
        for model, kw, has_plan in ((tm, {"M": M}, False), (wd, {}, True)):
            adapter = tad.make_edge_adapter(model, {w: A for w in WINDOWS}, feats, edict,
                                            device="cpu", **kw)
            assert ("readout" in adapter.bundles["train"]) == has_plan, type(model).__name__

    def test_loop_trains_the_nested_tree(self, case):
        """run_edge_classification over WD-GCN's nested params, port against JAX."""
        ja, ta, edict = _adapters(case, "pallas")
        rng = np.random.default_rng(6)
        splits = {}
        for w in WINDOWS:
            e = edict[w]
            tgt = rng.integers(0, C, e.shape[1])
            splits[w] = type("Split", (), {"edges": e, "target": tgt,
                                           "eval_mask": np.ones(e.shape[1], bool)})
        cw = np.array([0.2, 0.5, 0.3])
        jvars = ja.init(jax.random.PRNGKey(5))
        res_j, out_j = jloop.run_edge_classification(
            ja, splits, cw, jloop.TrainConfig(n_epochs=4, eval_every=2), variables=jvars
        )
        tvars = params_from_jax(_np_tree(jvars))
        res_t, out_t = tloop.run_edge_classification(
            ta, splits, cw, tloop.TrainConfig(n_epochs=4, eval_every=2), variables=tvars
        )
        np.testing.assert_allclose(res_t[:, [3, 7, 11]], res_j[:, [3, 7, 11]], rtol=1e-5)
        _assert_tree_close(out_t["params"], _np_tree(out_j["params"]), 1e-4, 1e-4)
        _assert_tree_close(out_t["buffers"], _np_tree(jvars["buffers"]), 0, 0)
        for name, v in _leaves(out_t["params"]):  # every leaf was trained
            assert not np.array_equal(v.numpy(), dict(_leaves(tvars["params"]))[name].numpy()), name


CHESS = Path(__file__).resolve().parents[1] / "data" / "chess" / "out.chess.csv"
EPOCHS, EVAL_EVERY = 5, 3
CW = np.array([1 / 3, 1 / 3, 1 / 3])


@pytest.fixture(scope="module")
def chess(tmp_path_factory):
    dirs = {}
    for side in ("torch", "jax"):
        d = tmp_path_factory.mktemp(f"chess_wdgcn_{side}")
        shutil.copy(CHESS, d / CHESS.name)
        dirs[side] = d
    cfg_t = tpresets.get_preset("chess_wdgcn_cls")
    cfg_j = jpresets.get_preset("chess_wdgcn_cls")
    assert cfg_t.spmm_impl == cfg_j.spmm_impl == "jnp"
    return dirs, cfg_t, cfg_j, tbuild.build_data(cfg_t, data_dir=dirs["torch"]), \
        jbuild.build_data(cfg_j, data_dir=dirs["jax"])


def test_chess_data_matches_jax(chess):
    """The disjoint windows of the untransformed C, 80/10/10 slices."""
    _, cfg_t, _, data_t, data_j = chess
    assert [data_t.adj[w].n_slices for w in WINDOWS] == [80, 10, 10]
    for w in WINDOWS:
        for f in ("rows", "cols", "vals", "nnz"):
            np.testing.assert_array_equal(
                np.asarray(getattr(data_t.adj[w], f)), np.asarray(getattr(data_j.adj[w], f))
            )
        np.testing.assert_array_equal(data_t.feats[w], data_j.feats[w])
    assert t_split(data_t.edge_index, data_t.edge_values, data_t.spec,
                   cfg_t.n_classes)["train"].target.size == 39_192


def test_chess_short_run_matches_jax(chess):
    """5 epochs of chess_wdgcn_cls at full width, from the same variables.

    The JAX model runs its scan rolled (scan_unroll=1): the preset's full
    unroll of 80 steps takes minutes to compile on the CPU and changes no
    arithmetic. Both sides run the plain gather readout (no plan off the
    accelerator with spmm_impl "jnp").
    """
    _, cfg_t, cfg_j, data_t, data_j = chess
    s_t = t_split(data_t.edge_index, data_t.edge_values, data_t.spec, cfg_t.n_classes)
    s_j = j_split(data_j.edge_index, data_j.edge_values, data_j.spec, cfg_j.n_classes)
    model_j = dataclasses.replace(jbuild.build_model(cfg_j, data_j.spec.s_train, 2), scan_unroll=1)
    adapter_j = jad.make_edge_adapter(
        model_j, data_j.adj, data_j.feats, {w: s_j[w].edges for w in WINDOWS}
    )
    variables = adapter_j.init(jax.random.PRNGKey(cfg_j.seed))
    res_j, _ = jloop.run_edge_classification(
        adapter_j, s_j, CW, jloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=variables,
    )

    launches = (tk.windowed_segment_matmul.launches, tk.windowed_segment_matmul_t.launches)
    model_t = tbuild.build_model(cfg_t, data_t.spec.s_train, 2)
    assert isinstance(model_t, twd.WDGCN) and model_t.hidden_feat == (6, 3)
    adapter_t = tad.make_edge_adapter(
        model_t, data_t.adj, data_t.feats, {w: s_t[w].edges for w in WINDOWS}, device="cpu"
    )
    assert "readout" not in adapter_t.bundles["train"]
    res_t, _ = tloop.run_edge_classification(
        adapter_t, s_t, CW, tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=params_from_jax(_np_tree(variables)),
    )
    assert (tk.windowed_segment_matmul.launches,
            tk.windowed_segment_matmul_t.launches) == launches

    assert res_t.shape == res_j.shape == (EPOCHS, 12)
    losses = [3, 7, 11]
    np.testing.assert_allclose(res_t[:, losses], res_j[:, losses], rtol=1e-4)
    rates = [0, 1, 2, 4, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(np.isnan(res_t[:, rates]), np.isnan(res_j[:, rates]))
    np.testing.assert_allclose(res_t[:, rates], res_j[:, rates], atol=1e-3)


def test_chess_run_experiment_on_the_cpu(chess):
    """The entry point: run_experiment(chess_wdgcn_cls), cached data, 2 epochs."""
    dirs, cfg_t, _, _, _ = chess
    out = tbuild.run_experiment(cfg_t, data_dir=dirs["torch"], n_epochs=2, verbose=False,
                                device="cpu")
    (res,) = out["results"].values()
    assert res.shape == (2, 12) and np.all(np.isfinite(res[:, [3, 7, 11]]))


@pytest.mark.parametrize("preset", ["seir_wdgcn_reg", "seir_wdgcn_reg_tuned"])
def test_unported_wdgcn_tasks_raise(preset, tmp_path):
    """WD-GCN regression on a device mesh: on the 1 x 1 mesh (this process
    as the world) with checkpoints, a run of 4 epochs resumed to 6 gives
    the uninterrupted sharded run's train losses and val/test L1 (a chunk's
    end is a save, so the resumed run is the whole one), and those are the
    unsharded run's (rtol 1e-3); a mesh larger than this world raises
    naming its size."""
    from tmgcn_torch.parallel import distributed

    distributed.initialize("cpu")
    cfg = dataclasses.replace(tpresets.get_preset(preset), eval_every=2)

    def run(n, **kw):
        out = tbuild.run_experiment(cfg, n_epochs=n, verbose=False, device="cpu", **kw)
        return next(iter(out["results"].values()))

    full = run(6, mesh_shape=(1, 1))
    run(4, mesh_shape=(1, 1), checkpoint_dir=tmp_path)
    resumed = run(6, mesh_shape=(1, 1), checkpoint_dir=tmp_path)
    for k, v in full.items():
        np.testing.assert_array_equal(resumed[k], v, err_msg=k)
        np.testing.assert_allclose(v, run(6)[k], rtol=1e-3, err_msg=k)
    with pytest.raises(ValueError, match=r"mesh 1x2 != 1 devices \(the world size\)"):
        run(1, mesh_shape=(1, 2), checkpoint_dir=tmp_path)

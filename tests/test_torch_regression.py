"""Node regression of the port against the JAX package: the summed
per-slice MSE and the L1 evaluation, the three regression models
(TMGCNReg, EvolveGCNReg, WDGCNReg) and their gradients, the regression
adapter's three branches, ``run_regression``, the training step it
captures (``train_chunks(task="regression")``), the six SEIR presets
through ``run_experiment``, and the CLI.

Inputs are made with numpy from a seed, at the JAX suite's SEIR size (60
nodes x 20 slices, tests/test_tasks.py); JAX's initial variables are
carried across with ``params_from_jax``, and the JAX side gets float32
features, as the JAX package holds them with x64 off (tests/conftest.py
turns x64 on). spmm_impl="pallas" runs K1's plain version in the port and
the Pallas kernel in interpret mode on the JAX side. Tolerances: outputs
and gradients float32 atol 1e-5 (rtol 1e-5; 1e-4 through the LSTM and GRU
loops, as tests/test_torch_wdgcn.py holds them); losses rtol 1e-4 over the
epochs where the JAX loss is finite and below 1e6, both sides non-finite
from the same epoch on (the untuned presets diverge); L1 and L1 ratio rtol
1e-4, NaN or inf where the JAX package's are.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.configs import build as jbuild
from tmgcn_tpu.configs import presets as jpresets
from tmgcn_tpu.core.mmatrix import make_m_matrix
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.kernels.spmm_pallas import make_operator as j_make_operator
from tmgcn_tpu.models import evolvegcn as jev
from tmgcn_tpu.models import tmgcn as jtm
from tmgcn_tpu.models import wdgcn as jwd
from tmgcn_tpu.ops.mtransform import m_transform_coo as j_m_transform_coo
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.tasks import metrics as jmetrics
from tmgcn_tpu.train import loop as jloop
from tmgcn_tpu.train import losses as jlosses
from tmgcn_torch import cli
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda
from tmgcn_torch.models import evolvegcn as tev
from tmgcn_torch.models import tmgcn as ttm
from tmgcn_torch.models import wdgcn as twd
from tmgcn_torch.ops.mtransform import m_transform_coo
from tmgcn_torch.ops.spmm import pack_operator
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks import metrics as tmetrics
from tmgcn_torch.train import loop as tloop
from tmgcn_torch.train import losses as tlosses
from tests.test_torch_synthetic import SMALL_SEIR, assert_losses_close, run_both

T, N, F0, HIDDEN = 8, 30, 5, (6, 2)
WINDOWS = ("train", "val", "test")
SEIR_PRESETS = tuple(f"seir_{m}_reg{t}" for m in ("tmgcn", "evolvegcn", "wdgcn")
                     for t in ("", "_tuned"))


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _close(a, b, tol=1e-5, what=""):
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=1e-5, err_msg=what)


# ---------------------------------------------------------------- loss, metric


@pytest.mark.parametrize("shape", [(4, 7), (3, 5, 2)])
def test_summed_per_slice_mse_matches_jax(shape):
    rng = np.random.default_rng(1)
    pred = rng.standard_normal(shape).astype(np.float32)
    truth = rng.standard_normal(shape).astype(np.float32)
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = tlosses.summed_per_slice_mse(p, torch.from_numpy(truth))
    loss.backward()
    ref, grad = jax.value_and_grad(jlosses.summed_per_slice_mse)(jnp.asarray(pred),
                                                                jnp.asarray(truth))
    assert loss.dtype == torch.float32
    _close(loss.item(), ref, 1e-6)
    _close(p.grad.numpy(), grad)


def test_l1_and_ratio_matches_jax_with_a_zero_norm_slice():
    """Float64 on the host; a slice whose targets are all 0 gives an
    infinite ratio, as the reference's division does."""
    rng = np.random.default_rng(2)
    pred = rng.standard_normal((4, 9)).astype(np.float32)
    truth = (rng.random((4, 9)) < 0.5).astype(np.float64)
    got, ref = tmetrics.l1_and_ratio(pred, truth), jmetrics.l1_and_ratio(pred, truth)
    assert got == ref and np.all(np.isfinite(got))
    truth[2] = 0.0
    got, ref = tmetrics.l1_and_ratio(pred, truth), jmetrics.l1_and_ratio(pred, truth)
    assert got == ref
    assert np.isfinite(got[0]) and np.isinf(got[1])


# ---------------------------------------------------------------- models


@pytest.fixture(scope="module")
def problem():
    """A small temporal graph (row-normalized, so the losses stay finite),
    float32 features, M."""
    rng = np.random.default_rng(0)
    dense = (rng.random((T, N, N)) < 0.15) * rng.random((T, N, N))
    dense = dense / np.maximum(dense.sum(-1, keepdims=True), 1.0)
    X = rng.standard_normal((T, N, F0)).astype(np.float32)
    M = make_m_matrix(T, 3).astype(np.float32)
    return dense, X, M


def _grads_match(tvars, t_out, jfun, jvars, tol=1e-5):
    """The (T, N) outputs and every parameter's gradient of <out, G>."""
    G = np.random.default_rng(7).standard_normal(t_out.shape).astype(np.float32)
    (t_out * torch.from_numpy(G)).sum().backward()

    def f(p):
        o = jfun({"params": p, "buffers": jvars["buffers"]})
        return jnp.vdot(o, jnp.asarray(G, o.dtype)), o

    (_, ref), grads = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, jvars["params"]))
    assert tuple(t_out.shape) == ref.shape == (T, N)
    _close(t_out.detach().numpy(), ref, what="outputs")
    ours, theirs = dict(_leaves(tvars["params"])), dict(_leaves(_np_tree(grads)))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        _close(ours[k].grad.numpy(), theirs[k], tol, what=k)


def _port_vars(jvars):
    tvars = params_from_jax(jvars)
    for _, v in _leaves(tvars["params"]):
        v.requires_grad_(True)
    return tvars


@pytest.mark.parametrize("case", ["cached", "uncached", "uncondensed", "minv", "pallas"])
def test_tmgcn_reg_matches_jax(problem, case):
    dense, X, M = problem
    kw = {"n_slices": T, "in_feat": F0, "hidden_feat": HIDDEN,
          "condensed_W": case != "uncondensed", "use_Minv": case == "minv"}
    jm = jtm.TMGCNReg(**kw, spmm_impl="pallas" if case == "pallas" else "jnp")
    tm = ttm.TMGCNReg(**kw, spmm_impl="pallas" if case == "pallas" else "jnp")
    Ct_j = j_m_transform_coo(JaxCOO.from_dense(dense), M)
    Ct_t = m_transform_coo(TemporalCOO.from_dense(dense), M)
    jvars = _np_tree(jm.init(jax.random.PRNGKey(1)))
    assert jvars["params"]["W"].shape == ((F0, 6) if case != "uncondensed" else (T, F0, 6))
    tvars = _port_vars(jvars)
    Xt, Mt = torch.from_numpy(X), torch.from_numpy(M)
    cached_t = cached_j = None
    if case in ("cached", "pallas"):
        cached_t = tm.propagate(Ct_t, Xt, Mt)
        cached_j = jm.propagate(Ct_j, jnp.asarray(X), jnp.asarray(M))
        _close(cached_t.numpy(), cached_j, what="propagation")
    before = spmm_cuda.windowed_segment_matmul.launches
    out = tm.apply(tvars, Ct_t, Xt, Mt, cached_t)
    assert spmm_cuda.windowed_segment_matmul.launches == before  # the plain version here
    _grads_match(tvars, out,
                 lambda v: jm.apply(v, Ct_j, jnp.asarray(X), jnp.asarray(M), cached_j), jvars)


@pytest.mark.parametrize("cached", [True, False])
def test_evolvegcn_reg_matches_jax(problem, cached):
    dense, X, _ = problem
    kw = {"n_slices": T, "in_feat": F0, "hidden_feat": HIDDEN}
    jm, tm = jev.EvolveGCNReg(**kw), tev.EvolveGCNReg(**kw)
    A_j, A_t = JaxCOO.from_dense(dense), TemporalCOO.from_dense(dense)
    jvars = _np_tree(jm.init(jax.random.PRNGKey(2)))
    assert set(jvars["buffers"]) == {"W_init1"}
    tvars = _port_vars(jvars)
    Xt = torch.from_numpy(X)
    AX_t = tm.propagate(A_t, Xt) if cached else None
    AX_j = jm.propagate(A_j, jnp.asarray(X)) if cached else None
    out = tm.apply(tvars, A_t, Xt, AX=AX_t)
    _grads_match(tvars, out, lambda v: jm.apply(v, A_j, jnp.asarray(X), AX=AX_j), jvars, 1e-4)


def test_evolvegcn_reg_embed_dtype_and_w_init(problem):
    """embed_dtype float64 keeps the embeddings (and outputs) in float64;
    an explicit W_init is the start of the weight loop."""
    dense, X, _ = problem
    kw = {"n_slices": T, "in_feat": F0, "hidden_feat": HIDDEN}
    jm = jev.EvolveGCNReg(**kw, embed_dtype=jnp.float64)
    tm = tev.EvolveGCNReg(**kw, embed_dtype=torch.float64)
    A_j, A_t = JaxCOO.from_dense(dense), TemporalCOO.from_dense(dense)
    jvars = _np_tree(jm.init(jax.random.PRNGKey(3)))
    tvars = params_from_jax(jvars)
    W0 = np.random.default_rng(4).standard_normal((F0, 6)).astype(np.float32)
    with torch.no_grad():
        out = tm.apply(tvars, A_t, torch.from_numpy(X), W_init=torch.from_numpy(W0))
    ref = jm.apply(jvars, A_j, jnp.asarray(X), W_init=jnp.asarray(W0))
    assert out.dtype == torch.float64
    _close(out.numpy(), ref, 1e-4)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_wdgcn_reg_matches_jax(problem, impl):
    """The JAX side through its own impl (the Pallas kernel interpreted for
    "pallas"); the port's "pallas" through the prepacked operator, whose
    K1 runs its plain version on the CPU."""
    dense, X, _ = problem
    kw = {"n_slices": T, "in_feat": F0, "hidden_feat": HIDDEN, "spmm_impl": impl}
    jm, tm = jwd.WDGCNReg(**kw), twd.WDGCNReg(**kw)
    A_j, A_t = JaxCOO.from_dense(dense), TemporalCOO.from_dense(dense)
    if impl == "pallas":
        A_j, A_t = j_make_operator(A_j), pack_operator(A_t, "pallas")
    jvars = _np_tree(jm.init(jax.random.PRNGKey(5)))
    assert set(jvars["params"]) == {"W", "lstm", "lin_w", "lin_b"}
    tvars = _port_vars(jvars)
    out = tm.apply(tvars, A_t, torch.from_numpy(X))
    _grads_match(tvars, out, lambda v: jm.apply(v, A_j, jnp.asarray(X)), jvars, 1e-4)


@pytest.mark.parametrize("model_cls", [ttm.TMGCNReg, tev.EvolveGCNReg, twd.WDGCNReg])
def test_heads_are_drawn_as_nn_linear(model_cls):
    """lin_w (F1, 1) and lin_b (1,) within ±1/√F1, from the generator."""
    model = model_cls(n_slices=4, in_feat=3, hidden_feat=(9, 2))
    v = model.init(torch.Generator().manual_seed(0))
    for name, shape in (("lin_w", (9, 1)), ("lin_b", (1,))):
        t = v["params"][name]
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        assert torch.all(t.abs() <= 1 / 3)
    again = model.init(torch.Generator().manual_seed(0))
    for (k, a), (_, b) in zip(_leaves(v), _leaves(again)):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------- adapter


def _windows(problem):
    dense, X, M = problem
    rng = np.random.default_rng(11)
    dense_w = {"train": dense, "val": dense[::-1].copy(), "test": np.roll(dense, 2, axis=0)}
    feats = {"train": X, "val": X + 0.5, "test": X[::-1].copy()}
    targets = {w: rng.random((T, N)).astype(np.float32) for w in WINDOWS}
    return dense_w, feats, targets, M


def _adapters(problem, family, impl="jnp"):
    dense_w, feats, targets, M = _windows(problem)
    kw = {"n_slices": T, "in_feat": F0, "hidden_feat": HIDDEN}
    spmm = {} if family == "evolvegcn" else {"spmm_impl": impl}
    jm = {"tmgcn": jtm.TMGCNReg, "evolvegcn": jev.EvolveGCNReg, "wdgcn": jwd.WDGCNReg}[family]
    tm = {"tmgcn": ttm.TMGCNReg, "evolvegcn": tev.EvolveGCNReg, "wdgcn": twd.WDGCNReg}[family]
    adj_j = {w: JaxCOO.from_dense(d) for w, d in dense_w.items()}
    adj_t = {w: TemporalCOO.from_dense(d) for w, d in dense_w.items()}
    if family == "tmgcn":
        adj_j = {w: j_m_transform_coo(a, M) for w, a in adj_j.items()}
        adj_t = {w: m_transform_coo(a, M) for w, a in adj_t.items()}
    ja = jad.make_regression_adapter(jm(**kw, **spmm), adj_j, feats, M=M)
    ta = tad.make_regression_adapter(tm(**kw, **spmm), adj_t, feats, M=M, device="cpu")
    return ja, ta, targets


BRANCHES = {"tmgcn": "cached", "evolvegcn": "cached_ax", "wdgcn": None}


@pytest.mark.parametrize("family,impl", [("tmgcn", "jnp"), ("tmgcn", "pallas"),
                                         ("evolvegcn", "jnp"), ("wdgcn", "jnp"),
                                         ("wdgcn", "pallas")])
def test_adapter_branches_match_jax(problem, family, impl):
    """Each window's outputs, the train window's gradients; the bundles
    cache what the JAX package's cache (TM-GCN's propagation, EvolveGCN's
    AX, nothing for WD-GCN), prepack the impl's operator only for TM-GCN
    and WD-GCN, and carry M only for TM-GCN; the carry stays ()."""
    ja, ta, _ = _adapters(problem, family, impl)
    for w in WINDOWS:
        keys_t = {k for k in ta.bundles[w] if k not in ("adj", "X")}
        keys_j = {k for k in ja.bundles[w] if k not in ("adj", "X")}
        assert keys_t == keys_j == ({"M", "cached"} if family == "tmgcn" else
                                    {BRANCHES[family]} - {None}), w
        packed = not isinstance(ta.bundles[w]["adj"], TemporalCOO)
        assert packed == (impl == "pallas")
    jvars = _np_tree(ja.init(jax.random.PRNGKey(6)))
    tvars = _port_vars(jvars)
    out, carry = ta.apply(tvars, ta.bundles["train"], ())
    assert carry == ()
    _grads_match(tvars, out, lambda v: ja.apply(v, ja.bundles["train"], ())[0], jvars,
                 1e-5 if family == "tmgcn" else 1e-4)
    with torch.no_grad():
        for w in ("val", "test"):
            out, carry = ta.apply(tvars, ta.bundles[w], ())
            ref, _ = ja.apply(jvars, ja.bundles[w], ())
            assert carry == ()
            _close(out.numpy(), ref, 1e-4, what=w)


def test_adapter_shares_one_bundle_for_equal_windows(problem):
    dense, X, M = problem
    A = TemporalCOO.from_dense(dense)
    ad = tad.make_regression_adapter(tev.EvolveGCNReg(T, F0, HIDDEN), {w: A for w in WINDOWS},
                                     {w: X for w in WINDOWS}, device="cpu")
    assert ad.bundles["train"] is ad.bundles["val"] is ad.bundles["test"]
    with pytest.raises(TypeError, match="regression"):
        tad.make_regression_adapter(ttm.TMGCN(T, F0, (6, 2)), {w: A for w in WINDOWS},
                                    {w: X for w in WINDOWS}, M=M, device="cpu")


# ---------------------------------------------------------------- the loop

LOOP_CFGS = {
    "untuned": {"lr": 0.01},
    "tuned": {"lr": 1e-3, "optimizer": "adam", "grad_clip": 1.0},
}


@pytest.mark.parametrize("family", ["tmgcn", "evolvegcn", "wdgcn"])
@pytest.mark.parametrize("setting", list(LOOP_CFGS))
def test_run_regression_matches_jax(problem, family, setting):
    """7 epochs in chunks of 3: the loss of every epoch, val and test L1 and
    L1 ratio scored once at the end, from the same variables."""
    ja, ta, targets = _adapters(problem, family)
    kw = dict(n_epochs=7, eval_every=3, **LOOP_CFGS[setting])
    variables = ja.init(jax.random.PRNGKey(8))
    res_j, _ = jloop.run_regression(ja, targets, jloop.TrainConfig(**kw), variables=variables)
    res_t, trained = tloop.run_regression(ta, targets, tloop.TrainConfig(**kw),
                                          variables=params_from_jax(_np_tree(variables)))
    assert res_t.keys() == res_j.keys() == {"train_loss", "val_l1", "val_l1_ratio", "test_l1",
                                            "test_l1_ratio"}
    assert res_t["train_loss"].shape == (7,)
    assert_losses_close(res_t["train_loss"], res_j["train_loss"])
    for k in ("val_l1", "val_l1_ratio", "test_l1", "test_l1_ratio"):
        assert np.isfinite(res_j[k])
        np.testing.assert_allclose(res_t[k], res_j[k], rtol=1e-4, err_msg=k)
    assert not any(v.requires_grad for _, v in _leaves(trained["params"]))


def test_train_chunks_regression_is_the_eager_algorithm(problem):
    """The step that ``train_chunks(task="regression")`` builds, 5 epochs
    in chunks of 2, 2 and 1, against the plain algorithm written out:
    forward, summed per-slice MSE on the float32 targets, backward, SGD
    with momentum. Losses and parameters bitwise; stats rows are [loss]."""
    _, ta, targets = _adapters(problem, "tmgcn")
    variables = ta.init(torch.Generator().manual_seed(3))
    cfg = tloop.TrainConfig(n_epochs=5)
    chunks, eval_forward, trained = tloop.train_chunks(
        ta, targets["train"], None, cfg, task="regression",
        variables={"params": {k: v.clone() for k, v in variables["params"].items()},
                   "buffers": {}})
    assert type(chunks) is tloop._EagerChunks
    for n in (2, 2, 1):
        out, carry = chunks(n)
    assert carry == () and tuple(out.shape) == (T, N)
    stats = chunks.stats(5)
    assert stats.shape == (5, 1) and stats.dtype == torch.float64

    params = {k: v.clone().requires_grad_(True) for k, v in variables["params"].items()}
    trace = {k: torch.zeros_like(v) for k, v in params.items()}
    y = torch.from_numpy(targets["train"].astype(np.float32))
    losses = []
    for _ in range(5):
        out, _ = ta.apply({"params": params, "buffers": {}}, ta.bundles["train"], ())
        loss = torch.sum(torch.mean((out - y) ** 2, dim=1))
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                trace[k].mul_(0.9).add_(g)
                p.add_(trace[k], alpha=-0.01)
        losses.append(loss.item())
    assert stats[:, 0].tolist() == losses
    for k in params:
        assert torch.equal(trained["params"][k], params[k]), k
    with torch.no_grad():
        val, _ = eval_forward("val", ())
    assert tuple(val.shape) == (T, N)


def test_trial_chunks_run_the_step_that_run_trial_trains():
    """configs.build.trial_chunks of a SEIR experiment (what profile_slice
    and chip_smoke.py time) steps as run_trial's run_regression does from
    the same generator: the same losses, bitwise."""
    cfg = dataclasses.replace(tpresets.get_preset("seir_wdgcn_reg_tuned"), **SMALL_SEIR,
                              eval_every=2)
    exp = tbuild.build_experiment(cfg, device="cpu")
    tcfg = tbuild.train_config(cfg, 5)
    res = tbuild.run_trial(exp, tcfg, None, torch.Generator().manual_seed(5))
    chunks = tbuild.trial_chunks(exp, tcfg, None, torch.Generator().manual_seed(5))
    chunks(5)
    assert chunks.stats(5)[:, 0].tolist() == res["train_loss"].tolist()


# ---------------------------------------------------------------- presets


@pytest.mark.parametrize("preset", SEIR_PRESETS)
def test_seir_preset_runs_like_jax(monkeypatch, preset):
    """Each SEIR preset at 60 nodes x 20 slices, 12 epochs in chunks of 5:
    the port's run_experiment against the JAX package's, one result per
    trial keyed (0, None). The untuned presets diverge on both sides."""
    cfg_t = dataclasses.replace(tpresets.get_preset(preset), **SMALL_SEIR, eval_every=5)
    cfg_j = dataclasses.replace(jpresets.get_preset(preset), **SMALL_SEIR, eval_every=5)
    res_t, res_j, adapter = run_both(monkeypatch, cfg_t, cfg_j, 12)
    assert list(res_t) == [(0, None)]
    got, ref = res_t[(0, None)], res_j[(0, None)]
    assert got["train_loss"].shape == (12,)
    assert_losses_close(got["train_loss"], ref["train_loss"])
    for k in ("val_l1", "val_l1_ratio", "test_l1", "test_l1_ratio"):
        if np.isfinite(ref[k]):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
        else:
            assert not np.isfinite(got[k]), k
    if preset.endswith("_tuned"):
        assert np.all(np.isfinite(got["train_loss"]))
        # spmm_impl="pallas": K1's operator only for TM-GCN and WD-GCN.
        packed = not isinstance(adapter.bundles["train"]["adj"], TemporalCOO)
        assert packed == (cfg_t.method != "evolvegcn")


def test_regression_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuild.run_experiment(tpresets.get_preset("seir_wdgcn_reg_tuned"), n_epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", "seir_tmgcn_reg_tuned", "--epochs", "1"])


def test_regression_on_a_mesh_is_not_ported():
    """Regression shards now: on the 1 x 1 mesh (this process as the world)
    seir_tmgcn_reg_tuned's result is the unsharded run's (train losses, val
    and test L1 and L1 ratio rtol 1e-3); a mesh larger than the world
    raises naming the world size."""
    from tmgcn_torch.parallel import distributed

    distributed.initialize("cpu")
    cfg = tpresets.get_preset("seir_tmgcn_reg_tuned")
    (sharded,) = tbuild.run_experiment(cfg, n_epochs=4, verbose=False, device="cpu",
                                       mesh_shape=(1, 1))["results"].values()
    (plain,) = tbuild.run_experiment(cfg, n_epochs=4, verbose=False,
                                     device="cpu")["results"].values()
    assert sharded.keys() == plain.keys()
    for k, v in plain.items():
        np.testing.assert_allclose(sharded[k], v, rtol=1e-3, err_msg=k)
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices \(the world size\)"):
        tbuild.run_experiment(cfg, n_epochs=1, device="cpu", mesh_shape=(2, 1))


def test_cli_runs_seir_regression_on_the_cpu(tmp_path):
    """``cli run seir_tmgcn_reg_tuned --epochs 5 --device cpu`` at the
    preset's size (200 nodes, 100 slices; no --data-dir): the results
    pickle holds the result dict, the summary its scalars (train_loss
    None, as the JAX CLI writes it)."""
    argv = ["run", "seir_tmgcn_reg_tuned", "--epochs", "5", "--device", "cpu", "--out",
            str(tmp_path), "--quiet"]
    assert cli.main(argv) == 0
    with open(tmp_path / "results_seir_tmgcn_reg_tuned_tr0.pkl", "rb") as f:
        res = pickle.load(f)
    assert res["train_loss"].shape == (5,) and np.all(np.isfinite(res["train_loss"]))
    summary = json.loads((tmp_path / "summary_seir_tmgcn_reg_tuned.json").read_text())
    run = summary["runs"]["seir_tmgcn_reg_tuned_tr0"]
    assert run["train_loss"] is None
    assert run["val_l1"] == res["val_l1"] and np.isfinite(run["test_l1_ratio"])

"""Checkpoints and resume of the port (train/checkpoint.py and the loops'
checkpointer), on the CPU, against the JAX package's resumed runs.

* The round trip: nested params (WD-GCN's ``lstm``), the SGD trace, Adam's
  mu, nu and float64 count, the float64 results rows and the buffers come
  back exactly; the file loads under ``weights_only=True``; ``max_to_keep``
  is honoured; an empty directory has no latest epoch; a stray temporary
  file is never taken for a checkpoint; the restore copies into the
  step's own tensors (the same ``data_ptr`` before and after).
* Resume, built as tests/test_train_extras.py's ``TestResume`` builds it:
  a short run that saves, then a longer run with the same checkpointer.
  Classification and link prediction (tests/test_torch_chunk.py's small
  float64 graphs) and regression with Adam and clipping (a float64
  TMGCNReg on the same dyadic graph): the port's resumed rows against the
  JAX package's resumed rows from the same initial variables, every
  column, rtol 1e-10 (float64 on both sides; only the order of sums
  differs); the port's resumed train columns against its own
  uninterrupted run, bitwise. The resumed
  run's evaluation epochs are shifted by one against the uninterrupted
  run's (the JAX package resumes with an evaluation epoch), so only its
  train columns equal that run's.
* ``run_experiment`` of 2 trials x 2 alphas with ``checkpoint_dir``, twice:
  the second call resumes every run (one run's directory removed, so it
  trains anew from the shared generator) and gives the first call's rows.
* A checkpoint past the run's last epoch is refused (the JAX package
  fails there in a numpy broadcast).
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.test_torch_chunk import (
    CLS_CW, F0, LP_CW, N, _cls_setup, _graph, _lp_setup, _np_tree,
)
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.models import tmgcn as jtm
from tmgcn_tpu.ops.mtransform import m_transform_coo as j_m_transform_coo
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.train import loop as jloop
from tmgcn_tpu.train.checkpoint import RunCheckpointer as JaxCheckpointer
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models import tmgcn as ttm
from tmgcn_torch.ops.mtransform import m_transform_coo
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.train import loop as tloop
from tmgcn_torch.train.checkpoint import RunCheckpointer

RTOL = 1e-10  # float64 on both sides: only the order of sums differs
WINDOWS = ("train", "val", "test")


def _tree():
    """WD-GCN's nesting: W, an ``lstm`` dict of gate weights, U."""
    g = torch.Generator().manual_seed(0)
    return {"W": torch.randn(4, 3, generator=g),
            "lstm": {"W_i": torch.randn(3, 3, generator=g), "b_i": torch.randn(3, generator=g)},
            "U": torch.randn(6, 2, generator=g, dtype=torch.float64)}


def _assert_tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _trained_optimizer(optimizer, params):
    """An optimizer that has taken 3 steps on ``params`` (non-zero state)."""
    leaves = tloop._tree_leaves(params)
    opt = tloop._Optimizer(tloop.TrainConfig(optimizer=optimizer, grad_clip=1.0), leaves)
    for i in range(3):
        opt.step([torch.full_like(p, 0.1 * (i + 1)) for p in leaves])
    return opt


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_round_trip_restores_in_place(tmp_path, optimizer):
    params = _tree()
    opt = _trained_optimizer(optimizer, params)
    results = np.random.default_rng(1).random((5, 12))
    buffers = {"U": torch.ones(2, 2), "h_init": torch.zeros(3)}
    ck = RunCheckpointer(tmp_path / "run")
    ck.save(4, params, opt.state_dict(), results, buffers=buffers)
    assert ck.latest_epoch() == 4

    # Everything loads under weights_only (no numpy or Python objects).
    state = torch.load(tmp_path / "run" / "ckpt_4.pt", weights_only=True)
    assert state["results"].dtype == torch.float64
    np.testing.assert_array_equal(state["results"].numpy(), results)
    _assert_tree_equal(state["buffers"], buffers)
    assert set(state["opt_state"]) == ({"mu"} if optimizer == "sgd" else {"mu", "nu", "count"})
    if optimizer == "adam":
        assert state["opt_state"]["count"].dtype == torch.float64
        assert state["opt_state"]["count"].item() == 3.0

    # Restore into a fresh step's tensors: copied in place, equal values.
    fresh = tloop._tree_map(torch.zeros_like, params)
    fresh_opt = tloop._Optimizer(tloop.TrainConfig(optimizer=optimizer, grad_clip=1.0),
                                 tloop._tree_leaves(fresh))
    own = {id(t): t.data_ptr() for t in
           [*tloop._tree_leaves(fresh), *fresh_opt.mu, *fresh_opt.nu]
           + ([fresh_opt.count] if fresh_opt.count is not None else [])}
    step, rows = tloop._restore(ck, fresh, fresh_opt)
    assert step == 4
    np.testing.assert_array_equal(rows, results)
    _assert_tree_equal(fresh, params)
    for mine, theirs in zip(fresh_opt.mu + fresh_opt.nu, opt.mu + opt.nu):
        assert torch.equal(mine, theirs)
    if optimizer == "adam":
        assert torch.equal(fresh_opt.count, opt.count)
    after = [*tloop._tree_leaves(fresh), *fresh_opt.mu, *fresh_opt.nu]
    after += [fresh_opt.count] if fresh_opt.count is not None else []
    assert {id(t): t.data_ptr() for t in after} == own


def test_max_to_keep_and_the_newest_epoch(tmp_path):
    ck = RunCheckpointer(tmp_path / "run", max_to_keep=3)
    params = {"W": torch.zeros(2)}
    for ep in (0, 99, 199, 1000, 299):
        ck.save(ep, {"W": params["W"] + ep}, {"mu": []}, np.zeros((1, 9)))
    names = sorted(p.name for p in (tmp_path / "run").iterdir())
    assert names == ["ckpt_1000.pt", "ckpt_199.pt", "ckpt_299.pt"]
    assert ck.latest_epoch() == 1000  # by epoch number, not by the order saved
    step, state = ck.restore()
    assert step == 1000 and state["params"]["W"].tolist() == [1000.0, 1000.0]


def test_empty_directory_and_stray_temporary_files(tmp_path):
    ck = RunCheckpointer(tmp_path / "run")
    assert ck.latest_epoch() is None
    assert ck.restore() is None
    assert ck.restore_inference({}, {}) is None
    # A save cut short leaves only its temporary file: never a checkpoint.
    (tmp_path / "run" / ".ckpt_7.pt.tmp").write_bytes(b"cut short")
    (tmp_path / "run" / "ckpt_8.pt.partial").write_bytes(b"")
    assert ck.latest_epoch() is None
    ck.save(3, {"W": torch.ones(2)}, {"mu": []}, np.zeros(4))
    assert ck.latest_epoch() == 3
    assert ck.restore()[1]["params"]["W"].tolist() == [1.0, 1.0]
    ck.close()


def test_restore_inference_casts_and_keeps_unsaved_buffers(tmp_path):
    ck = RunCheckpointer(tmp_path / "run")
    params = {"W": torch.randn(3, 2, dtype=torch.float64), "lstm": {"b": torch.randn(2)}}
    ck.save(5, params, {"mu": []}, np.zeros(3), buffers={"U": torch.full((2, 2), 7.0)})
    tmpl = {"W": torch.zeros(3, 2), "lstm": {"b": torch.zeros(2, dtype=torch.float64)}}
    step, p, b = ck.restore_inference(tmpl, {"U": torch.zeros(2, 2, dtype=torch.float64)})
    assert step == 5
    assert p["W"].dtype == torch.float32 and p["lstm"]["b"].dtype == torch.float64
    torch.testing.assert_close(p["W"], params["W"].float(), rtol=0, atol=0)
    assert b["U"].dtype == torch.float64 and b["U"].tolist() == [[7.0, 7.0], [7.0, 7.0]]
    # Buffers of another nesting (a checkpoint saved without them): the
    # caller's template stays.
    other = {"W_init1": torch.zeros(3, 2)}
    _, _, b = ck.restore_inference(tmpl, other)
    assert b is other


def test_load_state_dict_refuses_another_optimizer(tmp_path):
    params = _tree()
    sgd = _trained_optimizer("sgd", params)
    adam = _trained_optimizer("adam", _tree())
    with pytest.raises(ValueError, match="does not fit"):
        adam.load_state_dict(sgd.state_dict())
    with pytest.raises(ValueError, match="does not fit"):
        sgd.load_state_dict({"mu": sgd.mu[:1]})
    with pytest.raises(ValueError, match="do not fit"):
        tloop._copy_tree_(_tree(), {"W": torch.zeros(4, 3)})


# ---------------------------------------------------------------- resume

N_SHORT, N_FULL, EVAL_EVERY = 4, 8, 3


def _resume_both(tmp_path, run_j, run_t, jvars):
    """(port uninterrupted, port resumed, JAX resumed) rows: a run of
    N_SHORT epochs that saves, then one of N_FULL with the same
    checkpointer, on each side from the same initial variables."""
    tvars = params_from_jax(_np_tree(jvars))
    full_t = run_t(N_FULL, tvars, None)
    ck_t = RunCheckpointer(tmp_path / "port")
    run_t(N_SHORT, tvars, ck_t)
    resumed_t = run_t(N_FULL, tvars, ck_t)
    ck_j = JaxCheckpointer(tmp_path / "jax")
    run_j(N_SHORT, jvars, ck_j)
    resumed_j = run_j(N_FULL, jvars, ck_j)
    ck_j.close()
    return full_t, resumed_t, resumed_j, ck_t


def test_a_checkpoint_past_the_run_is_refused(tmp_path):
    """A checkpoint of an epoch at or past the run's last: the JAX package
    fails in a numpy broadcast, the port says why."""
    ad_j, ad_t, splits = _cls_setup("tmgcn1")
    jvars = ad_j.init(jax.random.PRNGKey(0))
    ck_j, ck_t = JaxCheckpointer(tmp_path / "jax"), RunCheckpointer(tmp_path / "port")
    jloop.run_edge_classification(ad_j, splits, CLS_CW,
                                  jloop.TrainConfig(n_epochs=8, eval_every=3),
                                  variables=jvars, checkpointer=ck_j)
    tloop.run_edge_classification(ad_t, splits, CLS_CW,
                                  tloop.TrainConfig(n_epochs=8, eval_every=3),
                                  variables=params_from_jax(_np_tree(jvars)), checkpointer=ck_t)
    assert ck_j.latest_epoch() == ck_t.latest_epoch() == 6
    with pytest.raises(ValueError, match="broadcast"):
        jloop.run_edge_classification(ad_j, splits, CLS_CW, jloop.TrainConfig(n_epochs=4),
                                      variables=jvars, checkpointer=ck_j)
    with pytest.raises(ValueError, match="epoch 6, past this run's 4 epochs"):
        tloop.run_edge_classification(ad_t, splits, CLS_CW, tloop.TrainConfig(n_epochs=4),
                                      checkpointer=ck_t)
    # At the run's last epoch exactly, nothing is left to train: its rows.
    rows, _ = tloop.run_edge_classification(ad_t, splits, CLS_CW, tloop.TrainConfig(n_epochs=7),
                                            checkpointer=ck_t)
    assert rows.shape == (7, 12)
    ck_j.close()


def _assert_rows_close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=RTOL, atol=0)


@pytest.mark.parametrize("opt", ["sgd", "adam_clip"])
def test_classification_resumes_like_jax(tmp_path, opt):
    kw = {"sgd": {}, "adam_clip": {"optimizer": "adam", "grad_clip": 1.0}}[opt]
    ad_j, ad_t, splits = _cls_setup("tmgcn1")

    def run_j(n, variables, ck):
        cfg = jloop.TrainConfig(n_epochs=n, eval_every=EVAL_EVERY, **kw)
        return jloop.run_edge_classification(ad_j, splits, CLS_CW, cfg, variables=variables,
                                             checkpointer=ck)[0]

    def run_t(n, variables, ck):
        cfg = tloop.TrainConfig(n_epochs=n, eval_every=EVAL_EVERY, **kw)
        return tloop.run_edge_classification(ad_t, splits, CLS_CW, cfg, variables=variables,
                                             checkpointer=ck)[0]

    jvars = ad_j.init(jax.random.PRNGKey(7))
    full, resumed, resumed_j, ck = _resume_both(tmp_path, run_j, run_t, jvars)
    # The short run saved at its evaluation epochs 0 and 3; the resumed run
    # evaluates at 4 and 7 and saves there.
    assert ck.latest_epoch() == 7
    _assert_rows_close(resumed, resumed_j)
    # Train precision, recall, F1 and loss: bitwise the uninterrupted run's.
    np.testing.assert_array_equal(resumed[:, :4], full[:, :4])
    np.testing.assert_array_equal(resumed[:4], full[:4])  # the restored rows


def test_link_prediction_resumes_like_jax(tmp_path):
    ad_j, ad_t, splits = _lp_setup("tmgcn1_pallas")

    def run_j(n, variables, ck):
        cfg = jloop.TrainConfig(n_epochs=n, eval_every=EVAL_EVERY)
        return jloop.run_link_prediction(ad_j, splits, LP_CW, cfg, variables=variables,
                                         checkpointer=ck)[0]

    def run_t(n, variables, ck):
        cfg = tloop.TrainConfig(n_epochs=n, eval_every=EVAL_EVERY)
        return tloop.run_link_prediction(ad_t, splits, LP_CW, cfg, variables=variables,
                                         checkpointer=ck)[0]

    jvars = ad_j.init(jax.random.PRNGKey(5))
    full, resumed, resumed_j, ck = _resume_both(tmp_path, run_j, run_t, jvars)
    assert ck.latest_epoch() == 7
    _assert_rows_close(resumed, resumed_j)
    # The train loss of every epoch; the chunk epochs' train MAP/MRR are
    # copied from their evaluation epoch, which the resume shifts.
    np.testing.assert_array_equal(resumed[:, 2], full[:, 2])
    np.testing.assert_array_equal(resumed[:4], full[:4])


def _regression_adapters():
    """A float64 TMGCNReg on tests/test_torch_chunk.py's dyadic graph (8
    slices; the M-transform exact on both sides), float32 targets."""
    rng, dense, X, Mm = _graph()
    T = Mm.shape[0]
    dense, X = dense[:T], X[:T]
    targets = {w: rng.random((T, N)).astype(np.float32) for w in WINDOWS}
    kw = {"n_slices": T, "in_feat": F0, "hidden_feat": (4, 2)}
    Aj = j_m_transform_coo(JaxCOO.from_dense(dense, dtype=np.float32, pad_multiple=16), Mm)
    At = m_transform_coo(TemporalCOO.from_dense(dense, pad_multiple=16), Mm)
    ja = jad.make_regression_adapter(jtm.TMGCNReg(dtype=np.float64, **kw),
                                     {w: Aj for w in WINDOWS}, {w: X for w in WINDOWS}, M=Mm)
    ta = tad.make_regression_adapter(ttm.TMGCNReg(dtype=torch.float64, **kw),
                                     {w: At for w in WINDOWS}, {w: X for w in WINDOWS}, M=Mm,
                                     device="cpu")
    return ja, ta, targets


def test_regression_with_adam_and_clipping_resumes_like_jax(tmp_path):
    """Regression saves after each chunk, so its resumed run is the
    uninterrupted one: losses and val/test L1 bitwise."""
    ja, ta, targets = _regression_adapters()
    kw = {"eval_every": 2, "lr": 1e-3, "optimizer": "adam", "grad_clip": 1.0}

    def run_j(n, variables, ck):
        return jloop.run_regression(ja, targets, jloop.TrainConfig(n_epochs=n, **kw),
                                    variables=variables, checkpointer=ck)[0]

    def run_t(n, variables, ck):
        return tloop.run_regression(ta, targets, tloop.TrainConfig(n_epochs=n, **kw),
                                    variables=variables, checkpointer=ck)[0]

    jvars = ja.init(jax.random.PRNGKey(11))
    full, resumed, resumed_j, ck = _resume_both(tmp_path, run_j, run_t, jvars)
    assert ck.latest_epoch() == N_FULL - 1
    assert resumed.keys() == resumed_j.keys()
    for k, v in resumed.items():
        np.testing.assert_allclose(v, resumed_j[k], rtol=RTOL, atol=0, err_msg=k)
        np.testing.assert_array_equal(v, full[k], err_msg=k)
    # Adam's count came back: the restored state is the state of epoch 3.
    state = torch.load(ck._path(N_FULL - 1), weights_only=True)
    assert state["opt_state"]["count"].item() == N_FULL


def test_run_experiment_resumes_every_trial_and_alpha(tmp_path):
    """2 trials x 2 alphas, 5 epochs (evaluations at 0, 2 and 4): the
    second call finds every run's checkpoint at its last epoch and returns
    its rows; the run whose directory was removed trains anew from the
    shared generator, which the resumed runs before it still drew from."""
    cfg = dataclasses.replace(
        tpresets.get_preset("sbm_tmgcn_lp"), sbm_n_nodes=40, sbm_n_slices=10, beta1=2,
        beta2=2, eval_every=2, n_trials=2, alpha_vec=(0.9, 0.8),
    )
    ck = tmp_path / "ck"
    first = tbuild.run_experiment(cfg, n_epochs=5, verbose=False, checkpoint_dir=ck,
                                  device="cpu")["results"]
    tags = sorted(p.name for p in (ck / cfg.name).iterdir())
    assert tags == ["tr0_w80", "tr0_w90", "tr1_w80", "tr1_w90"]
    for tag in tags:
        assert RunCheckpointer(ck / cfg.name / tag).latest_epoch() == 4
    shutil.rmtree(ck / cfg.name / "tr1_w80")
    second = tbuild.run_experiment(cfg, n_epochs=5, verbose=False, checkpoint_dir=ck,
                                   device="cpu")["results"]
    assert first.keys() == second.keys()
    for key in first:
        np.testing.assert_array_equal(second[key], first[key], err_msg=str(key))
    # Without checkpoints the same sweep gives the same rows.
    plain = tbuild.run_experiment(cfg, n_epochs=5, verbose=False, device="cpu")["results"]
    for key in first:
        np.testing.assert_array_equal(plain[key], first[key], err_msg=str(key))

"""``cli predict`` of the port and the carry it threads, on the CPU,
against the JAX package.

* ``ModelAdapter.initial_carry``: EvolveGCN-H's frozen initial weights on
  its three adapter paths (gather-free, restricted, generic), equal to the
  JAX adapter's from the same variables; ``()`` for the other families and
  for regression.
* ``predict`` on the same parameters: the JAX package's ``cli run
  --checkpoint-dir`` trains; the params and buffers that its
  ``restore_inference`` returns are written into a port checkpoint; the
  port's ``cli predict --device cpu`` scores must equal the JAX ``cli
  predict`` scores at atol 1e-5 (float32 models; the sums run in another
  order). Presets: ``sbm_tiny_lp`` (TM-GCN link prediction, the preset of
  tests/test_train_extras.py's ``TestPredictCLI``), a 1-layer EvolveGCN-H
  link-prediction preset at a small size (its carry threaded train -> val
  -> test) and a WD-GCN classification preset (its frozen U restored) on
  a small synthetic bitcoin_alpha written by the port's ``synth`` (120
  nodes, windows of 10, 2 and 2 slices).
* The port end to end: ``cli run --checkpoint-dir … --device cpu``, then
  ``cli predict``: the scores give the metric of the saved epoch's row.
"""

import dataclasses
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.test_torch_chunk import _cls_setup, _np_tree
from tests.test_torch_synthetic import SMALL_SBM, _float32_feats
from tmgcn_tpu import cli as jcli
from tmgcn_tpu.configs import build as jbuild
from tmgcn_tpu.configs import presets as jpresets
from tmgcn_tpu.preprocess import datasets as jdatasets
from tmgcn_tpu.train.checkpoint import RunCheckpointer as JaxCheckpointer
from tmgcn_torch import cli
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.configs.build import params_from_jax, run_tag
from tmgcn_torch.preprocess import datasets as tdatasets
from tmgcn_torch.preprocess import synthetic_raw
from tmgcn_torch.tasks import metrics as M
from tmgcn_torch.train.checkpoint import RunCheckpointer

ATOL = 1e-5  # float32 models: the same sums in another order


# ---------------------------------------------------------------- the carry


@pytest.mark.parametrize("case,n", [("evolvegcn1", 1), ("evolvegcn2", 2),
                                    ("evolvegcn1_generic", 1), ("tmgcn1", 0),
                                    ("wdgcn_pallas", 0), ("gcn2_pallas", 0)])
def test_initial_carry_matches_jax(case, n):
    ad_j, ad_t, _ = _cls_setup(case)
    jvars = ad_j.init(jax.random.PRNGKey(3))
    got = ad_t.initial_carry(params_from_jax(_np_tree(jvars)))
    ref = ad_j.initial_carry(jvars)
    assert len(got) == len(ref) == n
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_regression_carry_is_empty():
    from tests.test_torch_checkpoint import _regression_adapters

    _, ta, _ = _regression_adapters()
    assert ta.initial_carry(ta.init(torch.Generator().manual_seed(0))) == ()


# ---------------------------------------------------------------- predict


def _small(name, **small):
    """The preset ``name`` at a small size in both packages' registries."""
    return (dataclasses.replace(tpresets.get_preset(name), **small),
            dataclasses.replace(jpresets.get_preset(name), **small))


def _bitcoin_alpha(tmp_path, monkeypatch):
    """A small synthetic bitcoin_alpha (120 nodes; windows of 10, 2 and 2
    slices in both packages' registries), written by the port's generator
    into two directories (each package caches its artifact beside the raw
    file)."""
    monkeypatch.setitem(synthetic_raw.SYNTH, "bitcoin_alpha",
                        synthetic_raw.SynthSpec(120, 4000, 135))
    for registry in (tdatasets.REGISTRY, jdatasets.REGISTRY):
        spec = registry["bitcoin_alpha"]
        small = dataclasses.replace(spec.preprocess, s_train=10, s_val=2, s_test=2)
        monkeypatch.setitem(registry, "bitcoin_alpha", dataclasses.replace(spec, preprocess=small))
    raw = synthetic_raw.generate("bitcoin_alpha", tmp_path / "raw_j", seed=0)
    shutil.copytree(raw.parent, tmp_path / "raw_t")
    return {"jax": tmp_path / "raw_j", "port": tmp_path / "raw_t"}


# (preset, size overrides, extra run arguments)
PREDICT_CASES = {
    "sbm_tiny_lp": ("sbm_tmgcn_lp", {"sbm_n_nodes": 60, "sbm_n_slices": 10, "beta1": 2,
                                     "beta2": 2, "eval_every": 2}, []),
    "sbm_evolvegcn_lp_small": ("sbm_evolvegcn_lp", {**SMALL_SBM, "eval_every": 2}, []),
    "bitcoin_alpha_wdgcn_cls_small": ("bitcoin_alpha_wdgcn_cls", {"eval_every": 2},
                                      ["--alphas", "0.8"]),
}


@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predict_matches_jax_on_the_same_params(tmp_path, monkeypatch, case):
    base, small, extra = PREDICT_CASES[case]
    cfg_t, cfg_j = _small(base, **small)
    cfg_t, cfg_j = (dataclasses.replace(c, name=case) for c in (cfg_t, cfg_j))
    monkeypatch.setitem(tpresets.PRESETS, case, cfg_t)
    monkeypatch.setitem(jpresets.PRESETS, case, cfg_j)
    # float32 features on the JAX side, as it holds them with x64 off.
    monkeypatch.setattr(jbuild, "build_data", _float32_feats(jbuild.build_data))
    data = {"jax": [], "port": []}
    if base.startswith("bitcoin_alpha"):
        dirs = _bitcoin_alpha(tmp_path, monkeypatch)
        data = {k: ["--data-dir", str(d)] for k, d in dirs.items()}
    alpha = 0.8 if extra else cfg_j.alpha_vec[0]
    pick = ["--alpha", "0.8"] if extra else []

    ck_j = tmp_path / "ck_jax"
    assert jcli.main(["run", case, "--epochs", "3", "--checkpoint-dir", str(ck_j), "--quiet",
                      *data["jax"], *extra]) == 0
    # The trained params and frozen buffers, as JAX's predict restores them,
    # written into a port checkpoint.
    tag = run_tag(0, alpha)
    d = jbuild.build_data(cfg_j, data_dir=data["jax"][1] if data["jax"] else None)
    lp = cfg_j.task == "link_pred"
    in_feat = d.feats["train"].shape[-1]
    model = jbuild.build_model(cfg_j, d.spec.s_train - (1 if lp else 0), in_feat)
    tmpl = model.init(jax.random.PRNGKey(cfg_j.seed))
    jck = JaxCheckpointer(ck_j / case / tag)
    step, params, buffers = jck.restore_inference(tmpl["params"], tmpl["buffers"])
    jck.close()
    assert step == 2
    ck_t = tmp_path / "ck_port"
    RunCheckpointer(ck_t / case / tag).save(
        step, params_from_jax(_np_tree(params)), {"mu": []}, np.zeros((3, 9 if lp else 12)),
        buffers=params_from_jax(_np_tree(buffers)))

    for window in ("val", "test"):
        out_j, out_t = tmp_path / f"j_{window}.npz", tmp_path / f"t_{window}.npz"
        assert jcli.main(["predict", case, "--checkpoint-dir", str(ck_j), "--window", window,
                          "--out", str(out_j), *data["jax"], *pick]) == 0
        assert cli.main(["predict", case, "--checkpoint-dir", str(ck_t), "--window", window,
                         "--out", str(out_t), "--device", "cpu", *data["port"], *pick]) == 0
        zj, zt = np.load(out_j), np.load(out_t)
        assert int(zt["epoch"]) == int(zj["epoch"]) == step
        np.testing.assert_array_equal(zt["edges"], zj["edges"])
        assert zt["scores"].shape == zj["scores"].shape
        np.testing.assert_allclose(zt["scores"], zj["scores"], rtol=0, atol=ATOL)


def test_cli_run_then_predict_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The port alone: 5 epochs (evaluations at 0, 2 and 4, the newest
    checkpoint at 4), then predict --window val: its scores give row 4's
    val MAP and MRR (a TM-GCN has no carry: the saved params are the ones
    that epoch scored)."""
    base, small, _ = PREDICT_CASES["sbm_tiny_lp"]
    cfg, _ = _small(base, **small)
    cfg = dataclasses.replace(cfg, name="sbm_tiny_lp")
    monkeypatch.setitem(tpresets.PRESETS, "sbm_tiny_lp", cfg)
    ck, res_dir = tmp_path / "ck", tmp_path / "res"
    assert cli.main(["run", "sbm_tiny_lp", "--epochs", "5", "--checkpoint-dir", str(ck),
                     "--device", "cpu", "--quiet", "--out", str(res_dir)]) == 0
    rows = np.load(res_dir / "results_sbm_tiny_lp_tr0_w90.pkl", allow_pickle=True)
    out = tmp_path / "val.npz"
    capsys.readouterr()
    assert cli.main(["predict", "sbm_tiny_lp", "--checkpoint-dir", str(ck), "--window", "val",
                     "--out", str(out), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert re.search(r"\[val\] epoch 4: MAP [0-9.]+ MRR [0-9.]+", printed), printed
    z = np.load(out)
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.tasks.windows import split_data_link_prediction

    data = build_data(cfg)
    s = split_data_link_prediction(data.lp_edges, data.lp_labels, data.spec)["val"]
    K = s.n_eval_tail
    mp, mr = M.map_mrr(z["scores"][-K:], s.target[-K:], s.edges[:, -K:])
    assert (mp, mr) == (rows[4, 3], rows[4, 4])


def test_predict_refuses_regression_and_a_missing_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="predict supports edge_cls/link_pred, not 'regression'"):
        cli.main(["predict", "seir_tmgcn_reg", "--checkpoint-dir", str(tmp_path),
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint under"):
        cli.main(["predict", "sbm_tmgcn_lp", "--checkpoint-dir", str(tmp_path),
                  "--device", "cpu"])

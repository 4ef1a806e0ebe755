"""Edge classification on the registry's other datasets against the JAX
package: bitcoin_otc, bitcoin_alpha, reddit and amlsim with TM-GCN, KW-GCN
and EvolveGCN-H (WD-GCN: tests/test_torch_registry_wdgcn_cls.py).

* 5 epochs with two evaluations, from the same variables
  (tests/torch_registry.py's ``loop_pair``), one preset per family:
  bitcoin_otc_tmgcn_cls (comma CSV, 95 slices, the 1-layer fast path),
  amlsim_gcn_cls (amlsim's ``transactions.csv``, 150 slices; the port on
  "pallas", K1's plain version) and bitcoin_alpha_evolvegcn_cls (the
  gather-free path; F1 held to the tie range of its logits).
* Every other classification preset of those datasets through
  ``run_experiment`` on the CPU, 3 epochs at its first alpha, twice: finite
  losses, rates in [0, 1] or NaN, the same rows.
* bitcoin_alpha_tmgcn_cls's whole 21-alpha sweep through ``run_experiment``
  at 2 epochs: every alpha trains, with the class weights the JAX
  package's ``run_experiment`` gives that alpha.
"""

from unittest import mock

import numpy as np
import pytest

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.torch_registry import (
    DATASETS,
    PRESETS,
    assert_rows_close,
    assert_run_sane,
    loop_pair,
    raw_copies,
    run_twice,
)
from tmgcn_tpu.configs import build as jbuild
from tmgcn_tpu.configs import presets as jpresets
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.kernels import spmm_cuda

LOOPS = {"bitcoin_otc_tmgcn_cls": None, "amlsim_gcn_cls": "pallas",
         "bitcoin_alpha_evolvegcn_cls": None}
HELD_ELSEWHERE = {"reddit_wdgcn_cls"}  # tests/test_torch_registry_wdgcn_cls.py
RUNS = [p for p in PRESETS
        if p.endswith("_cls") and p not in LOOPS and p not in HELD_ELSEWHERE]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    with raw_copies(tmp_path_factory.mktemp("registry_cls"),
                    [d for d in DATASETS if d != "uci"]) as copies:
        yield copies


@pytest.mark.parametrize("preset", list(LOOPS))
def test_short_run_matches_jax(dirs, preset):
    ds = tpresets.get_preset(preset).dataset
    before = spmm_cuda.windowed_segment_matmul.launches
    out = loop_pair(preset, {s: dirs[s][ds] for s in dirs}, LOOPS[preset])
    assert spmm_cuda.windowed_segment_matmul.launches == before  # plain versions on the CPU
    assert_rows_close(*out)


def test_runs_cover_every_other_cls_preset():
    assert len(RUNS) == 12 and len(RUNS) + len(LOOPS) + len(HELD_ELSEWHERE) == 16


@pytest.mark.parametrize("preset", RUNS)
def test_run_experiment_is_finite_and_repeatable(dirs, preset):
    run_twice(preset, dirs["torch"][tpresets.get_preset(preset).dataset])


def test_alpha_sweep_class_weights_match_jax(dirs):
    """The bitcoin classification presets sweep alpha over 0.75 ... 0.95:
    each run of the port's sweep trains at the class weights that the JAX
    package's run_experiment passes its loop for the same alpha (its loop
    patched out here: only the weights are compared)."""
    preset = "bitcoin_alpha_tmgcn_cls"
    cfg_t, cfg_j = tpresets.get_preset(preset), jpresets.get_preset(preset)
    assert cfg_t.alpha_vec == cfg_j.alpha_vec and len(cfg_t.alpha_vec) == 21
    seen_t, seen_j = [], []
    real = tbuild.run_edge_classification

    def recording(adapter, splits, cw, *args, **kwargs):
        seen_t.append(np.array(cw))
        return real(adapter, splits, cw, *args, **kwargs)

    def jax_loop(adapter, splits, cw, tcfg, **kwargs):
        seen_j.append(np.array(cw))
        return np.zeros((tcfg.n_epochs, 12)), None

    with mock.patch.object(tbuild, "run_edge_classification", recording):
        out = tbuild.run_experiment(cfg_t, data_dir=dirs["torch"]["bitcoin_alpha"], n_epochs=2,
                                    verbose=False, device="cpu")
    with mock.patch.object(jbuild, "run_edge_classification", jax_loop):
        jout = jbuild.run_experiment(cfg_j, data_dir=dirs["jax"]["bitcoin_alpha"], n_epochs=2,
                                     verbose=False)
    assert list(out["results"]) == list(jout["results"]) == [(0, a) for a in cfg_t.alpha_vec]
    assert len(seen_t) == len(seen_j) == 21
    for alpha, wt, wj in zip(cfg_t.alpha_vec, seen_t, seen_j):
        assert wt.dtype == wj.dtype
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_array_equal(tbuild.class_weights(cfg_t, alpha), wj)
    for rows in out["results"].values():
        assert_run_sane(rows, "edge_cls", 2)

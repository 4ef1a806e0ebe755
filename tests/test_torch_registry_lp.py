"""Link prediction on the registry's other datasets against the JAX package:
bitcoin_otc, bitcoin_alpha, reddit and uci with TM-GCN, KW-GCN and
EvolveGCN-H (WD-GCN: tests/test_torch_registry_wdgcn_lp.py).

* 5 epochs with two evaluations, from the same variables, negatives drawn
  on both sides from ``cfg.seed`` (tests/torch_registry.py's ``loop_pair``),
  one preset per family:
  - uci_tmgcn_lp (uci's whitespace text, fractional-day timestamps): the
    registry's one 2-layer TM-GCN with M^2 and M^3, not restricted, so its
    layer 2 is the full-row SpMM every epoch; the port on "pallas" (K1's
    plain version forward and over the transposed packing backward), the
    JAX side on its preset's "jnp" (the JAX suite holds its operator equal
    to "jnp");
  - bitcoin_alpha_gcn_lp (comma CSV; the port on "pallas");
  - reddit_evolvegcn_lp (the reddit TSV).
* Every other link-prediction preset of those datasets through
  ``run_experiment`` on the CPU, 3 epochs, twice: finite losses, MAP and
  MRR in [0, 1] or NaN, the same rows.
"""

import dataclasses

import pytest

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.torch_registry import (
    DATASETS,
    PRESETS,
    WINDOWS,
    assert_rows_close,
    loop_pair,
    raw_copies,
    run_twice,
)
from tmgcn_tpu import native as jnative
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.kernels import spmm_cuda
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks.windows import split_data_link_prediction

LOOPS = {"uci_tmgcn_lp": "pallas", "bitcoin_alpha_gcn_lp": "pallas",
         "reddit_evolvegcn_lp": None}
HELD_ELSEWHERE = {"uci_wdgcn_lp"}  # tests/test_torch_registry_wdgcn_lp.py
RUNS = [p for p in PRESETS
        if p.endswith("_lp") and p not in LOOPS and p not in HELD_ELSEWHERE]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    with raw_copies(tmp_path_factory.mktemp("registry_lp"),
                    [d for d in DATASETS if d != "amlsim"]) as copies:
        yield copies


@pytest.mark.parametrize("preset", list(LOOPS))
def test_short_run_matches_jax(dirs, preset):
    if not jnative.available():
        pytest.skip("the JAX package's C++ sampler did not load: it draws other negatives")
    ds = tpresets.get_preset(preset).dataset
    before = spmm_cuda.windowed_segment_matmul.launches
    out = loop_pair(preset, {s: dirs[s][ds] for s in dirs}, LOOPS[preset])
    assert spmm_cuda.windowed_segment_matmul.launches == before  # plain versions on the CPU
    assert_rows_close(*out)


def test_uci_tmgcn_lp_runs_the_full_row_layer_2(dirs):
    """uci_tmgcn_lp's adapter: no restricted layer 2 (M^2 and M^3 rule it
    out, as in the JAX package), so layer 2 is the full-row operator of each
    window, K1's packing with "pallas", and the readout plan's backward."""
    cfg = dataclasses.replace(tpresets.get_preset("uci_tmgcn_lp"), spmm_impl="pallas")
    assert cfg.n_layers == 2 and cfg.apply_M_twice and cfg.apply_M_three_times
    data = tbuild.build_data(cfg, data_dir=dirs["torch"]["uci"])
    splits = split_data_link_prediction(data.lp_edges, data.lp_labels, data.spec)
    model = tbuild.build_model(cfg, data.spec.s_train - 1, data.feats["train"].shape[-1])
    adapter = tad.make_edge_adapter(
        model, data.adj, data.feats, {w: splits[w].model_edges for w in WINDOWS}, M=data.M,
        drop_last_slice=True, device="cpu")
    for w in WINDOWS:
        bundle = adapter.bundles[w]
        assert "l2op" not in bundle and "l2s_op" not in bundle
        assert isinstance(bundle["adj"], spmm_cuda.PallasSpmmOperator)
        assert "readout" in bundle


def test_runs_cover_every_other_lp_preset():
    assert len(RUNS) == 12 and len(RUNS) + len(LOOPS) + len(HELD_ELSEWHERE) == 16


@pytest.mark.parametrize("preset", RUNS)
def test_run_experiment_is_finite_and_repeatable(dirs, preset):
    run_twice(preset, dirs["torch"][tpresets.get_preset(preset).dataset])

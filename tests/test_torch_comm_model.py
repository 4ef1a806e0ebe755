"""The port's communication model (tmgcn_torch/utils/comm_model.py): its
host parts on the CPU. The collectives it reckons are held against what the
sharded adapters issue on gloo meshes in tests/test_torch_sharded_recurrent.py;
here its ring formulas against the JAX module's, its parameter counts against
the port's models, the per-family structure of a step, and the fit of
latency and bandwidth on a made-up sweep."""

import numpy as np
import pytest
import torch

from tmgcn_tpu.utils import comm_model as jcm
from tmgcn_torch.utils import comm_model as cm

CHESS = {w.name: w for w in cm.WORKLOADS}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_bytes_as_the_jax_module(n):
    assert cm.moved_bytes(cm.ALL_REDUCE, n, 96) == pytest.approx(jcm.ring_all_reduce_bytes(96, n))
    assert cm.moved_bytes(cm.ALL_GATHER, n, 96) == pytest.approx(jcm.all_gather_bytes(96, n))


@pytest.mark.parametrize("name", sorted(CHESS))
def test_parameter_count_is_the_models(name):
    """The gradient all-reduce's buffer: every trainable parameter of the
    port's model of the preset, nothing frozen."""
    from tmgcn_torch.configs.build import build_model
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.train.loop import _tree_leaves

    w = CHESS[name]
    model = build_model(get_preset(name), w.T, w.F0)
    params = model.init(torch.Generator().manual_seed(0))["params"]
    assert cm.n_params(w) == sum(p.numel() for p in _tree_leaves(params))


def test_one_device_moves_nothing():
    for w in cm.WORKLOADS:
        assert cm.step_comm_bytes(w, 1, 1)["total"] == 0.0
        assert cm.predict_ms(cm.step_collectives(w, 1, 1), {}) == 0.0


def test_plain_step_drops_the_logit_gather():
    """The banded family's plain epochs reduce scalars over time instead of
    gathering the (E, C) logits."""
    w = CHESS["chess_tmgcn_cls"]
    ev, pl = cm.step_collectives(w, 1, 4), cm.step_collectives(w, 1, 4, plain=True)
    assert any(k[0] == cm.ALL_GATHER for k in ev)
    assert not any(k[0] == cm.ALL_GATHER for k in pl)
    assert cm.step_comm_bytes(w, 1, 4, plain=True)["total"] < cm.step_comm_bytes(w, 1, 4)["total"]


def test_recurrent_families_shard_graph_only():
    for name in ("chess_wdgcn_cls", "chess_evolvegcn2_cls"):
        with pytest.raises(ValueError):
            cm.step_collectives(CHESS[name], 2, 2)


def test_evolvegcn2_gathers_with_the_summing_rule():
    """EvolveGCN-2 adds its candidates (values and rows), their ids and the
    hidden rows, gathered over graph; the float gathers' backward is an
    all-reduce of the whole gathered buffer, the ids' none."""
    one = cm.step_collectives(CHESS["chess_evolvegcn_cls"], 4, 1)
    two = cm.step_collectives(CHESS["chess_evolvegcn2_cls"], 4, 1)
    gathers = [k for k in two if k[0] == cm.ALL_GATHER]
    assert not [k for k in one if k[0] == cm.ALL_GATHER] and len(gathers) == 3
    reduces = {k[2] for k in two if k[0] == cm.ALL_REDUCE}
    N_loc, T, F1 = -(-7301 // 4), 80, 6
    assert 4 * T * N_loc * F1 * 4 in reduces  # the hidden rows' backward
    assert 4 * T * 6 * 8 not in reduces  # the ids': none


def test_two_layer_graph_mesh_gathers_rows():
    w = CHESS["chess_tmgcn2_cls"]
    g = cm.step_comm_bytes(w, 4, 1, plain=True)["total"]
    t = cm.step_comm_bytes(w, 1, 4, plain=True)["total"]
    assert g > t


def test_fit_recovers_a_made_up_sweep():
    """Sweeps made from known latencies and bandwidths, 1 % noise: the fit
    finds them (latency within 5 %, bandwidth within 2 %), and
    ``predict_ms`` reckons a step with them."""
    rng = np.random.default_rng(0)
    truth = {(cm.ALL_REDUCE, 2): (12e-6, 150e9), (cm.ALL_REDUCE, 4): (20e-6, 120e9),
             (cm.ALL_GATHER, 4): (15e-6, 200e9)}
    records = []
    for (kind, n), (a, bw) in truth.items():
        for nbytes in cm.SIZES:
            for mode in ("eager", "graph"):
                t = (a + cm.moved_bytes(kind, n, nbytes) / bw) * (1 + 0.01 * rng.standard_normal())
                records.append({"kind": kind, "n": n, "mode": mode, "bytes": nbytes,
                                "ms": t * 1e3})
    fitted = cm.fit(records)
    assert len(fitted) == 2 * len(truth)
    for (kind, n), (a, bw) in truth.items():
        c = fitted[f"{kind}/{n}/graph"]
        assert c["latency_us"] == pytest.approx(a * 1e6, rel=0.05)
        assert c["bandwidth_GBps"] == pytest.approx(bw / 1e9, rel=0.02)
        assert c["points"] == len(cm.SIZES) and c["max_rel_err"] < 0.05
    issued = {(cm.ALL_REDUCE, 4, 1 << 20): 2, (cm.ALL_GATHER, 4, 4096): 1, (cm.ALL_REDUCE, 1, 8): 3}
    want = 2 * (20e-3 + cm.moved_bytes(cm.ALL_REDUCE, 4, 1 << 20) / 120e6) + \
        (15e-3 + cm.moved_bytes(cm.ALL_GATHER, 4, 4096) / 200e6)
    assert cm.predict_ms(issued, fitted) == pytest.approx(want, rel=0.05)
    assert cm.predict_ms({(cm.ALL_GATHER, 2, 64): 1}, fitted) is None  # not measured


def test_table_and_mesh_bench_rows():
    constants = {f"{k}/{n}/{m}": {"latency_us": 10.0, "bandwidth_GBps": 100.0}
                 for k in (cm.ALL_REDUCE, cm.ALL_GATHER) for n in (2, 4)
                 for m in ("eager", "graph")}
    rows = cm.table(constants)
    assert {r["workload"] for r in rows} == set(CHESS)
    assert all(r["plain_step_ms"] > 0 for r in rows)
    bench = {"mesh": {"graph": 4, "time": 1}, "presets": [{
        "preset": "chess_wdgcn_cls",
        "collectives_issued": {"plain step": [[[cm.ALL_REDUCE, 4, 4000], 2]]},
        "trace_rank0": {"nccl_device_ms_per_epoch": 0.5},
        "plain_epoch": {"sharded captured": {"median_ms": 7.0}}}]}
    (row,) = cm.against_mesh_bench(bench, constants)
    assert row["predicted_nccl_ms"] == pytest.approx(2 * (0.01 + 6000 / 100e6))
    assert row["traced_nccl_ms"] == 0.5


def test_scaling_bench_on_two_gloo_ranks(tmp_path):
    """utils/scaling_bench on a tiny problem under gloo: a mesh of 1 rank
    (the first alone, the other waiting) and of 2 (1 x 2: time 2, the halo
    fits), each a subgroup of the world; rank 0's rows: finite positive
    rates, efficiency 1 on one rank."""
    from tests import torch_mesh_workers as W

    rows, _ = W.spawn("scaling_rows", 2, tmp_path)
    assert [(r["devices"], r["mesh"]) for r in rows] == [(1, "1x1"), (2, "1x2")]
    assert rows[0]["efficiency"] == 1.0 and rows[0]["control_no_comm_efficiency"] == 1.0
    for r in rows:
        assert np.isfinite(r["step_ms"]) and r["edges_per_s"] > 0 and r["efficiency"] > 0

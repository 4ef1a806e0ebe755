"""The port's roofline accounting and profiling helpers (utils/profiling)
against the JAX package's.

The cost models must give the JAX package's flops and bytes on the same
shapes; the peaks are the H100 SXM's data sheet, not a TPU's; the gather
bound counts whole 32-byte sectors a row; ``measure`` and ``trace`` work on
CPU tensors. No time measured here is a device number.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tmgcn_tpu.utils import profiling as jp
from tmgcn_torch import cli
from tmgcn_torch.utils import profiling as tp

ROOT = Path(__file__).resolve().parents[1]


def test_h100_peaks():
    assert tp.PEAK_FLOPS_F32 == 67e12
    assert tp.PEAK_FLOPS_BF16 == 989e12
    assert tp.PEAK_HBM_BYTES == 3.35e12
    assert (tp.PEAK_FLOPS_F32, tp.PEAK_FLOPS_BF16, tp.PEAK_HBM_BYTES) != (
        jp.PEAK_FLOPS_F32, jp.PEAK_FLOPS_BF16, jp.PEAK_HBM_BYTES)


@pytest.mark.parametrize("cost,args", [
    ("spmm_cost", (1_000_000, 8192, 128)),
    ("spmm_cost", (1_580_000, 576_779, 8, 2)),
    ("m_transform_cost", (80, 7301, 6)),
    ("m_transform_cost", (80, 7301, 6, 20)),
    ("edge_readout_cost", (39_192, 6, 3)),
    ("edge_readout_cost", (772_520, 6, 2, 2)),
])
def test_cost_models_match_jax(cost, args):
    ours, theirs = getattr(tp, cost)(*args), getattr(jp, cost)(*args)
    assert (ours.flops, ours.hbm_bytes) == (theirs.flops, theirs.hbm_bytes)
    # The same roofline at the same peaks; the defaults are this card's.
    peaks = {"peak_flops": 1e12, "peak_bw": 1e11}
    assert ours.roofline_seconds(**peaks) == theirs.roofline_seconds(**peaks)
    assert ours.roofline_seconds() == max(ours.flops / 67e12, ours.hbm_bytes / 3.35e12)
    t = ours.roofline_seconds()
    assert ours.roofline_fraction(4 * t) == pytest.approx(0.25)


@pytest.mark.parametrize("feat,row_bytes", [
    (1, 32), (2, 32), (6, 32), (8, 32), (9, 64), (16, 64), (128, 512),
])
def test_gather_bound_moves_whole_sectors(feat, row_bytes):
    nnz = 1_000_000
    assert tp.spmm_gather_bound(nnz, feat) == nnz * row_bytes / 3.35e12
    assert tp.spmm_gather_bound(nnz, feat, peak_bw=1e12) == nnz * row_bytes / 1e12


def test_measure_fetches_and_counts_calls():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    dt = tp.measure(fn, torch.ones(3), iters=5)
    assert dt > 0
    assert len(calls) == 6  # one warm call, then the timed ones


def test_measure_takes_any_array_like():
    assert tp.measure(lambda: np.float32(1.0), iters=2) > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tp.trace(tmp_path / "prof"):
        torch.randn(64, 64) @ torch.randn(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names


def test_cli_run_profile_writes_a_trace(tmp_path):
    """``cli run --profile DIR`` traces the run, as the JAX CLI's does."""
    data = tmp_path / "chess"
    data.mkdir()
    shutil.copy(ROOT / "data" / "chess" / "out.chess.csv", data)
    rc = cli.main(["run", "chess_tmgcn_cls", "--data-dir", str(data), "--epochs", "2",
                   "--device", "cpu", "--quiet", "--profile", str(tmp_path / "prof")])
    assert rc == 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 0
    # The span recorder was on: its records and summary beside the trace,
    # and each span a host range of the trace.
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    names = {r["name"] for r in spans["records"]}
    assert {"setup.data", "data.load", "data.features", "setup.adapter", "adapter.bundles",
            "adapter.propagate", "loop.trial", "loop.prepare", "loop.eval",
            "loop.eval.forward", "loop.eval.score", "loop.steps", "loop.fetch"} <= names
    assert set(spans["summary"]) == names
    assert spans["summary"]["loop.eval"]["count"] == 1  # 2 epochs: one evaluation
    assert names <= {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}

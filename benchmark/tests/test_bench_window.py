"""The window opens at trial 0's first block boundary and is cut at the
first block boundary after its seconds; a run's result line has the
contract's keys."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness, program, run
from benchmark.tests.tiny import cell


def _save(hook, epoch):
    hook.save(epoch, {"W": torch.zeros(2)}, {"mu": [torch.zeros(2)]}, np.zeros((epoch + 1, 12)))


def test_hook_opens_then_cuts_at_a_boundary():
    hook = program.BlockHook(start_epoch=10, seconds=0.0, snap_epochs=(0, 10))
    _save(hook, 0)
    assert hook.window_start is None and 0 in hook.snaps
    _save(hook, 10)
    assert hook.window_start is not None and 10 in hook.snaps
    with pytest.raises(program.Cut) as cut:
        _save(hook, 20)
    assert cut.value.epoch == 20 and hook.boundaries[-1][:2] == (0, 20)


def test_hook_does_not_cut_before_its_seconds():
    hook = program.BlockHook(start_epoch=10, seconds=3600.0)
    for e in (0, 10, 20, 30):
        _save(hook, e)
    assert [b[1] for b in hook.boundaries] == [20, 30]


def test_trials_end_at_block_boundaries(tmp_path):
    c, data_dir = cell("tmgcn2.chess", tmp_path)
    out = harness.run_cell(c, 3, 0.3, False, torch.device("cpu"), 0.0, data_dir=data_dir)
    e = c.traffic["drive"]["eval_every"]
    n = c.traffic["drive"]["epochs"]
    # Trial 0 opens the window after its first block (e + 1 epochs); every
    # trial ends at a boundary: after an evaluation epoch, or its last epoch.
    done = out["attempted"] + e + 1
    trials = out["window"]["trials"]
    last = done - (trials - 1) * n
    assert 0 < last <= n and (last == n or last % e == 1)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tmp_path, trace):
    c, data_dir = cell("wdgcn.chess", tmp_path)
    out = harness.as_numbers(harness.run_cell(c, 4, 0.2, trace,
                                              torch.device("cpu"), 0.0, data_dir=data_dir))
    json.dumps(out)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(out["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert len(out["breakdown"]["device_ops"]) <= 10
        assert len(out["breakdown"]["idle_gaps"]) <= 10
        assert {"setup.data_s", "setup.adapter_s", "loop.plain_epoch_ms.recurrent",
                "step_mfu.recurrent"} <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == names


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "tmgcn2.chess", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no NVIDIA card")
    c, data_dir = cell("tmgcn2.powerlaw500k", tmp_path)
    out = harness.run_cell(c, 5, 0.5, True, torch.device("cuda"), 0.0, data_dir=data_dir)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0


def test_benchmark_alone_exits_without_a_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, there is
    no program to measure: a non-zero exit and no result."""
    import shutil
    import subprocess
    import sys

    from benchmark.tests.tiny import ROOT

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tmgcn2.chess",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""

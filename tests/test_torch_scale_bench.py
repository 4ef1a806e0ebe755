"""The port's scale benchmark against tools/bench_scale.py, at small sizes.

The port keeps its own numpy copy of the tool's graph and edge builders:
the same seeds must give the same arrays. Families and flags not ported
yet must raise NotImplementedError naming their ROADMAP item.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from tmgcn_torch.utils import scale_bench

TOOL = Path(__file__).resolve().parents[1] / "tools" / "bench_scale.py"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("bench_scale_tool", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_inputs_match_the_tool(tool):
    ours = scale_bench.build_inputs(900, 5, 2_000, 700, 3)
    ref = tool.build_inputs(900, 5, 2_000, 700, 3)
    A, A_ref = ours[0], ref[0]
    for f in ("rows", "cols", "vals", "nnz"):
        np.testing.assert_array_equal(np.asarray(getattr(A, f)), np.asarray(getattr(A_ref, f)), f)
    assert A.n_nodes == A_ref.n_nodes == 900
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


@pytest.mark.parametrize(
    "argv",
    [["--families", "tmgcn2"], ["--families", "evolvegcn,tmgcn2"],
     ["--families", "wdgcn", "--l2-stream", "8"]],
)
def test_unported_families_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        scale_bench.main(argv + ["--device", "cpu"])


def test_small_run_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "scale.json"
    argv = ["--nodes", "400", "--slices", "4", "--nnz-per-slice", "1500", "--edges", "300",
            "--families", "tmgcn1,wdgcn", "--n-timed", "4", "--device", "cpu", "--out", str(out)]
    assert scale_bench.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == res
    assert res["device"] == "cpu" and res["edges"] == 300
    for key in ("one_layer", "wdgcn"):
        assert res[f"{key}_ms_per_epoch"] > 0 and res[f"{key}_edges_per_s"] > 0
        assert res[f"{key}_build_s"] >= 0


def test_run_family_counts_its_steps():
    inputs = scale_bench.build_inputs(300, 3, 800, 200, 3)
    out = scale_bench.run_family("wdgcn", inputs, 4, "cpu")
    assert out["steps"] == 6  # max(4 // 4, 3) warm-up steps, then as many timed
    assert out["losses"].shape == (6,) and np.all(np.isfinite(out["losses"]))


def test_run_family_runs_more_steps_from_where_it_ended():
    """``run(n)``: n more steps on the same parameters, continuing the run."""
    inputs = scale_bench.build_inputs(300, 3, 800, 200, 3)
    out = scale_bench.run_family("wdgcn", inputs, 4, "cpu")
    more = out["run"](2).numpy()
    assert more.shape == (2,) and np.all(np.isfinite(more))
    again = scale_bench.run_family("wdgcn", inputs, 4, "cpu")
    np.testing.assert_array_equal(again["losses"], out["losses"])
    assert not np.array_equal(more, out["losses"][:2])  # later steps, not a restart


def test_run_takes_more_steps_than_its_stats_ring(monkeypatch):
    """``run(n)`` past the ring of stats rows runs in chunks of the ring's
    size and still returns every step's loss: the same as one chunk."""
    inputs = scale_bench.build_inputs(300, 3, 800, 200, 3)
    whole = scale_bench.run_family("tmgcn1", inputs, 2, "cpu")["run"](5).numpy()
    monkeypatch.setattr(scale_bench, "STATS_ROWS", 2)  # the ring: max(2 steps, 2) rows
    pieces = scale_bench.run_family("tmgcn1", inputs, 2, "cpu")["run"](5).numpy()
    assert pieces.shape == (5,) and np.all(np.isfinite(pieces))
    np.testing.assert_array_equal(pieces, whole)

"""The port's scale benchmark against tools/bench_scale.py, at small sizes.

The port keeps its own numpy copy of the tool's graph and edge builders:
the same seeds must give the same arrays. Every family and flag runs on
the CPU at a small size, and the tmgcn2 family's adapter (single operator
and streamed) matches the JAX package's on the tool's inputs.
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


SMALL = ["--nodes", "300", "--slices", "4", "--nnz-per-slice", "1000", "--edges", "200",
         "--n-timed", "4", "--device", "cpu"]


@pytest.mark.parametrize(
    "argv",
    [["--families", "tmgcn2"], ["--families", "evolvegcn,tmgcn2"],
     ["--families", "wdgcn", "--l2-stream", "8"], []],
)
def test_families_run_on_the_cpu(argv, capsys):
    """Each family, the default ones (tmgcn1,tmgcn2) and --l2-stream (which
    only tmgcn2 reads) at a small size: the tool's JSON keys, finite and
    positive."""
    assert scale_bench.main(argv + SMALL) == 0
    captured = capsys.readouterr()
    res = json.loads(captured.out.strip().splitlines()[-1])
    families = argv[1].split(",") if argv else ["tmgcn1", "tmgcn2"]
    for fam in families:
        key = scale_bench._NAMES[fam]
        for name in ("build_s", "first_run_s", "ms_per_epoch", "edges_per_s"):
            assert np.isfinite(res[f"{key}_{name}"]) and res[f"{key}_{name}"] >= 0, name
        assert res[f"{key}_ms_per_epoch"] > 0
    assert ("# tmgcn2 layer 2:" in captured.err) == ("tmgcn2" in families)


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


@pytest.mark.parametrize("l2_stream", [None, 3])
def test_tmgcn2_adapter_matches_jax(tool, l2_stream):
    """The tmgcn2 family's adapter on the tool's inputs (one operator, and
    streamed over 3 groups) against the JAX package's adapter from the
    tool's model: logits and W1/W2/U gradients at the suite's float32
    tolerances scaled to the outputs (the unnormalised degree features
    give logits of ~1e4): 2e-5 · max(|logits|, 1), 1e-5 · max(|g|, 1);
    finite losses."""
    import jax
    import jax.numpy as jnp
    import torch

    from tmgcn_torch.configs.build import params_from_jax
    from tmgcn_torch.tasks.adapters import WINDOWS, make_edge_adapter
    from tmgcn_tpu.models.tmgcn import TMGCN2 as JaxTMGCN2
    from tmgcn_tpu.tasks.adapters import make_edge_adapter as jax_adapter

    A, M, X, edges, _, _ = scale_bench.build_inputs(400, 6, 1500, 300, 3)
    A_j, *_ = tool.build_inputs(400, 6, 1500, 300, 3)
    model, Mw = scale_bench.build_model("tmgcn2", A.n_slices, X.shape[-1], M)
    ad = make_edge_adapter(model, {w: A for w in WINDOWS}, {w: X for w in WINDOWS},
                           {w: edges for w in WINDOWS}, M=Mw, device="cpu",
                           l2_stream_chunks=l2_stream)
    assert ("l2s_op" in ad.bundles["train"]) == (l2_stream is not None)
    jmodel = JaxTMGCN2(n_slices=A.n_slices, in_feat=X.shape[-1], hidden_feat=(6, 6, 2),
                       nonlin2="selu")
    ad_j = jax_adapter(jmodel, {w: A_j for w in WINDOWS}, {w: X for w in WINDOWS},
                       {w: edges for w in WINDOWS}, M=M, l2_stream_chunks=l2_stream)
    jvars = ad_j.init(jax.random.PRNGKey(0))
    G = np.random.default_rng(0).standard_normal((edges.shape[1], 2)).astype(np.float32)
    params = {k: v.requires_grad_(True) for k, v in params_from_jax(
        {k: np.asarray(v) for k, v in jvars["params"].items()}).items()}
    out, _ = ad.apply({"params": params, "buffers": {}}, ad.bundles["train"], ())
    (out * torch.from_numpy(G)).sum().backward()

    def f(p):
        o, _ = ad_j.apply({"params": p, "buffers": {}}, ad_j.bundles["train"], ())
        return jnp.vdot(o, jnp.asarray(G, o.dtype)), o

    (_, ref), grads = jax.value_and_grad(f, has_aux=True)(jvars["params"])
    ref = np.asarray(ref)
    assert np.all(np.isfinite(out.detach().numpy()))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=2e-5 * max(np.abs(ref).max(), 1.0))
    for k in ("W1", "W2", "U"):
        r = np.asarray(grads[k])
        np.testing.assert_allclose(params[k].grad.numpy(), r, rtol=0,
                                   atol=1e-5 * max(np.abs(r).max(), 1.0), err_msg=k)
    steps = scale_bench.run_family("tmgcn2", scale_bench.build_inputs(400, 6, 1500, 300, 3), 4,
                                   "cpu", l2_stream)
    assert steps["losses"].shape == (6,) and np.all(np.isfinite(steps["losses"]))

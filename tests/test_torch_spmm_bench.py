"""The SpMM microbenchmark of the port (utils/spmm_bench) against the JAX
package's, at small sizes on the CPU.

The workloads must be the JAX package's arrays bit for bit; ``bench_case``
must print the JAX script's records in its order with its tags; every
windowed configuration it times must compute what the JAX operator of the
same configuration computes in interpret mode (float32 at atol 1e-5; the
fast tier at the bf16 tolerance 2e-2·scale, since interpret mode computes
DEFAULT in float32); the script runs on the card unless told otherwise.
Times measured here are CPU times of the plain versions, not device numbers.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.kernels import spmm_pallas as jk
from tmgcn_tpu.utils import spmm_bench as jb
from tmgcn_torch.kernels import spmm_cuda as tk
from tmgcn_torch.utils import spmm_bench as tb

SMALL = {"T": 3, "N": 96, "nnz_per_slice": 400, "F": 4}


@pytest.mark.parametrize("shape,seed", [
    (SMALL, 0),
    ({"T": 2, "N": 50, "nnz_per_slice": 3000, "F": 8}, 3),  # many duplicates summed
    ({"T": 5, "N": 300, "nnz_per_slice": 100, "F": 1}, 7),
])
def test_make_workload_is_the_jax_workload(shape, seed):
    A_j, X_j = jb.make_workload(**shape, seed=seed)
    A_t, X_t = tb.make_workload(**shape, seed=seed)
    for field in ("rows", "cols", "vals", "nnz"):
        ours, theirs = np.asarray(getattr(A_t, field)), np.asarray(getattr(A_j, field))
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs), field
    assert A_t.n_nodes == A_j.n_nodes
    assert X_t.dtype == torch.float32 and np.array_equal(X_t.numpy(), np.asarray(X_j))


def test_cases_are_the_jax_scripts():
    assert tb.CASES == {
        "r1": ("r1_1Mnnz_F128", {"T": 16, "N": 8192, "nnz_per_slice": 62_500, "F": 128}),
        "chess2": ("chess2_F8", {"T": 79, "N": 7301, "nnz_per_slice": 20_000, "F": 8}),
    }


@pytest.mark.parametrize("fwd_only", [False, True])
@pytest.mark.parametrize("quick", [False, True])
def test_bench_case_prints_the_jax_records(capsys, fwd_only, quick):
    A_j, X_j = jb.make_workload(**SMALL)
    theirs = jb.bench_case("small", A_j, X_j, fwd_only, quick, iters=1)
    capsys.readouterr()
    A_t, X_t = tb.make_workload(**SMALL)
    ours = tb.bench_case("small", A_t, X_t, fwd_only, quick, iters=1)
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["impl"] for r in ours] == [r["impl"] for r in theirs]
    assert printed == ours
    for r in ours:
        assert set(r) == {"case", "impl", "mnnz_per_s", "ms", "roofline_frac"}
        assert r["case"] == "small" and r["ms"] >= 0 and "error" not in r


@pytest.mark.parametrize("chunk,window", tb.PALLAS_CONFIGS)
@pytest.mark.parametrize("fast", [False, True])
def test_pallas_configurations_match_jax(chunk, window, fast):
    """Each windowed configuration's operator, forward and backward, against
    the JAX operator of the same configuration in interpret mode."""
    shape = {"T": 3, "N": 300, "nnz_per_slice": 1500, "F": 4}
    A_j, X_j = jb.make_workload(**shape)
    A_t, X_t = tb.make_workload(**shape)
    G = np.random.default_rng(1).standard_normal(X_t.shape).astype(np.float32)
    op_j = jk.make_operator(A_j, chunk=chunk, window=window, fast=fast, interpret=True)
    op_t = dataclasses.replace(tk.make_operator(A_t, chunk=chunk, window=window), fast=fast)
    Xg = X_t.clone().requires_grad_(True)
    out = op_t(Xg)
    (out * torch.from_numpy(G)).sum().backward()
    ref = np.asarray(op_j(X_j))
    dX = np.asarray(jax.grad(lambda x: jnp.vdot(op_j(x), jnp.asarray(G)))(X_j))
    for got, want in ((out.detach().numpy(), ref), (Xg.grad.numpy(), dX)):
        atol = 2e-2 * max(1.0, np.abs(want).max()) if fast else 1e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"], ["--case", "r1", "--quick"]])
def test_main_needs_a_card_by_default(no_cuda, argv):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.main(argv)


def test_main_on_the_cpu_when_asked(monkeypatch, capsys):
    """--device cpu runs every record of --case all (here at small shapes),
    after a first line that names the device and no card; --quick and
    --fwd-only reach bench_case."""
    monkeypatch.setattr(tb, "CASES", {
        "r1": ("r1_small", SMALL),
        "chess2": ("chess2_small", {"T": 4, "N": 64, "nnz_per_slice": 200, "F": 8}),
    })
    bench_case = tb.bench_case
    monkeypatch.setattr(tb, "bench_case", lambda *a: bench_case(*a, iters=1))
    out = tb.main(["--device", "cpu", "--case", "all"])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0]) == {"device": "cpu", "card": None}
    assert [json.loads(line) for line in lines[1:]] == out
    assert [r["case"] for r in out] == ["r1_small"] * 21 + ["chess2_small"] * 21
    quick = tb.main(["--device", "cpu", "--case", "chess2", "--quick", "--fwd-only"])
    assert [(r["case"], r["impl"]) for r in quick] == [
        ("chess2_small", impl)
        for impl in ("gather_only", "jnp_flat", "rowsplit_k16", "pallas_c256_w256")
    ]

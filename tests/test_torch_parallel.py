"""The port's mesh plumbing (tmgcn_torch/parallel) against the JAX package's
(tmgcn_tpu/parallel), on the CPU.

Host numpy helpers bitwise: ``partition_rows`` / ``pad_time``,
``local_banded_m``, ``bucket_edges_by_time``, ``partition_edges_by_time``.
The mesh: the JAX default factorization and its error, the rank -> (g, t)
order of ``mesh_utils.create_device_mesh``, the device policy (a CUDA mesh
larger than the visible cards raises, naming their count). The sorted
entry streams: each (time, graph) stream cut to its ``nnz`` (the padding
trails the sorted entries) and the segment sum over it against a dense
product. A world of one process (no launcher): its runtime info, the
halo of a time group of one (zeros, no communication), the v1 and halo
training steps at 1 x 1 against the unsharded model. And one launched CLI
run: ``torch.distributed.run --nproc-per-node 2 ... --mesh graph=2,time=1
--device cpu`` against the single-device rows (loss rtol 1e-4, F1 1e-3).
"""

import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_mesh_workers as W
from tmgcn_tpu.core.mmatrix import band_offsets, make_m_matrix
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.parallel import adapter as jadapter
from tmgcn_tpu.parallel import halo as jhalo
from tmgcn_tpu.parallel import mesh as jmesh
from tmgcn_tpu.parallel import partition as jpart
from tmgcn_tpu.parallel import tmgcn_sharded as jsharded
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs.presets import get_preset
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.tmgcn import TMGCN
from tmgcn_torch.parallel import adapter as tadapter
from tmgcn_torch.parallel import distributed, halo, mesh, partition, tmgcn_sharded
from tmgcn_torch.train.losses import weighted_cross_entropy

ROOT = Path(__file__).resolve().parents[1]
CHESS = ROOT / "data" / "chess" / "out.chess.csv"


def _dense(seed: int, T: int = 8, N: int = 45, p: float = 0.08) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random((T, N, N)) < p) * rng.random((T, N, N))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("given", [(None, None), ("graph", None), (None, "time")])
def test_factorization_as_jax(n, given):
    """The default and half-given factorizations, and the mapping of a flat
    device list onto the (graph, time) grid: rank g * T + t."""
    devices = jax.devices()[:n]
    kw = {}
    if given[0]:
        kw["n_graph"] = 1 if n == 1 else 2 - (n % 2)
    if given[1]:
        kw["n_time"] = 1 if n == 1 else 2 - (n % 2)
    jm = jmesh.make_mesh(devices=devices, **kw)
    G, T = mesh.factorize(n, kw.get("n_graph"), kw.get("n_time"))
    assert (G, T) == (jm.shape[jmesh.GRAPH_AXIS], jm.shape[jmesh.TIME_AXIS])
    ids = np.vectorize(lambda d: d.id)(jm.devices) - devices[0].id
    np.testing.assert_array_equal(ids, np.arange(G * T).reshape(G, T))
    assert [divmod(r, T) for r in range(n)] == [tuple(np.argwhere(ids == r)[0]) for r in range(n)]


def test_factorization_error_as_jax():
    with pytest.raises(ValueError, match=r"mesh 3x1 != 2 devices") as theirs:
        jmesh.make_mesh(3, 1, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match=r"mesh 3x1 != 2 devices") as ours:
        mesh.factorize(2, 3, 1)
    assert str(ours.value).startswith(str(theirs.value))


def test_cuda_mesh_larger_than_the_cards_raises(monkeypatch):
    """No fallback: a CUDA mesh past the visible cards raises, naming them,
    before any process group or data exists."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 GPUs, one per process; 1 visible"):
        mesh.make_mesh(2, 2, device="cuda")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="need 2 GPUs, one each; 1 visible"):
        distributed.initialize("cuda")


@pytest.mark.parametrize("seed,n_graph,n_time", [(0, 1, 1), (1, 2, 3), (2, 4, 2), (3, 3, 1)])
def test_partition_and_pad_bitwise(seed, n_graph, n_time):
    dense = _dense(seed, T=7)
    ours = partition.pad_time(
        partition.partition_rows(TemporalCOO.from_dense(dense, pad_multiple=16), n_graph, 16),
        n_time)
    theirs = jpart.pad_time(
        jpart.partition_rows(JaxCOO.from_dense(dense, dtype=jnp.float32, pad_multiple=16),
                             n_graph, 16), n_time)
    for key in ("rows", "cols", "vals", "nnz"):
        a, b = getattr(ours, key), np.asarray(getattr(theirs, key))
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert (ours.n_local_rows, ours.n_graph_shards) == (theirs.n_local_rows,
                                                         theirs.n_graph_shards)


@pytest.mark.parametrize("T,band,n_time", [(8, 3, 2), (8, 6, 4), (12, 5, 3), (80, 20, 8)])
def test_local_banded_m_bitwise(T, band, n_time):
    M = make_m_matrix(T, band)
    h = band_offsets(M)[0]
    np.testing.assert_array_equal(halo.local_banded_m(M, n_time, h),
                                  jhalo.local_banded_m(M, n_time, h))


@pytest.mark.parametrize("seed,T_pad,n_time", [(1, 8, 4), (2, 8, 2), (3, 9, 3)])
def test_bucket_edges_round_trip(seed, T_pad, n_time):
    """Bitwise the JAX buckets, and ``pos`` restores the original order."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, T_pad, 37), rng.integers(0, 5, 37),
                      rng.integers(0, 5, 37)])
    ours = tadapter.bucket_edges_by_time(edges, T_pad, n_time, pad_multiple=4)
    theirs = jadapter.bucket_edges_by_time(edges, T_pad, n_time, pad_multiple=4)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    e_b, mask, pos = ours
    t_loc = T_pad // n_time
    flat_t = (e_b[:, 0, :] + np.arange(n_time)[:, None] * t_loc).reshape(-1)
    np.testing.assert_array_equal(flat_t[pos], edges[0])
    np.testing.assert_array_equal(e_b[:, 1, :].reshape(-1)[pos], edges[1])
    np.testing.assert_array_equal(e_b[:, 2, :].reshape(-1)[pos], edges[2])
    assert mask.reshape(-1).sum() == 37 and mask.reshape(-1)[pos].all()


def test_partition_edges_by_time_bitwise():
    rng = np.random.default_rng(4)
    edges = np.stack([rng.integers(0, 8, 50), rng.integers(0, 9, 50), rng.integers(0, 9, 50)])
    targets = rng.integers(0, 3, 50)
    for a, b in zip(tmgcn_sharded.partition_edges_by_time(edges, targets, 8, 2, 16),
                    jsharded.partition_edges_by_time(edges, targets, 8, 2, 16)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_graph,n_time,stride", [(1, 1, None), (3, 2, None), (3, 2, "gathered")])
def test_shard_streams_drop_the_padding(n_graph, n_time, stride):
    """Each (time, graph) stream: its nnz entries only, rows sorted (the
    padded layout is not: row 0 trails each stream), and the segment sum
    over it equals the dense product of its block."""
    dense = _dense(5, T=6, N=31, p=0.15)
    A_sh = partition.partition_rows(TemporalCOO.from_dense(dense, pad_multiple=64), n_graph, 64)
    assert any(np.any(np.diff(A_sh.rows[t, g].astype(int)) < 0)
               for t in range(6) for g in range(n_graph))  # padding breaks the sort
    n_loc = A_sh.n_local_rows
    in_rows = n_loc * n_graph if stride else 31
    t_loc = 6 // n_time
    x = torch.as_tensor(np.random.default_rng(6).standard_normal((6, in_rows, 3)))
    for ti in range(n_time):
        for g in range(n_graph):
            r, c, v = partition.shard_stream(A_sh, ti * t_loc, t_loc, g, in_rows)
            assert len(r) == A_sh.nnz[ti * t_loc : (ti + 1) * t_loc, g].sum()
            assert np.all(np.diff(r) >= 0)
            stream = {"rows": torch.as_tensor(r), "cols": torch.as_tensor(c),
                      "vals": torch.as_tensor(v)}
            got = tmgcn_sharded.local_spmm(stream, x[ti * t_loc : (ti + 1) * t_loc].reshape(
                -1, 3), t_loc * n_loc).reshape(t_loc, n_loc, 3)
            rows = slice(g * n_loc, min((g + 1) * n_loc, 31))
            block = dense[ti * t_loc : (ti + 1) * t_loc, rows]
            want = np.einsum("tij,tjf->tif", block, x[ti * t_loc : (ti + 1) * t_loc, :31].numpy())
            np.testing.assert_allclose(got[:, : block.shape[1]].numpy(), want, rtol=1e-6,
                                       atol=1e-6)


@pytest.fixture
def world_of_one():
    """This process alone as the world (no launcher); a 1 x 1 mesh."""
    return mesh.make_mesh(1, 1, device=distributed.initialize("cpu"))


def test_world_of_one(world_of_one):
    info = distributed.runtime_info()
    assert set(info) == {"process_index", "process_count", "local_devices", "global_devices",
                         "platform"}
    assert info["process_count"] == 1 and info["platform"] == "cpu"
    assert (world_of_one.g, world_of_one.t) == (0, 0)
    assert world_of_one.shape == {"graph": 1, "time": 1}


@pytest.mark.parametrize("halo_width", [0, 3, 9])
def test_halo_of_a_time_group_of_one(world_of_one, halo_width):
    """As in JAX: a group of one receives zeros (nothing precedes t = 0),
    with no collective; halo 0 is empty."""
    from tmgcn_torch.parallel import collectives

    x = torch.randn(4, 3, 2)
    collectives.CALLS.clear()
    h = halo.halo_exchange_backward(x, halo_width, world_of_one.time_group)
    assert h.shape == (halo_width, 3, 2) and not h.any()
    assert not collectives.CALLS


@pytest.mark.parametrize("step", ["v1", "halo"])
def test_standalone_steps_at_one_by_one(world_of_one, step):
    """The standalone sharded steps (the JAX dry run's): the first step's
    loss is the unsharded model's (rtol 1e-5), and the loss descends."""
    dense, M, X, edges, targets, params = W.standalone_problem()
    losses = W.standalone_losses(world_of_one, step, n_steps=5)
    model = TMGCN(n_slices=8, in_feat=4, hidden_feat=(6, 2))
    p = {k: torch.tensor(v, dtype=torch.float32) for k, v in params.items()}
    out = model.apply({"params": p, "buffers": {}}, TemporalCOO.from_dense(dense),
                      torch.as_tensor(X), torch.as_tensor(edges), torch.as_tensor(M))
    ref = weighted_cross_entropy(out, torch.as_tensor(targets), torch.tensor([0.9, 0.1]))
    assert losses[0] == pytest.approx(float(ref), rel=1e-5)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_cli_run_on_a_two_process_mesh(tmp_path):
    """``torch.distributed.run --nproc-per-node 2 -m tmgcn_torch.cli run
    chess_tmgcn_cls --mesh graph=2,time=1 --device cpu --epochs 3``: exit 0,
    rank 0's rows against the single-device run's."""
    data = tmp_path / "chess"
    data.mkdir()
    shutil.copy(CHESS, data / CHESS.name)
    # The single-device run first: it also writes the .mat cache both ranks read.
    ref = tbuild.run_experiment(get_preset("chess_tmgcn_cls"), data_dir=data, n_epochs=3,
                                verbose=False, device="cpu")
    (ref_rows,) = ref["results"].values()
    out = tmp_path / "out"
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "2", "-m", "tmgcn_torch.cli", "run", "chess_tmgcn_cls", "--data-dir", str(data),
            "--mesh", "graph=2,time=1", "--device", "cpu", "--epochs", "3", "--quiet",
            "--out", str(out)]
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("runs in") == 1  # rank 0 reports, rank 1 does not
    (pkl,) = out.glob("results_*.pkl")
    rows = pickle.loads(pkl.read_bytes())
    assert rows.shape == ref_rows.shape
    for col in (3, 7, 11):
        np.testing.assert_allclose(rows[:, col], ref_rows[:, col], rtol=1e-4)
    for col in (2, 6, 10):
        np.testing.assert_allclose(rows[:, col], ref_rows[:, col], rtol=1e-3, equal_nan=True)

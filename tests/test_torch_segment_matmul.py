"""K1 (windowed segment matmul) of the port against the JAX package.

The port's packer must give the JAX package's packing; the plain PyTorch
version of K1 must match the Pallas kernel run in interpret mode on the
same packing; the operator's forward and autograd backward must match
JAX's operator and ``jax.grad``. Tolerance 1e-5 absolute: both sides sum
float32 products, in a different order (one-hot matmul vs index_add).

The CUDA kernel itself has no CPU mode: its comparison with the plain
version is in tests/test_torch_cuda.py, marked ``cuda``, and skips
without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.kernels import spmm_pallas as jk
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda as tk

ATOL = 1e-5
FIELDS = ("rows", "cols", "vals", "window_id", "is_first")


def _stream(seed=0, n_out=1000, n_in=700, P=3000):
    """Row-sorted entries with empty windows and a window of many chunks."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([
        rng.integers(0, 300, P // 2),        # windows 0-2 (window=128)
        rng.integers(640, 700, P // 4),      # one dense window: several chunks
        rng.integers(900, n_out, P - P // 2 - P // 4),
    ])
    rows = np.sort(rows)
    cols = rng.integers(0, n_in, P)
    vals = rng.standard_normal(P).astype(np.float32)
    return rows, cols, vals, n_out, n_in


def _jax_packed(p: tk.PackedSpmm) -> jk.PackedSpmm:
    """The port's packing as the JAX package's container (same arrays)."""
    return jk.PackedSpmm(
        rows=jnp.asarray(p.rows), cols=jnp.asarray(p.cols), vals=jnp.asarray(p.vals),
        window_id=jnp.asarray(p.window_id), is_first=jnp.asarray(p.is_first),
        n_rows_out=p.n_rows_out, chunk=p.chunk, window=p.window,
    )


class TestPacking:
    @pytest.mark.parametrize("sort_cols", [False, True])
    @pytest.mark.parametrize("all_windows", [True, False])
    def test_flat_matches_jax(self, sort_cols, all_windows):
        rows, cols, vals, n_out, _ = _stream()
        ours = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, sort_cols, all_windows)
        ref = jk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, sort_cols, all_windows)
        assert ours.n_rows_out == ref.n_rows_out
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(ref, f)), err_msg=f)
            assert getattr(ours, f).dtype == np.asarray(getattr(ref, f)).dtype, f

    @pytest.mark.parametrize("all_windows", [True, False])
    def test_window_ptr(self, all_windows):
        rows, cols, vals, n_out, _ = _stream(seed=1)
        p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, all_windows=all_windows)
        for w in range(p.n_windows):
            lo, hi = p.window_ptr[w], p.window_ptr[w + 1]
            assert np.all(p.window_id[lo:hi] == w)
        assert p.window_ptr[-1] == p.n_chunks
        # The first chunk of each window carries is_first, the others not.
        starts = p.window_ptr[:-1][np.diff(p.window_ptr) > 0]
        np.testing.assert_array_equal(np.flatnonzero(p.is_first), starts)

    @pytest.mark.parametrize("sort_cols", [False, True])
    def test_temporal_matches_jax(self, sort_cols):
        rng = np.random.default_rng(2)
        dense = (rng.random((3, 90, 90)) < 0.1) * rng.random((3, 90, 90))
        ours = tk.pack_windowed(TemporalCOO.from_dense(dense, pad_multiple=16), 32, 64, sort_cols)
        ref = jk.pack_windowed(JaxCOO.from_dense(dense, pad_multiple=16), 32, 64, sort_cols)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(ref, f)), err_msg=f)

    def test_empty_stream(self):
        z = np.zeros(0, np.int64)
        p = tk.pack_windowed_flat(z, z, np.zeros(0, np.float32), 300, 64, 128)
        assert p.n_chunks == 3 and np.all(p.vals == 0)
        np.testing.assert_array_equal(p.window_ptr, [0, 1, 2, 3])

    def test_rows_out_of_range_raise(self):
        with pytest.raises(ValueError):
            tk.pack_windowed_flat(np.array([5]), np.array([0]), np.ones(1, np.float32), 5)


class TestPlainVersion:
    @pytest.mark.parametrize("F", [1, 2, 6, 8])
    @pytest.mark.parametrize(
        "case", ["all_windows", "sort_cols", "init", "init_sort_cols"]
    )
    def test_matches_pallas_interpret(self, F, case):
        rows, cols, vals, n_out, _ = _stream(seed=3)
        sort_cols = "sort_cols" in case
        use_init = case.startswith("init")
        p = tk.pack_windowed_flat(
            rows, cols, vals, n_out, 64, 128, sort_cols, all_windows=not use_init
        )
        rng = np.random.default_rng(F)
        gathered = rng.standard_normal((p.n_chunks, p.chunk, F)).astype(np.float32)
        init_np = np.zeros((p.n_rows_out, F), np.float32)
        ours = tk.windowed_segment_matmul_reference(
            p, torch.from_numpy(gathered),
            init=torch.from_numpy(init_np.copy()) if use_init else None,
        )
        ref = jk.windowed_segment_matmul(
            _jax_packed(p), jnp.asarray(gathered), interpret=True,
            init=jnp.asarray(init_np) if use_init else None,
        )
        assert ours.shape == (p.n_rows_out, F) and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)

    def test_pure_padding_chunk_adds_nothing(self):
        """Untouched windows get one all-padding chunk: output rows 0."""
        rows, cols, vals, n_out, _ = _stream(seed=4)
        p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128)
        empty = [w for w in range(p.n_windows) if not np.any(p.vals[p.window_id == w])]
        assert empty, "the stream must leave a window empty"
        g = torch.randn(p.n_chunks, p.chunk, 3, generator=torch.Generator().manual_seed(0))
        out = tk.windowed_segment_matmul_reference(p, g)
        for w in empty:
            assert torch.all(out[w * 128:(w + 1) * 128] == 0)

    def test_init_keeps_unvisited_windows(self):
        rows, cols, vals, n_out, _ = _stream(seed=5)
        p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, all_windows=False)
        init = torch.full((p.n_rows_out, 2), 7.0)
        g = torch.randn(p.n_chunks, p.chunk, 2, generator=torch.Generator().manual_seed(1))
        out = tk.windowed_segment_matmul_reference(p, g, init=init)
        assert out is init
        visited = set(p.window_id.tolist())
        for w in range(p.n_windows):
            block = out[w * 128:(w + 1) * 128]
            assert (w in visited) != bool(torch.all(block == 7.0))

    def test_wrapper_uses_plain_version_on_cpu(self):
        rows, cols, vals, n_out, _ = _stream(seed=6)
        p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128)
        g = torch.randn(p.n_chunks, p.chunk, 2, generator=torch.Generator().manual_seed(2))
        before = tk.windowed_segment_matmul.launches
        out = tk.windowed_segment_matmul(p, g)
        assert tk.windowed_segment_matmul.launches == before
        torch.testing.assert_close(out, tk.windowed_segment_matmul_reference(p, g), rtol=0, atol=0)


@pytest.fixture(scope="module")
def small_graph():
    """The sizes of tests/test_pallas_spmm.py: T=4, N=100, F=8."""
    rng = np.random.default_rng(0)
    T, N, F = 4, 100, 8
    dense = (rng.random((T, N, N)) < 0.08) * rng.random((T, N, N))
    X = rng.standard_normal((T, N, F)).astype(np.float32)
    G = rng.standard_normal((T, N, F)).astype(np.float32)
    return dense, X, G


class TestOperator:
    @pytest.mark.parametrize("sort_cols", [False, True])
    def test_forward_matches_jax(self, small_graph, sort_cols):
        dense, X, _ = small_graph
        op_j = jk.make_operator(
            JaxCOO.from_dense(dense, dtype=jnp.float32, pad_multiple=16),
            chunk=64, window=64, interpret=True, sort_cols=sort_cols,
        )
        op_t = tk.make_operator(
            TemporalCOO.from_dense(dense, pad_multiple=16), chunk=64, window=64,
            sort_cols=sort_cols,
        )
        out = op_t(torch.from_numpy(X))
        np.testing.assert_allclose(out.numpy(), np.asarray(op_j(jnp.asarray(X))), atol=ATOL)

    @pytest.mark.parametrize("sort_cols", [False, True])
    def test_backward_matches_jax_grad(self, small_graph, sort_cols):
        dense, X, G = small_graph
        op_j = jk.make_operator(
            JaxCOO.from_dense(dense, dtype=jnp.float32, pad_multiple=16),
            chunk=64, window=64, interpret=True, sort_cols=sort_cols,
        )
        op_t = tk.make_operator(
            TemporalCOO.from_dense(dense, pad_multiple=16), chunk=64, window=64,
            sort_cols=sort_cols,
        )
        dX_j = jax.grad(lambda x: jnp.vdot(op_j(x), jnp.asarray(G)))(jnp.asarray(X))
        Xt = torch.from_numpy(X).requires_grad_(True)
        (op_t(Xt) * torch.from_numpy(G)).sum().backward()
        np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(dX_j), atol=ATOL)

    def test_spmm_pallas_matches_dense(self, small_graph):
        dense, X, _ = small_graph
        out = tk.spmm_pallas(TemporalCOO.from_dense(dense, pad_multiple=16), torch.from_numpy(X))
        ref = np.einsum("tij,tjf->tif", dense, X.astype(np.float64))
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)

    @pytest.mark.parametrize(
        "kwargs", [{"fast": True}, {"gather_dtype": "bfloat16"}, {"tile_dedup": True}]
    )
    def test_unported_tiers_raise(self, small_graph, kwargs):
        dense, _, _ = small_graph
        with pytest.raises(NotImplementedError):
            tk.make_operator(TemporalCOO.from_dense(dense), **kwargs)

"""K3 (tile-dedup windowed segment matmul) of the port against the JAX package.

The port's tiled packer must give the JAX package's arrays; K3's plain
PyTorch version must match the Pallas kernel run in interpret mode on the
same packing; the tiled operators' forward and autograd backward must match
JAX's operators and ``jax.grad``; ``spmm(impl="pallas_tiled[_bf16]")`` must
match JAX's ``spmm``. Tolerances are the JAX suite's: 1e-5 absolute for the
float32 tier (tests/test_pallas_spmm.py:62), 2e-2 of the output's scale for
the bf16 tier (:115).

The CUDA kernel itself has no CPU mode: its comparison with the plain
version is in tests/test_torch_cuda.py, marked ``cuda``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.kernels import spmm_pallas as jk
from tmgcn_tpu.ops import spmm as jspmm
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda as tk
from tmgcn_torch.ops import spmm as tspmm

ATOL = 1e-5
BF16_REL = 2e-2
FIELDS = ("rows", "uidx", "tiles", "vals", "window_id", "is_first")
GATHER = {None: np.float32, "bfloat16": jnp.bfloat16}


def _stream(seed=0, n_out=1000, n_in=700, P=3000, crowd=False):
    """Row-sorted entries with empty windows and a window of many chunks.

    crowd=True packs the columns into a few tiles and repeats (row, col)
    pairs: the pattern tile dedup targets.
    """
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([
        rng.integers(0, 300, P // 2),
        rng.integers(640, 700, P // 4),
        rng.integers(900, n_out, P - P // 2 - P // 4),
    ]))
    cols = rng.integers(0, 24 if crowd else n_in, P)
    if crowd:  # every (row, col) pair twice
        order = np.argsort(np.r_[rows[::2], rows[::2]], kind="stable")
        rows = np.r_[rows[::2], rows[::2]][order]
        cols = np.r_[cols[::2], cols[::2]][order]
    vals = rng.standard_normal(P).astype(np.float32)
    return rows, cols, vals, n_out, n_in


def _jax_tiled(p: tk.PackedTiled) -> jk.PackedTiled:
    """The port's packing as the JAX package's container (same arrays)."""
    return jk.PackedTiled(
        rows=jnp.asarray(p.rows), uidx=jnp.asarray(p.uidx), tiles=jnp.asarray(p.tiles),
        vals=jnp.asarray(p.vals), window_id=jnp.asarray(p.window_id),
        is_first=jnp.asarray(p.is_first), n_rows_out=p.n_rows_out, chunk=p.chunk,
        window=p.window, ut_cap=p.ut_cap,
    )


def _assert_packing_equal(ours, ref):
    assert (ours.n_rows_out, ours.chunk, ours.window, ours.ut_cap) == (
        ref.n_rows_out, ref.chunk, ref.window, ref.ut_cap
    )
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(ref, f)), err_msg=f)
        assert getattr(ours, f).dtype == np.asarray(getattr(ref, f)).dtype, f


class TestPacking:
    @pytest.mark.parametrize(
        "case,ut_cap,all_windows",
        [("plain", 64, True), ("plain", 4, True), ("crowd", 2, True), ("crowd", 64, True),
         ("plain", 4, False), ("crowd", 1, False)],
    )
    def test_flat_matches_jax(self, case, ut_cap, all_windows):
        rows, cols, vals, n_out, _ = _stream(seed=1, crowd=case == "crowd")
        ours = tk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, ut_cap, all_windows)
        ref = jk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, ut_cap, all_windows)
        _assert_packing_equal(ours, ref)

    def test_ut_cap_cuts_chunks(self):
        rows, cols, vals, n_out, _ = _stream(seed=2)
        wide = tk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, ut_cap=64)
        narrow = tk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, ut_cap=4)
        assert narrow.n_chunks > wide.n_chunks
        # No chunk references more distinct tiles than the budget.
        assert int(narrow.uidx.max()) < 8 * 4

    @pytest.mark.parametrize("ut_cap", [16, 64])
    def test_temporal_matches_jax(self, ut_cap):
        rng = np.random.default_rng(3)
        dense = (rng.random((3, 90, 90)) < 0.1) * rng.random((3, 90, 90))
        ours = tk.pack_windowed_tiled(TemporalCOO.from_dense(dense, pad_multiple=16), 32, 64, ut_cap)
        ref = jk.pack_windowed_tiled(JaxCOO.from_dense(dense, pad_multiple=16), 32, 64, ut_cap)
        _assert_packing_equal(ours, ref)

    def test_window_ptr(self):
        rows, cols, vals, n_out, _ = _stream(seed=4)
        p = tk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, 8, all_windows=False)
        for w in range(p.n_windows):
            lo, hi = p.window_ptr[w], p.window_ptr[w + 1]
            assert np.all(p.window_id[lo:hi] == w)
        assert p.window_ptr[-1] == p.n_chunks

    def test_empty_stream(self):
        z = np.zeros(0, np.int64)
        p = tk.pack_windowed_tiled_flat(z, z, np.zeros(0, np.float32), 300, 64, 128)
        ref = jk.pack_windowed_tiled_flat(z, z, np.zeros(0, np.float32), 300, 64, 128)
        _assert_packing_equal(p, ref)
        np.testing.assert_array_equal(p.window_ptr, [0, 1, 2, 3])

    @pytest.mark.parametrize("ut_cap", [0, -1])
    def test_ut_cap_below_one_raises(self, ut_cap):
        with pytest.raises(ValueError, match="ut_cap"):
            tk.pack_windowed_tiled_flat(
                np.array([0, 1]), np.array([0, 1]), np.ones(2, np.float32), 64, ut_cap=ut_cap
            )


class TestPlainVersion:
    @pytest.mark.parametrize("F", [1, 2, 6, 8])
    @pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
    def test_matches_pallas_interpret(self, F, gather_dtype):
        rows, cols, vals, n_out, _ = _stream(seed=5, crowd=F == 2)
        p = tk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, ut_cap=8)
        rng = np.random.default_rng(F)
        gathered = rng.standard_normal((p.n_chunks, 8 * p.ut_cap, F)).astype(np.float32)
        gt = torch.from_numpy(gathered)
        gj = jnp.asarray(gathered)
        if gather_dtype is not None:
            gt, gj = gt.to(torch.bfloat16), gj.astype(jnp.bfloat16)
        ours = tk.windowed_tiled_segment_matmul_reference(p, gt, out_dtype=torch.float32)
        precision = jax.lax.Precision.HIGHEST if gather_dtype is None else jax.lax.Precision.DEFAULT
        ref = np.asarray(jk.windowed_tiled_segment_matmul(
            _jax_tiled(p), gj, precision, interpret=True, out_dtype=jnp.float32
        ))
        assert ours.shape == (p.n_rows_out, F) and ours.dtype == torch.float32
        tol = ATOL if gather_dtype is None else BF16_REL * np.abs(ref).max()
        np.testing.assert_allclose(ours.numpy(), ref, atol=tol)

    def test_wrapper_uses_plain_version_on_cpu(self):
        rows, cols, vals, n_out, _ = _stream(seed=6)
        p = tk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, ut_cap=8)
        g = torch.randn(p.n_chunks, 64, 2, generator=torch.Generator().manual_seed(2))
        before = (tk.windowed_tiled_segment_matmul.launches,
                  tk.windowed_tiled_segment_matmul.launches_bf16)
        out = tk.windowed_tiled_segment_matmul(p, g)
        assert (tk.windowed_tiled_segment_matmul.launches,
                tk.windowed_tiled_segment_matmul.launches_bf16) == before
        torch.testing.assert_close(
            out, tk.windowed_tiled_segment_matmul_reference(p, g), rtol=0, atol=0
        )

    def test_same_sums_as_k1(self):
        """Expanding the tile block by uidx gives K1's per-entry rows."""
        rows, cols, vals, n_out, n_in = _stream(seed=7)
        p = tk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, ut_cap=16)
        X = torch.randn(n_in + 4, 3, generator=torch.Generator().manual_seed(3))
        blocks = X.reshape(-1, 24)[torch.from_numpy(p.tiles).long().reshape(-1)]
        out = tk.windowed_tiled_segment_matmul(p, blocks.reshape(p.n_chunks, -1, 3))
        dense = np.zeros((n_out, n_in + 4))
        np.add.at(dense, (rows, cols), vals)
        np.testing.assert_allclose(out[:n_out].numpy(), dense @ X.double().numpy(), atol=ATOL)


@pytest.fixture(scope="module")
def small_graph():
    """The sizes of tests/test_pallas_spmm.py: T=4, N=100, F=8."""
    rng = np.random.default_rng(0)
    T, N, F = 4, 100, 8
    dense = (rng.random((T, N, N)) < 0.08) * rng.random((T, N, N))
    X = rng.standard_normal((T, N, F)).astype(np.float32)
    G = rng.standard_normal((T, N, F)).astype(np.float32)
    return dense, X, G


def _tol(gather_dtype, ref):
    return ATOL if gather_dtype is None else BF16_REL * np.abs(ref).max()


class TestOperator:
    @pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
    @pytest.mark.parametrize("ut_cap", [4, 64])
    def test_forward_and_backward_match_jax(self, small_graph, gather_dtype, ut_cap):
        dense, X, G = small_graph
        op_j = jk.make_operator(
            JaxCOO.from_dense(dense, dtype=jnp.float32, pad_multiple=16), chunk=64, window=64,
            interpret=True, tile_dedup=True, ut_cap=ut_cap, gather_dtype=gather_dtype,
        )
        op_t = tk.make_operator(
            TemporalCOO.from_dense(dense, pad_multiple=16), chunk=64, window=64,
            tile_dedup=True, ut_cap=ut_cap, gather_dtype=gather_dtype,
        )
        ref = np.asarray(op_j(jnp.asarray(X)))
        Xt = torch.from_numpy(X).requires_grad_(True)
        out = op_t(Xt)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=_tol(gather_dtype, ref))
        (out * torch.from_numpy(G)).sum().backward()
        dX_j = np.asarray(jax.grad(lambda x: jnp.vdot(op_j(x), jnp.asarray(G)))(jnp.asarray(X)))
        np.testing.assert_allclose(Xt.grad.numpy(), dX_j, atol=_tol(gather_dtype, dX_j))

    @pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
    def test_flat_operator_duplicates_match_jax(self, gather_dtype):
        """Repeated (row, col) pairs crowding two tiles (the JAX suite's case)."""
        rng = np.random.default_rng(23)
        n, nnz, F = 96, 500, 5
        r = rng.integers(0, n, nnz)
        c = rng.integers(0, 16, nnz)
        v = rng.standard_normal(nnz).astype(np.float32)
        kw = dict(n_in=n, n_out=n, chunk=32, window=32, tile_dedup=True, ut_cap=8,
                  gather_dtype=gather_dtype)
        op_j = jk.make_flat_operator(r, c, v, interpret=True, **kw)
        op_t = tk.make_flat_operator(r, c, v, **kw)
        for pj, pt in ((op_j.packed, op_t.packed), (op_j.packed_t, op_t.packed_t)):
            _assert_packing_equal(pt, pj)
        X = rng.standard_normal((n, F)).astype(np.float32)
        G = rng.standard_normal((n, F)).astype(np.float32)
        ref = np.asarray(op_j(jnp.asarray(X)))
        Xt = torch.from_numpy(X).requires_grad_(True)
        out = op_t(Xt)
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=_tol(gather_dtype, ref))
        (out * torch.from_numpy(G)).sum().backward()
        dX_j = np.asarray(jax.grad(lambda x: jnp.vdot(op_j(x), jnp.asarray(G)))(jnp.asarray(X)))
        np.testing.assert_allclose(Xt.grad.numpy(), dX_j, atol=_tol(gather_dtype, dX_j))

    def test_operator_moves_with_to(self, small_graph):
        dense, X, _ = small_graph
        op = tk.make_operator(TemporalCOO.from_dense(dense, pad_multiple=16), 64, 64,
                              tile_dedup=True)
        moved = op.to("cpu")
        assert isinstance(moved.packed, tk.PackedTiled)
        assert isinstance(moved.packed.tiles, torch.Tensor)
        Xt = torch.from_numpy(X)
        torch.testing.assert_close(moved(Xt), op(Xt), rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["pallas_tiled", "pallas_tiled_bf16"])
def test_spmm_tiled_impls_match_jax(small_graph, impl):
    dense, X, G = small_graph
    A_t = TemporalCOO.from_dense(dense, pad_multiple=16)
    A_j = JaxCOO.from_dense(dense, dtype=jnp.float32, pad_multiple=16)
    gather_dtype = "bfloat16" if impl.endswith("bf16") else None
    Xt = torch.from_numpy(X).requires_grad_(True)
    out = tspmm.spmm(A_t, Xt, impl=impl)
    ref = np.asarray(jspmm.spmm(A_j, jnp.asarray(X), impl=impl))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=_tol(gather_dtype, ref))
    (out * torch.from_numpy(G)).sum().backward()
    dX = np.asarray(jax.grad(lambda x: jnp.vdot(jspmm.spmm(A_j, x, impl=impl), jnp.asarray(G)))(
        jnp.asarray(X)))
    np.testing.assert_allclose(Xt.grad.numpy(), dX, atol=_tol(gather_dtype, dX))

"""The port's sparse operators against the JAX package: K1's bf16-gather
tier, the rectangular flat operator, the row-split and block-dense
operators.

Inputs are made with numpy from a seed and go through both packages.
Tolerances are the JAX suite's: 1e-5 absolute for float32
(tests/test_pallas_spmm.py:62), 2e-2 of the output's scale for the bf16
tiers (:115) and 3e-2 for block-dense bf16 (tests/test_spmm_blockdense.py:36).
Packings and plans must be equal array for array.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.kernels import spmm_pallas as jk
from tmgcn_tpu.ops import spmm_blockdense as jbd
from tmgcn_tpu.ops import spmm_rowsplit as jrs
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda as tk
from tmgcn_torch.ops import spmm_blockdense as tbd
from tmgcn_torch.ops import spmm_rowsplit as trs

ATOL = 1e-5
BF16_REL = 2e-2


def _scale_tol(ref, rel):
    return rel * max(np.abs(ref).max(), 1e-30)


def _rect_stream(seed, n_out=75, n_in=210, nnz=600):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n_out, nnz)
    c = rng.integers(0, n_in, nnz)
    v = rng.standard_normal(nnz).astype(np.float32)
    return r, c, v, n_out, n_in


def _clustered(seed, n_out=500, n_in=900, nnz=4000):
    """Block-local pattern (tests/test_spmm_blockdense.py's)."""
    rng = np.random.default_rng(seed)
    centers_r = rng.integers(0, n_out, nnz // 16 + 1)
    centers_c = rng.integers(0, n_in, nnz // 16 + 1)
    pick = rng.integers(0, len(centers_r), nnz)
    rows = np.clip(centers_r[pick] + rng.integers(-40, 40, nnz), 0, n_out - 1)
    cols = np.clip(centers_c[pick] + rng.integers(-40, 40, nnz), 0, n_in - 1)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return rows, cols, vals, n_out, n_in


def _fwd_bwd(op_t, op_j, X, G):
    """Port and JAX outputs and input gradients of op(X) · G."""
    Xt = torch.from_numpy(X).requires_grad_(True)
    out = op_t(Xt)
    (out * torch.from_numpy(G)).sum().backward()
    ref = np.asarray(op_j(jnp.asarray(X)))
    dX = np.asarray(jax.grad(lambda x: jnp.vdot(op_j(x), jnp.asarray(G)))(jnp.asarray(X)))
    return out.detach().numpy(), Xt.grad.numpy(), ref, dX


@pytest.fixture(scope="module")
def small_graph():
    rng = np.random.default_rng(0)
    T, N, F = 4, 100, 8
    dense = (rng.random((T, N, N)) < 0.08) * rng.random((T, N, N))
    X = rng.standard_normal((T, N, F)).astype(np.float32)
    G = rng.standard_normal((T, N, F)).astype(np.float32)
    return dense, X, G


class TestK1Bf16Tier:
    @pytest.mark.parametrize("F", [2, 6])
    @pytest.mark.parametrize("use_init", [False, True])
    def test_plain_version_matches_pallas_interpret(self, F, use_init):
        rng = np.random.default_rng(F)
        rows = np.sort(rng.integers(0, 1000, 3000))
        cols = rng.integers(0, 700, 3000)
        vals = rng.standard_normal(3000).astype(np.float32)
        p = tk.pack_windowed_flat(rows, cols, vals, 1000, 64, 128, True, all_windows=not use_init)
        g = rng.standard_normal((p.n_chunks, p.chunk, F)).astype(np.float32)
        init = np.zeros((p.n_rows_out, F), np.float32)
        ours = tk.windowed_segment_matmul_reference(
            p, torch.from_numpy(g).to(torch.bfloat16), out_dtype=torch.float32,
            init=torch.from_numpy(init.copy()) if use_init else None,
        )
        jp = jk.PackedSpmm(
            rows=jnp.asarray(p.rows), cols=jnp.asarray(p.cols), vals=jnp.asarray(p.vals),
            window_id=jnp.asarray(p.window_id), is_first=jnp.asarray(p.is_first),
            n_rows_out=p.n_rows_out, chunk=p.chunk, window=p.window,
        )
        ref = np.asarray(jk.windowed_segment_matmul(
            jp, jnp.asarray(g, jnp.bfloat16), jax.lax.Precision.DEFAULT, interpret=True,
            out_dtype=jnp.float32, init=jnp.asarray(init) if use_init else None,
        ))
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, atol=_scale_tol(ref, BF16_REL))

    @pytest.mark.parametrize("sort_cols", [False, True])
    def test_operator_matches_jax(self, small_graph, sort_cols):
        dense, X, G = small_graph
        op_j = jk.make_operator(
            JaxCOO.from_dense(dense, dtype=jnp.float32, pad_multiple=16), chunk=64, window=64,
            interpret=True, gather_dtype="bfloat16", sort_cols=sort_cols,
        )
        op_t = tk.make_operator(
            TemporalCOO.from_dense(dense, pad_multiple=16), chunk=64, window=64,
            gather_dtype="bfloat16", sort_cols=sort_cols,
        )
        out, dX, ref, dX_j = _fwd_bwd(op_t, op_j, X, G)
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, ref, atol=_scale_tol(ref, BF16_REL))
        np.testing.assert_allclose(dX, dX_j, atol=_scale_tol(dX_j, BF16_REL))
        # The bf16 tier was taken: not the float32 result.
        f32 = dataclasses.replace(op_t, gather_dtype=None)(torch.from_numpy(X)).numpy()
        assert np.abs(out - f32).max() > 0

    def test_unknown_gather_dtype_raises(self, small_graph):
        dense, _, _ = small_graph
        with pytest.raises(ValueError, match="gather_dtype"):
            tk.make_operator(TemporalCOO.from_dense(dense), gather_dtype="float16")


class TestFlatPallasOperator:
    @pytest.mark.parametrize(
        "kwargs",
        [{}, {"sort_cols": True}, {"gather_dtype": "bfloat16", "sort_cols": True},
         {"tile_dedup": True}, {"tile_dedup": True, "ut_cap": 2, "gather_dtype": "bfloat16"}],
    )
    def test_forward_backward_match_jax(self, kwargs):
        r, c, v, n_out, n_in = _rect_stream(11)
        op_j = jk.make_flat_operator(
            r, c, v, n_in=n_in, n_out=n_out, chunk=64, window=64, interpret=True, **kwargs
        )
        op_t = tk.make_flat_operator(r, c, v, n_in=n_in, n_out=n_out, chunk=64, window=64, **kwargs)
        assert (op_t.n_in, op_t.n_out) == (n_in, n_out)
        rng = np.random.default_rng(1)
        X = rng.standard_normal((n_in, 5)).astype(np.float32)
        G = rng.standard_normal((n_out, 5)).astype(np.float32)
        out, dX, ref, dX_j = _fwd_bwd(op_t, op_j, X, G)
        rel = BF16_REL if "gather_dtype" in kwargs else None
        np.testing.assert_allclose(out, ref, atol=_scale_tol(ref, rel) if rel else ATOL)
        np.testing.assert_allclose(dX, dX_j, atol=_scale_tol(dX_j, rel) if rel else ATOL)
        # And the dense oracle.
        dense = np.zeros((n_out, n_in))
        np.add.at(dense, (r, c), v)
        np.testing.assert_allclose(out, dense @ X, atol=_scale_tol(ref, rel) if rel else 1e-4)

    def test_moves_with_to(self):
        r, c, v, n_out, n_in = _rect_stream(12)
        op = tk.make_flat_operator(r, c, v, n_in=n_in, n_out=n_out, chunk=32, window=32)
        X = torch.randn(n_in, 3, generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(op.to("cpu")(X), op(X), rtol=0, atol=0)


class TestRowSplit:
    @pytest.mark.parametrize("k", [1, 4, 16])
    def test_stream_plan_matches_jax(self, k):
        r, c, v, n_out, _ = _rect_stream(2, nnz=900)
        order = np.lexsort((c, r))
        ours = trs.pack_rowsplit_stream(r[order], c[order], v[order], n_out, k)
        ref = jrs.pack_rowsplit_stream(r[order], c[order], v[order], n_out, k)
        assert (ours.n_rows_out, ours.k, ours.n_segments) == (ref.n_rows_out, ref.k, ref.n_segments)
        for f in ("seg_rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(ref, f)), f)
        assert np.all(ours.vals[ours.n_real:] == 0)

    def test_temporal_plan_and_flatten_match_jax(self, small_graph):
        dense, _, _ = small_graph
        A_t, A_j = TemporalCOO.from_dense(dense, pad_multiple=16), JaxCOO.from_dense(dense, pad_multiple=16)
        for a, b in zip(trs.flatten_stream(A_t), jrs.flatten_stream(A_j)):
            np.testing.assert_array_equal(a, b)
        ours, ref = trs.pack_rowsplit(A_t, 4), jrs.pack_rowsplit(A_j, 4)
        for f in ("seg_rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(ref, f)), f)

    def test_empty_plan_matches_jax(self):
        z = np.zeros(0, np.int64)
        ours = trs.pack_rowsplit_stream(z, z, np.zeros(0, np.float32), 10, 4)
        ref = jrs.pack_rowsplit_stream(z, z, np.zeros(0, np.float32), 10, 4)
        assert ours.n_real == 0 and ours.n_segments == ref.n_segments
        out = trs.apply_plan(ours, torch.ones(3, 2))
        assert out.shape == (10, 2) and torch.all(out == 0)

    def test_operator_matches_jax(self, small_graph):
        dense, X, G = small_graph
        op_j = jrs.make_operator(JaxCOO.from_dense(dense, dtype=jnp.float32, pad_multiple=16))
        op_t = trs.make_operator(TemporalCOO.from_dense(dense, pad_multiple=16))
        assert (op_t.n_slices, op_t.n_nodes) == (4, 100)
        out, dX, ref, dX_j = _fwd_bwd(op_t, op_j, X, G)
        np.testing.assert_allclose(out, ref, atol=ATOL)
        np.testing.assert_allclose(dX, dX_j, atol=ATOL)

    @pytest.mark.parametrize("k", [1, 4])
    def test_flat_operator_matches_jax(self, k):
        r, c, v, n_out, n_in = _rect_stream(3)
        op_j = jrs.make_flat_operator(r, c, v, n_in=n_in, n_out=n_out, k=k)
        op_t = trs.make_flat_operator(r, c, v, n_in=n_in, n_out=n_out, k=k)
        for pj, pt in ((op_j.plan, op_t.plan), (op_j.plan_t, op_t.plan_t)):
            for f in ("seg_rows", "cols", "vals"):
                np.testing.assert_array_equal(getattr(pt, f), np.asarray(getattr(pj, f)), f)
        rng = np.random.default_rng(4)
        X = rng.standard_normal((n_in, 3)).astype(np.float32)
        G = rng.standard_normal((n_out, 3)).astype(np.float32)
        out, dX, ref, dX_j = _fwd_bwd(op_t.to("cpu"), op_j, X, G)
        np.testing.assert_allclose(out, ref, atol=ATOL)
        np.testing.assert_allclose(dX, dX_j, atol=ATOL)


class TestBlockDense:
    @pytest.mark.parametrize("clustered", [True, False])
    @pytest.mark.parametrize("itemsize", [2, 4])
    def test_estimate_matches_jax(self, clustered, itemsize):
        rows, cols, _, _, _ = _clustered(0) if clustered else _rect_stream(0, 5000, 5000, 3000)
        assert tbd.estimate(rows, cols, itemsize=itemsize) == jbd.estimate(rows, cols, itemsize=itemsize)
        assert tbd.estimate(np.zeros(0), np.zeros(0)) == jbd.estimate(np.zeros(0), np.zeros(0))

    @pytest.mark.parametrize("dense_limit", [1 << 22, 16])
    def test_blocks_and_incidences_match_jax(self, dense_limit):
        rows, cols, vals, n_out, n_in = _clustered(1)
        kw = dict(n_in=n_in, n_out=n_out, block=64, dense_limit=dense_limit)
        ours = tbd.make_flat_operator(rows, cols, vals, **kw)
        ref = jbd.make_flat_operator(rows, cols, vals, **kw)
        np.testing.assert_array_equal(ours.AblkT, np.asarray(ref.AblkT))
        assert (ours.nrb, ours.ncb, ours.n_blocks) == (ref.nrb, ref.ncb, ref.n_blocks)
        for name in ("oh_rw", "oh_cw"):
            a, b = getattr(ours, name), getattr(ref, name)
            assert isinstance(a, tbd.BlockDenseOperator) == isinstance(b, jbd.BlockDenseOperator)
            if isinstance(a, tbd.BlockDenseOperator):
                np.testing.assert_array_equal(a.AblkT, np.asarray(b.AblkT))
                for sub in ("oh_rw", "oh_cw"):
                    np.testing.assert_array_equal(getattr(a, sub), np.asarray(getattr(b, sub)))
            else:
                np.testing.assert_array_equal(a, np.asarray(b))

    @pytest.mark.parametrize("mode", ["exact", "fast", "bf16"])
    @pytest.mark.parametrize("dense_limit", [1 << 22, 16])
    def test_forward_backward_match_jax(self, mode, dense_limit):
        rows, cols, vals, n_out, n_in = _clustered(2)
        kw = dict(n_in=n_in, n_out=n_out, block=64, mode=mode, dense_limit=dense_limit)
        op_t = tbd.make_flat_operator(rows, cols, vals, **kw).to("cpu")
        op_j = jbd.make_flat_operator(rows, cols, vals, **kw)
        if mode == "bf16":
            assert op_t.AblkT.dtype == torch.bfloat16
        rng = np.random.default_rng(3)
        X = rng.standard_normal((n_in, 6)).astype(np.float32)
        G = rng.standard_normal((n_out, 6)).astype(np.float32)
        out, dX, ref, dX_j = _fwd_bwd(op_t, op_j, X, G)
        assert out.dtype == np.float32
        if mode == "bf16":
            np.testing.assert_allclose(out, ref, atol=_scale_tol(ref, 3e-2))
            np.testing.assert_allclose(dX, dX_j, atol=_scale_tol(dX_j, 3e-2))
        else:
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=ATOL)
            np.testing.assert_allclose(dX, dX_j, rtol=1e-5, atol=ATOL)

    def test_duplicates_empty_and_guard(self):
        op = tbd.make_flat_operator(
            np.array([3, 3, 3, 7]), np.array([5, 5, 2, 5]),
            np.array([1.0, 2.0, 4.0, 8.0], np.float32), n_in=10, n_out=10, block=8,
        )
        Y = torch.zeros(10, 2)
        Y[5] = 1.0
        Z = op(Y)
        assert Z[3, 0].item() == 3.0 and Z[7, 0].item() == 8.0
        empty = tbd.make_flat_operator(
            np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32), n_in=17, n_out=9
        )
        Z = empty(torch.ones(17, 3))
        assert Z.shape == (9, 3) and torch.all(Z == 0)
        rows, cols, vals, _, _ = _rect_stream(4, 50_000, 50_000, 3000)
        with pytest.raises(ValueError, match="max_bytes"):
            tbd.make_flat_operator(rows, cols, vals, n_in=50_000, n_out=50_000, max_bytes=10_000_000)
        with pytest.raises(ValueError, match="mode"):
            tbd.make_flat_operator(rows, cols, vals, n_in=50_000, n_out=50_000, mode="tf32")

    @pytest.mark.parametrize("mode", ["exact", "bf16"])
    def test_temporal_operator_matches_jax(self, small_graph, mode):
        dense, X, G = small_graph
        op_t = tbd.make_operator(TemporalCOO.from_dense(dense, pad_multiple=16), block=64, mode=mode)
        op_j = jbd.make_operator(
            JaxCOO.from_dense(dense, dtype=jnp.float32, pad_multiple=16), block=64, mode=mode
        )
        assert (op_t.n_slices, op_t.n_nodes, op_t.mode) == (4, 100, mode)
        out, dX, ref, dX_j = _fwd_bwd(op_t.to("cpu"), op_j, X, G)
        tol = _scale_tol(ref, 3e-2) if mode == "bf16" else ATOL
        np.testing.assert_allclose(out, ref, atol=tol)
        np.testing.assert_allclose(dX, dX_j, atol=_scale_tol(dX_j, 3e-2) if mode == "bf16" else ATOL)

    def test_tf32_setting_is_restored(self):
        rows, cols, vals, n_out, n_in = _clustered(5)
        op = tbd.make_flat_operator(rows, cols, vals, n_in=n_in, n_out=n_out, block=64, mode="fast")
        before = torch.backends.cuda.matmul.allow_tf32
        Y = torch.randn(n_in, 2, requires_grad=True)
        op(Y).sum().backward()
        assert torch.backends.cuda.matmul.allow_tf32 == before

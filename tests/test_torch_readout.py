"""K2 and the ReadoutPlan of the port against the JAX package.

K2's plain version must match the lane-major Pallas kernel run in
interpret mode on the same packing (atol 1e-5: both sides sum float32
products, in another order). The port's ``make_readout_plan`` must give
the JAX plan's fields, and ``apply_readout``'s forward and gradients must
match JAX's custom VJP in both layouts (rtol/atol 1e-5, the JAX suite's
own, tests/test_edge_readout_plan.py). The JAX plans run ``interpret=True``
as that suite runs them.

The CUDA kernels have no CPU mode: their comparison with the plain
versions is in tests/test_torch_cuda.py, marked ``cuda``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.kernels import spmm_pallas as jk
from tmgcn_tpu.ops import edge_readout as jro
from tmgcn_torch.kernels import spmm_cuda as tk
from tmgcn_torch.ops import edge_readout as tro

ATOL = 1e-5
FIELDS = ("rows", "cols", "vals", "window_id", "is_first")


def _stream(seed=0, n_out=1000, n_in=700, P=3000):
    """Row-sorted entries with empty windows and a window of many chunks."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([
        rng.integers(0, 300, P // 2),
        rng.integers(640, 700, P // 4),
        rng.integers(900, n_out, P - P // 2 - P // 4),
    ]))
    cols = rng.integers(0, n_in, P)
    vals = rng.standard_normal(P).astype(np.float32)
    return rows, cols, vals, n_out


def _jax_packed(p: tk.PackedSpmm) -> jk.PackedSpmm:
    return jk.PackedSpmm(
        rows=jnp.asarray(p.rows), cols=jnp.asarray(p.cols), vals=jnp.asarray(p.vals),
        window_id=jnp.asarray(p.window_id), is_first=jnp.asarray(p.is_first),
        n_rows_out=p.n_rows_out, chunk=p.chunk, window=p.window,
    )


class TestK2:
    @pytest.mark.parametrize("F", [1, 3, 6])
    @pytest.mark.parametrize("use_init", [False, True])
    def test_plain_matches_pallas_interpret(self, F, use_init):
        rows, cols, vals, n_out = _stream(seed=F)
        p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, all_windows=not use_init)
        g = np.random.default_rng(F + 10).standard_normal((p.n_chunks, F, p.chunk)).astype(np.float32)
        # A nonzero init shows which windows the kernel leaves alone.
        init = np.full((F, p.n_rows_out), 7.0, np.float32)
        ours = tk.windowed_segment_matmul_t_reference(
            p, torch.from_numpy(g), init=torch.from_numpy(init.copy()) if use_init else None
        )
        ref = jk.windowed_segment_matmul_t(
            _jax_packed(p), jnp.asarray(g), interpret=True,
            init=jnp.asarray(init) if use_init else None,
        )
        assert ours.shape == (F, p.n_rows_out)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
        if use_init:  # windows 3, 4 and 6 (rows 384-639, 768-895) have no entry
            assert np.all(ours.numpy()[:, 384:640] == 7.0)

    @pytest.mark.parametrize("use_init", [False, True])
    def test_any_window_matches_pallas_interpret(self, use_init):
        """A 2048-row window, past the 1,024 rows the first CUDA K2 took:
        the row walk has no cap, and neither has the JAX kernel."""
        rows, cols, vals, _ = _stream(seed=8)
        rows = rows * 4  # three windows of 2048 rows, the middle one without entries
        rows[rows >= 2048] += 2048
        p = tk.pack_windowed_flat(rows, cols, vals, 6144, 64, 2048, all_windows=not use_init)
        assert p.window == 2048 and p.n_windows == 3
        g = np.random.default_rng(9).standard_normal((p.n_chunks, 6, p.chunk)).astype(np.float32)
        init = np.full((6, p.n_rows_out), 7.0, np.float32)
        ours = tk.windowed_segment_matmul_t(
            p.to("cpu"), torch.from_numpy(g), init=torch.from_numpy(init.copy()) if use_init else None
        )
        ref = jk.windowed_segment_matmul_t(
            _jax_packed(p), jnp.asarray(g), interpret=True,
            init=jnp.asarray(init) if use_init else None,
        )
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
        assert np.all(ours.numpy()[:, 2048:4096] == (7.0 if use_init else 0.0))

    def test_is_k1_transposed(self):
        rows, cols, vals, n_out = _stream(seed=4)
        p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, sort_cols=True)
        g = torch.from_numpy(
            np.random.default_rng(5).standard_normal((p.n_chunks, p.chunk, 5)).astype(np.float32)
        )
        k1 = tk.windowed_segment_matmul_reference(p, g)
        k2 = tk.windowed_segment_matmul_t_reference(p, g.permute(0, 2, 1).contiguous())
        torch.testing.assert_close(k2, k1.T, rtol=0, atol=0)

    def test_wrapper_takes_the_plain_version_on_the_cpu(self):
        rows, cols, vals, n_out = _stream(seed=6)
        p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128)
        g = torch.randn(p.n_chunks, 2, p.chunk, generator=torch.Generator().manual_seed(0))
        before = tk.windowed_segment_matmul_t.launches
        out = tk.windowed_segment_matmul_t(p.to("cpu"), g)
        assert tk.windowed_segment_matmul_t.launches == before
        torch.testing.assert_close(out, tk.windowed_segment_matmul_t_reference(p, g), rtol=0, atol=0)

    def test_wrapper_refuses_other_devices(self):
        rows, cols, vals, n_out = _stream(seed=7)
        p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128)
        with pytest.raises(ValueError, match="no kernel"):
            tk.windowed_segment_matmul_t(p, torch.empty(p.n_chunks, 2, p.chunk, device="meta"))


def _edges(seed, T, N, E):
    rng = np.random.default_rng(seed)
    return np.stack([
        np.sort(rng.integers(0, T, E)), rng.integers(0, N, E), rng.integers(0, N, E),
    ]).astype(np.int64)


class TestPlan:
    @pytest.mark.parametrize("lane_major", [False, True])
    def test_fields_match_jax(self, lane_major):
        T, N = 4, 300
        edges = _edges(0, T, N, 400)
        ours = tro.make_readout_plan(edges, T, N, 64, 128, lane_major=lane_major)
        ref = jro.make_readout_plan(edges, T, N, 64, 128, interpret=True, lane_major=lane_major)
        assert ours.lane_major == ref.lane_major == lane_major
        assert ours.n_rows == ref.n_rows == T * N
        for f in ("src", "trg", "sort_cols"):
            np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), f)
            assert getattr(ours, f).dtype == torch.int32, f
        assert ours.packed.n_rows_out == ref.packed.n_rows_out
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(ours.packed, f).numpy(), np.asarray(getattr(ref.packed, f)), f
            )

    @pytest.mark.parametrize(
        "n_slices,n_nodes,expected",
        [
            (80, 7_301, False),          # chess: T*N = 584,080
            (1, 4_194_303, False),       # the last T*N below the threshold
            (1, 4_194_304, True),        # the first T*N past it
            (64, 500_000, True),         # the 500k-node scale run: T*N = 32M
        ],
    )
    def test_auto_layout_matches_jax(self, n_slices, n_nodes, expected):
        edges = _edges(1, n_slices, n_nodes, 50)
        ours = tro.make_readout_plan(edges, n_slices, n_nodes)
        ref = jro.make_readout_plan(edges, n_slices, n_nodes, interpret=True)
        assert ours.lane_major == ref.lane_major == expected
        assert tro.LANE_MAJOR_BYTES == jro.LANE_MAJOR_BYTES

    def test_to_moves_every_tensor(self):
        plan = tro.make_readout_plan(_edges(2, 3, 50, 40), 3, 50, 32, 64).to("meta")
        assert {plan.src.device.type, plan.trg.device.type, plan.sort_cols.device.type,
                plan.packed.rows.device.type, plan.packed.window_ptr.device.type} == {"meta"}


def _readout_case(seed, T=4, N=64, E=120, F=5, C=3):
    rng = np.random.default_rng(seed)
    edges = _edges(seed, T, N, E)
    Y = rng.standard_normal((T, N, F)).astype(np.float32)
    U = rng.standard_normal((2 * F, C)).astype(np.float32)
    G = rng.standard_normal((E, C)).astype(np.float32)
    return edges, Y, U, G


class TestApplyReadout:
    @pytest.mark.parametrize("lane_major", [False, True])
    def test_forward_and_gradients_match_jax(self, lane_major):
        edges, Y, U, G = _readout_case(3)
        T, N, _ = Y.shape
        plan = tro.make_readout_plan(edges, T, N, lane_major=lane_major)
        Yt = torch.from_numpy(Y).requires_grad_(True)
        Ut = torch.from_numpy(U).requires_grad_(True)
        before = (tk.windowed_segment_matmul.launches, tk.windowed_segment_matmul_t.launches)
        out = tro.apply_readout(plan, Yt, Ut)
        (out * torch.from_numpy(G)).sum().backward()
        assert (tk.windowed_segment_matmul.launches,
                tk.windowed_segment_matmul_t.launches) == before  # plain versions on the CPU

        jplan = jro.make_readout_plan(edges, T, N, interpret=True, lane_major=lane_major)

        def f(y, u):
            o = jro.apply_readout(jplan, y, u)
            return jnp.vdot(o, jnp.asarray(G)), o

        (_, ref), (gY, gU) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(Y), jnp.asarray(U)
        )
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(Yt.grad.numpy(), np.asarray(gY), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(Ut.grad.numpy(), np.asarray(gU), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("lane_major", [False, True])
    def test_matches_plain_gather_in_float64(self, lane_major):
        edges, Y, U, G = _readout_case(4, T=3, N=300, E=500, F=6)
        T, N, _ = Y.shape
        plan = tro.make_readout_plan(edges, T, N, 64, 128, lane_major=lane_major)
        grads = []
        for readout in (lambda y, u: tro.apply_readout(plan, y, u),
                        lambda y, u: tro.edge_readout(y, torch.from_numpy(edges), u)):
            Yt = torch.from_numpy(Y.astype(np.float64)).requires_grad_(True)
            Ut = torch.from_numpy(U.astype(np.float64)).requires_grad_(True)
            out = readout(Yt, Ut)
            (out * torch.from_numpy(G.astype(np.float64))).sum().backward()
            grads.append((out.detach(), Yt.grad, Ut.grad))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)

    def test_only_the_asked_gradients(self):
        """A frozen U (WD-GCN's) gets no gradient; Y's still runs the kernel path."""
        edges, Y, U, G = _readout_case(5)
        T, N, _ = Y.shape
        plan = tro.make_readout_plan(edges, T, N)
        Yt = torch.from_numpy(Y).requires_grad_(True)
        Ut = torch.from_numpy(U)
        (tro.apply_readout(plan, Yt, Ut) * torch.from_numpy(G)).sum().backward()
        assert Ut.grad is None and Yt.grad is not None
        Ut.requires_grad_(True)
        (tro.apply_readout(plan, torch.from_numpy(Y), Ut) * torch.from_numpy(G)).sum().backward()
        assert Ut.grad is not None

    def test_make_readout_operator(self):
        edges, Y, U, _ = _readout_case(6)
        T, N, _ = Y.shape
        op = tro.make_readout_operator(edges, T, N, device="cpu")
        Yt, Ut = torch.from_numpy(Y), torch.from_numpy(U)
        torch.testing.assert_close(
            op(Yt, Ut), tro.edge_readout(Yt, torch.from_numpy(edges), Ut), rtol=1e-6, atol=1e-6
        )

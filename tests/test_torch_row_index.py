"""The row index of K1's, K2's and K3's packings (``entry_order``, ``row_ptr``).

The packers index the real entries (value != 0) by global output row, in
chunk then entry order within a row; the CUDA kernels walk that index, one
thread per output element. These CPU tests hold the index to that contract
for both packers (sort_cols True and False, all_windows True and False, the
empty stream, tiled packings, readout plans), check that sums taken through
it in float64 give the plain versions' output, and that a float32 emulation
of the kernels' row walk (its write rules included; K2's lane-major layout
too, against the JAX package's K2 in interpret mode) does too. The arrays
the JAX package also has must still equal its packers'. Tolerance 1e-5 ·
max(1, |reference|): float32 sums in another order than the float64 ones.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.kernels import spmm_pallas as jk
from tmgcn_torch.kernels import spmm_cuda as tk
from tmgcn_torch.ops.edge_readout import make_readout_plan

ATOL = 1e-5
K1_FIELDS = ("rows", "cols", "vals", "window_id", "is_first")
K3_FIELDS = ("rows", "uidx", "tiles", "vals", "window_id", "is_first")
K1_CASES = [(s, a) for s in (False, True) for a in (True, False)]
K3_CASES = [(u, a) for u in (4, 64) for a in (True, False)]


def _stream(seed=0, n_out=1000, n_in=700, P=3000):
    """Row-sorted entries: empty windows, a window of many chunks, one row
    of 300 entries spanning chunks, and a few explicit zero values."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([
        rng.integers(0, 300, P // 2),
        rng.integers(640, 700, P // 4),
        np.full(300, 650),
        rng.integers(900, n_out, P - P // 2 - P // 4),
    ]))
    cols = rng.integers(0, n_in, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    vals[rng.integers(0, rows.size, 20)] = 0.0
    return rows, cols, vals, n_out, n_in


def _k1(sort_cols, all_windows, seed=0):
    rows, cols, vals, n_out, _ = _stream(seed)
    return tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, sort_cols, all_windows)


def _k3(ut_cap, all_windows, seed=0):
    rows, cols, vals, n_out, _ = _stream(seed)
    return tk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, ut_cap, all_windows)


def _global_rows(p) -> np.ndarray:
    """Each slot's global output row, (J * C,)."""
    return (p.window_id.astype(np.int64)[:, None] * p.window + p.rows).reshape(-1)


def _row_of_position(p) -> np.ndarray:
    """The output row of each position of entry_order."""
    return np.repeat(np.arange(p.n_rows_out), np.diff(p.row_ptr))


def _assert_index(p):
    eo, rp = p.entry_order, p.row_ptr
    assert eo.dtype == np.int32 and rp.dtype == np.int32
    assert rp.shape == (p.n_rows_out + 1,) and rp[0] == 0 and rp[-1] == eo.size
    assert np.all(np.diff(rp) >= 0)
    # Every real slot exactly once, and no padding slot.
    np.testing.assert_array_equal(np.sort(eo), np.flatnonzero(p.vals.reshape(-1) != 0))
    row_of = _row_of_position(p)
    np.testing.assert_array_equal(_global_rows(p)[eo], row_of)
    # Chunk then entry order within a row: chunks are window-sorted, so that
    # is ascending flat slot id j*C + c.
    same_row = row_of[1:] == row_of[:-1]
    assert np.all(eo[1:][same_row] > eo[:-1][same_row])


def _source_rows(p, n_slots_per_chunk: int) -> np.ndarray:
    """Each slot's row of the flattened (J * rows-per-chunk, F) kernel input:
    the slot itself for K1, its tile-block row for K3."""
    slots = np.arange(p.rows.size)
    if isinstance(p, tk.PackedTiled):
        return slots // p.chunk * n_slots_per_chunk + p.uidx.reshape(-1)
    return slots


def _sum_through_index_f64(p, gathered: np.ndarray) -> np.ndarray:
    """Σ vals · x over each row's indexed entries, in float64."""
    J, R, F = gathered.shape
    x = gathered.reshape(J * R, F).astype(np.float64)
    eo = p.entry_order
    out = np.zeros((p.n_rows_out, F))
    np.add.at(out, _row_of_position(p),
              p.vals.reshape(-1)[eo, None].astype(np.float64) * x[_source_rows(p, R)[eo]])
    return out


def _emulate_kernel(p, gathered: torch.Tensor, init: torch.Tensor | None,
                    lane_major: bool = False) -> torch.Tensor:
    """The CUDA kernels' row walk on the CPU: each output row sums its
    indexed entries one by one in float32, each product rounded to the
    gathered type first; rows of windows without a chunk are written (as
    0) only without an init. lane_major (K2): gathered is (J, F, C), slot
    s = j*C + c reads feature f at flat offset (j*F + f)*C + c, and the
    output is (F, n_rows_out)."""
    if lane_major:
        J, F, R = gathered.shape
        flat = gathered.reshape(-1)
        f_off = torch.arange(F) * R

        def features(s):
            j, c = divmod(s, R)
            return flat[j * F * R + f_off + c]
    else:
        J, R, F = gathered.shape
        x = gathered.reshape(J * R, F)
        src = _source_rows(p, R)

        def features(s):
            return x[src[s]]
    vals = torch.from_numpy(p.vals.reshape(-1)).to(gathered.dtype)
    if init is None:
        out = torch.zeros((F, p.n_rows_out) if lane_major else (p.n_rows_out, F))
    else:
        out = init
    rows_of = out.T if lane_major else out  # output row r in either layout
    has_chunk = np.diff(p.window_ptr) > 0
    for r in range(p.n_rows_out):
        if init is not None and not has_chunk[r // p.window]:
            continue
        acc = torch.zeros(F)
        for s in p.entry_order[p.row_ptr[r]:p.row_ptr[r + 1]].tolist():
            acc = acc + (vals[s] * features(s)).float()
        rows_of[r] = acc
    return out


def _numpy(p):
    """A packing moved by ``.to`` back to numpy arrays."""
    arrays = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    return dataclasses.replace(p, **{k: v.numpy() for k, v in arrays.items()
                                     if isinstance(v, torch.Tensor)})


def _plain(p, gathered: torch.Tensor, init=None) -> torch.Tensor:
    if isinstance(p, tk.PackedTiled):
        return tk.windowed_tiled_segment_matmul_reference(p, gathered, torch.float32)
    return tk.windowed_segment_matmul_reference(p, gathered, torch.float32, init)


def _gathered(p, F: int, seed: int) -> np.ndarray:
    R = 8 * p.ut_cap if isinstance(p, tk.PackedTiled) else p.chunk
    return np.random.default_rng(seed).standard_normal((p.n_chunks, R, F)).astype(np.float32)


def _assert_close(out, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(out, np.float64), ref, rtol=0,
                               atol=ATOL * max(1.0, np.abs(ref).max(initial=0.0)))


class TestIndex:
    @pytest.mark.parametrize("sort_cols,all_windows", K1_CASES)
    def test_k1_lists_every_real_slot_in_order(self, sort_cols, all_windows):
        _assert_index(_k1(sort_cols, all_windows))

    @pytest.mark.parametrize("ut_cap,all_windows", K3_CASES)
    def test_k3_lists_every_real_slot_in_order(self, ut_cap, all_windows):
        _assert_index(_k3(ut_cap, all_windows))

    @pytest.mark.parametrize("tiled", [False, True])
    def test_empty_stream(self, tiled):
        z = np.zeros(0, np.int64)
        pack = tk.pack_windowed_tiled_flat if tiled else tk.pack_windowed_flat
        p = pack(z, z, np.zeros(0, np.float32), 300, 64, 128)
        _assert_index(p)
        assert p.entry_order.size == 0 and np.all(p.row_ptr == 0)

    def test_sort_cols_keeps_chunk_then_entry_order(self):
        """Column-sorted windows permute rows inside a window: the index
        still walks each row in chunk then entry order, which differs from
        the row-sorted packing's slot order."""
        by_col, by_row = _k1(True, True), _k1(False, True)
        np.testing.assert_array_equal(by_col.row_ptr, by_row.row_ptr)
        assert not np.array_equal(by_col.entry_order, by_row.entry_order)
        # Same multiset of (row, column, value) per row.
        for p in (by_col, by_row):
            _assert_index(p)
        key = lambda p: np.lexsort((p.cols.reshape(-1)[p.entry_order], _row_of_position(p)))
        for f in ("cols", "vals"):
            np.testing.assert_array_equal(
                getattr(by_col, f).reshape(-1)[by_col.entry_order][key(by_col)],
                getattr(by_row, f).reshape(-1)[by_row.entry_order][key(by_row)],
            )

    def test_zero_values_are_not_indexed(self):
        rows, cols, vals, n_out, _ = _stream(1)
        p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128)
        assert p.entry_order.size == np.count_nonzero(vals) < rows.size

    def test_long_row_spans_chunks(self):
        """Row 650 has over 300 entries across several chunks of 64."""
        p = _k1(False, True)
        lo, hi = p.row_ptr[650], p.row_ptr[651]
        assert hi - lo > 300
        chunks = p.entry_order[lo:hi] // p.chunk
        assert len(np.unique(chunks)) > 4 and np.all(np.diff(chunks) >= 0)

    @pytest.mark.parametrize("tiled", [False, True])
    def test_to_moves_the_index(self, tiled):
        p = _k3(8, True) if tiled else _k1(True, True)
        moved = p.to("cpu")
        for f in ("entry_order", "row_ptr"):
            t = getattr(moved, f)
            assert isinstance(t, torch.Tensor) and t.dtype == torch.int32, f
            np.testing.assert_array_equal(t.numpy(), getattr(p, f), f)

    @pytest.mark.parametrize("lane_major", [False, True])
    def test_readout_plan_packing_is_indexed(self, lane_major):
        """The readout plan's packing (K1's, or K2's past LANE_MAJOR_BYTES)."""
        rng = np.random.default_rng(8)
        T, N, E = 4, 300, 700
        edges = np.stack([rng.integers(0, T, E), rng.integers(0, N, E), rng.integers(0, N, E)])
        plan = make_readout_plan(edges, T, N, 64, 128, lane_major=lane_major)
        assert plan.lane_major == lane_major
        _assert_index(_numpy(plan.packed))

    @pytest.mark.parametrize("tile_dedup", [False, True])
    def test_flat_operator_packings_are_indexed(self, tile_dedup):
        """The restricted layer-2 operator's forward and transposed packings."""
        rng = np.random.default_rng(9)
        r, c = rng.integers(0, 900, 4000), rng.integers(0, 1300, 4000)
        v = rng.standard_normal(4000).astype(np.float32)
        op = tk.make_flat_operator(r, c, v, n_in=1300, n_out=900, chunk=512, window=256,
                                   sort_cols=True, tile_dedup=tile_dedup)
        for p in (op.packed, op.packed_t):
            _assert_index(p)
        moved = op.to("cpu")
        assert isinstance(moved.packed_t.row_ptr, torch.Tensor)


class TestSharedFields:
    @pytest.mark.parametrize("sort_cols,all_windows", K1_CASES)
    def test_k1_fields_match_jax(self, sort_cols, all_windows):
        rows, cols, vals, n_out, _ = _stream()
        ref = jk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, sort_cols, all_windows)
        ours = _k1(sort_cols, all_windows)
        assert ours.n_rows_out == ref.n_rows_out
        for f in K1_FIELDS:
            np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(ref, f)), f)
            assert getattr(ours, f).dtype == np.asarray(getattr(ref, f)).dtype, f

    @pytest.mark.parametrize("ut_cap,all_windows", K3_CASES)
    def test_k3_fields_match_jax(self, ut_cap, all_windows):
        rows, cols, vals, n_out, _ = _stream()
        ref = jk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, ut_cap, all_windows)
        ours = _k3(ut_cap, all_windows)
        assert (ours.n_rows_out, ours.ut_cap) == (ref.n_rows_out, ref.ut_cap)
        for f in K3_FIELDS:
            np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(ref, f)), f)
            assert getattr(ours, f).dtype == np.asarray(getattr(ref, f)).dtype, f


class TestSumsThroughTheIndex:
    @pytest.mark.parametrize("F", [2, 6])
    @pytest.mark.parametrize("sort_cols,all_windows", K1_CASES)
    def test_k1_float64_sums_match_plain(self, sort_cols, all_windows, F):
        p = _k1(sort_cols, all_windows)
        g = _gathered(p, F, F)
        init = None if all_windows else torch.zeros(p.n_rows_out, F)
        _assert_close(_sum_through_index_f64(p, g), _plain(p, torch.from_numpy(g), init))

    @pytest.mark.parametrize("F", [2, 6])
    @pytest.mark.parametrize("ut_cap,all_windows", K3_CASES)
    def test_k3_float64_sums_match_plain(self, ut_cap, all_windows, F):
        p = _k3(ut_cap, all_windows)
        g = _gathered(p, F, F + 1)
        _assert_close(_sum_through_index_f64(p, g), _plain(p, torch.from_numpy(g)))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("use_init", [False, True])
    def test_k1_row_walk_matches_plain(self, use_init, dtype):
        """The kernel's write rule: with an init, windows without a chunk
        keep the init's content (7 here); without, they are 0."""
        p = _k1(True, not use_init, seed=2)
        g = torch.from_numpy(_gathered(p, 6, 3)).to(dtype)
        init = (lambda: torch.full((p.n_rows_out, 6), 7.0)) if use_init else (lambda: None)
        out = _emulate_kernel(p, g, init())
        _assert_close(out, _plain(p, g, init()))
        if use_init:
            assert torch.all(out[384:512] == 7.0)  # window 3 has no entry

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_k3_row_walk_matches_plain(self, dtype):
        p = _k3(4, False, seed=4)
        g = torch.from_numpy(_gathered(p, 6, 5)).to(dtype)
        _assert_close(_emulate_kernel(p, g, None), _plain(p, g))


def _jax_packed(p: tk.PackedSpmm) -> jk.PackedSpmm:
    return jk.PackedSpmm(
        rows=jnp.asarray(p.rows), cols=jnp.asarray(p.cols), vals=jnp.asarray(p.vals),
        window_id=jnp.asarray(p.window_id), is_first=jnp.asarray(p.is_first),
        n_rows_out=p.n_rows_out, chunk=p.chunk, window=p.window,
    )


class TestLaneMajorRowWalk:
    """K2's walk of the same index: (J, F, C) in, (F, n_rows_out) out."""

    @pytest.mark.parametrize("window", [128, 2048])  # 2048: past the old kernel's 1,024 cap
    @pytest.mark.parametrize("use_init", [False, True])
    @pytest.mark.parametrize("F", [1, 6, 128])
    def test_k2_row_walk_matches_plain_and_jax(self, F, use_init, window):
        """With an init of 7s, windows without a chunk keep it, and rows of
        a visited window that have no entry are written 0."""
        rows, cols, vals, n_out, _ = _stream(F)
        p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, window, True, not use_init)
        g = np.random.default_rng(F + 1).standard_normal((p.n_chunks, F, p.chunk)).astype(np.float32)

        def init():
            return torch.full((F, p.n_rows_out), 7.0) if use_init else None

        out = _emulate_kernel(p, torch.from_numpy(g), init(), lane_major=True)
        assert out.shape == (F, p.n_rows_out)
        _assert_close(out, tk.windowed_segment_matmul_t_reference(p, torch.from_numpy(g), init=init()))
        ref = jk.windowed_segment_matmul_t(
            _jax_packed(p), jnp.asarray(g), interpret=True,
            init=jnp.asarray(init().numpy()) if use_init else None,
        )
        _assert_close(out, np.asarray(ref))
        visited = np.repeat(np.diff(p.window_ptr) > 0, p.window)
        empty_row = np.diff(p.row_ptr) == 0
        assert torch.all(out[:, visited & empty_row] == 0)
        if use_init:
            assert (~visited).any() == (window == 128)
            assert torch.all(out[:, ~visited] == 7.0)

    def test_k2_row_walk_is_k1_row_walk_transposed(self):
        """The same sums in the same order, so bit for bit K1's transposed."""
        p = _k1(True, False, seed=3)
        g = torch.from_numpy(_gathered(p, 6, 4))
        k1 = _emulate_kernel(p, g, torch.zeros(p.n_rows_out, 6))
        k2 = _emulate_kernel(p, g.transpose(1, 2).contiguous(), torch.zeros(6, p.n_rows_out),
                             lane_major=True)
        assert torch.equal(k2, k1.T)

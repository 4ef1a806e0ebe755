"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. The file imports no JAX, so it also runs on a
machine with the card and without JAX (tests/conftest.py imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerance 1e-5 · max(1, |reference|): float32 sums taken in another order
(the plain version's index_add_ uses atomics on the card). The bf16 and
fast tiers take the same tolerance: the plain versions round each product
to bf16 as the kernels do, so only the order of the float32 sums differs.

The training loop on the card replays one captured CUDA graph a step; its
cases here hold the rows bitwise against the loop's eager steps on the
same card (same kernels, same order), with the same launch counts.
"""

import numpy as np
import pytest
import torch

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import scan_cuda
from tmgcn_torch.kernels import spmm_cuda as tk
from tmgcn_torch.ops import edge_readout as tro
from tmgcn_torch.ops.spmm import spmm

pytestmark = pytest.mark.cuda

ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _packing(seed, device, sort_cols=True, all_windows=True, F=2):
    """Row-sorted entries with empty windows and a window of many chunks."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([
        rng.integers(0, 300, 1500), rng.integers(640, 700, 750), rng.integers(900, 1000, 750),
    ]))
    cols = rng.integers(0, 700, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    p = tk.pack_windowed_flat(rows, cols, vals, 1000, 64, 128, sort_cols, all_windows)
    return p.to(device)


@pytest.mark.parametrize("F", [1, 2, 6, 128])
@pytest.mark.parametrize("use_init", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain_and_repeats_bitwise(cuda_device, F, use_init, dtype):
    p = _packing(F, cuda_device, all_windows=not use_init)
    g = torch.randn(p.n_chunks, p.chunk, F, device=cuda_device).to(dtype)

    def init():
        return torch.zeros(p.n_rows_out, F, device=cuda_device) if use_init else None

    counter = "launches" if dtype == torch.float32 else "launches_bf16"
    before = getattr(tk.windowed_segment_matmul, counter)
    out = tk.windowed_segment_matmul(p, g, out_dtype=torch.float32, init=init())
    again = tk.windowed_segment_matmul(p, g, out_dtype=torch.float32, init=init())
    torch.cuda.synchronize()
    assert getattr(tk.windowed_segment_matmul, counter) == before + 2
    ref = tk.windowed_segment_matmul_reference(p, g, out_dtype=torch.float32, init=init())
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL * scale)
    assert torch.equal(out, again)


def test_k1_operator_backward(cuda_device):
    rng = np.random.default_rng(0)
    dense = (rng.random((4, 100, 100)) < 0.08) * rng.random((4, 100, 100))
    X = rng.standard_normal((4, 100, 8)).astype(np.float32)
    G = torch.from_numpy(rng.standard_normal((4, 100, 8)).astype(np.float32))
    op = tk.make_operator(TemporalCOO.from_dense(dense, pad_multiple=16), 64, 64)
    Xc = torch.from_numpy(X).to(cuda_device).requires_grad_(True)
    (op.to(cuda_device)(Xc) * G.to(cuda_device)).sum().backward()
    Xh = torch.from_numpy(X).requires_grad_(True)
    (op(Xh) * G).sum().backward()
    torch.testing.assert_close(Xc.grad.cpu(), Xh.grad, rtol=0, atol=ATOL)


def test_k1_rejects_other_tiers(cuda_device):
    """float16 chunks, or a bf16 output, have no kernel."""
    p = _packing(9, cuda_device)
    g = torch.randn(p.n_chunks, p.chunk, 2, device=cuda_device)
    with pytest.raises(NotImplementedError):
        tk.windowed_segment_matmul(p, g.half(), out_dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        tk.windowed_segment_matmul(p, g.to(torch.bfloat16))


def test_spmm_segment_path_is_deterministic_on_the_card(cuda_device):
    """spmm(impl="jnp"): sorted segment_reduce, no atomics, forward and backward."""
    rng = np.random.default_rng(1)
    dense = (rng.random((5, 200, 200)) < 0.05) * rng.standard_normal((5, 200, 200))
    A = TemporalCOO.from_dense(dense, pad_multiple=16)
    X = torch.from_numpy(rng.standard_normal((5, 200, 4)).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((5, 200, 4)).astype(np.float32))

    def run(device):
        Xd = X.to(device).requires_grad_(True)
        out = spmm(A.to(device), Xd)
        (out * G.to(device)).sum().backward()
        return out.detach().cpu(), Xd.grad.cpu()

    out1, g1 = run(cuda_device)
    out2, g2 = run(cuda_device)
    assert torch.equal(out1, out2) and torch.equal(g1, g2)
    out_h, g_h = run("cpu")
    torch.testing.assert_close(out1, out_h, rtol=0, atol=ATOL)
    torch.testing.assert_close(g1, g_h, rtol=0, atol=ATOL)


@pytest.mark.parametrize("F", [1, 2, 6, 128])
@pytest.mark.parametrize("use_init", [False, True])
def test_k2_matches_plain_and_repeats_bitwise(cuda_device, F, use_init):
    p = _packing(20 + F, cuda_device, all_windows=not use_init)
    g = torch.randn(p.n_chunks, F, p.chunk, device=cuda_device)

    def init():
        return torch.zeros(F, p.n_rows_out, device=cuda_device) if use_init else None

    before = tk.windowed_segment_matmul_t.launches
    out = tk.windowed_segment_matmul_t(p, g, init=init())
    again = tk.windowed_segment_matmul_t(p, g, init=init())
    torch.cuda.synchronize()
    assert tk.windowed_segment_matmul_t.launches == before + 2
    ref = tk.windowed_segment_matmul_t_reference(p, g, init=init())
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL * scale)
    assert torch.equal(out, again)
    # The same sums as K1 in the same order: K1's output transposed, bitwise.
    k1_init = torch.zeros(p.n_rows_out, F, device=cuda_device) if use_init else None
    assert torch.equal(out, tk.windowed_segment_matmul(p, g.transpose(1, 2).contiguous(),
                                                       init=k1_init).T)


@pytest.mark.parametrize("lane_major", [False, True])
def test_readout_plan_backward_on_the_card(cuda_device, lane_major):
    """apply_readout through K1 / K2 against the same plan on the CPU."""
    rng = np.random.default_rng(3)
    T, N, E, F = 5, 700, 900, 6
    edges = np.stack([np.sort(rng.integers(0, T, E)), rng.integers(0, N, E), rng.integers(0, N, E)])
    Y = torch.from_numpy(rng.standard_normal((T, N, F)).astype(np.float32))
    U = torch.from_numpy(rng.standard_normal((2 * F, 3)).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((E, 3)).astype(np.float32))
    plan = tro.make_readout_plan(edges, T, N, lane_major=lane_major)

    def run(device):
        Yd = Y.to(device).requires_grad_(True)
        Ud = U.to(device).requires_grad_(True)
        out = tro.apply_readout(plan.to(device), Yd, Ud)
        (out * G.to(device)).sum().backward()
        return out.detach().cpu(), Yd.grad.cpu(), Ud.grad.cpu()

    kernel = tk.windowed_segment_matmul_t if lane_major else tk.windowed_segment_matmul
    before = kernel.launches
    on_card = run(cuda_device)
    assert kernel.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(on_card, run(cuda_device)))
    for a, b in zip(on_card, run("cpu")):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _tiled_packing(seed, device, ut_cap, all_windows=True):
    """Column-crowded entries (repeated tiles), empty windows, ut_cap cuts."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([
        rng.integers(0, 300, 1500), rng.integers(640, 700, 750), rng.integers(900, 1000, 750),
    ]))
    cols = rng.integers(0, 120, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    p = tk.pack_windowed_tiled_flat(rows, cols, vals, 1000, 64, 128, ut_cap, all_windows)
    return p.to(device)


@pytest.mark.parametrize("F", [1, 2, 6, 128])
@pytest.mark.parametrize("ut_cap", [4, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain_and_repeats_bitwise(cuda_device, F, ut_cap, dtype):
    p = _tiled_packing(F + ut_cap, cuda_device, ut_cap, all_windows=ut_cap == 4)
    g = torch.randn(p.n_chunks, 8 * ut_cap, F, device=cuda_device).to(dtype)
    counter = "launches" if dtype == torch.float32 else "launches_bf16"
    before = getattr(tk.windowed_tiled_segment_matmul, counter)
    out = tk.windowed_tiled_segment_matmul(p, g, out_dtype=torch.float32)
    again = tk.windowed_tiled_segment_matmul(p, g, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert getattr(tk.windowed_tiled_segment_matmul, counter) == before + 2
    ref = tk.windowed_tiled_segment_matmul_reference(p, g, out_dtype=torch.float32)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL * scale)
    assert torch.equal(out, again)


@pytest.mark.parametrize("F", [1, 2, 6, 128])
@pytest.mark.parametrize("use_init", [False, True])
def test_k1_fast_matches_plain_and_repeats_bitwise(cuda_device, F, use_init):
    """K1's fast tier (float32 chunks, each product rounded to bf16): its own
    launch count, its plain version, a bitwise repeat, and not the float32 tier."""
    p = _packing(40 + F, cuda_device, all_windows=not use_init)
    g = torch.randn(p.n_chunks, p.chunk, F, device=cuda_device)

    def init():
        return torch.zeros(p.n_rows_out, F, device=cuda_device) if use_init else None

    k1 = tk.windowed_segment_matmul
    before = (k1.launches, k1.launches_fast)
    out = k1(p, g, out_dtype=torch.float32, init=init(), fast=True)
    again = k1(p, g, out_dtype=torch.float32, init=init(), fast=True)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_fast) == (before[0], before[1] + 2)
    ref = tk.windowed_segment_matmul_reference(p, g, out_dtype=torch.float32, init=init(),
                                               fast=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL * max(1.0, ref.abs().max().item()))
    assert torch.equal(out, again)
    assert not torch.equal(out, k1(p, g, out_dtype=torch.float32, init=init()))


@pytest.mark.parametrize("F", [1, 2, 6, 128])
@pytest.mark.parametrize("ut_cap", [4, 64])
def test_k3_fast_matches_plain_and_is_the_bf16_tier(cuda_device, F, ut_cap):
    """K3's fast tier: its own launch count, its plain version, a bitwise
    repeat, and bit for bit the bf16 tier on the blocks cast to bf16."""
    p = _tiled_packing(50 + F + ut_cap, cuda_device, ut_cap, all_windows=ut_cap == 4)
    g = torch.randn(p.n_chunks, 8 * ut_cap, F, device=cuda_device)
    k3 = tk.windowed_tiled_segment_matmul
    before = (k3.launches, k3.launches_bf16, k3.launches_fast)
    out = k3(p, g, out_dtype=torch.float32, fast=True)
    again = k3(p, g, out_dtype=torch.float32, fast=True)
    torch.cuda.synchronize()
    assert (k3.launches, k3.launches_bf16, k3.launches_fast) == (*before[:2], before[2] + 2)
    ref = tk.windowed_tiled_segment_matmul_reference(p, g, out_dtype=torch.float32, fast=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL * max(1.0, ref.abs().max().item()))
    assert torch.equal(out, again)
    assert torch.equal(out, k3(p, g.to(torch.bfloat16), out_dtype=torch.float32))


@pytest.mark.parametrize("kwargs,counter", [
    ({}, "launches_fast"),
    ({"tile_dedup": True, "chunk": 512}, "launches_fast"),
    ({"gather_dtype": "bfloat16", "sort_cols": True}, "launches_bf16"),
])
def test_fast_operator_backward_on_the_card(cuda_device, kwargs, counter):
    """make_operator(fast=True) forward and autograd backward against the CPU's
    plain path, bitwise repeatable; one launch of the tier each way (with bf16
    gathers, the bf16 tier's)."""
    rng = np.random.default_rng(8)
    dense = (rng.random((4, 300, 300)) < 0.05) * rng.random((4, 300, 300))
    X = torch.from_numpy(rng.standard_normal((4, 300, 6)).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((4, 300, 6)).astype(np.float32))
    op = tk.make_operator(TemporalCOO.from_dense(dense, pad_multiple=16), window=256, fast=True,
                          **kwargs)
    kernel = tk.windowed_tiled_segment_matmul if "tile_dedup" in kwargs else tk.windowed_segment_matmul

    def run(device):
        Xd = X.to(device).requires_grad_(True)
        out = op.to(device)(Xd)
        (out * G.to(device)).sum().backward()
        return out.detach().cpu(), Xd.grad.cpu()

    before = getattr(kernel, counter)
    on_card = run(cuda_device)
    assert getattr(kernel, counter) == before + 2
    assert all(torch.equal(a, b) for a, b in zip(on_card, run(cuda_device)))
    for a, b in zip(on_card, run("cpu")):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL * max(1.0, b.abs().max().item()))


# Regimes of the row walk of K1 and K3 (three threads a row) and K2 (one), at F = 6.
REGIMES = ("few_windows_many_chunks", "long_row", "padding_window")


def _regime_stream(regime):
    """Row-sorted entries over 2,048 rows (windows of 256) and 3,000 columns.

    few_windows_many_chunks: 8 windows of ~40 chunks of 64 each (the
    restricted layer-2 forward's regime); long_row: row 517 has 400 entries
    among short rows; padding_window: windows 2-5 have no entry, so an
    all-windows packing gives each of them one chunk of pure padding.
    """
    rng = np.random.default_rng(REGIMES.index(regime))
    if regime == "few_windows_many_chunks":
        rows = rng.integers(0, 2048, 20_000)
    elif regime == "long_row":
        rows = np.r_[rng.integers(0, 2048, 3000), np.full(400, 517)]
    else:
        rows = np.r_[rng.integers(0, 512, 2000), rng.integers(1536, 2048, 1000)]
    rows = np.sort(rows)
    cols = rng.integers(0, 3000, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("use_init", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_row_walk_regimes(cuda_device, regime, use_init, dtype):
    """K1 at F = 6 against its plain version, one launch a call, bitwise
    repeat; with an init (7s, so the write rule shows) windows without a
    chunk keep it, and a window whose only chunk is padding is written 0."""
    rows, cols, vals = _regime_stream(regime)
    all_windows = regime == "padding_window" or not use_init
    p = tk.pack_windowed_flat(rows, cols, vals, 2048, 64, 256, True, all_windows).to(cuda_device)
    g = torch.randn(p.n_chunks, p.chunk, 6, device=cuda_device).to(dtype)

    def init():
        return torch.full((p.n_rows_out, 6), 7.0, device=cuda_device) if use_init else None

    counter = "launches" if dtype == torch.float32 else "launches_bf16"
    before = getattr(tk.windowed_segment_matmul, counter)
    out = tk.windowed_segment_matmul(p, g, out_dtype=torch.float32, init=init())
    again = tk.windowed_segment_matmul(p, g, out_dtype=torch.float32, init=init())
    torch.cuda.synchronize()
    assert getattr(tk.windowed_segment_matmul, counter) == before + 2
    ref = tk.windowed_segment_matmul_reference(p, g, out_dtype=torch.float32, init=init())
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL * max(1.0, ref.abs().max().item()))
    assert torch.equal(out, again)
    if regime == "padding_window":
        assert torch.all(out[512:1536] == 0)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("use_init", [False, True])
@pytest.mark.parametrize("window", [256, 2048])
def test_k2_row_walk_regimes(cuda_device, regime, use_init, window):
    """K2 at F = 6 (one group of six features a thread) against its plain
    version, one launch a call, bitwise repeat, and bit for bit K1's output
    transposed; windows of 256 rows and of 2,048 (past the first CUDA K2's
    1,024-row cap); with an init of 7s, windows without a chunk keep it."""
    rows, cols, vals = _regime_stream(regime)
    all_windows = regime == "padding_window" or not use_init
    p = tk.pack_windowed_flat(rows, cols, vals, 2048, 64, window, True, all_windows).to(cuda_device)
    g = torch.randn(p.n_chunks, 6, p.chunk, device=cuda_device)

    def init(shape):
        return torch.full(shape, 7.0, device=cuda_device) if use_init else None

    before = tk.windowed_segment_matmul_t.launches
    out = tk.windowed_segment_matmul_t(p, g, init=init((6, p.n_rows_out)))
    again = tk.windowed_segment_matmul_t(p, g, init=init((6, p.n_rows_out)))
    torch.cuda.synchronize()
    assert tk.windowed_segment_matmul_t.launches == before + 2
    ref = tk.windowed_segment_matmul_t_reference(p, g, init=init((6, p.n_rows_out)))
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL * max(1.0, ref.abs().max().item()))
    assert torch.equal(out, again)
    k1 = tk.windowed_segment_matmul(p, g.transpose(1, 2).contiguous(), init=init((p.n_rows_out, 6)))
    assert torch.equal(out, k1.T)
    if regime == "padding_window":  # rows without entries in windows that own a chunk
        assert torch.all(out[:, 512:1536] == 0)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_row_walk_regimes(cuda_device, regime, dtype):
    """K3 at F = 6 against its plain version, one launch a call, bitwise repeat."""
    rows, cols, vals = _regime_stream(regime)
    p = tk.pack_windowed_tiled_flat(rows, cols, vals, 2048, 64, 256, 8).to(cuda_device)
    g = torch.randn(p.n_chunks, 8 * p.ut_cap, 6, device=cuda_device).to(dtype)
    counter = "launches" if dtype == torch.float32 else "launches_bf16"
    before = getattr(tk.windowed_tiled_segment_matmul, counter)
    out = tk.windowed_tiled_segment_matmul(p, g, out_dtype=torch.float32)
    again = tk.windowed_tiled_segment_matmul(p, g, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert getattr(tk.windowed_tiled_segment_matmul, counter) == before + 2
    ref = tk.windowed_tiled_segment_matmul_reference(p, g, out_dtype=torch.float32)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL * max(1.0, ref.abs().max().item()))
    assert torch.equal(out, again)


@pytest.mark.parametrize("kwargs", [
    {"gather_dtype": "bfloat16", "sort_cols": True, "chunk": 512},
    {"tile_dedup": True, "chunk": 512},
    {"tile_dedup": True, "ut_cap": 4, "gather_dtype": "bfloat16"},
])
def test_operator_tiers_backward_on_the_card(cuda_device, kwargs):
    """K1 bf16 and K3 forward and autograd backward against the CPU's plain path."""
    rng = np.random.default_rng(4)
    dense = (rng.random((4, 300, 300)) < 0.05) * rng.random((4, 300, 300))
    X = torch.from_numpy(rng.standard_normal((4, 300, 6)).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((4, 300, 6)).astype(np.float32))
    op = tk.make_operator(TemporalCOO.from_dense(dense, pad_multiple=16), window=256, **kwargs)

    def run(device):
        Xd = X.to(device).requires_grad_(True)
        out = op.to(device)(Xd)
        (out * G.to(device)).sum().backward()
        return out.detach().cpu(), Xd.grad.cpu()

    on_card = run(cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(on_card, run(cuda_device)))
    for a, b in zip(on_card, run("cpu")):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL * max(1.0, b.abs().max().item()))


@pytest.mark.parametrize("operator", ["pallas", "pallas_bf16", "blockdense", "blockdense_bf16"])
def test_restricted_layer2_on_the_card(cuda_device, operator):
    """The restricted 2-layer adapter: logits and gradients against the CPU, repeatable."""
    from tmgcn_torch.core.mmatrix import make_m_matrix
    from tmgcn_torch.models.tmgcn import TMGCN2
    from tmgcn_torch.tasks.adapters import make_edge_adapter

    rng = np.random.default_rng(6)
    T, N, E = 6, 500, 800
    dense = (rng.random((T, N, N)) < 0.02) * rng.random((T, N, N))
    adj = {w: TemporalCOO.from_dense(dense, pad_multiple=16) for w in ("train", "val", "test")}
    feats = {w: rng.standard_normal((T, N, 2)) for w in adj}
    edges = {w: np.stack([rng.integers(0, T, E), rng.integers(0, N, E), rng.integers(0, N, E)])
             for w in adj}
    M = make_m_matrix(T, 3)
    model = TMGCN2(n_slices=T, in_feat=2, hidden_feat=(6, 6, 3), nonlin2="selu",
                   spmm_impl=operator)
    params = model.init(torch.Generator().manual_seed(0))["params"]
    G = torch.from_numpy(rng.standard_normal((E, 3)).astype(np.float32))

    def run(device):
        ad = make_edge_adapter(model, adj, feats, edges, M=M, device=device)
        p = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
        out, _ = ad.apply({"params": p, "buffers": {}}, ad.bundles["train"], ())
        (out * G.to(device)).sum().backward()
        return [out.detach().cpu()] + [p[k].grad.cpu() for k in sorted(p)]

    on_card = run(cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(on_card, run(cuda_device)))
    rel = 3e-2 if operator == "blockdense_bf16" else 2e-2 if operator == "pallas_bf16" else 1e-5
    for a, b in zip(on_card, run("cpu")):
        torch.testing.assert_close(a, b, rtol=0, atol=rel * max(1.0, b.abs().max().item()))


# (family, spmm_impl, K1 launches in 4 epochs: the cached propagation of 3
# distinct windows, or the readout plan's backward once per training step)
LP_CASES = {"tmgcn1_pallas": ("tmgcn", "pallas", 3), "wdgcn_jnp": ("wdgcn", "jnp", 4),
            "tmgcn2_pallas": ("tmgcn2", "pallas", 3 + 2 * 4 + 4),
            "evolvegcn1": ("evolvegcn", "jnp", 0),
            "evolvegcn1_generic": ("evolvegcn_generic", "jnp", 4)}


def _lp_problem(family: str, impl: str):
    """(model, M, adj, feats, model edges, splits) of a small link-prediction
    task: 12 slices of 300 nodes, windows of 8/2/2 slices."""
    from tmgcn_torch.core.mmatrix import make_m_matrix
    from tmgcn_torch.models.tmgcn import TMGCN, TMGCN2
    from tmgcn_torch.models.wdgcn import WDGCN
    from tmgcn_torch.tasks.sampling import augment_edges
    from tmgcn_torch.tasks.windows import WindowSpec, split_data_link_prediction

    rng = np.random.default_rng(7)
    T_all, N, E = 12, 300, 2400
    spec = WindowSpec(8, 2, 2, same_block_size=family in ("tmgcn", "tmgcn2"))
    dense = (rng.random((T_all, N, N)) < 0.03) * rng.random((T_all, N, N))
    X = rng.standard_normal((T_all, N, 2)).astype(np.float32)
    real = np.stack([np.sort(rng.integers(0, T_all, E)), rng.integers(0, N, E),
                     rng.integers(0, N, E)])
    splits = split_data_link_prediction(*augment_edges(real, N, 4, 4, 12, seed=1), spec)
    windows = {w: spec.bounds(w) for w in ("train", "val", "test")}
    adj = {w: TemporalCOO.from_dense(dense[a:b], pad_multiple=16) for w, (a, b) in windows.items()}
    feats = {w: X[a:b] for w, (a, b) in windows.items()}
    edges = {w: splits[w].model_edges for w in windows}
    kw = dict(n_slices=7, in_feat=2, spmm_impl=impl)
    M = None
    if family == "wdgcn":
        model = WDGCN(hidden_feat=(6, 2), **kw)
    elif family.startswith("evolvegcn"):
        model = _evolvegcn(family, 7, (6, 2))
    elif family == "tmgcn":
        model, M = TMGCN(hidden_feat=(6, 2), **kw), make_m_matrix(8, 3)
    else:
        model, M = TMGCN2(hidden_feat=(6, 6, 2), nonlin2="selu", **kw), make_m_matrix(8, 3)
    return model, M, adj, feats, edges, splits


@pytest.mark.parametrize("case", sorted(LP_CASES))
def test_link_prediction_on_the_card(cuda_device, case, monkeypatch):
    """run_link_prediction on the card against the CPU's plain path: K1 as
    often as the path needs, the same (epochs, 9) rows (losses rtol 1e-4,
    MAP and MRR rtol 1e-3), a repeated run bitwise equal."""
    from tmgcn_torch.tasks.adapters import make_edge_adapter
    from tmgcn_torch.train.loop import TrainConfig, run_link_prediction

    family, impl, k1_launches = LP_CASES[case]
    model, M, adj, feats, edges, splits = _lp_problem(family, impl)
    _generic_path(family, monkeypatch)
    variables = model.init(torch.Generator().manual_seed(0))
    cfg = TrainConfig(n_epochs=4, eval_every=3)

    def run(device):
        ad = make_edge_adapter(model, adj, feats, edges, M=M, drop_last_slice=True,
                               device=device)
        res, _ = run_link_prediction(ad, splits, np.array([0.9, 0.1]), cfg, variables=variables)
        return res

    before = tk.windowed_segment_matmul.launches
    on_card = run(cuda_device)
    assert tk.windowed_segment_matmul.launches - before == k1_launches
    assert on_card.shape == (4, 9)
    np.testing.assert_array_equal(run(cuda_device), on_card)
    ref = run("cpu")
    np.testing.assert_allclose(on_card[:, [2, 5, 8]], ref[:, [2, 5, 8]], rtol=1e-4)
    rates = [0, 1, 3, 4, 6, 7]
    np.testing.assert_array_equal(np.isnan(on_card[:, rates]), np.isnan(ref[:, rates]))
    np.testing.assert_allclose(on_card[:, rates], ref[:, rates], rtol=1e-3)


# Every kernel tier's launch count, (wrapper, counter).
COUNTERS = [(w, c) for w in (tk.windowed_segment_matmul, tk.windowed_tiled_segment_matmul)
            for c in ("launches", "launches_bf16", "launches_fast")]
COUNTERS.append((tk.windowed_segment_matmul_t, "launches"))
# The LSTM scan's kernel pair: forward, backward, the backward's reduction.
SCAN_COUNTERS = [(scan_cuda.lstm_scan_cuda, c)
                 for c in ("launches", "launches_backward", "launches_reduce")]


def _launches() -> list[int]:
    return [getattr(w, c) for w, c in COUNTERS]


def _evolvegcn(family: str, n_slices: int, hidden: tuple):
    """EvolveGCN-H (a "_generic" family: see ``_generic_path``)."""
    from tmgcn_torch.models.evolvegcn import EvolveGCN

    return EvolveGCN(n_slices=n_slices, in_feat=2, hidden_feat=hidden)


def _generic_path(family: str, monkeypatch) -> None:
    """A "_generic" EvolveGCN family runs the adapter's generic staged path
    (the readout plan's K1 backward; at 2 layers spmm "jnp" every step): the
    one-hot budgets set to 0 route it there at this size."""
    from tmgcn_torch.tasks import adapters

    if family.endswith("_generic"):
        monkeypatch.setattr(adapters, "ONEHOT_BUDGET_1LAYER", 0)
        monkeypatch.setattr(adapters, "ONEHOT_BUDGET_RESTRICTED", 0)


def _cls_problem(family: str, impl: str):
    """(model, M, adj, feats, edges, splits) of a small 3-class edge task:
    6 slices of 400 nodes, one graph for the three windows."""
    import types

    from tmgcn_torch.core.mmatrix import make_m_matrix
    from tmgcn_torch.models.gcn import KWGCN
    from tmgcn_torch.models.tmgcn import TMGCN, TMGCN2
    from tmgcn_torch.models.wdgcn import WDGCN

    rng = np.random.default_rng(9)
    T, N, E = 6, 400, 600
    dense = (rng.random((T, N, N)) < 0.02) * rng.random((T, N, N))
    adj = {w: TemporalCOO.from_dense(dense, pad_multiple=16) for w in ("train", "val", "test")}
    feats = {w: rng.standard_normal((T, N, 2)).astype(np.float32) for w in adj}
    splits = {w: types.SimpleNamespace(
        edges=np.stack([np.sort(rng.integers(0, T, E)), rng.integers(0, N, E),
                        rng.integers(0, N, E)]),
        target=rng.integers(0, 3, E), eval_mask=np.ones(E, bool)) for w in adj}
    edges = {w: s.edges for w, s in splits.items()}
    kw = dict(n_slices=T, in_feat=2, spmm_impl=impl)
    if family == "wdgcn":
        return WDGCN(hidden_feat=(6, 3), **kw), None, adj, feats, edges, splits
    if family == "gcn2":
        return (KWGCN(hidden_feat=(6, 6, 3), nonlin2="selu", **kw), None, adj, feats, edges,
                splits)
    if family.startswith("evolvegcn"):
        hidden = (6, 6, 3) if family.startswith("evolvegcn2") else (6, 3)
        return _evolvegcn(family, T, hidden), None, adj, feats, edges, splits
    if family == "tmgcn":
        return TMGCN(hidden_feat=(6, 3), **kw), make_m_matrix(T, 3), adj, feats, edges, splits
    if family == "tmgcn_generic":  # per-slice W and M⁻¹: the generic 1-layer path
        return (TMGCN(hidden_feat=(6, 3), condensed_W=False, use_Minv=True, **kw),
                make_m_matrix(T, 3), adj, feats, edges, splits)
    return (TMGCN2(hidden_feat=(6, 6, 3), nonlin2="selu", **kw), make_m_matrix(T, 3), adj,
            feats, edges, splits)


# (task, family, spmm_impl)
CAPTURE_CASES = {
    "cls_tmgcn1_pallas": ("cls", "tmgcn", "pallas"),
    "cls_tmgcn1_generic_pallas": ("cls", "tmgcn_generic", "pallas"),
    "cls_tmgcn2_pallas": ("cls", "tmgcn2", "pallas"),
    "cls_wdgcn_jnp": ("cls", "wdgcn", "jnp"),
    "lp_wdgcn_jnp": ("lp", "wdgcn", "jnp"),
    "cls_gcn2_pallas": ("cls", "gcn2", "pallas"),
    "cls_evolvegcn1": ("cls", "evolvegcn", "jnp"),
    "cls_evolvegcn2": ("cls", "evolvegcn2", "jnp"),
    "cls_evolvegcn2_generic": ("cls", "evolvegcn2_generic", "jnp"),
    "cls_evolvegcn1_generic": ("cls", "evolvegcn_generic", "jnp"),
    "lp_evolvegcn1_generic": ("lp", "evolvegcn_generic", "jnp"),
}


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_captured_rows_match_eager(cuda_device, case, optimizer, monkeypatch):
    """7 epochs, eval_every 3, on the card: the loop as it runs (each step a
    replay of one captured graph) against its eager chunks — the rows
    bitwise equal, every kernel tier launched as often. Adam with
    grad_clip=1.0 reads its step count from the device."""
    from tmgcn_torch.tasks.adapters import make_edge_adapter
    from tmgcn_torch.train import loop

    task, family, impl = CAPTURE_CASES[case]
    problem = _lp_problem if task == "lp" else _cls_problem
    model, M, adj, feats, edges, splits = problem(family, impl)
    _generic_path(family, monkeypatch)
    variables = model.init(torch.Generator().manual_seed(0))
    opt = {"optimizer": "adam", "grad_clip": 1.0} if optimizer == "adam" else {}
    cfg = loop.TrainConfig(n_epochs=7, eval_every=3, **opt)

    def run():
        ad = make_edge_adapter(model, adj, feats, edges, M=M, drop_last_slice=task == "lp",
                               device=cuda_device)
        before = _launches()
        if task == "lp":
            res, _ = loop.run_link_prediction(ad, splits, np.array([0.9, 0.1]), cfg,
                                              variables=variables)
        else:
            res, _ = loop.run_edge_classification(ad, splits, np.array([0.2, 0.5, 0.3]), cfg,
                                                  variables=variables)
        return res, [a - b for a, b in zip(_launches(), before)]

    captured, n_captured = run()
    monkeypatch.setattr(loop, "_chunks", loop._EagerChunks)
    eager, n_eager = run()
    assert captured.shape[0] == 7 and np.all(np.isfinite(captured[:, 3 if task == "cls" else 2]))
    np.testing.assert_array_equal(captured, eager)
    assert n_captured == n_eager


# (task, family, layer-2 impl) of the sharded adapter on the one-card mesh.
MESH_CASES = {
    "cls_tmgcn1": ("cls", "tmgcn", "auto"),
    "cls_tmgcn2_gather": ("cls", "tmgcn2", "gather"),
    "cls_tmgcn2_blockdense": ("cls", "tmgcn2", "blockdense"),
    "cls_gcn2": ("cls", "gcn2", "auto"),
    "lp_tmgcn1": ("lp", "tmgcn", "auto"),
    # The recurrent families over graph (phase 7q of chip_smoke.py).
    "cls_wdgcn": ("cls", "wdgcn", "auto"),
    "cls_evolvegcn1": ("cls", "evolvegcn", "auto"),
    "cls_evolvegcn2": ("cls", "evolvegcn2", "auto"),
    "lp_evolvegcn1": ("lp", "evolvegcn", "auto"),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_one_by_one_on_the_card(cuda_device, case, monkeypatch):
    """The sharded adapter on the 1 x 1 mesh over NCCL (the one mesh one
    card allows): 7 epochs, eval_every 3, the loop's captured steps (the
    collectives inside both graphs) bitwise its eager ones, no kernel of
    ours launched, and the losses within rtol 1e-4 of the unsharded run's."""
    from tmgcn_torch.parallel import distributed
    from tmgcn_torch.parallel.adapter import make_sharded_edge_adapter
    from tmgcn_torch.parallel.mesh import make_mesh
    from tmgcn_torch.tasks.adapters import make_edge_adapter
    from tmgcn_torch.train import loop

    task, family, l2_impl = MESH_CASES[case]
    model, M, adj, feats, edges, splits = (_lp_problem if task == "lp" else _cls_problem)(
        family, "jnp")
    mesh = make_mesh(1, 1, device=distributed.initialize("cuda"))
    variables = model.init(torch.Generator().manual_seed(0))
    cfg = loop.TrainConfig(n_epochs=7, eval_every=3)
    lp = task == "lp"

    def run(adapter):
        before = _launches()
        if lp:
            res, _ = loop.run_link_prediction(adapter, splits, np.array([0.9, 0.1]), cfg,
                                              variables=variables)
        else:
            res, _ = loop.run_edge_classification(adapter, splits, np.array([0.2, 0.5, 0.3]),
                                                  cfg, variables=variables)
        return res, [a - b for a, b in zip(_launches(), before)]

    sharded = make_sharded_edge_adapter(model, adj, feats, edges, M, mesh,
                                        drop_last_slice=lp, l2_impl=l2_impl)
    captured, n_captured = run(sharded)
    plain, _ = run(make_edge_adapter(model, adj, feats, edges, M=M, drop_last_slice=lp,
                                     device=cuda_device))
    monkeypatch.setattr(loop, "_chunks", loop._EagerChunks)
    eager, n_eager = run(sharded)
    np.testing.assert_array_equal(captured, eager)
    assert n_captured == n_eager == [0] * len(COUNTERS)
    loss = 2 if lp else 3
    np.testing.assert_allclose(captured[:, loss], plain[:, loss], rtol=1e-4)


def test_chunks_replay_one_captured_step(cuda_device):
    """On the card a chunk is the warm-up step, the capture, then replays:
    K1 counts its launches as they run (2 a step in the restricted 2-layer
    TM-GCN: layer 2 forward and backward), none for the capture."""
    from tmgcn_torch.tasks.adapters import make_edge_adapter
    from tmgcn_torch.train import loop

    model, M, adj, feats, edges, splits = _cls_problem("tmgcn2", "pallas")
    ad = make_edge_adapter(model, adj, feats, edges, M=M, device=cuda_device)
    chunks, _, _ = loop.train_chunks(ad, splits["train"], np.ones(3) / 3, loop.TrainConfig(),
                                     capacity=8)
    assert type(chunks) is loop._CapturedChunks and chunks.graph is None
    before = tk.windowed_segment_matmul.launches
    chunks(1)
    assert chunks.graph is not None and tk.windowed_segment_matmul.launches - before == 2
    assert len(chunks.launches.launches) == 2
    chunks(3)
    assert tk.windowed_segment_matmul.launches - before == 8
    stats = chunks.stats(4).cpu()
    assert stats.shape == (4, 4) and torch.isfinite(stats).all()
    assert len(torch.unique(stats[:, 0])) == 4  # four steps, four losses


@pytest.mark.parametrize("family", ["tmgcn2", "wdgcn"])
def test_phase_events_time_the_captured_step(cuda_device, family):
    """``phase_events``: four timing events in the captured step read the
    last replay's forward, backward and update; the graph's steps are the
    steps without them (losses bitwise); with the recorder on, the capture
    and each chunk of replays are one span."""
    from tmgcn_torch.tasks.adapters import make_edge_adapter
    from tmgcn_torch.train import loop
    from tmgcn_torch.utils import profiling

    model, M, adj, feats, edges, splits = _cls_problem(family, "pallas")
    ad = make_edge_adapter(model, adj, feats, edges, M=M, device=cuda_device)

    def losses(phase_events):
        ch, _, _ = loop.train_chunks(ad, splits["train"], np.ones(3) / 3, loop.TrainConfig(),
                                     capacity=8, phase_events=phase_events)
        with profiling.recording():
            ch(1)
            ch(3)
        torch.cuda.synchronize()
        return ch, ch.stats(4)[:, 0].cpu().numpy()

    plain, want = losses(False)
    with pytest.raises(ValueError, match="phase"):
        plain.phase_ms()
    timed, got = losses(True)
    np.testing.assert_array_equal(got, want)
    names = [(r["name"], r["attrs"].get("n")) for r in profiling.records()]
    assert names == [("loop.capture", None), ("loop.steps", 3)]
    ms = timed.phase_ms()
    assert set(ms) == {"forward", "backward", "update"}
    assert all(0 < v < 1e3 for v in ms.values())


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_resumed_captured_run_matches_uninterrupted(cuda_device, optimizer, tmp_path):
    """8 epochs, eval_every 3, on the card; then 4 epochs that save and a
    resume to 8 (its evaluation epochs shifted by one): the resumed run's
    train columns (precision, recall, F1, loss) are bitwise the
    uninterrupted run's, each run's steps replays of its captured graph."""
    from tmgcn_torch.tasks.adapters import make_edge_adapter
    from tmgcn_torch.train import loop
    from tmgcn_torch.train.checkpoint import RunCheckpointer

    model, M, adj, feats, edges, splits = _cls_problem("tmgcn2", "pallas")
    ad = make_edge_adapter(model, adj, feats, edges, M=M, device=cuda_device)
    variables = model.init(torch.Generator().manual_seed(0))
    opt = {"optimizer": "adam", "grad_clip": 1.0} if optimizer == "adam" else {}
    cw = np.array([0.2, 0.5, 0.3])

    def run(n, ck=None):
        cfg = loop.TrainConfig(n_epochs=n, eval_every=3, **opt)
        return loop.run_edge_classification(ad, splits, cw, cfg, variables=variables,
                                            checkpointer=ck)[0]

    full = run(8)
    ck = RunCheckpointer(tmp_path / "run")
    run(4, ck)
    assert ck.latest_epoch() == 3
    resumed = run(8, ck)
    assert ck.latest_epoch() == 7
    np.testing.assert_array_equal(resumed[:, :4], full[:, :4])
    np.testing.assert_array_equal(resumed[:4], full[:4])


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_restore_into_a_captured_step(cuda_device, optimizer, tmp_path):
    """A checkpoint restored into a step that is already captured: the
    params and the optimizer state are copied into the graph's own
    tensors (every data_ptr unchanged), and the replays that follow repeat
    the steps taken after the save, bitwise."""
    from tmgcn_torch.tasks.adapters import make_edge_adapter
    from tmgcn_torch.train import loop
    from tmgcn_torch.train.checkpoint import RunCheckpointer

    model, M, adj, feats, edges, splits = _cls_problem("tmgcn2", "pallas")
    ad = make_edge_adapter(model, adj, feats, edges, M=M, device=cuda_device)
    opt = {"optimizer": "adam", "grad_clip": 1.0} if optimizer == "adam" else {}
    cfg = loop.TrainConfig(**opt)
    chunks, _, variables = loop.train_chunks(ad, splits["train"], np.ones(3) / 3, cfg,
                                             capacity=8)
    assert type(chunks) is loop._CapturedChunks
    chunks(3)
    step_opt = chunks.step.opt
    tensors = [*loop._tree_leaves(variables["params"]), *step_opt.mu, *step_opt.nu]
    tensors += [step_opt.count] if step_opt.count is not None else []
    ptrs = [t.data_ptr() for t in tensors]
    ck = RunCheckpointer(tmp_path / "run")
    loop._save(ck, 2, chunks, np.zeros((3, 12)))
    chunks(2)
    after_save = chunks.stats(2).cpu()
    assert loop._restore(ck, variables["params"], step_opt)[0] == 2
    assert [t.data_ptr() for t in tensors] == ptrs
    chunks(2)
    assert torch.equal(chunks.stats(2).cpu(), after_save)


@pytest.mark.parametrize("impl,counter", [("pallas", "launches"),
                                          ("pallas_bf16", "launches_bf16")])
def test_streamed_layer2_on_the_card(cuda_device, impl, counter, monkeypatch):
    """The streamed restricted layer 2, 4 groups of 2 slices over 6 (the
    fourth has no slice and launches nothing): logits and gradients against
    the CPU and against the single operator on the card; one captured step
    launches K1 forward and backward in each of the 3 other groups; 7 epochs
    (eval_every 3) captured bitwise the eager loop's, K1 launched alike."""
    from tmgcn_torch.tasks.adapters import make_edge_adapter
    from tmgcn_torch.train import loop

    model, M, adj, feats, edges, splits = _cls_problem("tmgcn2", impl)
    variables = model.init(torch.Generator().manual_seed(0))
    G = torch.from_numpy(np.random.default_rng(3).standard_normal((600, 3)).astype(np.float32))

    def logits_and_grads(device, stream=4):
        ad = make_edge_adapter(model, adj, feats, edges, M=M, device=device,
                               l2_stream_chunks=stream)
        p = {k: v.detach().clone().to(device).requires_grad_(True)
             for k, v in variables["params"].items()}
        out, _ = ad.apply({"params": p, "buffers": {}}, ad.bundles["train"], ())
        (out * G.to(device)).sum().backward()
        return [out.detach().cpu()] + [p[k].grad.cpu() for k in sorted(p)]

    on_card = logits_and_grads(cuda_device)
    rel = 2e-2 if impl == "pallas_bf16" else 1e-5
    for ref in (logits_and_grads("cpu"), logits_and_grads(cuda_device, stream=None)):
        for a, b in zip(on_card, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=rel * max(1.0, b.abs().max().item()))

    ad = make_edge_adapter(model, adj, feats, edges, M=M, device=cuda_device, l2_stream_chunks=4)
    assert [op.packed.entry_order.shape[0] > 0 for op in ad.bundles["train"]["l2s_op"]] == \
        [True, True, True, False]
    chunks, _, _ = loop.train_chunks(ad, splits["train"], np.ones(3) / 3, loop.TrainConfig(),
                                     capacity=8)
    assert type(chunks) is loop._CapturedChunks
    before = getattr(tk.windowed_segment_matmul, counter)
    chunks(1)
    assert getattr(tk.windowed_segment_matmul, counter) - before == 6
    chunks(3)
    assert getattr(tk.windowed_segment_matmul, counter) - before == 24

    cw = np.array([0.2, 0.5, 0.3])

    def run():
        ad = make_edge_adapter(model, adj, feats, edges, M=M, device=cuda_device,
                               l2_stream_chunks=4)
        before = _launches()
        res, _ = loop.run_edge_classification(ad, splits, cw,
                                              loop.TrainConfig(n_epochs=7, eval_every=3),
                                              variables=variables)
        return res, [a - b for a, b in zip(_launches(), before)]

    captured, n_captured = run()
    monkeypatch.setattr(loop, "_chunks", loop._EagerChunks)
    eager, n_eager = run()
    np.testing.assert_array_equal(captured, eager)
    assert n_captured == n_eager
    # 2 a step and 1 a forward of val or test at 3 evaluations, in each of
    # the 3 groups with entries (the cached propagations ran in the build).
    assert n_captured[COUNTERS.index((tk.windowed_segment_matmul, counter))] == 3 * (
        2 * 7 + 2 * 3)


def test_a_host_sync_in_the_step_raises(cuda_device):
    """A step that reads the card from the host fails loudly, naming the
    operation, before anything is captured; nothing falls back."""
    from tmgcn_torch.train import loop

    x = torch.ones(4, device=cuda_device)

    def step():
        return x.sum().item()

    step.device = cuda_device
    chunks = loop._CapturedChunks(step)
    with pytest.raises(RuntimeError, match="synchroniz"):
        chunks(2)
    assert chunks.graph is None


def _synthetic_runs(cuda_device, cfg, n_epochs, monkeypatch):
    """run_experiment of a SEIR or SBM config on the card, captured, then
    with the loop's eager chunks: (captured result, eager result, K1
    launches of each)."""
    from tmgcn_torch.configs import build
    from tmgcn_torch.train import loop

    def run():
        before = tk.windowed_segment_matmul.launches
        out = build.run_experiment(cfg, n_epochs=n_epochs, verbose=False, device=cuda_device)
        (res,) = out["results"].values()
        return res, tk.windowed_segment_matmul.launches - before

    captured, n_captured = run()
    with monkeypatch.context() as m:
        m.setattr(loop, "_chunks", loop._EagerChunks)
        eager, n_eager = run()
    return captured, eager, n_captured, n_eager


# K1 launches of each regression preset in 7 epochs: TM-GCN's cached
# propagation of the three windows; EvolveGCN none (the plain spmm); WD-GCN
# its propagation once a step and once for each of val and test.
REGRESSION_K1 = {"seir_tmgcn_reg_tuned": 3, "seir_evolvegcn_reg_tuned": 0,
                 "seir_wdgcn_reg_tuned": 7 + 2}


@pytest.mark.parametrize("preset", sorted(REGRESSION_K1))
def test_regression_captured_matches_eager(cuda_device, preset, monkeypatch):
    """A _tuned SEIR preset at 60 nodes x 20 slices, 7 epochs in chunks of
    3, spmm_impl "pallas": the captured loop's losses and val/test L1 bitwise
    the eager loop's, K1 launched as reckoned in both."""
    import dataclasses

    from tmgcn_torch.configs.presets import get_preset

    cfg = dataclasses.replace(get_preset(preset), seir_n_nodes=60, seir_n_slices=20,
                              eval_every=3)
    captured, eager, n_captured, n_eager = _synthetic_runs(cuda_device, cfg, 7, monkeypatch)
    assert n_captured == n_eager == REGRESSION_K1[preset]
    assert captured["train_loss"].shape == (7,) and np.all(np.isfinite(captured["train_loss"]))
    np.testing.assert_array_equal(captured["train_loss"], eager["train_loss"])
    for k in ("val_l1", "val_l1_ratio", "test_l1", "test_l1_ratio"):
        np.testing.assert_array_equal(captured[k], eager[k], err_msg=k)


@pytest.mark.parametrize("preset,generic", [("sbm_tmgcn_lp_tuned", False),
                                            ("sbm_evolvegcn_lp_tuned", True)])
def test_sbm_launches(cuda_device, preset, generic, monkeypatch):
    """An SBM _tuned preset at 50 nodes x 10 slices, 7 epochs: TM-GCN's
    "pallas" propagation 3 K1 launches at set-up; EvolveGCN, pushed onto the
    generic path as at full width (its one-hot budget set to 0), K1 in the
    readout plan's backward once a step. Rows bitwise captured and eager."""
    import dataclasses

    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.tasks import adapters

    if generic:
        monkeypatch.setattr(adapters, "ONEHOT_BUDGET_1LAYER", 0)
    cfg = dataclasses.replace(get_preset(preset), sbm_n_nodes=50, sbm_n_slices=10, beta1=2,
                              beta2=2, eval_every=3)
    captured, eager, n_captured, n_eager = _synthetic_runs(cuda_device, cfg, 7, monkeypatch)
    assert n_captured == n_eager == (7 if generic else 3)
    assert captured.shape == (7, 9) and np.all(np.isfinite(captured[:, 2]))
    np.testing.assert_array_equal(captured, eager)


@pytest.mark.parametrize("preset", sorted(REGRESSION_K1))
def test_mesh_regression_on_the_card(cuda_device, preset, monkeypatch):
    """A _tuned SEIR preset at 60 nodes x 20 slices on the 1 x 1 NCCL mesh,
    7 epochs in chunks of 3 (phase 7q of chip_smoke.py): the captured
    loop's result bitwise the eager loop's, no kernel of ours, and against
    the unsharded run train losses rtol 1e-4, val/test L1 and L1 ratio rtol
    1e-3."""
    import dataclasses

    from tmgcn_torch.configs import build
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.train import loop

    cfg = dataclasses.replace(get_preset(preset), seir_n_nodes=60, seir_n_slices=20,
                              eval_every=3)

    def run(**kw):
        before = _launches()
        out = build.run_experiment(cfg, n_epochs=7, verbose=False, device=cuda_device, **kw)
        return next(iter(out["results"].values())), [a - b for a, b in zip(_launches(), before)]

    captured, n_captured = run(mesh_shape=(1, 1))
    plain, _ = run()
    monkeypatch.setattr(loop, "_chunks", loop._EagerChunks)
    eager, n_eager = run(mesh_shape=(1, 1))
    assert n_captured == n_eager == [0] * len(COUNTERS)
    np.testing.assert_allclose(captured["train_loss"], plain["train_loss"], rtol=1e-4)
    for k, v in captured.items():
        np.testing.assert_array_equal(v, eager[k], err_msg=k)
        np.testing.assert_allclose(v, plain[k], rtol=1e-3, err_msg=k)


def test_mesh_resume_on_the_card(cuda_device, tmp_path):
    """EvolveGCN-H (its evolved weights the carry) on the 1 x 1 NCCL mesh
    with a checkpointer of the world (rank 0 writes, a barrier after each
    save): 8 epochs, eval_every 3; 4 that save and a resume to 8: the
    resumed train columns bitwise the uninterrupted run's."""
    import torch.distributed as dist

    from tmgcn_torch.parallel import distributed
    from tmgcn_torch.parallel.adapter import make_sharded_edge_adapter
    from tmgcn_torch.parallel.mesh import make_mesh
    from tmgcn_torch.train import loop
    from tmgcn_torch.train.checkpoint import RunCheckpointer

    model, M, adj, feats, edges, splits = _cls_problem("evolvegcn", "jnp")
    mesh = make_mesh(1, 1, device=distributed.initialize("cuda"))
    ad = make_sharded_edge_adapter(model, adj, feats, edges, M, mesh)
    variables = model.init(torch.Generator().manual_seed(0))
    cw = np.array([0.2, 0.5, 0.3])

    def run(n, ck=None):
        cfg = loop.TrainConfig(n_epochs=n, eval_every=3)
        return loop.run_edge_classification(ad, splits, cw, cfg, variables=variables,
                                            checkpointer=ck)[0]

    full = run(8)
    ck = RunCheckpointer(tmp_path / "run", group=dist.group.WORLD)
    run(4, ck)
    assert ck.latest_epoch() == 3
    resumed = run(8, ck)
    np.testing.assert_array_equal(resumed[:, :4], full[:, :4])
    np.testing.assert_array_equal(resumed[:4], full[:4])


def _auto_pattern(kind: str, T: int = 4, N: int = 2048, seed: int = 0) -> TemporalCOO:
    """Block-friendly ("banded": within 16 of the diagonal) or "random"
    entries, ~6,000 a slice."""
    rng = np.random.default_rng(seed)
    slices = []
    for _ in range(T):
        r = rng.integers(0, N, 6000)
        c = (np.clip(r + rng.integers(-16, 17, 6000), 0, N - 1) if kind == "banded"
             else rng.integers(0, N, 6000))
        slices.append((r, c, rng.standard_normal(6000).astype(np.float32)))
    return TemporalCOO.from_slices(slices, N)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["banded", "random"])
@pytest.mark.parametrize("F", [2, 6, 128])
def test_auto_pick_equals_the_other_candidates(cuda_device, kind, F, bf16):
    """The full-row rule's pick (ops.spmm.make_auto_operator, the constants
    fitted on the card) against the other two candidates of its precision
    class (kernel_probe.candidate: K1 with sort_cols, K3, block-dense) and
    the plain segment sum, forward and backward on the card: float32 at
    1e-5 of the scale, the bf16 tiers at 2e-2."""
    from tmgcn_torch.ops.spmm import make_auto_operator
    from tmgcn_torch.utils.kernel_probe import candidate

    A = _auto_pattern(kind)
    op, pick = make_auto_operator(A, bf16=bf16, feat=F, device=cuda_device)
    assert pick["branch"] in ("windowed", "tiled", "blockdense") and pick["bf16"] == bf16
    sfx = "_bf16" if bf16 else ""
    ops = {"pick": op.to(cuda_device)}
    for branch, name in (("windowed", "k1"), ("tiled", "k3"), ("blockdense", "blockdense")):
        if branch != pick["branch"]:
            ops[branch] = candidate(A, name + sfx).to(cuda_device)
    A_dev = A.to(cuda_device)
    ops["plain"] = lambda x: spmm(A_dev, x)
    gen = torch.Generator(device=cuda_device).manual_seed(F)
    X = torch.randn(A.n_slices, A.n_nodes, F, device=cuda_device, generator=gen)
    G = torch.randn(A.n_slices, A.n_nodes, F, device=cuda_device, generator=gen)
    outs = {}
    for k, o in ops.items():
        x = X.detach().requires_grad_(True)
        y = o(x)
        outs[k] = (y.detach(), torch.autograd.grad(y, x, G)[0])
    rel = 2e-2 if bf16 else ATOL
    for k in ops:
        for got, ref in zip(outs["pick"], outs[k]):
            tol = rel * max(1.0, float(ref.abs().max()))
            assert float((got - ref).abs().max()) <= tol, k


# The LSTM scan's kernel pair (kernels/scan_cuda.py, csrc/lstm_scan.cu)
# against the eager scan on the same card: the same function with the
# float32 sums of each gate's dots and of the weight gradients (summed over
# T and N) in another order, so ATOL of the reference's scale.
SCAN_SHAPES = {"chess": (80, 6, 7301), "F1_ragged": (10, 1, 37), "T1": (1, 4, 33),
               "F6_ragged": (10, 6, 100), "F4": (10, 4, 1000)}


def _scan_counts() -> list[int]:
    return [getattr(w, c) for w, c in SCAN_COUNTERS]


def _scan_problem(device, T: int, F: int, N: int, seed: int = 0):
    """WD-GCN's LSTM weights and initial states (standard normal, as the
    model draws them), a non-negative (T, F, N) input as the GCN layer's
    relu gives, and an upstream gradient."""
    from tmgcn_torch.models import wdgcn as twd

    p, bufs = twd._init_lstm(torch.Generator().manual_seed(seed), F, torch.float32)
    rng = np.random.default_rng(seed)
    Yt = torch.from_numpy(np.maximum(rng.standard_normal((T, F, N)), 0).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((T, N, F)).astype(np.float32))
    return ({k: v.to(device) for k, v in p.items()}, bufs["h_init"].to(device),
            bufs["c_init"].to(device), Yt.to(device), G.to(device))


def _scan_run(fn: str, p, h0, c0, Yt, G, remat):
    """The output (T, N, F) and the gradients of Y and every gate's W, U, b."""
    from tmgcn_torch.models import wdgcn as twd

    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    Y = (Yt if fn == "lstm_scan_t" else Yt.transpose(1, 2).contiguous()).requires_grad_(True)
    out = getattr(twd, fn)(leaves, h0, c0, Y, remat=remat)
    (out * G).sum().backward()
    return [out.detach(), Y.grad, *(leaves[k].grad for k in sorted(leaves))]


@pytest.mark.parametrize("shape", sorted(SCAN_SHAPES))
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("fn", ["lstm_scan", "lstm_scan_t"])
def test_lstm_scan_kernel_matches_eager(cuda_device, fn, remat, shape, monkeypatch):
    """Z and the gradients of Y, W, U and b: the kernel pair (one forward,
    one backward and one reduction launch) against the eager scan (hoisted
    or rematerialised, as ``remat`` says) on the card."""
    from tmgcn_torch.models import wdgcn as twd

    problem = _scan_problem(cuda_device, *SCAN_SHAPES[shape])
    before = _scan_counts()
    got = _scan_run(fn, *problem, remat)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_scan_counts(), before)] == [1, 1, 1]
    monkeypatch.setattr(twd, "_on_kernel", lambda p, Y: False)
    before = _scan_counts()
    want = _scan_run(fn, *problem, remat)
    assert _scan_counts() == before
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL * max(1.0, w.abs().max().item()))


def test_lstm_scan_kernel_repeats_bitwise(cuda_device):
    """No float atomics: two forward and backward runs at the chess shape
    give the same bits."""
    problem = _scan_problem(cuda_device, *SCAN_SHAPES["chess"])
    first = _scan_run("lstm_scan_t", *problem, None)
    again = _scan_run("lstm_scan_t", *problem, None)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_lstm_scan_kernel_reads_strided_views(cuda_device):
    """Y as the GCN layer's einsum leaves it (a view of (F, T, N) memory)
    and dZ as the readout's transpose sends it: the kernels read through
    the strides, the same bits as from contiguous copies."""
    p, h0, c0, Yt, G = _scan_problem(cuda_device, *SCAN_SHAPES["F6_ragged"])
    view = Yt.permute(1, 0, 2).contiguous().permute(1, 0, 2)
    assert not view.is_contiguous()
    strided = _scan_run("lstm_scan_t", p, h0, c0, view, G, None)
    dense = _scan_run("lstm_scan_t", p, h0, c0, Yt, G.contiguous(), None)
    assert all(torch.equal(a, b) for a, b in zip(strided, dense))


def test_lstm_scan_kernel_without_a_gradient(cuda_device):
    """Under no_grad (an evaluation forward) one forward launch, which
    writes no cell states, and the same Z as with a gradient."""
    from tmgcn_torch.models import wdgcn as twd

    p, h0, c0, Yt, G = _scan_problem(cuda_device, *SCAN_SHAPES["F6_ragged"])
    want = _scan_run("lstm_scan_t", p, h0, c0, Yt, G, None)[0]
    before = _scan_counts()
    with torch.no_grad():
        got = twd.lstm_scan_t(p, h0, c0, Yt)
    assert [a - b for a, b in zip(_scan_counts(), before)] == [1, 0, 0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["float64", "F above the cap"])
def test_lstm_scan_outside_the_kernel_is_eager_on_the_card(cuda_device, case):
    """float64, or F above MAX_F: the eager scan on the card, no launch."""
    from tmgcn_torch.models import wdgcn as twd

    F = scan_cuda.MAX_F + 1 if case == "F above the cap" else 4
    dtype = torch.float64 if case == "float64" else torch.float32
    p, bufs = twd._init_lstm(torch.Generator().manual_seed(0), F, dtype, cuda_device)
    Y = torch.rand(5, F, 40, dtype=dtype, device=cuda_device)
    before = _scan_counts()
    out = twd.lstm_scan_t(p, bufs["h_init"], bufs["c_init"], Y)
    assert _scan_counts() == before and out.shape == (5, 40, F) and out.dtype == dtype


def test_lstm_scan_launches_in_a_captured_chunk(cuda_device):
    """WD-GCN's captured step: one forward, one backward and one reduction
    launch of the scan a step, counted at each replay (chunks.launches),
    none for the capture."""
    from tmgcn_torch.tasks.adapters import make_edge_adapter
    from tmgcn_torch.train import loop

    model, M, adj, feats, edges, splits = _cls_problem("wdgcn", "pallas")
    ad = make_edge_adapter(model, adj, feats, edges, M=M, device=cuda_device)
    chunks, _, _ = loop.train_chunks(ad, splits["train"], np.ones(3) / 3, loop.TrainConfig(),
                                     capacity=8)
    assert type(chunks) is loop._CapturedChunks
    before = _scan_counts()
    chunks(1)
    assert [a - b for a, b in zip(_scan_counts(), before)] == [1, 1, 1]
    recorded = [(w, c) for w, c in chunks.launches.launches if w is scan_cuda.lstm_scan_cuda]
    assert sorted(c for _, c in recorded) == ["launches", "launches_backward", "launches_reduce"]
    chunks(3)
    assert [a - b for a, b in zip(_scan_counts(), before)] == [4, 4, 4]


def test_wdgcn_captured_chunk_matches_its_eager_steps(cuda_device, monkeypatch):
    """Five WD-GCN steps replayed from one captured graph and the same
    steps issued eagerly, both through the scan kernel pair: the losses
    and statistics bitwise, the scan launched as often."""
    from tmgcn_torch.tasks.adapters import make_edge_adapter
    from tmgcn_torch.train import loop

    model, M, adj, feats, edges, splits = _cls_problem("wdgcn", "jnp")
    variables = model.init(torch.Generator().manual_seed(0))

    def steps():
        ad = make_edge_adapter(model, adj, feats, edges, M=M, device=cuda_device)
        chunks, _, _ = loop.train_chunks(ad, splits["train"], np.ones(3) / 3,
                                         loop.TrainConfig(), capacity=8, variables=variables)
        before = _scan_counts()
        chunks(2)
        chunks(3)
        return chunks.stats(5).cpu(), [a - b for a, b in zip(_scan_counts(), before)]

    captured, n_captured = steps()
    monkeypatch.setattr(loop, "_chunks", loop._EagerChunks)
    eager, n_eager = steps()
    assert torch.isfinite(captured).all() and len(torch.unique(captured[:, 0])) == 5
    assert torch.equal(captured, eager)
    assert n_captured == n_eager == [5, 5, 5]

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tmgcn_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure exits
non-zero, and nothing falls back to the CPU:

  1. card    — the card's name and power limit, as nvidia-smi gives them;
  2. build   — compile every CUDA kernel from tmgcn_torch/kernels/csrc;
  3. K1      — the windowed segment matmul against its plain PyTorch
               version on the card: random packings (F = 2, 6, 128, with
               and without init, with empty windows), the chess
               train-window packing at F = 2 (forward and autograd
               backward) and the chess readout-plan packing at F = 6
               (zero init), two launches bitwise equal; times at both
               chess shapes (kernel, plain version, torch.sparse.mm
               yardstick) and the bound the card's memory rate sets;
  4. K2      — the lane-major twin against its plain version: random
               packings (F = 2, 6, 128, with and without init, with empty
               windows), K1 transposed bitwise, and the chess readout plan
               forced lane-major (forward and backward against the plain
               gather), two launches bitwise equal; times at the WD-GCN
               scale shape (1M labelled edges into 500k x 64 rows);
  5. paths   — the main paths, each with every launch count set to 0 just
               before it and read just after:
               a. ``run_experiment`` of chess_tmgcn_cls, spmm_impl="pallas",
                  200 epochs: 3 K1 launches (the cached propagation), then
                  the same run warm (same rows) and 5 epochs against the
                  CPU's plain path;
               b. ``run_experiment`` of chess_wdgcn_cls (the preset's
                  spmm_impl "jnp"), 200 epochs: 200 K1 launches (the
                  readout plan's backward, one per step), 0 K2; warm rerun
                  with the same rows; 5 epochs against the CPU's plain path;
               c. ``python -m tmgcn_torch.cli run chess_wdgcn_cls
                  --spmm-impl pallas --epochs 200`` (in process): 203 K1
                  launches (3 for the cached propagation);
               d. the WD-GCN scale run of ``tmgcn_torch.utils.scale_bench``
                  (500,000 nodes x 64 slices, 1,000,000 labelled edges,
                  nnz_per_slice cut from 2,000,000 to 250,000): one K2
                  launch per training step, no K1;
  6. a JSON line {"kernels": [...]} with every ported kernel's numbers;
  7. last line: {"ok": true, "device": {...}}.

Without CUDA, or outside a checkout, it exits non-zero and prints no
result. It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (float32 outside the tensor cores; HBM3).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
ATOL = 1e-5  # float32 sums taken in another order; scaled by max(1, |ref|)
EPOCHS = 200
REF_EPOCHS = 5
DATA_DIR = "data/chess"
SOURCE = "tmgcn_torch/kernels/csrc/windowed_segment_matmul.cu"
K1_REPLACES = "tmgcn_tpu/kernels/spmm_pallas.py:650"
K2_REPLACES = "tmgcn_tpu/kernels/spmm_pallas.py:761"
DEVICE = "cuda"
# The WD-GCN scale run: tools/bench_scale.py's wdgcn family, host build cut.
SCALE = {"n_nodes": 500_000, "n_slices": 64, "nnz_per_slice": 250_000,
         "n_edges": 1_000_000, "band": 20}
SCALE_N_TIMED = 12  # -> 3 warm-up and 3 timed steps (scale_bench's rule)


def check(cond: bool, msg: str) -> None:
    if not cond:
        sys.exit(f"chip_smoke: FAIL: {msg}")


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(line)
    return line


def phase_build() -> None:
    from tmgcn_torch.kernels.build import build_all

    t0 = time.perf_counter()
    paths = build_all(verbose=True)
    print(f"build: {len(paths)} kernel libraries in {time.perf_counter() - t0:.3f} s")


def _max_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, the tolerance for ref's scale)."""
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    return err, ATOL * max(1.0, ref.abs().max().item() if ref.numel() else 0.0)


def _check_kernel(torch, kernel, plain, packed, gathered, init_fn, what: str) -> float:
    """Kernel vs plain version on the same card inputs; bitwise repeat."""
    out = kernel(packed, gathered, init=init_fn())
    again = kernel(packed, gathered, init=init_fn())
    ref = plain(packed, gathered, init=init_fn())
    torch.cuda.synchronize()
    err, tol = _max_err(out, ref)
    check(err <= tol, f"{what}: max abs err {err} > {tol}")
    check(torch.equal(out, again), f"{what}: two launches differ")
    return err


def _check_operator_backward(torch, tk, op, X, what: str) -> float:
    """Autograd backward (K1 on the transposed packing) vs the plain version."""
    T, N, F = X.shape
    Xg = X.clone().requires_grad_(True)
    G = torch.randn(X.shape, device=X.device, generator=torch.Generator(device=X.device).manual_seed(1))
    (op(Xg) * G).sum().backward()
    pt = op.packed_t
    gathered = G.reshape(T * N, F)[pt.cols.long().reshape(-1)].reshape(pt.n_chunks, pt.chunk, F)
    ref = tk.windowed_segment_matmul_reference(pt, gathered)[: T * N].reshape(T, N, F)
    torch.cuda.synchronize()
    err, tol = _max_err(Xg.grad, ref)
    check(err <= tol, f"K1 backward {what}: max abs err {err} > {tol}")
    return err


def _random_stream(np, seed: int, n_out: int):
    """Row-sorted entries over n_out rows; a third of the windows empty."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_out, 60_000)
    rows = np.sort(rows[(rows // 256) % 3 != 1])
    cols = rng.integers(0, n_out, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals


def _time_ms(torch, fn, reps: int = 25) -> float:
    """Median ms of fn on the card (CUDA events), L2 flushed before each."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(p, F: int, n_real: int, with_init: bool) -> tuple[float, str, int, int]:
    """The least time for K1/K2's function on these inputs.

    The function needs only the real entries (a row id, a value and F
    gathered features each; the padding slots of the packing are not
    counted), the window offsets, and each output element it writes, once.
    Without an init it writes every window; with one (the caller's zeros)
    it writes only the windows that own a chunk, and leaves the rest alone.
    """
    if with_init:
        wp = p.window_ptr
        n_written = int((wp[1:] > wp[:-1]).sum()) * p.window
    else:
        n_written = p.n_rows_out
    bytes_moved = 4 * (n_real * (2 + F) + p.window_ptr.numel() + n_written * F)
    flops = 2 * n_real * F
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        bytes_moved, flops


def _slot_csr(torch, p, n_real_mask):
    """The (n_rows_out, J*C) CSR matrix of a packing's real slots: the same
    sums as K1/K2 as one torch.sparse.mm (a yardstick; the port never calls it)."""
    J, C = p.rows.shape
    W = p.window
    slot = torch.arange(J * C, device=p.rows.device)
    out_row = (p.window_id.long()[:, None] * W + p.rows.long()).reshape(-1)
    keep = n_real_mask.reshape(-1)
    return torch.sparse_coo_tensor(
        torch.stack([out_row[keep], slot[keep]]), p.vals.reshape(-1)[keep],
        (p.n_rows_out, J * C),
    ).coalesce().to_sparse_csr()


def _time_shape(torch, kernel, plain, p, gathered, F, n_real, init_shape, lib_fn, what: str) -> dict:
    """Kernel, plain and library times at one shape, with the bound."""
    # A zero init is the caller's (allocated once per step on the path),
    # so both versions write into one kept buffer: each call rewrites the
    # same visited windows with the same sums.
    init = torch.zeros(init_shape, device=gathered.device) if init_shape is not None else None
    ms = _time_ms(torch, lambda: kernel(p, gathered, init=init))
    plain_ms = _time_ms(torch, lambda: plain(p, gathered, init=init))
    library_ms = _time_ms(torch, lib_fn)
    bound_ms, bound_by, nbytes, flops = _bound(p, F, n_real, init is not None)
    print(f"{what}: J={p.n_chunks} C={p.chunk} W={p.window} F={F} nnz={n_real} "
          f"n_rows_out={p.n_rows_out}")
    print(f"{what}: kernel ms (median, CUDA events, L2 flushed): {ms:.6f}")
    print(f"{what}: plain version ms: {plain_ms:.6f}")
    print(f"{what}: bound ms: {bound_ms:.6f} ({bound_by}: {nbytes} bytes, {flops} operations)")
    print(f"{what}: library ms (torch.sparse.mm, CSR): {library_ms:.6f}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


@functools.cache
def _chess_wdgcn_train_edges():
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.tasks.windows import split_edges_classification

    cfg = get_preset("chess_wdgcn_cls")
    data = build_data(cfg, data_dir=DATA_DIR)
    split = split_edges_classification(
        data.edge_index, data.edge_values, data.spec, n_classes=cfg.n_classes
    )["train"]
    return split.edges, data.spec.s_train, data.adj["train"].n_nodes


def phase_k1(torch, np) -> tuple[dict, int]:
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.core.sparse import TemporalCOO
    from tmgcn_torch.kernels import spmm_cuda as tk
    from tmgcn_torch.ops.edge_readout import make_readout_plan
    from tmgcn_torch.ops.mtransform import m_transform
    from tmgcn_torch.tasks.windows import split_edges_classification

    dev = torch.device(DEVICE)
    k1, k1p = tk.windowed_segment_matmul, tk.windowed_segment_matmul_reference
    max_err = 0.0
    for F in (2, 6, 128):
        for use_init in (False, True):
            rows, cols, vals = _random_stream(np, F, 20_000)
            p = tk.pack_windowed_flat(
                rows, cols, vals, 20_000, sort_cols=True, all_windows=not use_init
            ).to(dev)
            g = torch.randn(p.n_chunks, p.chunk, F, device=dev)

            def init_fn(p=p, F=F, use_init=use_init):
                return torch.zeros(p.n_rows_out, F, device=dev) if use_init else None

            max_err = max(max_err, _check_kernel(torch, k1, k1p, p, g, init_fn,
                                                 f"K1 F={F} init={use_init}"))
        # Operator backward on a random temporal graph at this width.
        rng = np.random.default_rng(F)
        dense = (rng.random((4, 300, 300)) < 0.05) * rng.random((4, 300, 300))
        op = tk.make_operator(TemporalCOO.from_dense(dense)).to(dev)
        X = torch.randn(4, 300, F, device=dev)
        max_err = max(max_err, _check_operator_backward(torch, tk, op, X, f"F={F}"))
    print(f"K1 random packings: ok (max abs err {max_err:.3e})")

    # The chess train window at the TM-GCN path's width (F = 2 degree features).
    cfg = dataclasses.replace(get_preset("chess_tmgcn_cls"), spmm_impl="pallas")
    t0 = time.perf_counter()
    data = build_data(cfg, data_dir=DATA_DIR)
    t_data = time.perf_counter() - t0
    Ct = data.adj["train"]
    t0 = time.perf_counter()
    op = tk.make_operator(Ct).to(dev)
    t_pack = time.perf_counter() - t0
    e_train = split_edges_classification(
        data.edge_index, data.edge_values, data.spec, n_classes=cfg.n_classes
    )["train"].target.size
    print(f"chess data build: {t_data:.3f} s; K1 packing (train window, both directions): "
          f"{t_pack:.3f} s")
    T, N = op.T, op.N
    M = torch.as_tensor(data.M, dtype=torch.float32, device=dev)
    X = torch.as_tensor(data.feats["train"], dtype=torch.float32, device=dev)
    flat = m_transform(M, X).reshape(T * N, -1)
    F = flat.shape[1]
    p = op.packed
    gathered = flat[p.cols.long().reshape(-1)].reshape(p.n_chunks, p.chunk, F).contiguous()
    chess_err = _check_kernel(torch, k1, k1p, p, gathered, lambda: None, "K1 chess train window")
    chess_err = max(chess_err, _check_operator_backward(torch, tk, op, flat.reshape(T, N, F), "chess"))
    max_err = max(max_err, chess_err)
    # torch.sparse.mm of the block-diagonal (T*N, T*N) CSR matrix: the
    # operator-level yardstick (gather included).
    nnz = torch.as_tensor(Ct.nnz).long()
    real = torch.arange(Ct.capacity)[None, :] < nnz[:, None]
    offs = (torch.arange(T) * N)[:, None]
    idx = torch.stack([
        (torch.as_tensor(Ct.rows).long() + offs)[real],
        (torch.as_tensor(Ct.cols).long() + offs)[real],
    ])
    A_csr = torch.sparse_coo_tensor(
        idx, torch.as_tensor(Ct.vals)[real], (T * N, T * N), check_invariants=True
    ).coalesce().to_sparse_csr().to(dev)
    lib_out = torch.sparse.mm(A_csr, flat)
    k1_out = k1(p, gathered)[: T * N]
    torch.cuda.synchronize()
    err, tol = _max_err(k1_out, lib_out)
    check(err <= tol, f"K1 vs torch.sparse.mm at the chess shape: {err} > {tol}")
    train_window = _time_shape(
        torch, k1, k1p, p, gathered, F, int(nnz.sum()), None, lambda: torch.sparse.mm(A_csr, flat),
        "K1 chess train window",
    )
    del op, p, gathered, A_csr

    # The chess readout plan of chess_wdgcn_cls: 2E = 78,384 endpoint rows
    # into T*N = 584,080, F = 6, zero init — K1's launch in every step.
    edges, T, N = _chess_wdgcn_train_edges()
    plan = make_readout_plan(edges, T, N).to(dev)
    check(not plan.lane_major, "the chess readout plan picked the lane-major layout")
    p, F = plan.packed, 6
    g = torch.randn(p.n_chunks, p.chunk, F, device=dev)
    err = _check_kernel(torch, k1, k1p, p, g,
                        lambda: torch.zeros(p.n_rows_out, F, device=dev), "K1 chess readout plan")
    S = _slot_csr(torch, p, p.vals != 0)
    g_flat = g.reshape(-1, F)
    lib_out = torch.sparse.mm(S, g_flat)
    k1_out = k1(p, g, init=torch.zeros(p.n_rows_out, F, device=dev))
    torch.cuda.synchronize()
    lib_err, tol = _max_err(k1_out, lib_out)
    check(lib_err <= tol, f"K1 vs torch.sparse.mm at the readout shape: {lib_err} > {tol}")
    max_err = max(max_err, err)
    readout = _time_shape(torch, k1, k1p, p, g, F, 2 * edges.shape[1], (p.n_rows_out, F),
                          lambda: torch.sparse.mm(S, g_flat), "K1 chess readout plan")
    print(f"K1 max abs err over every check: {max_err:.3e}")
    # The per-epoch path's shape heads the row; the train window's follows.
    return {
        "name": "windowed_segment_matmul",
        "route": "cuda",
        "source": SOURCE,
        "replaces": K1_REPLACES,
        "max_abs_err": max_err,
        **readout,
        "shape": "chess readout plan (F=6, 78,384 entries, zero init)",
        "train_window": train_window,
    }, e_train


def phase_k2(torch, np, scale_edges) -> dict:
    from tmgcn_torch.kernels import spmm_cuda as tk
    from tmgcn_torch.ops.edge_readout import apply_readout, edge_readout, make_readout_plan

    dev = torch.device(DEVICE)
    k2, k2p = tk.windowed_segment_matmul_t, tk.windowed_segment_matmul_t_reference
    max_err = 0.0
    for F in (2, 6, 128):
        for use_init in (False, True):
            rows, cols, vals = _random_stream(np, 100 + F, 20_000)
            p = tk.pack_windowed_flat(
                rows, cols, vals, 20_000, sort_cols=True, all_windows=not use_init
            ).to(dev)
            g = torch.randn(p.n_chunks, F, p.chunk, device=dev)

            def init_fn(p=p, F=F, use_init=use_init):
                return torch.zeros(F, p.n_rows_out, device=dev) if use_init else None

            max_err = max(max_err, _check_kernel(torch, k2, k2p, p, g, init_fn,
                                                 f"K2 F={F} init={use_init}"))
            # The same sums as K1, bitwise: same order, same rounding.
            k1_out = tk.windowed_segment_matmul(p, g.transpose(1, 2).contiguous(),
                                                init=None if init_fn() is None
                                                else torch.zeros(p.n_rows_out, F, device=dev))
            check(torch.equal(k2(p, g, init=init_fn()), k1_out.T),
                  f"K2 F={F} init={use_init} is not K1 transposed")
    print(f"K2 random packings: ok (max abs err {max_err:.3e})")

    # The chess readout plan of chess_wdgcn_cls forced lane-major, forward
    # and backward, against the plain gather's autograd on the card.
    edges, T, N = _chess_wdgcn_train_edges()
    E = edges.shape[1]
    gen = torch.Generator(device=dev).manual_seed(3)
    Y = torch.randn(T, N, 6, device=dev, generator=gen)
    U = torch.randn(12, 3, device=dev, generator=gen)
    G = torch.randn(E, 3, device=dev, generator=gen)
    e_dev = torch.as_tensor(edges, device=dev)
    Yr, Ur = Y.clone().requires_grad_(True), U.clone().requires_grad_(True)
    ref = edge_readout(Yr, e_dev, Ur)
    (ref * G).sum().backward()
    plan = make_readout_plan(edges, T, N, lane_major=True).to(dev)
    grads = []
    for _ in range(2):
        Yk, Uk = Y.clone().requires_grad_(True), U.clone().requires_grad_(True)
        before = k2.launches
        out = apply_readout(plan, Yk, Uk)
        (out * G).sum().backward()
        torch.cuda.synchronize()
        check(k2.launches == before + 1, "the lane-major plan's backward did not launch K2")
        grads.append(Yk.grad)
        for what, a, b in (("logits", out, ref), ("dY", Yk.grad, Yr.grad), ("dU", Uk.grad, Ur.grad)):
            err, tol = _max_err(a, b)
            check(err <= tol, f"K2 chess lane-major plan {what}: max abs err {err} > {tol}")
            max_err = max(max_err, err)
    check(torch.equal(*grads), "K2 chess lane-major plan: two backward passes differ")
    print(f"K2 chess readout plan forced lane-major: forward and backward ok, "
          f"backward bitwise repeatable (max abs err {max_err:.3e})")
    del Y, Yr, Yk, plan, grads

    # The WD-GCN scale shape: 2M endpoint rows into T*N = 32M, F = 6.
    t0 = time.perf_counter()
    plan = make_readout_plan(scale_edges, SCALE["n_slices"], SCALE["n_nodes"]).to(dev)
    t_plan = time.perf_counter() - t0
    check(plan.lane_major, "the scale readout plan did not pick the lane-major layout")
    p, F = plan.packed, 6
    print(f"K2 scale plan built in {t_plan:.3f} s: {p.n_chunks} chunks of {p.chunk} slots for "
          f"{2 * scale_edges.shape[1]} entries ({2 * scale_edges.shape[1] / (p.n_chunks * p.chunk):.4f} "
          f"occupancy); the padded (J, F, C) chunks take "
          f"{p.n_chunks * F * p.chunk * 4} bytes")
    g = torch.randn(p.n_chunks, F, p.chunk, device=dev)
    err = _check_kernel(torch, k2, k2p, p, g,
                        lambda: torch.zeros(F, p.n_rows_out, device=dev), "K2 scale plan")
    max_err = max(max_err, err)
    S = _slot_csr(torch, p, p.vals != 0)
    g_flat = g.transpose(1, 2).reshape(-1, F).contiguous()  # (J*C, F); layout change not timed
    lib_out = torch.sparse.mm(S, g_flat)
    k2_out = k2(p, g, init=torch.zeros(F, p.n_rows_out, device=dev))
    torch.cuda.synchronize()
    lib_err, tol = _max_err(k2_out.T, lib_out)
    check(lib_err <= tol, f"K2 vs torch.sparse.mm at the scale shape: {lib_err} > {tol}")
    del k2_out, lib_out
    timing = _time_shape(torch, k2, k2p, p, g, F, 2 * scale_edges.shape[1], (F, p.n_rows_out),
                         lambda: torch.sparse.mm(S, g_flat), "K2 WD-GCN scale plan")
    print(f"K2 max abs err over every check: {max_err:.3e}")
    del plan, p, g, S, g_flat
    torch.cuda.empty_cache()
    return {
        "name": "windowed_segment_matmul_t",
        "route": "cuda",
        "source": SOURCE,
        "replaces": K2_REPLACES,
        "max_abs_err": max_err,
        **timing,
        "shape": "WD-GCN scale readout plan (F=6, 2,000,000 entries into 32,000,000 rows)",
    }


def _check_rows(np, res, what: str) -> None:
    check(res.shape[1] == 12, f"{what}: results are not (epochs, 12)")
    check(bool(np.all(np.isfinite(res[:, [3, 7, 11]]))), f"{what}: a loss is not finite")
    for col in (2, 6, 10):  # train / val / test F1
        f1, prec, rec = res[:, col], res[:, col - 2], res[:, col - 1]
        finite = np.isfinite(f1)
        check(bool(np.all((f1[finite] >= 0) & (f1[finite] <= 1))), f"{what}: F1 outside [0, 1]")
        # F1 is undefined (NaN) exactly when no class-0 edge is found
        # (tp = 0): then precision and recall are 0 or undefined.
        undefined = ~finite
        check(bool(np.all(~(prec[undefined] > 0) & ~(rec[undefined] > 0))),
              f"{what}: F1 NaN with a true positive")


def _counted(tk, fn):
    """Run fn with both kernels' launch counts set to 0; (result, (K1, K2))."""
    tk.windowed_segment_matmul.launches = 0
    tk.windowed_segment_matmul_t.launches = 0
    out = fn()
    return out, (tk.windowed_segment_matmul.launches, tk.windowed_segment_matmul_t.launches)


def _run_slice(torch, np, tk, cfg, e_train: int, expected: tuple[int, int]) -> tuple[int, int]:
    """200 epochs on cuda (counted), a warm rerun, 5 epochs against the CPU."""
    from tmgcn_torch.configs.build import run_experiment

    name = f"{cfg.name} ({cfg.spmm_impl})"
    out, launches = _counted(tk, lambda: run_experiment(
        cfg, data_dir=DATA_DIR, n_epochs=EPOCHS, verbose=False, device=DEVICE))
    check(launches == expected,
          f"{name}: (K1, K2) launched {launches} times on the main path, expected {expected}")
    (res,) = out["results"].values()
    check(res.shape == (EPOCHS, 12), f"{name}: results shape {res.shape}")
    _check_rows(np, res, f"{name} cuda run")
    sec = out["seconds"]
    print(f"slice {name} cuda, first run: {EPOCHS} epochs, (K1, K2) launches {launches}; "
          f"data {sec['data']:.3f} s, adapter {sec['adapter']:.3f} s, train {sec['train']:.3f} s "
          f"({1e3 * sec['train'] / EPOCHS:.6f} ms/epoch with the process's first launches)")
    print(f"slice {name} final row: train f1 {res[-1, 2]:.4f} loss {res[-1, 3]:.6f} | "
          f"val f1 {res[-1, 6]:.4f} | test f1 {res[-1, 10]:.4f}")
    # The same run again, warm: the steady-state epoch time.
    warm = run_experiment(cfg, data_dir=DATA_DIR, n_epochs=EPOCHS, verbose=False, device=DEVICE)
    (warm_res,) = warm["results"].values()
    check(np.array_equal(warm_res, res, equal_nan=True), f"{name}: a repeated run gave other rows")
    t_warm = warm["seconds"]["train"]
    print(f"slice {name} warm run: {1e3 * t_warm / EPOCHS:.6f} ms/epoch, "
          f"{e_train * EPOCHS / t_warm:.1f} labelled edges/s ({e_train} training edges, "
          f"{EPOCHS} epochs, 2 evaluation epochs)")

    # Reference: the same run on the CPU's plain path, first epochs.
    ref = run_experiment(cfg, data_dir=DATA_DIR, n_epochs=REF_EPOCHS, verbose=False,
                         device="cpu")
    (ref_res,) = ref["results"].values()
    got = res[:REF_EPOCHS]
    losses = [3, 7, 11]
    check(bool(np.allclose(got[:, losses], ref_res[:, losses], rtol=1e-4, atol=0)),
          f"{name}: losses differ from the CPU plain path: {got[:, losses]} vs {ref_res[:, losses]}")
    f1s = [2, 6, 10]
    same_nan = np.isnan(got[:, f1s]) == np.isnan(ref_res[:, f1s])
    close = np.nan_to_num(np.abs(got[:, f1s] - ref_res[:, f1s]), nan=0.0) <= 1e-3
    check(bool(np.all(same_nan & close)), f"{name}: F1 differs from the CPU plain path")
    print(f"slice {name} vs CPU plain path, {REF_EPOCHS} epochs: losses within rtol 1e-4, "
          f"F1 within 1e-3")
    return launches


def phase_tmgcn(torch, np, tk, e_train: int) -> tuple[int, int]:
    from tmgcn_torch.configs.presets import get_preset

    cfg = dataclasses.replace(get_preset("chess_tmgcn_cls"), spmm_impl="pallas")
    return _run_slice(torch, np, tk, cfg, e_train, (3, 0))


def phase_wdgcn_chess(torch, np, tk, e_train: int) -> dict[str, tuple[int, int]]:
    from tmgcn_torch import cli
    from tmgcn_torch.configs.presets import get_preset

    cfg = get_preset("chess_wdgcn_cls")
    check(cfg.spmm_impl == "jnp", "chess_wdgcn_cls is expected to name spmm_impl jnp")
    counts = {"chess_wdgcn_cls": _run_slice(torch, np, tk, cfg, e_train, (EPOCHS, 0))}
    # The CLI, with the CUDA propagation: 3 more K1 launches at set-up.
    argv = ["run", "chess_wdgcn_cls", "--data-dir", DATA_DIR, "--spmm-impl", "pallas",
            "--epochs", str(EPOCHS), "--quiet"]
    t0 = time.perf_counter()
    rc, launches = _counted(tk, lambda: cli.main(argv))
    check(rc == 0, f"cli {' '.join(argv)} exited {rc}")
    check(launches == (EPOCHS + 3, 0),
          f"cli run chess_wdgcn_cls --spmm-impl pallas: (K1, K2) launched {launches} times, "
          f"expected {(EPOCHS + 3, 0)}")
    print(f"cli run chess_wdgcn_cls --spmm-impl pallas: {EPOCHS} epochs in "
          f"{time.perf_counter() - t0:.3f} s, (K1, K2) launches {launches}")
    counts["cli chess_wdgcn_cls --spmm-impl pallas"] = launches
    return counts


def phase_wdgcn_scale(torch, np, tk, inputs, t_build: float) -> tuple[int, int]:
    from tmgcn_torch.utils import scale_bench

    out, launches = _counted(
        tk, lambda: scale_bench.run_family("wdgcn", inputs, SCALE_N_TIMED, DEVICE))
    steps = out["steps"]
    check(launches == (0, steps),
          f"WD-GCN scale: (K1, K2) launched {launches} times in {steps} steps, "
          f"expected {(0, steps)}")
    losses = out["losses"]
    check(losses.shape == (steps,) and bool(np.all(np.isfinite(losses))),
          f"WD-GCN scale: losses not finite: {losses}")
    print(f"WD-GCN scale ({SCALE['n_nodes']} nodes x {SCALE['n_slices']} slices, "
          f"{SCALE['n_edges']} labelled edges, nnz_per_slice {SCALE['nnz_per_slice']} — cut from "
          f"2000000 to shorten the host build; only the set-up depends on it): host build "
          f"{t_build:.3f} s, adapter build {out['wdgcn_build_s']:.3f} s, first {steps // 2} steps "
          f"{out['wdgcn_first_run_s']:.3f} s, {out['wdgcn_ms_per_epoch']:.6f} ms/epoch, "
          f"{out['wdgcn_edges_per_s']:.1f} labelled edges/s; (K1, K2) launches {launches} in "
          f"{steps} steps; losses {losses.tolist()}")
    return launches


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        sys.exit(f"chip_smoke: FAIL: {e}")
    check(torch.cuda.is_available(), "CUDA is not available: this smoke run needs an NVIDIA card")
    try:
        from tmgcn_torch.kernels import spmm_cuda as tk
        from tmgcn_torch.utils import scale_bench
    except ImportError as e:
        sys.exit(f"chip_smoke: FAIL: run from the root of a tmgcn checkout ({e})")
    check("jax" not in sys.modules, "jax was imported")

    t_start = time.perf_counter()
    phase_card()
    phase_build()
    k1, e_train = phase_k1(torch, np)
    t0 = time.perf_counter()
    inputs = scale_bench.build_inputs(**SCALE)
    t_scale_build = time.perf_counter() - t0
    k2 = phase_k2(torch, np, inputs[3])
    by_path = {"chess_tmgcn_cls pallas": phase_tmgcn(torch, np, tk, e_train)}
    by_path.update(phase_wdgcn_chess(torch, np, tk, e_train))
    by_path["wdgcn scale 500k x 64"] = phase_wdgcn_scale(torch, np, tk, inputs, t_scale_build)
    check("jax" not in sys.modules and "tmgcn_tpu" not in sys.modules,
          "the JAX package was imported")
    for i, k in enumerate((k1, k2)):
        k["launches"] = sum(c[i] for c in by_path.values())
        k["launches_by_path"] = {path: c[i] for path, c in by_path.items()}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("shape", "launches_by_path", "train_window")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {**{k: kern[k] for k in keys}, **{k: kern[k] for k in extra if k in kern}}
        for kern in (k1, k2)
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

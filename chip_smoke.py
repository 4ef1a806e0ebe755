#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tmgcn_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure exits
non-zero, and nothing falls back to the CPU:

  1. card    — the card's name and power limit, as nvidia-smi gives them;
  2. build   — compile every CUDA kernel from tmgcn_torch/kernels/csrc;
  3. K1      — the windowed segment matmul against its plain PyTorch
               version on the card: random packings (F = 2, 6, 128, with
               and without init, with empty windows) and the chess
               train-window packing at F = 2, forward and autograd
               backward, two launches bitwise equal; times at the chess
               shape (kernel, plain version, torch.sparse.mm yardstick)
               and the bound the card's memory rate sets;
  4. slice   — the main path, ``run_experiment`` of chess_tmgcn_cls with
               spmm_impl="pallas" for 200 epochs on cuda, K1's launches
               counted; then the same run warm (the steady-state epoch
               time), which must give the same rows; its first 5 epochs
               held against the same run on the CPU's plain path;
  5. a JSON line {"kernels": [...]} with every ported kernel's numbers;
  6. last line: {"ok": true, "device": {...}}.

Without CUDA, or outside a checkout, it exits non-zero and prints no
result. It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
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
K1_SOURCE = "tmgcn_torch/kernels/csrc/windowed_segment_matmul.cu"
K1_REPLACES = "tmgcn_tpu/kernels/spmm_pallas.py:650"
DEVICE = "cuda"


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


def _check_k1(torch, tk, packed, gathered, init_fn, what: str) -> float:
    """Kernel vs plain version on the same card inputs; bitwise repeat."""
    out = tk.windowed_segment_matmul(packed, gathered, init=init_fn())
    again = tk.windowed_segment_matmul(packed, gathered, init=init_fn())
    ref = tk.windowed_segment_matmul_reference(packed, gathered, init=init_fn())
    torch.cuda.synchronize()
    err, tol = _max_err(out, ref)
    check(err <= tol, f"K1 {what}: max abs err {err} > {tol}")
    check(torch.equal(out, again), f"K1 {what}: two launches differ")
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


def phase_k1(torch, np) -> tuple[dict, int]:
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.core.sparse import TemporalCOO
    from tmgcn_torch.kernels import spmm_cuda as tk
    from tmgcn_torch.ops.mtransform import m_transform
    from tmgcn_torch.tasks.windows import split_edges_classification

    dev = torch.device(DEVICE)
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

            max_err = max(max_err, _check_k1(torch, tk, p, g, init_fn, f"F={F} init={use_init}"))
        # Operator backward on a random temporal graph at this width.
        rng = np.random.default_rng(F)
        dense = (rng.random((4, 300, 300)) < 0.05) * rng.random((4, 300, 300))
        op = tk.make_operator(TemporalCOO.from_dense(dense)).to(dev)
        X = torch.randn(4, 300, F, device=dev)
        max_err = max(max_err, _check_operator_backward(torch, tk, op, X, f"F={F}"))
    print(f"K1 random packings: ok (max abs err {max_err:.3e})")

    # The chess train window at the main path's width (F = 2 degree features).
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
    chess_err = _check_k1(torch, tk, p, gathered, lambda: None, "chess train window")
    chess_err = max(chess_err, _check_operator_backward(torch, tk, op, flat.reshape(T, N, F), "chess"))
    max_err = max(max_err, chess_err)

    ms = _time_ms(torch, lambda: tk.windowed_segment_matmul(p, gathered))
    plain_ms = _time_ms(torch, lambda: tk.windowed_segment_matmul_reference(p, gathered))
    # torch.sparse.mm of the block-diagonal (T*N, T*N) CSR matrix: the
    # operator-level yardstick (gather included); the port never calls it.
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
    k1_out = tk.windowed_segment_matmul(p, gathered)[: T * N]
    torch.cuda.synchronize()
    err, tol = _max_err(k1_out, lib_out)
    check(err <= tol, f"K1 vs torch.sparse.mm at the chess shape: {err} > {tol}")
    library_ms = _time_ms(torch, lambda: torch.sparse.mm(A_csr, flat))

    # The function needs only the real entries: a row id, a value and F
    # gathered features each; the padding slots of the packing are not
    # counted. Plus the window offsets, and each output row written once.
    n_real = int(nnz.sum())
    bytes_moved = 4 * (n_real * (2 + F) + p.window_ptr.numel() + p.n_rows_out * F)
    flops = 2 * n_real * F
    bound_ms = 1e3 * max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S)
    bound_by = "bytes" if bytes_moved / PEAK_BYTES_PER_S >= flops / PEAK_F32_FLOP_PER_S else "operations"
    print(f"K1 chess train window: J={p.n_chunks} C={p.chunk} W={p.window} F={F} nnz={n_real} "
          f"n_rows_out={p.n_rows_out}; max abs err {chess_err:.3e}")
    print(f"K1 kernel ms (median, CUDA events, L2 flushed): {ms:.6f}")
    print(f"K1 plain version ms: {plain_ms:.6f}")
    print(f"K1 bound ms: {bound_ms:.6f} ({bound_by}: {bytes_moved} bytes, {flops} operations)")
    print(f"K1 library ms (torch.sparse.mm, CSR, gather included): {library_ms:.6f}")
    return {
        "name": "windowed_segment_matmul",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, e_train


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


def phase_slice(torch, np, tk, e_train: int) -> int:
    from tmgcn_torch.configs.build import run_experiment
    from tmgcn_torch.configs.presets import get_preset

    cfg = dataclasses.replace(get_preset("chess_tmgcn_cls"), spmm_impl="pallas")
    tk.windowed_segment_matmul.launches = 0
    out = run_experiment(cfg, data_dir=DATA_DIR, n_epochs=EPOCHS, verbose=False, device=DEVICE)
    launches = tk.windowed_segment_matmul.launches
    check(launches == 3, f"K1 launched {launches} times on the main path, expected 3 (one per window)")
    (res,) = out["results"].values()
    check(res.shape == (EPOCHS, 12), f"results shape {res.shape}")
    _check_rows(np, res, "cuda run")
    sec = out["seconds"]
    print(f"slice chess_tmgcn_cls pallas cuda, first run: {EPOCHS} epochs, K1 launches {launches}; "
          f"data {sec['data']:.3f} s, adapter {sec['adapter']:.3f} s, train {sec['train']:.3f} s "
          f"({1e3 * sec['train'] / EPOCHS:.6f} ms/epoch with the process's first launches)")
    print(f"slice final row: train f1 {res[-1, 2]:.4f} loss {res[-1, 3]:.6f} | "
          f"val f1 {res[-1, 6]:.4f} | test f1 {res[-1, 10]:.4f}")
    # The same run again, warm: the steady-state epoch time.
    warm = run_experiment(cfg, data_dir=DATA_DIR, n_epochs=EPOCHS, verbose=False, device=DEVICE)
    (warm_res,) = warm["results"].values()
    check(np.array_equal(warm_res, res, equal_nan=True), "a repeated run gave other rows")
    t_warm = warm["seconds"]["train"]
    print(f"slice warm run: {1e3 * t_warm / EPOCHS:.6f} ms/epoch, "
          f"{e_train * EPOCHS / t_warm:.1f} labelled edges/s ({e_train} training edges, "
          f"{EPOCHS} epochs, 2 evaluation epochs)")

    # Reference: the same run on the CPU's plain path, first epochs.
    ref = run_experiment(cfg, data_dir=DATA_DIR, n_epochs=REF_EPOCHS, verbose=False,
                         device="cpu")
    (ref_res,) = ref["results"].values()
    got = res[:REF_EPOCHS]
    losses = [3, 7, 11]
    check(bool(np.allclose(got[:, losses], ref_res[:, losses], rtol=1e-4, atol=0)),
          f"losses differ from the CPU plain path: {got[:, losses]} vs {ref_res[:, losses]}")
    f1s = [2, 6, 10]
    same_nan = np.isnan(got[:, f1s]) == np.isnan(ref_res[:, f1s])
    close = np.nan_to_num(np.abs(got[:, f1s] - ref_res[:, f1s]), nan=0.0) <= 1e-3
    check(bool(np.all(same_nan & close)), "F1 differs from the CPU plain path")
    print(f"slice vs CPU plain path, {REF_EPOCHS} epochs: losses within rtol 1e-4, F1 within 1e-3")
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
    except ImportError as e:
        sys.exit(f"chip_smoke: FAIL: run from the root of a tmgcn checkout ({e})")
    check("jax" not in sys.modules, "jax was imported")

    phase_card()
    phase_build()
    k1, e_train = phase_k1(torch, np)
    k1["launches"] = phase_slice(torch, np, tk, e_train)
    check("jax" not in sys.modules and "tmgcn_tpu" not in sys.modules,
          "the JAX package was imported")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: k1[k] for k in keys}]}))
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

"""SpMM kernel probe on the card: the gather/kernel split, K1's tiers and
packing variants, and the sweep that sets the full-row ``auto`` rule (port
of tools/kernel_probe.py).

    python -m tmgcn_torch.utils.kernel_probe [--nnz 1048576] [--feat 128] \
        [--device cuda|cpu] [--out probe.json]
    python -m tmgcn_torch.utils.kernel_probe --sweep auto [--shapes chess,uci,...] \
        [--out sweep.json]

Without ``--sweep`` it measures, at the JAX tool's shape (T = 16, N = 8192,
~1M random entries, F = 128), each operator's forward: K1 in float32, its
fast tier and its bf16-gather tier at chunk/window variants and with
``sort_cols``, K3 at tile budgets; the split of K1 and K3 into their gather
(PyTorch's row gather) and the kernel alone on gathered chunks; and the
block-dense estimate's ratio on that random graph and on a block-local one
of the same size, with K1, K3 and block-dense timed there. Each record
gives ms, Mnnz/s and the fractions of the card's roofline
(``utils/profiling.spmm_cost`` at the H100's peaks) and of the sector
gather bound (``spmm_gather_bound``).

``--sweep auto`` times forward and forward + backward of the candidates of
``ops.spmm.make_auto_operator`` — K1 with ``sort_cols``, K3 with tile
dedup, block-dense, each in float32 and bf16 — at the full-row shapes the
presets run (the chess train window's Ct at F = 2 and 6, uci_tmgcn_lp's
full-row layer 2, the SEIR propagation, ``spmm_bench``'s r1 and chess2)
and at a banded, block-friendly pattern and a random one at three
densities each. It prints one JSON record a shape (times with the spread
of their reps, bounds, the estimate's ratio, the counts the K3 model
prices, each candidate's error against K1, and the operator each rule
would pick: the committed constants, this run's fit, and the fastest
measured), then the fitted constants of ``ops/spmm.py``
(``fit_costs``, ``fit_limit``).

Times on the card are CUDA events around replays of the call captured as
a CUDA graph (no host time between its launches, as in a training step),
the L2 cache flushed before each, after warm-up: the median of the reps
and their spread (max - min) / median. The first line names the device and the card's name and power
limit as nvidia-smi gives them. It runs on the card unless ``--device
cpu`` is given (the kernels' plain versions, for small sizes only), and a
candidate that fails to build, launch or agree fails the run.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import shutil
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.ops import spmm as ops_spmm
from tmgcn_torch.utils.profiling import spmm_cost, spmm_gather_bound
from tmgcn_torch.utils.spmm_bench import CASES, _card, make_workload

REPO = Path(__file__).resolve().parents[2]
# Copies of the raw files the sweep's preset shapes are built from, under
# the build directory git ignores; removed when the sweep ends.
WORK_DIR = REPO / "build" / "kernel_probe"
CANDIDATES = ("k1", "k1_bf16", "k3", "k3_bf16", "blockdense", "blockdense_bf16")
# A candidate against K1 float32 (bf16: K1 bf16) on the same input:
# float32 sums in another order, scaled by max(1, |ref|); the bf16 tiers
# at 2e-2 of the output's scale (tests/test_pallas_spmm.py:62, 115).
ATOL, BF16_REL = 1e-5, 2e-2


def time_ms(fn, device: torch.device, reps: int = 25, warmup: int = 3) -> dict:
    """Median ms of ``fn()`` over ``reps`` and the reps' spread. On the card
    ``fn`` is captured once as a CUDA graph (as the training loop captures
    its step) and each rep is a replay between CUDA events, the L2 cache
    flushed before it; elsewhere the host clock around ``fn()``."""
    cuda = device.type == "cuda"
    for _ in range(warmup):
        fn()
    run = fn
    if cuda:
        from tmgcn_torch.kernels.spmm_cuda import LaunchLog

        torch.cuda.synchronize(device)
        graph, log = torch.cuda.CUDAGraph(), LaunchLog()
        with log.recording(), torch.cuda.graph(graph):
            fn()

        def run():
            graph.replay()
            log.replayed()

        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    times = []
    for _ in range(reps):
        if cuda:
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            times.append(1e3 * (time.perf_counter() - t0))
    med = statistics.median(times)
    return {"ms": med, "best_ms": min(times), "max_ms": max(times),
            "spread": (max(times) - min(times)) / med if med > 0 else 0.0, "reps": reps}


# --- the probe (the JAX tool's measurements) -------------------------------

VARIANTS = {
    "pallas_f32_256": dict(chunk=256, window=256),
    "pallas_fast_256": dict(chunk=256, window=256, fast=True),
    "pallas_bf16_256": dict(chunk=256, window=256, gather_dtype="bfloat16"),
    "pallas_bf16_512c": dict(chunk=512, window=256, gather_dtype="bfloat16"),
    "pallas_bf16_512w": dict(chunk=512, window=512, gather_dtype="bfloat16"),
    "pallas_f32_512c": dict(chunk=512, window=256),
    "pallas_bf16_w128": dict(chunk=512, window=128, gather_dtype="bfloat16"),
    "pallas_bf16_w128_sort": dict(chunk=512, window=128, gather_dtype="bfloat16", sort_cols=True),
    "pallas_bf16_512c_sort": dict(chunk=512, window=256, gather_dtype="bfloat16", sort_cols=True),
    "pallas_f32_sort": dict(chunk=512, window=256, sort_cols=True),
    "pallas_tiled_f32": dict(chunk=256, window=256, tile_dedup=True),
    "pallas_tiled_bf16": dict(chunk=256, window=256, tile_dedup=True, gather_dtype="bfloat16"),
    "pallas_tiled_bf16_cap32": dict(chunk=256, window=256, tile_dedup=True,
                                    gather_dtype="bfloat16", ut_cap=32),
    "pallas_tiled_bf16_cap128": dict(chunk=256, window=256, tile_dedup=True,
                                     gather_dtype="bfloat16", ut_cap=128),
}


def random_pattern(T: int, N: int, nnz_slice: int, seed: int = 0) -> TemporalCOO:
    """Uniform random entries, the JAX tool's graph (duplicates summed)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, N, (T, nnz_slice))
    c = rng.integers(0, N, (T, nnz_slice))
    v = rng.standard_normal((T, nnz_slice)).astype(np.float32)
    return TemporalCOO.from_slices([(r[t], c[t], v[t]) for t in range(T)], N)


def clustered_pattern(T: int, N: int, nnz_slice: int, seed: int = 0) -> TemporalCOO:
    """The JAX tool's block-local graph: entries within 40 of a slice's
    centres in both row and column (a centre for every 24 entries)."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, max(1, N - 80), (T, nnz_slice // 24 + 1))
    pick = rng.integers(0, centers.shape[1], (T, nnz_slice))
    at = np.take_along_axis(centers, pick, 1)
    r = np.clip(at + rng.integers(-40, 40, (T, nnz_slice)), 0, N - 1)
    c = np.clip(at + rng.integers(-40, 40, (T, nnz_slice)), 0, N - 1)
    v = rng.standard_normal((T, nnz_slice)).astype(np.float32)
    return TemporalCOO.from_slices([(r[t], c[t], v[t]) for t in range(T)], N)


def banded_pattern(T: int, N: int, nnz_slice: int, seed: int = 0, half_width: int = 64):
    """Entries within ``half_width`` of the diagonal: block-friendly."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, N, (T, nnz_slice))
    c = np.clip(r + rng.integers(-half_width, half_width + 1, (T, nnz_slice)), 0, N - 1)
    v = rng.standard_normal((T, nnz_slice)).astype(np.float32)
    return TemporalCOO.from_slices([(r[t], c[t], v[t]) for t in range(T)], N)


def _probe(args, device: torch.device, out: dict) -> None:
    from tmgcn_torch.kernels import spmm_cuda
    from tmgcn_torch.ops import spmm_blockdense

    T, N, F = args.slices, args.nodes, args.feat
    A = random_pattern(T, N, args.nnz // T)
    nnz = int(np.asarray(A.nnz).sum())
    X = torch.from_numpy(np.random.default_rng(1).standard_normal((T, N, F)).astype(np.float32))
    X = X.to(device)
    cost = spmm_cost(nnz, T * N, F)
    floor_ms = 1e3 * cost.roofline_seconds()
    gbound_ms = 1e3 * spmm_gather_bound(nnz, F)
    out.update(nnz=nnz, T=T, N=N, F=F, roofline_bytes=cost.hbm_bytes, roofline_ms=floor_ms,
               gather_bound_ms=gbound_ms, variants={})

    def record(name, fn, n=nnz):
        t = time_ms(fn, device, args.reps)
        rec = {**t, "mnnz_per_s": n / t["ms"] / 1e3,
               "roofline_frac": floor_ms / t["ms"], "gather_bound_frac": gbound_ms / t["ms"]}
        out["variants"][name] = rec
        print(json.dumps({"variant": name, **rec}), flush=True)

    ops = {}
    for name, kw in VARIANTS.items():
        ops[name] = spmm_cuda.make_operator(A, **kw).to(device)
        record(name, lambda op=ops[name]: op(X))

    # The split: the kernel alone on gathered chunks (tile blocks for K3),
    # and the gather alone.
    flat = X.reshape(T * N, F)
    for name in ("pallas_f32_256", "pallas_bf16_256", "pallas_tiled_bf16", "pallas_tiled_f32"):
        op = ops[name]
        src = flat.to(torch.bfloat16) if op.gather_dtype else flat
        g = spmm_cuda.gather_chunks(src, op.packed)
        if isinstance(op.packed, spmm_cuda.PackedTiled):
            kernel = spmm_cuda.windowed_tiled_segment_matmul
            record(name + "_kernel_only", lambda p=op.packed, g=g: kernel(p, g, torch.float32))
        else:
            kernel = spmm_cuda.windowed_segment_matmul
            record(name + "_kernel_only",
                   lambda p=op.packed, g=g: kernel(p, g, out_dtype=torch.float32))
        record(name + "_gather_only", lambda s=src, p=op.packed: spmm_cuda.gather_chunks(s, p))

    from tmgcn_torch.ops.spmm_rowsplit import flatten_stream

    g_r, g_c, _ = flatten_stream(A)
    out["blockdense_random_ratio"] = spmm_blockdense.estimate(g_r, g_c)["ratio"]
    A2 = clustered_pattern(T, N, args.nnz // T)
    g_r2, g_c2, _ = flatten_stream(A2)
    out["clustered_nnz"] = len(g_r2)
    out["blockdense_clustered_ratio"] = spmm_blockdense.estimate(g_r2, g_c2)["ratio"]
    for pattern, (rr, cc) in (("random", (g_r, g_c)), ("clustered", (g_r2, g_c2))):
        counts = ops_spmm.auto_counts(rr, cc, T * N, T * N, F, 2)
        out[f"k3_model_{pattern}_bf16"] = {**counts, "tiled_ratio": ops_spmm.tiled_ratio(counts)}
    print(json.dumps({k: out[k] for k in ("blockdense_random_ratio", "blockdense_clustered_ratio",
                                          "k3_model_random_bf16", "k3_model_clustered_bf16")}),
          flush=True)
    for name, make in {
        "clustered_pallas_bf16": lambda: spmm_cuda.make_operator(
            A2, chunk=512, window=256, gather_dtype="bfloat16", sort_cols=True),
        "clustered_pallas_tiled_bf16": lambda: spmm_cuda.make_operator(
            A2, chunk=256, window=256, tile_dedup=True, gather_dtype="bfloat16"),
        "clustered_blockdense": lambda: spmm_blockdense.make_operator(A2, mode="exact"),
        "clustered_blockdense_bf16": lambda: spmm_blockdense.make_operator(A2, mode="bf16"),
    }.items():
        op = make().to(device)
        record(name, lambda op=op: op(X), n=out["clustered_nnz"])
        del op


# --- the sweep of the full-row rule ----------------------------------------


def _preset_window(name: str, dataset_dir: str | None, drop_last: bool = False) -> TemporalCOO:
    """The train window's adjacency of a preset's data (its last slice
    dropped for link prediction's model input), built from a copy of the
    raw file under WORK_DIR (SEIR: generated from the seed)."""
    from tmgcn_torch.configs.build import build_data
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.preprocess.datasets import REGISTRY

    cfg = get_preset(name)
    data_dir = None
    if dataset_dir is not None:
        data_dir = WORK_DIR / cfg.dataset
        data_dir.mkdir(parents=True, exist_ok=True)
        raw = "out.chess.csv" if cfg.dataset == "chess" else REGISTRY[cfg.dataset].filename
        shutil.copy(REPO / dataset_dir / raw, data_dir / raw)
    A = build_data(cfg, data_dir=data_dir).adj["train"]
    return A.slice_window(0, A.n_slices - 1) if drop_last else A


def sweep_shapes(args) -> dict:
    """{name: (builder of the host TemporalCOO, F)}: the presets' full-row
    shapes, and the banded and random patterns at ``args``' sizes (T slices
    of N nodes, F features; a sixteenth, a quarter and all of ``--nnz``
    entries)."""
    T, N, F = args.slices, args.nodes, args.feat
    chess = functools.cache(lambda: _preset_window("chess_tmgcn_cls", "data/chess"))
    shapes = {
        "chess_train_F2": (chess, 2),
        "chess_train_F6": (chess, 6),
        "uci_layer2_F6": (lambda: _preset_window("uci_tmgcn_lp", "data/synthetic/uci",
                                                 drop_last=True), 6),
        "seir_propagation_F5": (lambda: _preset_window("seir_wdgcn_reg_tuned", None), 5),
    }
    for case, (_, shape) in CASES.items():
        shapes[f"spmm_bench_{case}_F{shape['F']}"] = (
            lambda shape=shape: make_workload(**shape)[0], shape["F"])
    for i, total in enumerate((args.nnz // 16, args.nnz // 4, args.nnz)):
        per = max(1, total // T)
        shapes[f"banded_{i}_F{F}"] = (lambda per=per, i=i: banded_pattern(T, N, per, seed=i), F)
        shapes[f"random_{i}_F{F}"] = (lambda per=per, i=i: random_pattern(T, N, per, seed=i), F)
    return shapes


def candidate(A: TemporalCOO, name: str):
    """A candidate operator of the full-row rule, packed on the host as
    make_auto_operator packs it."""
    from tmgcn_torch.kernels import spmm_cuda
    from tmgcn_torch.ops import spmm_blockdense

    bf16 = name.endswith("_bf16")
    gdt = "bfloat16" if bf16 else None
    kw = dict(chunk=ops_spmm.AUTO_CHUNK, window=ops_spmm.AUTO_WINDOW, gather_dtype=gdt)
    if name.startswith("k1"):
        return spmm_cuda.make_operator(A, sort_cols=True, **kw)
    if name.startswith("k3"):
        return spmm_cuda.make_operator(A, tile_dedup=True, ut_cap=ops_spmm.AUTO_UT_CAP, **kw)
    return spmm_blockdense.make_operator(A, mode="bf16" if bf16 else "exact")


def _close(out: torch.Tensor, ref: torch.Tensor, bf16: bool) -> tuple[float, float]:
    """(max abs error, its tolerance) of a candidate against its class's K1."""
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    return err, (BF16_REL if bf16 else ATOL) * scale


def measure_shape(name: str, A: TemporalCOO, F: int, device: torch.device, reps: int) -> dict:
    """One sweep record without its picks: each candidate's forward and
    forward + backward, its error, the bounds and the rule's counts."""
    from tmgcn_torch.ops.spmm_rowsplit import flatten_stream

    T, N = A.n_slices, A.n_nodes
    g_rows, g_cols, _ = flatten_stream(A)
    nnz = len(g_rows)
    gen = np.random.default_rng(7)
    X = torch.from_numpy(gen.standard_normal((T, N, F)).astype(np.float32)).to(device)
    G = torch.from_numpy(gen.standard_normal((T, N, F)).astype(np.float32)).to(device)
    rec = {"shape": name, "T": T, "N": N, "F": F, "nnz": nnz,
           "counts": {"f32": ops_spmm.auto_counts(g_rows, g_cols, T * N, T * N, F, 4)},
           "bound_ms": {}, "ops": {}}
    rec["counts"]["bf16"] = {**rec["counts"]["f32"], "sectors": max(1, math.ceil(F * 2 / 32)),
                             "tile_sectors": max(1, math.ceil(8 * F * 2 / 32))}
    rec["blockdense_ratio"] = rec["counts"]["f32"]["blockdense_ratio"]
    for cls, itemsize in (("f32", 4), ("bf16", 2)):
        # Forward and backward: each moves the function's bytes once.
        rec["bound_ms"][cls] = 2e3 * spmm_cost(nnz, T * N, F, itemsize).roofline_seconds()
    refs = {}
    for cand in CANDIDATES:
        bf16 = cand.endswith("_bf16")
        try:
            op = candidate(A, cand).to(device)
        except ValueError as e:  # block-dense over its byte budget
            rec["ops"][cand] = {"error": str(e)}
            continue
        x = X.detach().requires_grad_(True)

        def fwd(op=op):
            return op(X)

        def fwdbwd(op=op, x=x):
            return torch.autograd.grad(op(x), x, G)[0]

        y, dx = fwd(), fwdbwd()
        if cand in ("k1", "k1_bf16"):
            refs[bf16] = (y, dx)
        err = max(_close(y, refs[bf16][0], bf16)[0], _close(dx, refs[bf16][1], bf16)[0])
        tol = max(_close(y, refs[bf16][0], bf16)[1], _close(dx, refs[bf16][1], bf16)[1])
        if not err <= tol:
            raise AssertionError(f"{name}: {cand} differs from K1 by {err} > {tol}")
        rec["ops"][cand] = {"fwd": time_ms(fwd, device, reps),
                            "fwdbwd": time_ms(fwdbwd, device, reps), "max_abs_err": err}
        del op, y, dx
    return rec


def _fwdbwd_ms(rec: dict, cand: str) -> float | None:
    op = rec["ops"].get(cand, {})
    return op["fwdbwd"]["ms"] if "fwdbwd" in op else None


def fit_costs(samples: list[tuple[dict, float]], kernel: str) -> dict:
    """The model's costs for ``kernel`` ("k1" or "k3"): non-negative least
    squares of the relative error over (counts, measured ms of a forward
    and backward) samples; terms that are 0 in every sample cost 0."""
    from scipy.optimize import nnls

    keys = ("launch", "entry", "chunk", "gather")
    D = np.array([[ops_spmm.model_terms(c, kernel)[k] for k in keys] for c, _ in samples], float)
    t = np.array([ms for _, ms in samples], float)
    D, ones = D / t[:, None], np.ones(len(t))
    scale = np.abs(D).max(axis=0)
    live = scale > 0
    coef = np.zeros(len(keys))
    if live.any():
        sol, _ = nnls(D[:, live] / scale[live], ones)
        coef[live] = sol / scale[live]
    return {k: float(v) for k, v in zip(keys, coef)}


def fit_limit(points: list[tuple[float, float]]) -> float:
    """A rule's limit from (predictor, measured candidate ms / K1 ms) points:
    1 / max(measured / predictor). With the measured ratio taken as
    proportional to the predictor, this is the largest limit under which
    no point the rule sends to the candidate ran slower than K1 there; 0
    without a point."""
    worst = max((r / p for p, r in points if p > 0), default=math.inf)
    return 0.0 if not math.isfinite(worst) or worst <= 0 else 1.0 / worst


def fit(records: list[dict]) -> dict:
    """The constants of ops/spmm.py from the sweep's records: the K1 and K3
    models' costs (float32 and bf16 together, each at its sectors), then
    AUTO_TILED_RATIO from the model's K3 / K1 ratio against the measured
    one, and AUTO_BLOCKDENSE_RATIO from the estimate's ratio against
    block-dense / K1 measured, each class against its own K1."""
    samples = {"k1": [], "k3": []}
    for rec in records:
        for cls in ("f32", "bf16"):
            sfx = "_bf16" if cls == "bf16" else ""
            for kernel in samples:
                ms = _fwdbwd_ms(rec, kernel + sfx)
                if ms is not None:
                    samples[kernel].append((rec["counts"][cls], ms))
    k1, k3 = fit_costs(samples["k1"], "k1"), fit_costs(samples["k3"], "k3")
    tiled, blockdense = [], []
    for rec in records:
        for cls in ("f32", "bf16"):
            sfx = "_bf16" if cls == "bf16" else ""
            base = _fwdbwd_ms(rec, "k1" + sfx)
            t3, tb = _fwdbwd_ms(rec, "k3" + sfx), _fwdbwd_ms(rec, "blockdense" + sfx)
            if base and t3 is not None:
                tiled.append((ops_spmm.tiled_ratio(rec["counts"][cls], k1, k3), t3 / base))
            if base and tb is not None:
                blockdense.append((rec["blockdense_ratio"], tb / base))
    return {"AUTO_BLOCKDENSE_RATIO": fit_limit(blockdense), "AUTO_TILED_RATIO": fit_limit(tiled),
            "AUTO_K1_COSTS": k1, "AUTO_K3_COSTS": k3}


def picks(rec: dict, fitted: dict) -> dict:
    """The operator each rule picks at this shape, by precision class: the
    committed constants, this run's fit, and the fastest measured forward
    + backward."""
    out = {}
    for cls in ("f32", "bf16"):
        sfx = "_bf16" if cls == "bf16" else ""
        counts = rec["counts"][cls]
        fit_ratio = ops_spmm.tiled_ratio(counts, fitted["AUTO_K1_COSTS"], fitted["AUTO_K3_COSTS"])
        times = {b: _fwdbwd_ms(rec, c + sfx) for b, c in
                 (("windowed", "k1"), ("tiled", "k3"), ("blockdense", "blockdense"))}
        out[cls] = {
            "tiled_ratio": {"committed": ops_spmm.tiled_ratio(counts), "fitted": fit_ratio},
            "committed": ops_spmm.auto_pick(rec["blockdense_ratio"], ops_spmm.tiled_ratio(counts)),
            "fitted": ops_spmm.auto_pick(rec["blockdense_ratio"], fit_ratio,
                                         fitted["AUTO_BLOCKDENSE_RATIO"],
                                         fitted["AUTO_TILED_RATIO"]),
            "fastest": min((b for b in times if times[b] is not None), key=times.get),
        }
    return out


def _sweep(args, device: torch.device, out: dict) -> None:
    shapes = sweep_shapes(args)
    names = list(shapes) if not args.shapes else [
        n for n in shapes if any(n.startswith(s) for s in args.shapes.split(","))]
    records = []
    try:
        for name in names:
            build, F = shapes[name]
            t0 = time.perf_counter()
            A = build()
            rec = measure_shape(name, A, F, device, args.reps)
            rec["seconds"] = time.perf_counter() - t0
            records.append(rec)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    fitted = fit(records)
    for rec in records:
        rec["picks"] = picks(rec, fitted)
        print(json.dumps(rec), flush=True)
    committed = {k: getattr(ops_spmm, k) for k in fitted}
    print(json.dumps({"fitted": fitted, "committed": committed}), flush=True)
    out.update(records=records, fitted=fitted, committed=committed)


def main(argv=None) -> dict:
    from tmgcn_torch.configs.build import resolve_device

    ap = argparse.ArgumentParser(prog="tmgcn_torch.utils.kernel_probe")
    ap.add_argument("--sweep", choices=["auto"], default=None,
                    help="time the full-row auto rule's candidates and fit its constants")
    ap.add_argument("--shapes", default="",
                    help="comma list of sweep shape name prefixes (default: all)")
    ap.add_argument("--nnz", type=int, default=1 << 20)
    ap.add_argument("--feat", type=int, default=128)
    ap.add_argument("--nodes", type=int, default=8192)
    ap.add_argument("--slices", type=int, default=16)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the plain versions)")
    ap.add_argument("--out", default=None, help="also write the records here as JSON")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    out = {"device": str(device), "card": _card(device)}
    print(json.dumps(out), flush=True)
    if args.sweep:
        _sweep(args, device, out)
    else:
        _probe(args, device, out)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

"""SpMM implementation microbenchmark: rate + roofline fraction per impl
(port of tmgcn_tpu.utils.spmm_bench).

    python -m tmgcn_torch.utils.spmm_bench [--quick] [--fwd-only] \
        [--case r1|chess2|all] [--device cuda|cpu]

Benchmarks the port's SpMM implementations (the flat gather and sorted
segment sum of ``spmm(impl="jnp")``, row-split, and the windowed CUDA
kernel K1 in its float32 and fast tiers) on (a) the round-1 comparison
shape (1M nnz, N=8192, F=128) and (b) the chess layer-2 shape (T=79,
N=7301, ~20k nnz/slice, F=8), printing Mnnz/s and the fraction of the
card's bandwidth/compute roofline (utils/profiling.spmm_cost) for each, one
JSON line a record, with the JAX script's records and tags. A gather-only
diagnostic isolates where the time goes.

The first line names the device and, on the card, its name and power
limit as nvidia-smi gives them. It runs on the card unless ``--device cpu``
is given, and fails without one. A configuration that fails (a kernel that
does not build or launch) fails the run: no record hides it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.utils.profiling import measure, spmm_cost

PALLAS_CONFIGS = ((256, 256), (512, 256), (1024, 256), (512, 512), (1024, 512))
# --case name -> (record case name, make_workload's shape).
CASES = {
    "r1": ("r1_1Mnnz_F128", {"T": 16, "N": 8192, "nnz_per_slice": 62_500, "F": 128}),
    "chess2": ("chess2_F8", {"T": 79, "N": 7301, "nnz_per_slice": 20_000, "F": 8}),
}


def make_workload(T, N, nnz_per_slice, F, seed=0):
    """(A, X): random slices of ``nnz_per_slice`` entries (duplicates
    summed) as a host TemporalCOO, and (T, N, F) float32 features on the
    CPU; the JAX package's arrays from the same seed, bit for bit."""
    rng = np.random.default_rng(seed)
    slices = []
    for _ in range(T):
        r = rng.integers(0, N, nnz_per_slice)
        c = rng.integers(0, N, nnz_per_slice)
        v = rng.random(nnz_per_slice)
        slices.append((r, c, v))
    A = TemporalCOO.from_slices(slices, N, dtype=np.float32)
    X = torch.from_numpy(rng.standard_normal((T, N, F)).astype(np.float32))
    return A, X


def bench_case(name, A, X, fwd_only=False, quick=False, iters=20):
    """Time every impl on host-packed ``A`` and features ``X`` (on the
    device to run on); one record a configuration, in the JAX script's
    order and with its tags."""
    from tmgcn_torch.kernels import spmm_cuda
    from tmgcn_torch.ops import spmm_rowsplit
    from tmgcn_torch.ops.spmm import spmm

    device = X.device
    nnz = int(np.asarray(A.nnz).sum())
    T, N, F = X.shape[0], A.n_nodes, X.shape[-1]
    cost = spmm_cost(nnz, T * N, F)
    G = torch.from_numpy(
        np.random.default_rng(1).standard_normal(X.shape).astype(np.float32)
    ).to(device)

    results = []

    def run(tag, fn, *args):
        dt = measure(fn, *args, iters=iters)
        rec = {
            "case": name,
            "impl": tag,
            "mnnz_per_s": round(nnz / dt / 1e6, 1),
            "ms": round(dt * 1e3, 3),
            "roofline_frac": round(cost.roofline_fraction(dt), 3),
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)

    def fwdbwd(o, x):
        """The gradient of <o(x), G> with respect to x: Aᵀ G, summed."""
        xx = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(o(xx), xx, G)
        return dx.sum()

    # Diagnostics: where does the time go?
    flat_cols = np.concatenate(
        [np.asarray(A.cols)[t, : np.asarray(A.nnz)[t]] + t * N for t in range(T)]
    ).astype(np.int32)
    cols_dev = torch.from_numpy(flat_cols).to(device)
    run("gather_only", lambda c, x: x.reshape(T * N, F).index_select(0, c).sum(dim=0),
        cols_dev, X)

    run("jnp_flat", lambda a, x: spmm(a, x).sum(), A.to(device), X)

    ks = (16,) if quick else (8, 16, 32, 64)
    for k in ks:
        op = spmm_rowsplit.make_operator(A, k=k).to(device)
        run(f"rowsplit_k{k}", lambda o, x: o(x).sum(), op, X)
        if not fwd_only:
            run(f"rowsplit_k{k}_fwdbwd", fwdbwd, op, X)

    pallas_cfgs = PALLAS_CONFIGS[:1] if quick else PALLAS_CONFIGS
    for chunk, window in pallas_cfgs:
        # The fast tier reads the same packing: one packing serves both.
        packed_op = spmm_cuda.make_operator(A, chunk=chunk, window=window).to(device)
        for fast in ((False,) if quick else (False, True)):
            op = dataclasses.replace(packed_op, fast=fast)
            tag = f"pallas_c{chunk}_w{window}" + ("_fast" if fast else "")
            run(tag, lambda o, x: o(x).sum(), op, X)
            if not fwd_only and chunk == 256 and window == 256 and not fast:
                run(tag + "_fwdbwd", fwdbwd, op, X)
    return results


def _card(device: torch.device) -> str | None:
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def main(argv=None):
    from tmgcn_torch.configs.build import resolve_device

    ap = argparse.ArgumentParser(prog="tmgcn_torch.utils.spmm_bench")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--case", choices=["r1", "chess2", "all"], default="all")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print(json.dumps({"device": str(device), "card": _card(device)}), flush=True)

    out = []
    for case, (name, shape) in CASES.items():
        if args.case in (case, "all"):
            A, X = make_workload(**shape)
            out += bench_case(name, A, X.to(device), args.fwd_only, args.quick)
    return out


if __name__ == "__main__":
    main()

"""Profiling and roofline accounting (port of tmgcn_tpu.utils.profiling).

A ``torch.profiler`` trace helper and analytic cost models of the hot ops,
so that a measured kernel time can be stated as a fraction of the card's
roofline. This module is the port's one home of the card's peak rates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from pathlib import Path

import torch

# NVIDIA H100 SXM 80GB HBM3, NVIDIA's data sheet (dense rates, 700 W):
# float32 outside the tensor cores, bf16 on the dense tensor cores, HBM3.
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_BF16 = 989e12
PEAK_HBM_BYTES = 3.35e12
# The card's memory moves whole 32-byte sectors.
SECTOR_BYTES = 32


@dataclasses.dataclass(frozen=True)
class OpCost:
    flops: float
    hbm_bytes: float

    def roofline_seconds(
        self, peak_flops: float = PEAK_FLOPS_F32, peak_bw: float = PEAK_HBM_BYTES
    ) -> float:
        """Time lower bound: max of compute-bound and bandwidth-bound."""
        return max(self.flops / peak_flops, self.hbm_bytes / peak_bw)

    def roofline_fraction(self, measured_seconds: float, **kw) -> float:
        return self.roofline_seconds(**kw) / measured_seconds


def spmm_gather_bound(nnz: int, feat: int, peak_bw: float = PEAK_HBM_BYTES) -> float:
    """Seconds floor for gather-based SpMM with random column access.

    A random row gather on this card moves whole 32-byte sectors, so one
    float32 feature row of ``feat`` values costs ceil(feat * 4 / 32) * 32
    bytes, whatever its neighbours. Any SpMM built on a per-nonzero gather
    is bounded by one such row per nonzero when columns have no locality;
    ``spmm_cost`` is the idealized byte count.
    """
    row_bytes = math.ceil(feat * 4 / SECTOR_BYTES) * SECTOR_BYTES
    return nnz * row_bytes / peak_bw


def spmm_cost(nnz: int, n_rows: int, feat: int, dtype_bytes: int = 4) -> OpCost:
    """Gather/scale/segment-reduce SpMM: 2*nnz*F FLOPs.

    HBM traffic lower bound: indices + values once, one feature row read
    per nonzero (worst case, no reuse), output written once.
    """
    return OpCost(
        flops=2.0 * nnz * feat,
        hbm_bytes=nnz * (8 + dtype_bytes) + nnz * feat * dtype_bytes
        + n_rows * feat * dtype_bytes,
    )


def m_transform_cost(T: int, n_nodes: int, feat: int, band: int | None = None,
                     dtype_bytes: int = 4) -> OpCost:
    """(T, T) x (T, N*F) matmul; banded M does band*T*N*F MACs."""
    k = band if band is not None else T
    return OpCost(
        flops=2.0 * k * T * n_nodes * feat,
        hbm_bytes=2 * T * n_nodes * feat * dtype_bytes + T * T * dtype_bytes,
    )


def edge_readout_cost(n_edges: int, feat: int, n_classes: int,
                      dtype_bytes: int = 4) -> OpCost:
    return OpCost(
        flops=2.0 * n_edges * 2 * feat * n_classes,
        hbm_bytes=n_edges * (2 * feat + n_classes) * dtype_bytes,
    )


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block with torch.profiler (the CPU, and the card where
    there is one) and write its Chrome trace to ``log_dir/trace.json``
    (chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(log_dir / "trace.json"))


def _fetch_scalar(out) -> float:
    """One element of ``out`` on the host: waits for the work that made it."""
    return float(torch.as_tensor(out).reshape(-1)[0])


def measure(fn, *args, iters: int = 30) -> float:
    """Steady-state seconds per call; forces completion via scalar fetch.

    ``fn`` should return a tensor. One of its elements is fetched after the
    warm call and after the loop, so a launch still queued on the card
    cannot end the timing early.
    """
    out = fn(*args)
    _fetch_scalar(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _fetch_scalar(out)
    return (time.perf_counter() - t0) / iters

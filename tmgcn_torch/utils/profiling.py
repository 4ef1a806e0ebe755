"""Profiling and roofline accounting (port of tmgcn_tpu.utils.profiling).

A ``torch.profiler`` trace helper and analytic cost models of the hot ops,
so that a measured kernel time can be stated as a fraction of the card's
roofline. This module is the port's one home of the card's peak rates.

It is also the port's span recorder. ``span(name)`` marks a stretch of the
program where the work happens (the data build, the adapter's phases, a
trial, a chunk of replays, an evaluation epoch), and ``spanned(name)`` a
whole function as one, as a decorator; ``recording()`` is the recorder's one
switch, off by default. Off, a span reads the host clock twice and
records nothing (``span.seconds`` is still measured); on, it appends a
record (name, parent, start and end on ``time.perf_counter_ns``,
attributes) and opens a ``torch.profiler.record_function`` range of the
same name, so that under a profiler each span is a host range in the same
trace as the kernels. A ``loop.trial`` span takes the next trial id, and
every span opened inside it carries that id as its ``trial`` attribute.
No span sits on a per-replay path: the finest is one chunk of replays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import statistics
import time
from pathlib import Path

import torch

TRIAL = "loop.trial"

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
    there is one) and the span recorder on, and write its Chrome trace to
    ``log_dir/trace.json`` (chrome://tracing or Perfetto; each span is a
    host range there) and the spans to ``log_dir/spans.json``
    ({"records": records(), "summary": summary()})."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with recording():
            yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(log_dir / "trace.json"))
        (log_dir / "spans.json").write_text(
            json.dumps({"records": records(), "summary": summary()}, indent=1))


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


# The recorder's state: whether it is on, its records (in the order the
# spans opened), the records of the spans open now (innermost last), the
# trial ids handed out, and a generation that turning it on advances.
_on = False
_records: list[dict] = []
_open: list[dict] = []
_trials = 0
_generation = 0


class span:
    """A context manager around one stretch of the program.

    ``span(name, sync=False, **attrs)``; ``.seconds`` is its host-clock
    duration, on or off. With the recorder on, entering appends a record
    and opens a ``record_function`` range; ``set(**attrs)`` adds attributes
    known only inside (a count, the operator a rule picked); ``sync=True``
    synchronises the card before the span closes, so it covers the device
    work it queued. Off, ``sync`` and ``set`` do nothing."""

    __slots__ = ("name", "sync", "attrs", "t0", "t1", "_rec", "_range")

    def __init__(self, name: str, sync: bool = False, **attrs):
        self.name = name
        self.sync = sync
        self.attrs = attrs
        self._rec = None

    def __enter__(self) -> "span":
        if _on:
            self._begin()
        self.t0 = time.perf_counter_ns()
        if self._rec is not None:
            self._rec["start_ns"] = self.t0
        return self

    def __exit__(self, *exc) -> bool:
        if self._rec is not None and self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter_ns()
        if self._rec is not None:
            self._end()
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def set(self, **attrs) -> None:
        if self._rec is not None:
            self._rec["attrs"].update(attrs)

    def _begin(self) -> None:
        global _trials
        parent = _open[-1] if _open else None
        attrs = dict(self.attrs)
        if self.name == TRIAL:
            attrs["trial"] = _trials
            _trials += 1
        elif parent is not None and "trial" in parent["attrs"]:
            attrs.setdefault("trial", parent["attrs"]["trial"])
        self._rec = {"id": len(_records), "name": self.name,
                     "parent": parent["id"] if parent is not None else None,
                     "start_ns": None, "end_ns": None, "attrs": attrs, "gen": _generation}
        _records.append(self._rec)
        _open.append(self._rec)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()

    def _end(self) -> None:
        rec = self._rec
        self._range.__exit__(None, None, None)
        if rec["gen"] == _generation:  # not a span of a recording since replaced
            rec["end_ns"] = self.t1
            while _open and _open.pop() is not rec:
                pass


def spanned(name: str, sync: bool = False, result_attrs=None):
    """The decorated function's calls as ``name`` spans (``sync`` as
    ``span`` takes it); ``result_attrs(result)``, where given, is a dict of
    attributes set on the span from what the call returned, read only while
    the recorder is on."""

    def decorate(fn):
        @functools.wraps(fn)
        def spanned_fn(*args, **kwargs):
            with span(name, sync=sync) as s:
                out = fn(*args, **kwargs)
                if result_attrs is not None and s._rec is not None:
                    s.set(**result_attrs(out))
                return out

        return spanned_fn

    return decorate


class recording:
    """The recorder's switch: ``recording()`` turns it on (from off, with a
    new list of records), ``recording(False)`` turns it off; as a context
    manager it is on for the block, then as it was before."""

    def __init__(self, on: bool = True):
        global _on, _records, _open, _trials, _generation
        self._before = _on
        if on and not _on:
            _records, _open, _trials = [], [], 0
            _generation += 1
        _on = on

    def __enter__(self) -> "recording":
        return self

    def __exit__(self, *exc) -> bool:
        global _on
        _on = self._before
        return False


def records() -> list[dict]:
    """The closed spans of the newest recording, in the order they opened:
    {"id", "name", "parent" (its parent's id, or None), "start_ns",
    "end_ns", "attrs"}."""
    return [{k: v for k, v in r.items() if k != "gen"} for r in _records
            if r["end_ns"] is not None]


def summary(recs: list[dict] | None = None) -> dict:
    """Per span name of ``recs`` (default: ``records()``): its count, total
    seconds, self seconds (each span's duration less the time its child
    spans cover) and the median milliseconds of one span."""
    recs = records() if recs is None else recs
    children_ns: dict[int, int] = {}
    for r in recs:
        if r["parent"] is not None:
            children_ns[r["parent"]] = children_ns.get(r["parent"], 0) + r["end_ns"] - r["start_ns"]
    by_name: dict[str, list] = {}
    for r in recs:
        d = r["end_ns"] - r["start_ns"]
        by_name.setdefault(r["name"], []).append((d, d - children_ns.get(r["id"], 0)))
    return {name: {"count": len(ds), "total_s": sum(d for d, _ in ds) / 1e9,
                   "self_s": sum(s for _, s in ds) / 1e9,
                   "median_ms": statistics.median(d for d, _ in ds) / 1e6}
            for name, ds in by_name.items()}

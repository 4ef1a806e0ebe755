"""The device trace of a traced run, and what is read from it.

``Profile`` wraps ``torch.profiler`` (CPU and CUDA activities) around a
stretch of whole blocks, with a ``bench.window`` range from its first to
its last boundary. ``Trace`` holds the events as plain tuples, so the
readers (and the tests, on synthetic events) need no profiler: device
operations as (name, start_us, end_us), host operations the same way, and
the window.
"""

from __future__ import annotations

import dataclasses

WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]  # us
    device_ops: list[tuple[str, float, float]]
    host_ops: list[tuple[str, float, float]]
    steps: int  # the epochs or steps the window holds

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_intervals(tr: Trace) -> list[tuple[float, float]]:
    """Device-busy intervals clipped to the window."""
    lo, hi = tr.window
    return union((max(a, lo), min(b, hi)) for _, a, b in tr.device_ops if b > lo and a < hi)


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) / 1e6


def idle_gaps(tr: Trace) -> list[tuple[float, float]]:
    """The window's stretches in which no device operation ran."""
    lo, hi = tr.window
    gaps, at = [], lo
    for a, b in busy_intervals(tr):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def _host_label(tr: Trace, a: float, b: float) -> str:
    """What the host was doing in a gap: the innermost host operation that
    covers its middle, or the one that was running longest inside it."""
    mid = (a + b) / 2
    covering = [(e - s, n) for n, s, e in tr.host_ops if s <= mid <= e and n != WINDOW]
    if covering:
        return min(covering)[1]
    inside = [(min(e, b) - max(s, a), n) for n, s, e in tr.host_ops
              if e > a and s < b and n != WINDOW]
    return max(inside)[1] if inside else "host (no traced operation)"


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing (seconds, as measured)."""
    by_name: dict[str, float] = {}
    lo, hi = tr.window
    for n, a, b in tr.device_ops:
        if b > lo and a < hi:
            by_name[n[:160]] = by_name.get(n[:160], 0.0) + (min(b, hi) - max(a, lo)) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(tr), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_host_label(tr, a, b)[:160], (b - a) / 1e6] for a, b in gaps]}


class Profile:
    """A torch.profiler run; ``begin()`` and ``end()`` mark the window
    (at two block boundaries), ``trace(steps)`` reads it out."""

    def __init__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._range = None

    def begin(self) -> None:
        import torch

        self._prof.start()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def end(self) -> None:
        self._range.__exit__(None, None, None)
        self._prof.stop()

    def trace(self, steps: int) -> Trace:
        from torch.autograd import DeviceType

        device_ops, host_ops, window = [], [], None
        for e in self._prof.events():
            span = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == DeviceType.CUDA:
                # A user range's device copy spans its kernels: not an operation.
                if not getattr(e, "is_user_annotation", False):
                    device_ops.append(span)
            else:
                host_ops.append(span)
                if e.name == WINDOW:
                    window = span[1:]
        if window is None:
            raise RuntimeError("the profile holds no window range")
        return Trace(window, device_ops, host_ops, steps)


KERNELS = "row_segment_matmul_kernel"


def kernel_roofline(ctx) -> float | None:
    """Per cent of the roofline of the hand-written sparse products a step
    hands the kernels: their least time (``ctx.cost.kernel_products``) over
    the device time of their launches in the traced window.

    K1, K2 and K3 are instances of one CUDA template
    (``tmgcn_torch/kernels/csrc/row_segment_matmul.cuh``), matched by its
    function name. Where the trace holds none, or not as many launches as
    the traced steps' products (the kernels then compute something else),
    there is nothing to read."""
    tr = ctx.trace
    if tr is None or ctx.cost is None:
        return None
    lo, hi = tr.window
    spans = [(a, b) for n, a, b in tr.device_ops if KERNELS in n and a >= lo and b <= hi]
    products = ctx.cost.kernel_products(ctx.counts, ctx.cfg)
    if not spans or not products or len(spans) != tr.steps * len(products):
        return None
    least = tr.steps * sum(p.least_s for p in products)
    return 100.0 * least / (sum(b - a for a, b in spans) / 1e6)

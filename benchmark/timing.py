"""Host-clock timing of captured chunks, and the process's start.

``timed_chunks`` is a copy of ``tmgcn_torch.utils.profile_slice.timed_chunks``
(the benchmark keeps its yardstick): a warm chunk, a probe, the chunk grown
until a round covers ``min_round_s``, then the median of ``rounds`` rounds,
each chunk ending in a fetch that waits for its epochs.
"""

from __future__ import annotations

import math
import os
import time
from pathlib import Path

import numpy as np


def timed_chunks(runs: dict, n_timed: int, rounds: int = 5, min_round_s: float = 0.25) -> dict:
    """Seconds per epoch of each ``run(n)`` (n epochs, returning a device
    tensor whose fetch waits for them), the median of the rounds; the runs
    take their rounds in turns."""
    sizes = {}
    for name, run in runs.items():
        run(n_timed).cpu()
        t0 = time.perf_counter()
        run(n_timed).cpu()
        probe = time.perf_counter() - t0
        n = n_timed
        if probe < min_round_s:
            n *= math.ceil(min_round_s / max(probe, 1e-4))
            run(n).cpu()
        sizes[name] = n
    per_round = {name: [] for name in runs}
    for _ in range(rounds):
        for name, run in runs.items():
            t0 = time.perf_counter()
            run(sizes[name]).cpu()
            per_round[name].append((time.perf_counter() - t0) / sizes[name])
    return {name: float(np.median(times)) for name, times in per_round.items()}


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (from
    /proc/self/stat, to a clock tick); now where that cannot be read."""
    now = time.perf_counter()
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))

"""Whole trials as users run them: each from fresh parameters drawn from
the seed, ``epochs`` epochs with an evaluation every ``eval_every``,
through the task's trial entry (the loop's own). The set-up drives trial
0 through its first block (``eval_every`` + 1 epochs: the capture, the
first evaluation); the window opens at that boundary and is cut at the
first block boundary past its seconds, so a trial is cut there.

Compared (``correctness``): the losses of the first ``compared_steps``,
the first gradient, the change over trial 0's first block (the first
state past step 1 the loop's checkpointer shows) and the evaluation after
step 1.
"""

from __future__ import annotations

import time

from benchmark import program, timing
from benchmark import trace as tracing
from benchmark.reference import train as reftrain

MEASURED_BLOCKS = 2  # unprofiled blocks for the evaluation's overhead
PROFILED_BLOCKS = 2


def window(cell, built, draw, seconds: float, device) -> dict:
    e = cell.traffic["drive"]["eval_every"]
    hook = program.BlockHook(start_epoch=e, seconds=seconds, snap_epochs=(0, e))
    win = program.run_trials(cell.task, built, draw, hook, device)
    win["window_start"] = hook.window_start
    win["block_walls"] = [b[2] - a[2] for a, b in zip(hook.boundaries, hook.boundaries[1:])
                          if a[0] == b[0] and b[1] - a[1] == e]
    win["state"] = hook.snaps
    return win


class _Segment:
    """The traced run's checkpointer: records the boundaries of the first
    blocks, then profiles ``PROFILED_BLOCKS`` whole blocks and stops."""

    def __init__(self, e: int, profile):
        self.e, self.profile = e, profile
        self.first = e * (1 + MEASURED_BLOCKS)
        self.boundaries: list[tuple[int, int, float]] = []

    def restore(self):
        return None

    def save(self, epoch, *args, **kwargs):
        if epoch <= self.first:
            self.boundaries.append((0, epoch, time.perf_counter()))
        if epoch == self.first:
            self.profile.begin()
        elif epoch == self.first + self.e * PROFILED_BLOCKS:
            self.profile.end()
            raise program.Cut(epoch, None)


def traced(cell, built, run: dict, draw) -> dict:
    """From one fresh draw: plain epochs of the trials' step timed in
    chunks; then a trial from the same draw, whose first blocks' walls
    (unprofiled) give the evaluation's overhead, and whose next blocks are
    profiled."""
    e = cell.traffic["drive"]["eval_every"]
    v = draw()
    ch = cell.task.chunks(built, v, capacity=1)

    def plain(n):
        ch(n, plain=True)
        return ch.stats(1)

    plain_s = timing.timed_chunks({"plain": plain}, 21)["plain"]
    del ch, plain
    prof = tracing.Profile()
    seg = _Segment(e, prof)
    try:
        cell.task.trial(built, v, seg)
    except program.Cut:
        pass
    return {"plain_epoch_s": plain_s, "boundaries": seg.boundaries, "eval_every": e,
            "trace": prof.trace(e * PROFILED_BLOCKS)}


def program_readings(cell, run: dict) -> dict:
    """The port's readings of trial 0's first block (snapshots after the
    evaluation epochs 0 and ``eval_every``)."""
    e = cell.traffic["drive"]["eval_every"]
    snaps, init = run["state"], run["init0"]
    first, last = snaps[0], snaps[e]
    names = list(first["params"])
    p0 = reftrain.leaves(init["params"])
    return {"losses": [float(x) for x in last["rows"][:cell.traffic["drive"]["compared_steps"], 3]],
            "grad1": dict(zip(names, first["mu"], strict=True)),
            "change": {n: last["params"][n] - p0[n] for n in names},
            "eval": {1: cell.task.eval_rows(first["rows"][0])}}


class _FirstBlock:
    """The loop's checkpointer for one trial's first block: snapshots after
    the evaluation epochs 0 and ``block``, then stops the trial."""

    def __init__(self, block: int):
        self.block = block
        self.snaps = {}

    def restore(self):
        return None

    def save(self, epoch, params, opt_state, results, buffers=None):
        if epoch in (0, self.block):
            self.snaps[epoch] = program.snapshot(params, opt_state, results, epoch)
        if epoch == self.block:
            raise program.Cut(epoch, None)


def first_readings(cell, built, init: dict) -> dict:
    """The port's readings from ``init`` without a window (calibration)."""
    hook = _FirstBlock(cell.traffic["drive"]["eval_every"])
    try:
        cell.task.trial(built, init, hook)
    except program.Cut:
        pass
    return program_readings(cell, {"state": hook.snaps, "init0": init})


def reference_readings(cell, init: dict, wins: dict, tf32: bool = False) -> dict:
    """The reference through the first block, from the same variables."""
    drive = cell.traffic["drive"]
    ref = cell.task.follow(cell, init, wins, drive["eval_every"] + 1, tf32=tf32, eval_after=(1,))
    ref["losses"] = ref["losses"][:drive["compared_steps"]]
    return ref

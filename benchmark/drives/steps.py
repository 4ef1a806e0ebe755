"""The task's captured step, in chunks of ``chunk`` steps that each end in
a fetch of their losses, with no evaluation. The set-up takes the first
``compared_steps`` (the capture among them); the window runs chunks until
its seconds have passed.

Compared (``correctness``): the losses of the first ``compared_steps``,
the first gradient and the change over those steps.
"""

from __future__ import annotations

import time

from benchmark import program, timing
from benchmark import trace as tracing
from benchmark.reference import train as reftrain

PROFILED_STEPS = 40


def _first(cell, chunks, init: dict) -> dict:
    k = cell.traffic["drive"]["compared_steps"]
    chunks(1)
    snap1 = program.step_snapshot(chunks)
    chunks(k - 1)
    return {"snap1": snap1, "snapk": program.step_snapshot(chunks), "init0": init}


def window(cell, built, draw, seconds: float, device) -> dict:
    chunk = cell.traffic["drive"]["chunk"]
    init0 = draw()  # the loop trains copies: init0 stays the initial values
    chunks = cell.task.chunks(built, init0, capacity=max(chunk, 64))
    state = _first(cell, chunks, init0)
    window_start = time.perf_counter()
    win = program.run_steps(chunks, seconds, chunk)
    win.update(window_start=window_start, init0=init0, peak=program.memory(device)[1],
               chunks=chunks, state=state)
    return win


def traced(cell, built, run: dict, draw) -> dict:
    """The window's step timed in chunks, then ``PROFILED_STEPS`` profiled."""
    chunks = run["chunks"]

    def steps(n):
        chunks(n)
        return chunks.stats(1)

    plain_s = timing.timed_chunks({"plain": steps}, 21)["plain"]
    prof = tracing.Profile()
    prof.begin()
    chunks(PROFILED_STEPS)
    chunks.stats(1).cpu()
    prof.end()
    return {"plain_epoch_s": plain_s, "boundaries": [], "eval_every": 1,
            "trace": prof.trace(PROFILED_STEPS)}


def program_readings(cell, run: dict) -> dict:
    s = run["state"]
    names = list(s["snap1"]["params"])
    p0 = reftrain.leaves(s["init0"]["params"])
    return {"losses": [float(x) for x in s["snapk"]["losses"]],
            "grad1": dict(zip(names, s["snap1"]["mu"], strict=True)),
            "change": {n: s["snapk"]["params"][n] - p0[n] for n in names}}


def first_readings(cell, built, init: dict) -> dict:
    """The port's readings from ``init`` without a window (calibration)."""
    k = cell.traffic["drive"]["compared_steps"]
    chunks = cell.task.chunks(built, init, capacity=max(k, 64))
    return program_readings(cell, {"state": _first(cell, chunks, init)})


def reference_readings(cell, init: dict, wins: dict, tf32: bool = False) -> dict:
    return cell.task.follow(cell, init, wins, cell.traffic["drive"]["compared_steps"], tf32=tf32)

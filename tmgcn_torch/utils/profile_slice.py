"""Where the time of a warm epoch goes, on the card.

    python -m tmgcn_torch.utils.profile_slice [PRESET [SPMM_IMPL]]

PRESET is chess_tmgcn_cls (the default), chess_tmgcn2_cls or chess_gcn_cls,
each run with spmm_impl="pallas" unless SPMM_IMPL names another, or
chess_wdgcn_cls, chess_wdgcn_lp, chess_evolvegcn_cls, chess_evolvegcn2_cls,
chess_evolvegcn_lp, or the SEIR regression presets seir_tmgcn_reg_tuned,
seir_wdgcn_reg_tuned and seir_evolvegcn_reg_tuned (the preset's own
spmm_impl: "pallas" for the first two). Builds the preset's experiment once
(device cuda; chess data in data/chess, SEIR data generated), warms the
loop up with one run, then:

  * times REPEATS warm runs of EPOCHS epochs each (two evaluation epochs,
    or for regression val and test scored once at the end; each run
    captures its step anew): median, quartiles and extremes of ms per
    epoch;
  * times chunks of plain epochs alone, captured (as the loop runs them on
    the card) and eager (the loop's reference steps), in turns, by
    ``timed_chunks`` (bench.py's rule);
  * traces a warm captured chunk of TRACED_EPOCHS plain epochs with
    ``torch.profiler`` and prints the device time by kernel, the device's
    busy share of the traced run (the union of its device operations'
    intervals over the run's range, one trace), and the host time by
    operator;
  * times the captured step's phases on the device: a chunk built with
    ``train_chunks(phase_events=True)`` (timing events recorded in the
    graph), PHASE_REPLAYS single plain epochs each waited for, the median
    forward (with the loss), backward (``torch.autograd.grad``) and update
    (with the stats) milliseconds (``step_phase_ms``).

Prints one JSON line at the end; needs a card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from tmgcn_torch.configs.build import build_experiment, run_trial, train_config, trial_chunks
from tmgcn_torch.configs.presets import get_preset
from tmgcn_torch.train import loop

DATA_DIR = "data/chess"
EPOCHS = 200
REPEATS = 11
TRACED_EPOCHS = 21
PHASE_REPLAYS = 21
PRESETS = {
    "chess_tmgcn_cls": {"spmm_impl": "pallas"},
    "chess_tmgcn2_cls": {"spmm_impl": "pallas"},
    "chess_gcn_cls": {"spmm_impl": "pallas"},
    "chess_wdgcn_cls": {},
    "chess_wdgcn_lp": {},
    "chess_evolvegcn_cls": {},
    "chess_evolvegcn2_cls": {},
    "chess_evolvegcn_lp": {},
    "seir_tmgcn_reg_tuned": {},
    "seir_wdgcn_reg_tuned": {},
    "seir_evolvegcn_reg_tuned": {},
}


def chunk_runner(exp, tcfg, alpha: float, generator: torch.Generator, eager: bool = False,
                 phase_events: bool = False):
    """``run(n)``: n plain epochs of the step that ``run_trial`` trains at
    ``alpha`` (``configs.build.trial_chunks``, parameters drawn from
    ``generator``), returning the last one's stats row on the device.
    Captured, as the loop runs them on a card; with ``eager``, the loop's
    eager chunks of the same step, the reference the captured ones are held
    to. With ``phase_events``, ``run.phase_ms()`` is the chunks'
    ``phase_ms``: the last step's phases."""
    chunks = trial_chunks(exp, tcfg, alpha, generator, capacity=1, phase_events=phase_events)
    if eager:
        chunks = loop._EagerChunks(chunks.step, chunks.plain and chunks.plain.step)

    def run(n):
        chunks(n, plain=True)
        return chunks.stats(1)

    run.phase_ms = chunks.phase_ms
    return run


def build_runner(preset: str, spmm_impl: str | None = None):
    """(cfg, run, make_chunk) for one preset on the card: the experiment is
    built once; ``run(n_epochs, eval_every=cfg.eval_every)`` trains from the
    preset's initial parameters each time, through the loop users run, at
    the preset's first alpha (none for regression); ``make_chunk(eager=False,
    phase_events=False)`` is ``chunk_runner`` on the same adapter, alpha and
    initial parameters."""
    if preset not in PRESETS:
        raise SystemExit(f"profile_slice profiles one of {sorted(PRESETS)}, not {preset!r}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs an NVIDIA card")
    overrides = dict(PRESETS[preset], **({"spmm_impl": spmm_impl} if spmm_impl else {}))
    cfg = dataclasses.replace(get_preset(preset), **overrides)
    exp = build_experiment(cfg, data_dir=DATA_DIR, device="cuda")
    alpha = None if cfg.task == "regression" else cfg.alpha_vec[0]

    def run(n_epochs, eval_every=cfg.eval_every):
        tcfg = dataclasses.replace(train_config(cfg, n_epochs), eval_every=eval_every)
        return run_trial(exp, tcfg, alpha, torch.Generator().manual_seed(cfg.seed))

    def make_chunk(eager=False, phase_events=False):
        return chunk_runner(exp, train_config(cfg), alpha,
                            torch.Generator().manual_seed(cfg.seed), eager, phase_events)

    return cfg, run, make_chunk


def timed_chunks(runs: dict, n_timed: int, rounds: int = 5, min_round_s: float = 0.25) -> dict:
    """Seconds per epoch of each ``run(n)`` (n epochs, returning a device
    tensor whose fetch waits for them), timed as bench.py's
    ``_timed_epochs`` times a chunk: a warm chunk, a probe, the chunk grown
    until a round covers ``min_round_s``, then the median of ``rounds``
    rounds. bench.py caps the growth at 16×, which there bounds the
    recompiles of a longer scan; a chunk here compiles nothing new at any
    length, so it grows as far as the probe asks. The runs take their
    rounds in turns. Per run: ms per epoch (median, best, max), the spread
    (max - best) / median, the chunk length and the median round's
    seconds."""
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
    out = {}
    for name, times in per_round.items():
        med = float(np.median(times))
        out[name] = {
            "median_ms": 1e3 * med,
            "best_ms": 1e3 * min(times),
            "max_ms": 1e3 * max(times),
            "run_spread": (max(times) - min(times)) / med,
            "n_timed": sizes[name],
            "round_s": med * sizes[name],
            "rounds": rounds,
        }
    return out


RUN_RANGE = "profile_slice.run"


def busy_share(events) -> float:
    """The share of the ``RUN_RANGE`` host range in which some operation ran
    on the device: the union of the device operations' intervals (user
    annotations' device copies left out: they span kernels), clipped to the
    range, over its length."""
    run = next(e.time_range for e in events if e.name == RUN_RANGE
               and e.device_type != torch.autograd.DeviceType.CUDA)
    lo, hi = float(run.start), float(run.end)
    spans = sorted(
        (max(float(e.time_range.start), lo), min(float(e.time_range.end), hi)) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    )
    busy, at = 0.0, lo
    for a, b in spans:
        a = max(a, at)
        if b > a:
            busy += b - a
            at = b
    return busy / (hi - lo)


def trace(run_epochs, n_epochs: int = TRACED_EPOCHS, top: int = 8) -> tuple[dict, object]:
    """``run_epochs()``, a warm run of n_epochs, traced: device ms per
    epoch, the device's busy share of the run, host launch calls per epoch
    and the ``top`` kernels' device ms; and the profiler's averages.

    Device time is the profiler's kernel time: on an H100 it sees the
    kernels of a replayed CUDA graph. The span of CUDA events recorded
    around the run is reported beside it, ``event_ms_per_profiled_epoch``
    (the device's wall span, idle gaps included). The busy share is 1 less
    the idle share of the run's ``RUN_RANGE`` (which ends after a
    synchronise): the union of the device operations' intervals inside it
    over its length, both on the profiler's clock, so overlapping kernels
    count once and it cannot pass 1."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(RUN_RANGE):
            t0 = time.perf_counter()
            start.record()
            run_epochs()
            end.record()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    event_us = 1e3 * start.elapsed_time(end)
    avg = prof.key_averages()
    # Kernels (and copies) are the events on the device itself; operator
    # rows also carry their kernels' time, and annotation spans (the
    # optimizer's step) cover kernels already counted, so only kernels are
    # summed.
    on_device = [
        e for e in avg
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    device_us = sum(e.self_device_time_total for e in on_device)
    # Names cut to 80 characters can collide (template instances of one
    # kernel): their times add up.
    by_kernel: dict[str, float] = {}
    for e in on_device:
        by_kernel[e.key[:80]] = by_kernel.get(e.key[:80], 0.0) + e.self_device_time_total / 1e3
    return {
        "profiled_epochs": n_epochs,
        "profiled_wall_ms": wall_us / 1e3,
        "device_ms_per_profiled_epoch": device_us / 1e3 / n_epochs,
        "event_ms_per_profiled_epoch": event_us / 1e3 / n_epochs,
        "device_busy_share": busy_share(prof.events()),
        # Host-side kernel and graph launches (every kernel, library or ours).
        "launch_calls_per_profiled_epoch": sum(
            e.count for e in avg if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")
        ) / n_epochs,
        "graph_launches_per_profiled_epoch": sum(
            e.count for e in avg if e.key in ("cudaGraphLaunch", "cuGraphLaunch")
        ) / n_epochs,
        "device_ms_by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]),
    }, avg


def step_phases(run, n: int = PHASE_REPLAYS) -> dict:
    """The median forward, backward and update milliseconds of ``n``
    single epochs of ``run`` (a ``chunk_runner`` with ``phase_events``),
    each waited for before its events are read; the first epoch, the
    warm-up step and the capture, is left out."""
    run(1).cpu()
    readings = []
    for _ in range(n):
        run(1).cpu()
        torch.cuda.synchronize()
        readings.append(run.phase_ms())
    return {phase: float(np.median([r[phase] for r in readings])) for phase in readings[0]}


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    preset = argv[0] if argv else "chess_tmgcn_cls"
    cfg, run, make_chunk = build_runner(preset, argv[1] if len(argv) > 1 else None)

    run(EPOCHS)  # the process's first launches of every kernel
    warm_ms = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(EPOCHS)
        torch.cuda.synchronize()
        warm_ms.append(1e3 * (time.perf_counter() - t0) / EPOCHS)

    chunks = timed_chunks({"captured": make_chunk(), "eager": make_chunk(eager=True)},
                          TRACED_EPOCHS)
    chunk = make_chunk()
    chunk(TRACED_EPOCHS).cpu()  # the warm-up step and the capture
    traced, avg = trace(lambda: chunk(TRACED_EPOCHS).cpu(), TRACED_EPOCHS)
    print(avg.table(sort_by="self_device_time_total", row_limit=12))
    print(avg.table(sort_by="self_cpu_time_total", row_limit=12))
    phases = step_phases(make_chunk(phase_events=True))
    result = {
        "preset": preset,
        "spmm_impl": cfg.spmm_impl,
        "card": card(),
        "warm_ms_per_epoch": {
            "median": float(np.median(warm_ms)),
            "p25": float(np.percentile(warm_ms, 25)),
            "p75": float(np.percentile(warm_ms, 75)),
            "min": min(warm_ms),
            "max": max(warm_ms),
            "runs": REPEATS,
            "epochs_per_run": EPOCHS,
        },
        "plain_epoch_ms": chunks,
        **traced,
        "step_phase_ms": phases,
        "step_phase_replays": PHASE_REPLAYS,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

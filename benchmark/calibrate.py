"""The readings that a cell's limits are set from.

    python -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--control 1,2,3] [--out FILE]

For each seed, the numbers ``correctness`` compares: the port against the
reference (the lower readings); for the ``--control`` seeds also the
control, the reference computed in TF32 in the port's place, and each
fault of the cell's task (``FAULTS``, planted in the port's timed path by
the task's ``planted``) (the upper readings). Training needs no measured
window: the port runs the set-up's first steps through the window's own
entry (the drive's ``first_readings``). Prints one JSON line per reading.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import correctness, generator, harness, program


def calibrate(cell, seeds, control_seeds, device, data_dir=None):
    """Yield one record a reading: {"seed", "kind" ("program", "control" or
    a fault), "numbers", "correct"} under the cell's limits."""
    tr = cell.traffic
    shapes = cell.family.param_shapes(tr["features"], cell.cfg["hidden_feat"],
                                      tr["labels"]["classes"])
    built = source = wins = None
    for seed in seeds:
        t0 = time.perf_counter()
        if built is None or cell.graph.SEEDED:
            built, source = cell.graph.port(cell, seed, device, program.Spans(), data_dir)
        init = generator.initial_variables(shapes, generator.generator(seed, 2, device), device)
        runs = {"program": cell.drive.first_readings(cell, built, init)}
        if seed in control_seeds:
            for fault in cell.task.FAULTS:
                with cell.task.planted(fault):
                    runs[fault] = cell.drive.first_readings(cell, built, init)
        if cell.graph.SEEDED:
            built = None
            harness._free(device)
        if wins is None or cell.graph.SEEDED:
            wins = cell.graph.reference_windows(cell, source, device, data_dir)
        ref = cell.drive.reference_readings(cell, init, wins)
        if seed in control_seeds:
            runs["control"] = cell.drive.reference_readings(cell, init, wins, tf32=True)
        for kind, prog in runs.items():
            numbers = correctness.readings(prog, ref)
            correct, _ = correctness.judge(numbers, cell.limits)
            yield {"seed": seed, "kind": kind, "numbers": numbers, "correct": correct,
                   "seconds": time.perf_counter() - t0}
        if cell.graph.SEEDED:
            wins = source = None
            harness._free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma list of seeds")
    ap.add_argument("--control", default="", help="seeds that also read the control and faults")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control.split(",") if s}
    if not torch.cuda.is_available():
        print("calibration reads the card", file=sys.stderr)
        return 2
    manifest = harness.load_json(Path.cwd() / "BENCHMARK.json")
    cell = harness.find_cell(manifest, args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for rec in calibrate(cell, seeds, control, torch.device("cuda")):
            line = json.dumps(harness.as_numbers(rec))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The benchmark of tmgcn_torch: one run of one cell.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the NVIDIA cards the cell
asks for. Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; last come the numbers compared
against the reference with their limits (``checks``), which also end
standard error. Without the cards, or if JAX or the JAX package was loaded,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from benchmark.timing import process_start

T_START = process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    # Kernel caches at fixed paths of the checkout: only a checkout's first
    # run builds.
    cache = root / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import subprocess

    import torch

    import tmgcn_torch

    from benchmark import harness, imports

    if not Path(tmgcn_torch.__file__).resolve().is_relative_to(root.resolve()):
        print(f"tmgcn_torch is loaded from {tmgcn_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2
    manifest = harness.load_json(root / "BENCHMARK.json")
    cell = harness.find_cell(manifest, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda"), T_START)
    bad = imports.forbidden_loaded()
    if bad:
        print(f"modules of {bad} were loaded; no result", file=sys.stderr)
        return 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()
    print(f"card: {card[0] if card else 'unknown'} (peaks: 67 TFLOP/s f32, 3.35 TB/s)",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(harness.as_numbers(result)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

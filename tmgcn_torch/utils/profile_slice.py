"""Where the time of a warm chess epoch goes, on the card.

    python -m tmgcn_torch.utils.profile_slice [PRESET [SPMM_IMPL]]

PRESET is chess_tmgcn_cls (the default) or chess_tmgcn2_cls, each run with
spmm_impl="pallas" unless SPMM_IMPL names another, or chess_wdgcn_cls (the
preset's own spmm_impl). Builds the slice's adapter
once (device cuda, data in data/chess), warms the loop up with one run,
then:

  * times REPEATS warm runs of EPOCHS epochs each (two evaluation epochs):
    median, quartiles and extremes of ms per epoch;
  * traces a warm run of 21 epochs (one evaluation epoch, 20 plain ones)
    with ``torch.profiler`` and prints the device time by kernel, the
    device's busy share of the wall time (kernel time over wall time),
    and the host time by operator.

Prints one JSON line at the end; needs a card.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from tmgcn_torch.configs.build import build_data, build_model
from tmgcn_torch.configs.presets import get_preset
from tmgcn_torch.tasks.adapters import WINDOWS, make_edge_adapter
from tmgcn_torch.tasks.windows import split_edges_classification
from tmgcn_torch.train.loop import TrainConfig, run_edge_classification

DATA_DIR = "data/chess"
EPOCHS = 200
REPEATS = 11
TRACED_EPOCHS = 21
PRESETS = {
    "chess_tmgcn_cls": {"spmm_impl": "pallas"},
    "chess_tmgcn2_cls": {"spmm_impl": "pallas"},
    "chess_wdgcn_cls": {},
}


def build_runner(preset: str, spmm_impl: str | None = None):
    """(cfg, run) for one preset on the card: the adapter is built once;
    ``run(n_epochs, eval_every=cfg.eval_every)`` trains from the same
    initial parameters each time."""
    if preset not in PRESETS:
        raise SystemExit(f"profile_slice profiles one of {sorted(PRESETS)}, not {preset!r}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs an NVIDIA card")
    overrides = dict(PRESETS[preset], **({"spmm_impl": spmm_impl} if spmm_impl else {}))
    cfg = dataclasses.replace(get_preset(preset), **overrides)
    data = build_data(cfg, data_dir=DATA_DIR)
    splits = split_edges_classification(
        data.edge_index, data.edge_values, data.spec, n_classes=cfg.n_classes
    )
    model = build_model(cfg, data.spec.s_train, data.feats["train"].shape[-1])
    adapter = make_edge_adapter(
        model, data.adj, data.feats, {w: splits[w].edges for w in WINDOWS},
        M=data.M if cfg.method == "tmgcn" else None, device=torch.device("cuda"),
    )
    cw = np.array([1 / 3, 1 / 3, 1 / 3])
    gen = torch.Generator().manual_seed(cfg.seed)

    def run(n_epochs, eval_every=cfg.eval_every):
        tcfg = TrainConfig(n_epochs=n_epochs, lr=cfg.lr, momentum=cfg.momentum,
                           eval_every=eval_every)
        return run_edge_classification(adapter, splits, cw, tcfg, generator=gen)

    return cfg, run


def trace(run_epochs, n_epochs: int = TRACED_EPOCHS, top: int = 8) -> tuple[dict, object]:
    """``run_epochs()``, a warm run of n_epochs, traced: device ms per
    epoch, the device's busy share of the wall time, host launch calls per
    epoch and the ``top`` kernels' device ms; and the profiler's averages."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_epochs()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
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
        "device_busy_share": device_us / wall_us,
        # Host-side kernel launches (every kernel, library or ours).
        "launch_calls_per_profiled_epoch": sum(
            e.count for e in avg if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")
        ) / n_epochs,
        "device_ms_by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]),
    }, avg


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    preset = argv[0] if argv else "chess_tmgcn_cls"
    cfg, run = build_runner(preset, argv[1] if len(argv) > 1 else None)

    run(EPOCHS)  # the process's first launches of every kernel
    warm_ms = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(EPOCHS)
        torch.cuda.synchronize()
        warm_ms.append(1e3 * (time.perf_counter() - t0) / EPOCHS)

    traced, avg = trace(lambda: run(TRACED_EPOCHS, eval_every=TRACED_EPOCHS))
    print(avg.table(sort_by="self_device_time_total", row_limit=12))
    print(avg.table(sort_by="self_cpu_time_total", row_limit=12))
    result = {
        "preset": preset,
        "spmm_impl": cfg.spmm_impl,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip(),
        "warm_ms_per_epoch": {
            "median": float(np.median(warm_ms)),
            "p25": float(np.percentile(warm_ms, 25)),
            "p75": float(np.percentile(warm_ms, 75)),
            "min": min(warm_ms),
            "max": max(warm_ms),
            "runs": REPEATS,
            "epochs_per_run": EPOCHS,
        },
        **traced,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

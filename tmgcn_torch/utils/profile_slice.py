"""Where the time of a warm chess_tmgcn_cls epoch goes, on the card.

    python -m tmgcn_torch.utils.profile_slice

Builds the slice's adapter once (spmm_impl="pallas", device cuda, data in
data/chess), warms the loop up with one run, then:

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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs an NVIDIA card")
    dev = torch.device("cuda")

    cfg = dataclasses.replace(get_preset("chess_tmgcn_cls"), spmm_impl="pallas")
    data = build_data(cfg, data_dir=DATA_DIR)
    splits = split_edges_classification(
        data.edge_index, data.edge_values, data.spec, n_classes=cfg.n_classes
    )
    model = build_model(cfg, data.spec.s_train, data.feats["train"].shape[-1])
    adapter = make_edge_adapter(
        model, data.adj, data.feats, {w: splits[w].edges for w in WINDOWS}, M=data.M, device=dev
    )
    cw = np.array([1 / 3, 1 / 3, 1 / 3])
    gen = torch.Generator().manual_seed(cfg.seed)

    def run(n_epochs, eval_every=cfg.eval_every):
        tcfg = TrainConfig(n_epochs=n_epochs, lr=cfg.lr, momentum=cfg.momentum,
                           eval_every=eval_every)
        return run_edge_classification(adapter, splits, cw, tcfg, generator=gen)

    run(EPOCHS)  # the process's first launches of every kernel
    warm_ms = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(EPOCHS)
        torch.cuda.synchronize()
        warm_ms.append(1e3 * (time.perf_counter() - t0) / EPOCHS)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(TRACED_EPOCHS, eval_every=TRACED_EPOCHS)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    avg = prof.key_averages()
    print(avg.table(sort_by="self_device_time_total", row_limit=12))
    print(avg.table(sort_by="self_cpu_time_total", row_limit=12))
    # Kernels (and copies) are the events on the device itself; operator
    # rows also carry their kernels' time, and annotation spans (the
    # optimizer's step) cover kernels already counted, so only kernels are
    # summed.
    on_device = [
        e for e in avg
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    device_us = sum(e.self_device_time_total for e in on_device)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    result = {
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
        "profiled_epochs": TRACED_EPOCHS,
        "profiled_wall_ms": wall_us / 1e3,
        "device_ms_per_profiled_epoch": device_us / 1e3 / TRACED_EPOCHS,
        "device_busy_share": device_us / wall_us,
        "device_ms_by_kernel": {e.key[:80]: e.self_device_time_total / 1e3 for e in top},
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

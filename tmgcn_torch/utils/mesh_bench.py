"""Sharded training on a (graph x time) mesh against one device, one
process per card.

    torchrun --standalone --nproc-per-node 4 -m tmgcn_torch.utils.mesh_bench \\
        --mesh graph=2,time=2 [PRESET ...] [--epochs 200] [--device cpu]

For each preset (default chess_tmgcn_cls and chess_tmgcn2_cls, the chess
data in data/chess; any preset the mesh shards: the recurrent families on
a graph-only mesh, the SEIR regression presets generated) every rank builds
the sharded experiment and the unsharded one on its own card, then:

  * rows: a run of ``--epochs`` epochs sharded (the loop users run) and
    unsharded; the largest relative train-loss difference and the largest
    F1 (LP: MAP, MRR) difference, or for regression the largest relative
    difference of the train losses and of val/test L1 and L1 ratio; and
    whether every rank returned the same rows;
  * warm ms per epoch of the sharded run (host clock, the slowest rank);
  * ms per plain epoch, sharded captured and eager and unsharded captured:
    rounds of a fixed number of epochs that every rank runs in step (a
    barrier before each; the slowest rank's seconds), median of 5;
  * a traced captured chunk of 21 plain epochs: rank 0's device ms per
    epoch, busy share, and its NCCL kernels' count and device ms per epoch;
  * the collectives one evaluation step and one plain step issue (by kind,
    and by kind, group size and buffer bytes: ``utils/comm_model`` reckons
    their NCCL time from these), and the set-up seconds (the mesh's groups,
    data, adapter).

Rank 0 prints the card's name and power limit, a line per preset and one
JSON object last. Needs as many cards as processes with ``cuda`` (the
default); ``--device cpu`` runs gloo (small checks only: the chess layer-2
block-dense operator takes GBs of host memory a rank).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from tmgcn_torch.configs.build import build_experiment, run_trial, train_config, trial_chunks
from tmgcn_torch.configs.presets import get_preset
from tmgcn_torch.parallel import collectives, distributed
from tmgcn_torch.parallel.mesh import make_mesh
from tmgcn_torch.train import loop
from tmgcn_torch.utils import profile_slice

DATA_DIR = "data/chess"
ROUNDS = 5


def _slowest(seconds: float, device: torch.device, group=None) -> float:
    """The largest of every rank's ``seconds`` (of ``group``, default the
    world)."""
    t = torch.tensor([seconds], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rounds(run, n: int, device: torch.device) -> dict:
    """ms per epoch of ``run(n)`` (a warm round first), every rank in step:
    median, best and max of the slowest rank's rounds."""
    run(n).cpu()
    per = []
    for _ in range(ROUNDS):
        dist.barrier()
        t0 = time.perf_counter()
        run(n).cpu()
        per.append(1e3 * _slowest(time.perf_counter() - t0, device) / n)
    return {"median_ms": statistics.median(per), "best_ms": min(per), "max_ms": max(per),
            "epochs_a_round": n, "rounds": ROUNDS}


def _rows_diff(got, ref, lp: bool) -> dict:
    if isinstance(ref, dict):  # regression: run_regression's result dicts
        rel = {k: float(np.max(np.abs(np.asarray(got[k]) - v) / np.abs(v)))
               for k, v in ref.items()}
        return {"loss_max_rtol": rel.pop("train_loss"), "l1_max_rtol": max(rel.values())}
    loss = 2 if lp else 3
    rel = np.abs(got[:, loss] - ref[:, loss]) / np.abs(ref[:, loss])
    rates = [0, 1, 3, 4, 6, 7] if lp else [2, 6, 10]
    diff = np.nan_to_num(np.abs(got[:, rates] - ref[:, rates]), nan=0.0)
    same_nan = bool(np.all(np.isnan(got[:, rates]) == np.isnan(ref[:, rates])))
    return {"loss_max_rtol": float(rel.max()), "rates_max_abs": float(diff.max()),
            "rates_nan_alike": same_nan}


def _same_rows(a, b) -> bool:
    if isinstance(b, dict):
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k], equal_nan=True)
                                            for k in b)
    return np.array_equal(a, b, equal_nan=True)


def bench_preset(name: str, mesh, epochs: int, n_round: int) -> dict:
    cfg = get_preset(name)
    device = mesh.device
    exp = build_experiment(cfg, DATA_DIR, device=device, mesh=mesh)
    plain = build_experiment(cfg, DATA_DIR, device=device)
    tcfg = train_config(cfg, epochs)
    alpha = None if cfg.task == "regression" else cfg.alpha_vec[0]
    lp = cfg.task == "link_pred"

    def gen():
        return torch.Generator().manual_seed(cfg.seed)

    run_trial(exp, tcfg, alpha, gen())  # the first launches and captures
    _sync(device)
    t0 = time.perf_counter()
    rows = run_trial(exp, tcfg, alpha, gen())
    _sync(device)
    warm = _slowest(time.perf_counter() - t0, device)
    ref = run_trial(plain, tcfg, alpha, gen())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, rows)
    same = all(_same_rows(r, rows) for r in every)

    chunks = trial_chunks(exp, train_config(cfg), alpha, gen())
    eager = loop._EagerChunks(chunks.step, chunks.plain and chunks.plain.step)
    calls, issued = {}, {}
    for what, plain_step in (("evaluation step", False), ("plain step", True)):
        collectives.CALLS.clear()
        collectives.ISSUED.clear()
        eager(1, plain=plain_step)
        calls[what] = dict(collectives.CALLS)
        issued[what] = [[list(k), v] for k, v in sorted(collectives.ISSUED.items())]

    def runner(e, eager=False):
        return profile_slice.chunk_runner(e, train_config(cfg), alpha, gen(), eager)

    times = {"sharded captured": _rounds(runner(exp), n_round, device),
             "sharded eager": _rounds(runner(exp, eager=True), max(1, n_round // 8), device),
             "unsharded captured": _rounds(runner(plain), n_round, device)}
    out = {"preset": name, "epochs": epochs, "rows": _rows_diff(rows, ref, lp),
           "rows_equal_on_every_rank": same, "warm_ms_per_epoch": 1e3 * warm / epochs,
           "collectives": calls, "collectives_issued": issued, "plain_epoch": times,
           "setup_s": {"data": exp.seconds["data"], "adapter": exp.seconds["adapter"],
                       "unsharded_adapter": plain.seconds["adapter"]}}
    if device.type == "cuda":
        n = profile_slice.TRACED_EPOCHS
        run = runner(exp)
        run(n).cpu()  # the warm-up step and the capture
        dist.barrier()
        traced, avg = profile_slice.trace(lambda: run(n).cpu(), n)
        nccl = [e for e in avg if "nccl" in e.key.lower()
                and e.device_type == torch.autograd.DeviceType.CUDA]
        traced["nccl_kernels_per_epoch"] = sum(e.count for e in nccl) / n
        traced["nccl_device_ms_per_epoch"] = sum(e.self_device_time_total for e in nccl) / 1e3 / n
        out["trace_rank0"] = traced
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mesh_bench")
    ap.add_argument("presets", nargs="*", default=["chess_tmgcn_cls", "chess_tmgcn2_cls"])
    ap.add_argument("--mesh", required=True, help="graph=G,time=T")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--round-epochs", type=int, default=400,
                    help="plain epochs a timed round (the eager side runs an eighth)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from tmgcn_torch.cli import _parse_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(*_parse_mesh(args.mesh), device=distributed.initialize(args.device))
    t_mesh = time.perf_counter() - t0
    lead = dist.get_rank() == 0
    card = profile_slice.card() if mesh.device.type == "cuda" else "cpu"
    if lead:
        print(card, flush=True)
    result = {"mesh": mesh.shape, "card": card, "runtime": distributed.runtime_info(),
              "mesh_groups_s": t_mesh, "presets": []}
    for name in args.presets:
        r = bench_preset(name, mesh, args.epochs, args.round_epochs)
        result["presets"].append(r)
        if lead:
            t = r["plain_epoch"]
            print(f"{name} on a {mesh.n_graph} x {mesh.n_time} mesh: rows {r['rows']} (every "
                  f"rank alike: {r['rows_equal_on_every_rank']}); warm "
                  f"{r['warm_ms_per_epoch']:.6f} ms/epoch; plain epochs "
                  + ", ".join(f"{k} {v['median_ms']:.6f}" for k, v in t.items())
                  + f" ms [{card}]", flush=True)
    distributed.shutdown()
    if lead:
        print(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

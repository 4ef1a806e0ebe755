"""Strong scaling of the port's standalone sharded TM-GCN step (port of
tmgcn_tpu.utils.scaling_bench).

    torchrun --standalone --nproc-per-node 4 -m tmgcn_torch.utils.scaling_bench \\
        [--out scaling.json] [--device cpu]

The JAX module's fixed problem: T 16 slices of N 4,096 nodes, F 32
features, 40,000 nonzeros a slice, E 100,000 labelled edges, a band-4 M
(halo 3). On 1, 2 and 4 ranks (each mesh a subgroup of the world, its first
d ranks; time 2 where d is even and the halo fits, as the JAX module
picks), one process a card: the halo step
(``parallel.tmgcn_sharded.make_sharded_train_step_halo``: the banded
exchange, the row-local SpMM, the partitioned readout; SGD 1e-4, momentum
0.9, eager) timed over ``ITERS`` steps after a warm-up, the slowest rank's
host time with the card synchronized; labelled edges/s and the efficiency
against one rank. The control (the JAX module's): a chain of 8 tanh(x @ x)
on a (4, 512, 512) block a rank, no communication, whose efficiency says
whether the ranks share hardware (then the step's efficiency measures the
host, not the collectives).

Rank 0 prints the card's name and power limit, a JSON line a mesh and the
whole result last.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

PROBLEM = {"T": 16, "N": 4096, "F": 32, "E": 100_000, "nnz": 40_000, "band": 4}
ITERS = 20
CONTROL_ITERS = 10


def build_problem(T: int, N: int, F: int, E: int, nnz: int, band: int, seed: int = 0) -> dict:
    """The problem's host arrays from ``seed``, as the JAX module draws them
    (each slice's rows sorted), and the step's parameters W (F, 32) and
    U (64, 2)."""
    from tmgcn_torch.core.mmatrix import make_m_matrix
    from tmgcn_torch.core.sparse import TemporalCOO

    rng = np.random.default_rng(seed)
    slices = []
    for _ in range(T):
        r = np.sort(rng.integers(0, N, nnz))
        slices.append((r, rng.integers(0, N, nnz), rng.random(nnz)))
    return {
        "A": TemporalCOO.from_slices(slices, N),
        "M": make_m_matrix(T, band).astype(np.float32),
        "X": rng.standard_normal((T, N, F)).astype(np.float32),
        "edges": np.stack([rng.integers(0, T, E), rng.integers(0, N, E),
                           rng.integers(0, N, E)]).astype(np.int64),
        "targets": rng.integers(0, 2, E),
        "params": {"W": rng.standard_normal((F, 32)).astype(np.float32),
                   "U": rng.standard_normal((64, 2)).astype(np.float32)},
    }


def _timed(fn, iters: int, group, device) -> float:
    """Seconds a call of ``fn``, the slowest rank of ``group``, every rank
    starting together."""
    from tmgcn_torch.utils.mesh_bench import _slowest, _sync

    _sync(device)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return _slowest((time.perf_counter() - t0) / iters, device, group)


def _mesh_step(p: dict, mesh, halo: int):
    """This rank's halo step on its shard of the problem: step() -> loss."""
    from tmgcn_torch.parallel import halo as halo_mod
    from tmgcn_torch.parallel import partition, tmgcn_sharded
    from tmgcn_torch.train.loop import TrainConfig

    T = p["A"].n_slices
    dev = mesh.device
    A_sh = partition.pad_time(partition.partition_rows(p["A"], mesh.n_graph), mesh.n_time)
    batch = tmgcn_sharded.shard_batch(mesh, A_sh, p["X"], p["M"], p["edges"])
    params = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in p["params"].items()}
    step = tmgcn_sharded.make_sharded_train_step_halo(
        mesh, A_sh.n_local_rows, params, TrainConfig(lr=1e-4, momentum=0.9),
        halo_mod.local_banded_m(p["M"], mesh.n_time, halo), halo)
    e_b, t_b, m_b = (torch.as_tensor(a[mesh.t], device=dev) for a in
                     tmgcn_sharded.partition_edges_by_time(p["edges"], p["targets"], T,
                                                           mesh.n_time))
    cw = torch.tensor([0.9, 0.1], device=dev)
    return lambda: step(batch, e_b.long(), t_b, m_b, cw)


def run(problem: dict | None = None, device: str = "cuda", iters: int = ITERS,
        control_iters: int = CONTROL_ITERS, verbose: bool = True) -> list[dict]:
    """Every rank of the world calls this (``distributed.initialize`` first
    or not); rank 0's rows, one a mesh of 1, 2, 4, ... ranks up to the
    world's size."""
    from tmgcn_torch.core.mmatrix import band_offsets
    from tmgcn_torch.parallel import distributed
    from tmgcn_torch.parallel.mesh import make_mesh

    dev = distributed.initialize(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the loop's float32 contract
    sizes = dict(PROBLEM, **(problem or {}))
    p = build_problem(**sizes)
    halo = band_offsets(p["M"])[0]
    world = dist.get_world_size()
    rows, base_rate, control_base = [], None, None
    d = 1
    while d <= world:
        n_time = 2 if d % 2 == 0 and halo <= sizes["T"] // 2 else 1
        mesh = make_mesh(d // n_time, n_time, device=dev, n_ranks=d)
        if mesh is not None:
            step = _mesh_step(p, mesh, halo)
            for _ in range(3):
                step()
            dt = _timed(step, iters, mesh.world, dev)
            x = torch.randn((4, 512, 512), generator=torch.Generator().manual_seed(1)).to(dev)

            def control():
                y = x
                for _ in range(8):
                    y = torch.tanh(y @ y)
                return y

            control()
            ctrl_dt = _timed(control, control_iters, mesh.world, dev)
            rate, ctrl_rate = sizes["E"] / dt, d / ctrl_dt
            base_rate = rate if base_rate is None else base_rate
            control_base = ctrl_rate if control_base is None else control_base
            rows.append({
                "devices": d, "mesh": f"{mesh.n_graph}x{mesh.n_time}", "step_ms": 1e3 * dt,
                "edges_per_s": rate, "efficiency": rate / (base_rate * d),
                "control_no_comm_efficiency": ctrl_rate / (control_base * d),
            })
            if verbose and dist.get_rank() == 0:
                print(json.dumps(rows[-1]), flush=True)
        dist.barrier()
        d *= 2
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scaling_bench")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="write the JSON result here (rank 0)")
    args = ap.parse_args(argv)
    from tmgcn_torch.parallel import distributed
    from tmgcn_torch.utils.profile_slice import card

    distributed.initialize(args.device)
    lead = dist.get_rank() == 0
    name = card() if args.device == "cuda" else "cpu"
    if lead:
        print(name, flush=True)
    rows = run(device=args.device)
    distributed.shutdown()
    if lead:
        result = {"card": name, "workload": "strong scaling: T=16 N=4096 F=32 E=100k "
                  "nnz=40k a slice, band 4", "results": rows}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Communication model of the port's sharded training step, with NCCL's
costs measured on the card (port of tmgcn_tpu.utils.comm_model).

    python -m tmgcn_torch.utils.comm_model [--constants fit.json] [--mesh-bench mb.json]
    torchrun --standalone --nproc-per-node 4 -m tmgcn_torch.utils.comm_model --measure \\
        [--out fit.json]

``step_collectives(w, g, t, plain)`` lists every collective one training
step of the port issues on a (graph=g, time=t) mesh, forward and backward,
as (kind, group size, buffer bytes) with its count — what
``parallel.collectives.ISSUED`` records in an eager step. It counts the
port's own backward rules (parallel/collectives.py), not JAX's
transposes:

  * ``reduce_from`` (the readout's sum over ``graph``, the loss sums over
    ``time``): an all-reduce forward, nothing backward;
  * ``gather_from`` (the bucket logits over ``time``, the regression
    output over ``graph`` and ``time``): an all-gather forward, nothing
    backward (this rank's slice);
  * ``all_gather`` (layer 2's rows over ``graph``, the halo's tails over
    ``time``, EvolveGCN-2's top-k candidates and hidden rows over
    ``graph``): an all-gather forward and an all-reduce of the whole
    gathered buffer backward (not a reduce-scatter); the candidates'
    integer ids have no backward;
  * ``copy_params``: one all-reduce of every trainable parameter over the
    world, backward.

The evaluation step runs ``apply`` (the banded family gathers its bucket
logits over ``time``); the plain epochs of the banded family run
``train_stats`` (loss sums and, for classification, three confusion counts
summed over ``time``, no logits gathered); the recurrent families and
regression run ``apply`` in every step.

Bytes a rank moves: a ring all-reduce 2(n-1)/n of its buffer, an
all-gather (n-1)/n of its result. Times come from constants fitted on the
card by ``--measure`` (no TPU constant): for each collective, group size
and mode (eager, or inside a captured CUDA graph, as the loop replays its
step) a latency and a bandwidth, t = latency + moved bytes / bandwidth,
fitted to a sweep of 4 KB to 64 MB buffers by least squares on relative
error. A group of one issues a copy and no NCCL kernel: 0 s.

``--mesh-bench`` prints, for each preset and mesh of a ``mesh_bench``
JSON, the model's NCCL ms per captured plain epoch, reckoned from the
collectives that run recorded (``collectives_issued``), beside the NCCL
kernels' device ms its trace measured.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math

import numpy as np

ALL_REDUCE, ALL_GATHER = "all_reduce", "all_gather"
F32, I64 = 4, 8


@dataclasses.dataclass(frozen=True)
class Workload:
    """One sharded run's per-step shape.

    ``family``: "tmgcn" (TM-GCN and KW-GCN, the banded adapter over graph x
    time), "evolvegcn" or "wdgcn" (graph only); ``task``: "edge_cls",
    "link_pred" or "regression". ``hidden``: the model's hidden_feat, its
    last entry the classes (regression: the head's input width first).
    ``E``: labelled edges of the train window; ``edges_per_bucket``: the
    largest time bucket's edges where known (default E / t). ``halo``: the
    banded M's band - 1; ``m2`` and ``m3``: the per-step M mixings of
    TM-GCN 2 (UCI).
    """

    name: str
    family: str
    task: str
    T: int
    N: int
    F0: int
    hidden: tuple[int, ...]
    E: int = 0
    edges_per_bucket: int | None = None
    halo: int = 0
    m2: bool = False
    m3: bool = False

    @property
    def n_layers(self) -> int:
        return len(self.hidden) - 1 if self.task != "regression" else 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _gru_cell(f_in: int, f_out: int) -> int:
    """EvolveGCN's GRU cell: p, then W, U (f_in x f_in) and B (f_in x f_out)
    for each of three gates."""
    return f_in + 3 * (2 * f_in * f_in + f_in * f_out)


def _lstm(f: int) -> int:
    """WD-GCN's LSTM: W and U (f x f) and b (f) for each of four gates."""
    return 4 * (2 * f * f + f)


def n_params(w: Workload) -> int:
    """Trainable parameters (WD-GCN's U and every W_init are frozen)."""
    f = (w.F0,) + tuple(w.hidden)
    if w.task == "regression":
        head = f[1] + 1
        if w.family == "tmgcn":
            return w.F0 * f[1] + head
        if w.family == "wdgcn":
            return w.F0 * f[1] + _lstm(f[1]) + head
        return _gru_cell(w.F0, f[1]) + head
    readout = 2 * f[-2] * f[-1]
    if w.family == "wdgcn":
        return w.F0 * f[1] + _lstm(f[1])
    if w.family == "evolvegcn":
        return sum(_gru_cell(f[i], f[i + 1]) for i in range(w.n_layers)) + readout
    return sum(f[i] * f[i + 1] for i in range(w.n_layers)) + readout


def step_collectives(w: Workload, g: int, t: int, plain: bool = False) -> collections.Counter:
    """{(kind, group size, buffer bytes): calls} of one training step on a
    (graph=g, time=t) mesh: an evaluation step, or with ``plain`` a step of
    the plain epochs. The same keys as ``parallel.collectives.ISSUED``."""
    if w.family != "tmgcn" and t != 1:
        raise ValueError(f"{w.family} shards over graph only, not time={t}")
    out: collections.Counter = collections.Counter()

    def gather(n, nbytes, backward=True):
        out[(ALL_GATHER, n, nbytes)] += 1
        if backward:
            out[(ALL_REDUCE, n, nbytes)] += 1

    n_loc = -(-w.N // g)
    t_loc = -(-w.T // t)
    out[(ALL_REDUCE, g * t, n_params(w) * F32)] += 1  # copy_params, backward
    if w.task == "regression":
        gather(g, g * t_loc * n_loc * F32, backward=False)
        if t > 1:
            gather(t, t * t_loc * g * n_loc * F32, backward=False)
        return out
    C = w.hidden[-1]
    eb = _round_up(max(1, w.edges_per_bucket or -(-w.E // t)), 128)
    out[(ALL_REDUCE, g, eb * C * F32)] += 1  # the readout's sum over graph
    if w.family == "evolvegcn" and w.n_layers == 2:
        F1, k2 = w.hidden[0], w.hidden[1]
        k_loc = min(k2, n_loc)
        gather(g, g * w.T * k_loc * (1 + F1) * F32)  # candidates' values and rows
        gather(g, g * w.T * k_loc * I64, backward=False)  # their global ids
        gather(g, g * w.T * n_loc * F1 * F32)  # the hidden rows for layer 2
    if w.family != "tmgcn":
        return out
    if w.n_layers == 2:
        F1, F2 = w.hidden[0], w.hidden[1]
        halo = w.halo if t > 1 else 0
        tail = min(t_loc, halo)
        if w.m2 and halo:
            gather(t, t * tail * n_loc * F1 * F32)
        gather(g, g * t_loc * n_loc * F1 * F32)  # layer 2's rows over graph
        if w.m3 and halo:
            gather(t, t * tail * n_loc * F2 * F32)
    if not plain:
        gather(t, t * eb * C * F32, backward=False)  # the bucket logits over time
        return out
    out[(ALL_REDUCE, t, 2 * F32)] += 1  # the loss's two sums over time
    if w.task == "edge_cls":
        out[(ALL_REDUCE, t, 3 * I64)] += 1  # tp, fp, fn over time
    return out


def moved_bytes(kind: str, n: int, nbytes: float) -> float:
    """Bytes one rank sends in a ring collective of ``nbytes`` (an
    all-reduce's buffer, an all-gather's result) over n ranks."""
    if n <= 1:
        return 0.0
    return (2.0 if kind == ALL_REDUCE else 1.0) * (n - 1) / n * nbytes


def step_comm_bytes(w: Workload, g: int, t: int, plain: bool = False) -> dict:
    """Per-rank bytes one step moves, by (kind, group size), and in all."""
    by: collections.Counter = collections.Counter()
    for (kind, n, nbytes), calls in step_collectives(w, g, t, plain).items():
        by[f"{kind}_{n}"] += calls * moved_bytes(kind, n, nbytes)
    return {"by_kind": dict(by), "total": sum(by.values())}


def predict_ms(issued, constants: dict, mode: str = "graph") -> float | None:
    """ms of the collectives ``issued`` ({(kind, n, bytes): calls}) under
    the fitted ``constants`` (``fit``'s keys "kind/n/mode"); None if a group
    size was not measured."""
    total = 0.0
    for (kind, n, nbytes), calls in dict(issued).items():
        if n <= 1:
            continue
        c = constants.get(f"{kind}/{n}/{mode}")
        if c is None:
            return None
        total += calls * (c["latency_us"] * 1e-3
                          + moved_bytes(kind, n, nbytes) / (c["bandwidth_GBps"] * 1e6))
    return total


def fit(records: list[dict]) -> dict:
    """{"kind/n/mode": {"latency_us", "bandwidth_GBps", "max_rel_err"}} from
    sweep records {"kind", "n", "mode", "bytes", "ms"}: t = a + moved / b,
    least squares on the relative error (each size weighs alike)."""
    groups = collections.defaultdict(list)
    for r in records:
        groups[(r["kind"], r["n"], r["mode"])].append(r)
    out = {}
    for (kind, n, mode), rs in sorted(groups.items()):
        x = np.array([moved_bytes(kind, n, r["bytes"]) for r in rs])
        t = np.array([r["ms"] * 1e-3 for r in rs])
        A = np.stack([np.ones_like(x), x], axis=1) / t[:, None]
        (a, b), *_ = np.linalg.lstsq(A, np.ones_like(t), rcond=None)
        pred = a + b * x
        out[f"{kind}/{n}/{mode}"] = {
            "latency_us": a * 1e6,
            "bandwidth_GBps": (1.0 / b) / 1e9 if b > 0 else math.inf,
            "max_rel_err": float(np.max(np.abs(pred - t) / t)),
            "points": len(rs),
        }
    return out


# The chess and SEIR presets' train windows (classification; LP drops a
# slice and has 772,520 training edges), for the tables.
CHESS = dict(T=80, N=7301, F0=2, E=39_192)
WORKLOADS = [
    Workload("chess_tmgcn_cls", "tmgcn", "edge_cls", hidden=(6, 3), halo=19, **CHESS),
    Workload("chess_tmgcn2_cls", "tmgcn", "edge_cls", hidden=(6, 6, 3), halo=19, **CHESS),
    Workload("chess_wdgcn_cls", "wdgcn", "edge_cls", hidden=(6, 3), **CHESS),
    Workload("chess_evolvegcn_cls", "evolvegcn", "edge_cls", hidden=(6, 3), **CHESS),
    Workload("chess_evolvegcn2_cls", "evolvegcn", "edge_cls", hidden=(6, 6, 3), **CHESS),
    Workload("seir_tmgcn_reg_tuned", "tmgcn", "regression", T=80, N=200, F0=5, hidden=(6, 2),
             halo=19),
    Workload("seir_wdgcn_reg_tuned", "wdgcn", "regression", T=80, N=200, F0=5, hidden=(6, 2)),
]


def _meshes(w: Workload, n_dev: int) -> list[tuple[int, int]]:
    return [(g, n_dev // g) for g in range(1, n_dev + 1)
            if n_dev % g == 0 and (w.family == "tmgcn" or g == n_dev)]


def table(constants: dict | None = None) -> list[dict]:
    """Each workload's per-rank bytes a plain step on 2 and 4 ranks, and
    with ``constants`` the predicted ms (graph mode)."""
    rows = []
    for w in WORKLOADS:
        for n_dev in (2, 4):
            for g, t in _meshes(w, n_dev):
                plain = step_collectives(w, g, t, plain=True)
                row = {"workload": w.name, "mesh": f"{g}x{t}",
                       "plain_step_bytes": step_comm_bytes(w, g, t, plain=True)["total"],
                       "eval_step_bytes": step_comm_bytes(w, g, t)["total"],
                       "plain_step_collectives": sum(plain.values())}
                if constants:
                    row["plain_step_ms"] = predict_ms(plain, constants)
                rows.append(row)
    return rows


def against_mesh_bench(bench: dict, constants: dict) -> list[dict]:
    """For each preset of a ``mesh_bench`` JSON: the model's NCCL ms per
    captured plain epoch from the collectives its eager plain step issued,
    beside the traced NCCL device ms per epoch."""
    rows = []
    for p in bench["presets"]:
        issued = {tuple(k): v for k, v in p["collectives_issued"]["plain step"]}
        trace = p.get("trace_rank0", {})
        rows.append({"preset": p["preset"], "mesh": bench["mesh"],
                     "predicted_nccl_ms": predict_ms(issued, constants, "graph"),
                     "predicted_nccl_ms_eager": predict_ms(issued, constants, "eager"),
                     "traced_nccl_ms": trace.get("nccl_device_ms_per_epoch"),
                     "captured_ms_per_epoch": p["plain_epoch"]["sharded captured"]["median_ms"]})
    return rows


SIZES = [4096 * 4 ** i for i in range(8)]  # 4 KB .. 64 MB
ITERS = 20


def measure(sizes=SIZES, iters: int = ITERS) -> list[dict]:
    """On every rank of a ``torchrun`` world of NCCL processes, one card
    each: all-reduce and all-gather of each size over groups of 2 and of
    4 ranks (the world cut into such groups, each running at once, as a
    mesh's groups do), eager and captured in a CUDA graph. ms a call: the
    slowest rank's CUDA-event time of ``iters`` calls after a barrier.
    Returns rank 0's records (every rank returns the same)."""
    import torch
    import torch.distributed as dist

    from tmgcn_torch.parallel import distributed

    device = distributed.initialize("cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    records = []
    for n in (2, 4):
        if world % n:
            continue
        mine = None
        for start in range(0, world, n):
            group = dist.new_group(list(range(start, start + n)), timeout=distributed.TIMEOUT)
            if start <= rank < start + n:
                mine = group
        for kind in (ALL_REDUCE, ALL_GATHER):
            for nbytes in sizes:
                out = torch.zeros(nbytes // F32, device=device)
                inp = torch.zeros(nbytes // F32 // n, device=device)

                def call():
                    if kind == ALL_REDUCE:
                        dist.all_reduce(out, group=mine)
                    else:
                        dist.all_gather_into_tensor(out, inp, group=mine)

                for mode in ("eager", "graph"):
                    run = _runner(torch, call, iters, device) if mode == "graph" else None
                    for _ in range(3):  # warm: the communicator, the capture
                        call() if run is None else run()
                    torch.cuda.synchronize(device)
                    dist.barrier()
                    start_ev = torch.cuda.Event(enable_timing=True)
                    end_ev = torch.cuda.Event(enable_timing=True)
                    start_ev.record()
                    if run is None:
                        for _ in range(iters):
                            call()
                    else:
                        run()
                    end_ev.record()
                    end_ev.synchronize()
                    ms = torch.tensor([start_ev.elapsed_time(end_ev) / iters], device=device)
                    dist.all_reduce(ms, op=dist.ReduceOp.MAX)
                    records.append({"kind": kind, "n": n, "mode": mode, "bytes": nbytes,
                                    "ms": float(ms)})
    return records


def _runner(torch, call, iters: int, device):
    """``iters`` calls captured once in a CUDA graph; returns its replay."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        call()  # NCCL's communicator and buffers before the capture
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            call()
    return graph.replay


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="comm_model")
    ap.add_argument("--measure", action="store_true",
                    help="sweep NCCL all-reduce and all-gather (under torchrun, a card a rank)")
    ap.add_argument("--out", help="write the sweep and its fit here (--measure)")
    ap.add_argument("--constants", help="a --measure JSON: predict times with its fit")
    ap.add_argument("--mesh-bench", action="append", default=[],
                    help="a mesh_bench log (its last JSON line): the model beside its NCCL ms")
    args = ap.parse_args(argv)
    constants = None
    if args.measure:
        import torch.distributed as dist

        from tmgcn_torch.parallel import distributed
        from tmgcn_torch.utils.profile_slice import card

        records = measure()
        lead = dist.get_rank() == 0
        distributed.shutdown()
        if not lead:
            return 0
        name = card()
        print(name, flush=True)
        constants = fit(records)
        for key, c in constants.items():
            print(f"{key}: latency {c['latency_us']:.3f} us, {c['bandwidth_GBps']:.3f} GB/s "
                  f"(max relative error {c['max_rel_err']:.3f}, {c['points']} sizes) [{name}]")
        result = {"card": name, "records": records, "fit": constants}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
    elif args.constants:
        with open(args.constants) as f:
            constants = json.load(f)["fit"]
    for row in table(constants):
        print(json.dumps(row))
    for path in args.mesh_bench:
        if constants is None:
            raise SystemExit("--mesh-bench needs --constants or --measure")
        with open(path) as f:
            bench = json.loads([line for line in f if line.startswith("{")][-1])
        for row in against_mesh_bench(bench, constants):
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

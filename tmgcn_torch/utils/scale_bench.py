"""Production-scale single-card benchmark: a large synthetic dynamic graph.

The port's counterpart of tools/bench_scale.py: the same power-law
temporal graph and labelled edges from the same seeds (its own numpy copy
of ``build_graph`` / ``build_inputs``), trained with the port's adapters,
loss, optimizer and step, full-batch SGD (lr 0.01, momentum 0.9, class
weights [0.9, 0.1]); on a card each step after the first is a replay of
the step captured as one CUDA graph, as the tool scans its steps in one
device call:

    python -m tmgcn_torch.utils.scale_bench [--nodes 500000] [--slices 64]
        [--nnz-per-slice 2000000] [--edges 1000000] [--families tmgcn1,tmgcn2]
        [--l2-stream N] [--out FILE] [--device cuda]

Prints ms/epoch and labelled edges/s for each family, then one JSON line.
Families: ``tmgcn1`` (1-layer TM-GCN, hidden (6, 2)), ``tmgcn2`` (2-layer
TM-GCN, hidden (6, 6, 2), selu: the readout-restricted layer 2 on the
operator the ``auto`` rule picks, or with ``--l2-stream N`` streamed over N
groups of time slices, one K1 operator each; the flag reaches no other
family), ``wdgcn`` (WD-GCN, hidden (6, 2)) and ``evolvegcn`` (EvolveGCN-H,
hidden (6, 2)). At 500k nodes x 64 slices the readout plan's T·N = 32M
rows pass ``LANE_MAJOR_BYTES``, so every WD-GCN training step runs the
readout backward through K2; so does every EvolveGCN step, whose (T, E)
slice one-hot (244 MiB) is over the gather-free path's budget, so it runs
the generic path with the plan. For ``tmgcn2`` a stderr line names the
restricted operator and, for K1, its packing's real entries against its
slots.

The flags and their defaults are the tool's own, except ``--out``: the
tool writes results/scale_bench.json, where the JAX package keeps its
history, so here the JSON file is written only when ``--out`` names one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tmgcn_torch.core.mmatrix import make_m_matrix
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.ops.degree import degree_features_np
from tmgcn_torch.tasks.windows import EdgeSplit

_NAMES = {"tmgcn1": "one_layer", "tmgcn2": "two_layer", "evolvegcn": "evolvegcn",
          "wdgcn": "wdgcn"}


def build_graph(n_nodes: int, n_slices: int, nnz_per_slice: int, seed: int = 0) -> TemporalCOO:
    """Power-law temporal adjacency, row-sorted per slice, scaled values."""
    rng = np.random.default_rng(seed)
    pop = rng.pareto(1.3, n_nodes) + 1.0
    p = pop / pop.sum()
    slices = []
    for _ in range(n_slices):
        r = rng.choice(n_nodes, nnz_per_slice, p=p).astype(np.int64)
        c = rng.choice(n_nodes, nnz_per_slice, p=p).astype(np.int64)
        order = np.argsort(r, kind="stable")
        r, c = r[order], c[order]
        # An approximate degree normalisation keeps activations bounded;
        # the bench measures throughput, not accuracy.
        v = np.full(len(r), 1.0 / np.sqrt(nnz_per_slice / n_nodes), np.float32)
        slices.append((r, c, v))
    return TemporalCOO.from_slices(slices, n_nodes, dtype=np.float32)


def build_inputs(n_nodes, n_slices, nnz_per_slice, n_edges, band, seed=1):
    """(A, M, X, edges, tgt, cw): the tool's workload, host-side numpy."""
    A = build_graph(n_nodes, n_slices, nnz_per_slice)
    M = make_m_matrix(n_slices, band).astype(np.float32)
    X = degree_features_np(A).astype(np.float32)
    rng = np.random.default_rng(seed)
    edges = np.stack([
        rng.integers(0, n_slices, n_edges),
        rng.integers(0, n_nodes, n_edges),
        rng.integers(0, n_nodes, n_edges),
    ]).astype(np.int64)
    tgt = rng.integers(0, 2, n_edges)
    cw = np.array([0.9, 0.1], np.float32)
    return A, M, X, edges, tgt, cw


def _check_family(fam: str) -> None:
    if fam not in _NAMES:
        raise ValueError(f"unknown family {fam!r}")


def build_model(fam: str, n_slices: int, f_in: int, M: np.ndarray):
    """(model, M for the adapter) of one family."""
    from tmgcn_torch.models.evolvegcn import EvolveGCN
    from tmgcn_torch.models.tmgcn import TMGCN, TMGCN2
    from tmgcn_torch.models.wdgcn import WDGCN

    _check_family(fam)
    if fam == "tmgcn1":
        return TMGCN(n_slices=n_slices, in_feat=f_in, hidden_feat=(6, 2)), M
    if fam == "tmgcn2":
        return TMGCN2(n_slices=n_slices, in_feat=f_in, hidden_feat=(6, 6, 2), nonlin2="selu"), M
    if fam == "wdgcn":
        return WDGCN(n_slices=n_slices, in_feat=f_in, hidden_feat=(6, 2)), None
    if fam == "evolvegcn":
        return EvolveGCN(n_slices=n_slices, in_feat=f_in, hidden_feat=(6, 2)), None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Rows of the steps' stats ring (at least the timed steps): ``run(n)``
# takes up to this many steps as one chunk, more in chunks of this size.
STATS_ROWS = 1024


def timed_epochs(adapter, train: EdgeSplit, cw: np.ndarray, n_steps: int):
    """n_steps SGD steps twice: the first run pays the first launches (on a
    card, the warm-up step and the capture of the step as a CUDA graph), the
    second is timed. Returns (seconds per step, first-run seconds, every
    step's loss as numpy, and ``run(n)``, which takes n more steps from where
    the timed ones ended and returns their losses as a tensor on the
    adapter's device).

    The steps are the training loop's edge-classification step on the train
    bundle (``train.loop.train_chunks``), run as its chunks: on a card, n
    steps are n replays of one captured graph, the port of the tool's
    scanned chunk. The step also counts its confusion, as the loop's does;
    the tool's scan keeps only the loss.
    """
    from tmgcn_torch.train.loop import TrainConfig, train_chunks

    device = adapter.device
    # Seed 0, as the tool draws its parameters.
    ring = max(n_steps, STATS_ROWS)
    chunks, _, _ = train_chunks(adapter, train, cw, TrainConfig(lr=0.01, momentum=0.9),
                                capacity=ring)

    def run(n):
        losses = []
        while n > 0:
            k = min(n, ring)
            chunks(k)
            losses.append(chunks.stats(k)[:, 0].clone())  # before the ring wraps
            n -= k
        return torch.cat(losses)

    _sync(device)
    t0 = time.perf_counter()
    first = run(n_steps).cpu().numpy()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    timed = run(n_steps).cpu().numpy()
    dt = (time.perf_counter() - t0) / n_steps
    return dt, t_first, np.concatenate([first, timed]), run


def labelled_edges(inputs) -> EdgeSplit:
    """The tool's labelled edges as the train window's split."""
    _, _, _, edges, tgt, _ = inputs
    return EdgeSplit(edges, tgt, np.ones(tgt.shape, bool))


def layer2_summary(bundle: dict) -> str:
    """The restricted layer 2 a tmgcn2 bundle holds: the operator (with
    what the ``auto`` rule saw, where it chose) and, for K1 packings, the
    real entries against the slots of the forward and backward packings."""
    from tmgcn_torch.kernels.spmm_cuda import FlatPallasOperator

    ops = bundle.get("l2s_op") or [bundle["l2op"]]
    what = (f"streamed over {len(ops)} groups" if "l2s_op" in bundle
            else f"one operator {type(ops[0]).__name__}")
    if "l2op_choice" in bundle:
        what += f", l2op_choice {bundle['l2op_choice']}"
    if all(isinstance(op, FlatPallasOperator) for op in ops):
        for side in ("packed", "packed_t"):
            real = sum(int(getattr(op, side).entry_order.shape[0]) for op in ops)
            slots = sum(getattr(op, side).rows.numel() for op in ops)
            what += f"; {side}: {real} entries in {slots} slots ({slots / max(real, 1):.2f}x)"
    return what


def run_family(fam: str, inputs, n_timed: int, device: str | torch.device,
               l2_stream: int | None = None) -> dict:
    """Build one family's adapter on the shared inputs and time its epochs.

    ``l2_stream``: tmgcn2's streamed layer 2 over this many groups of time
    slices (ignored by the other families, as the tool ignores it).
    Returns the tool's keys for the family (build seconds, ms/epoch,
    edges/s), ``steps`` / ``losses`` of every training step run,
    ``run(n)``: n more steps on the same adapter and parameters (a warm
    run to trace), and the ``adapter``.
    """
    from tmgcn_torch.tasks.adapters import WINDOWS, make_edge_adapter

    device = torch.device(device)
    A, M, X, edges, _, cw_np = inputs
    key = _NAMES[fam]
    t0 = time.perf_counter()
    model, Mw = build_model(fam, A.n_slices, X.shape[-1], M)
    # All three windows share the same objects: the adapter builds one
    # bundle (one device copy) for them.
    adapter = make_edge_adapter(
        model, {w: A for w in WINDOWS}, {w: X for w in WINDOWS},
        {w: edges for w in WINDOWS}, M=Mw, device=device,
        l2_stream_chunks=l2_stream if fam == "tmgcn2" else None,
    )
    _sync(device)
    build_s = time.perf_counter() - t0
    n = n_timed if fam == "tmgcn1" else max(n_timed // 4, 3)
    dt, t_first, losses, run = timed_epochs(adapter, labelled_edges(inputs), cw_np, n)
    n_edges = edges.shape[1]
    return {
        f"{key}_build_s": build_s,
        f"{key}_first_run_s": t_first,
        f"{key}_ms_per_epoch": dt * 1e3,
        f"{key}_edges_per_s": n_edges / dt,
        "steps": 2 * n,
        "losses": losses,
        "run": run,
        "adapter": adapter,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tmgcn_torch.utils.scale_bench")
    ap.add_argument("--nodes", type=int, default=500_000)
    ap.add_argument("--slices", type=int, default=64)
    ap.add_argument("--nnz-per-slice", type=int, default=2_000_000)
    ap.add_argument("--edges", type=int, default=1_000_000)
    ap.add_argument("--band", type=int, default=20)
    ap.add_argument("--n-timed", type=int, default=20)
    ap.add_argument("--l2-stream", type=int, default=None,
                    help="stream the tmgcn2 restricted layer 2 over this many groups of "
                         "time slices")
    ap.add_argument("--families", default="tmgcn1,tmgcn2",
                    help="comma list of tmgcn1,tmgcn2,evolvegcn,wdgcn")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    families = [f.strip() for f in args.families.split(",") if f.strip()]
    for fam in families:  # before the host build, which takes minutes at full size
        _check_family(fam)

    from tmgcn_torch.configs.build import resolve_device

    device = resolve_device(args.device)
    res = {
        "nodes": args.nodes, "slices": args.slices,
        "nnz_per_slice": args.nnz_per_slice, "edges": args.edges, "l2_stream": args.l2_stream,
        "device": str(device),
    }
    if device.type == "cuda":
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    t0 = time.perf_counter()
    inputs = build_inputs(args.nodes, args.slices, args.nnz_per_slice, args.edges, args.band)
    res["build_host_s"] = time.perf_counter() - t0
    A = inputs[0]
    print(f"# built: {A.n_slices}x{A.n_nodes}, {int(np.asarray(A.nnz).sum())} nnz, "
          f"host {res['build_host_s']:.1f}s", file=sys.stderr)
    for fam in families:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        out = run_family(fam, inputs, args.n_timed, device, args.l2_stream)
        key = _NAMES[fam]
        if fam == "tmgcn2":
            print(f"# tmgcn2 layer 2: {layer2_summary(out['adapter'].bundles['train'])}",
                  file=sys.stderr)
        ms = out[f"{key}_ms_per_epoch"]
        res.update({k: v for k, v in out.items() if k.startswith(key)})
        if device.type == "cuda":
            # The family's build and steps, its adapter included.
            res[f"{key}_peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
        print(f"# {fam} {ms:.3f} ms/epoch ({out[f'{key}_edges_per_s'] / 1e6:.3f} M edges/s), "
              f"first run {out[f'{key}_first_run_s']:.1f}s", file=sys.stderr)
        del out
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

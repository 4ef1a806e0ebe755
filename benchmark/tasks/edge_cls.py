"""Edge classification: the port's ``edge_cls`` task.

The port's side: the labelled edges of each window as ``EdgeSplit``s,
the adapter ``tasks.adapters.make_edge_adapter``, a trial
``train.loop.run_edge_classification`` (what ``configs.build.run_trial``
calls) and the captured step ``train.loop.train_chunks``. The
reference's side: ``reference.train.follow``, full-batch SGD with
momentum on the class-weighted cross-entropy, and the evaluation
windows' F1 and loss. ``planted`` puts a fault in the port's loop, for
the tests and ``benchmark.calibrate``.
"""

from __future__ import annotations

import contextlib

import numpy as np

from benchmark import program
from benchmark.reference import train as reftrain

TASK = "edge_cls"  # the port's ExperimentConfig.task
FAULTS = ("state_unchanged", "half_batch")


def from_experiment_data(cell, ecfg, data, device) -> program.Built:
    """The adapter of the port's ``build_data`` result: its windows split
    by the port's own classification split."""
    from tmgcn_torch.tasks.windows import split_edges_classification

    splits = split_edges_classification(data.edge_index, data.edge_values, data.spec,
                                        n_classes=ecfg.n_classes)
    return _built(cell, ecfg, data.spec.s_train, data.adj, data.feats, data.M, splits, device)


def from_graph(cell, ecfg, A, X, M, edges, target, device) -> program.Built:
    """The adapter of one window used for train, val and test."""
    from tmgcn_torch.tasks.adapters import WINDOWS
    from tmgcn_torch.tasks.windows import EdgeSplit

    split = EdgeSplit(edges, target, np.ones(target.shape, bool))
    return _built(cell, ecfg, A.n_slices, {w: A for w in WINDOWS}, {w: X for w in WINDOWS}, M,
                  {w: split for w in WINDOWS}, device)


def _built(cell, ecfg, n_slices, adj, feats, M, splits, device) -> program.Built:
    from tmgcn_torch.configs.build import build_model
    from tmgcn_torch.tasks.adapters import WINDOWS, make_edge_adapter

    model = build_model(ecfg, n_slices, feats["train"].shape[-1])
    adapter = make_edge_adapter(model, adj, feats, {w: splits[w].edges for w in WINDOWS},
                                M=M if ecfg.method == "tmgcn" else None, device=device)
    return program.Built(adapter, splits, np.asarray(cell.traffic["labels"]["class_weights"]),
                         program.train_config(ecfg), int(splits["train"].edges.shape[1]))


def trial(built: program.Built, variables: dict, checkpointer, tcfg=None):
    """One trial from ``variables``: the loop's rows (epochs, 12)."""
    from tmgcn_torch.train.loop import run_edge_classification

    rows, _ = run_edge_classification(built.adapter, built.splits, built.class_weights,
                                      tcfg or built.tcfg, variables=variables,
                                      checkpointer=checkpointer)
    return rows


def chunks(built: program.Built, variables: dict, capacity: int):
    """The loop's captured step on the train window, from ``variables``."""
    from tmgcn_torch.train.loop import train_chunks

    ch, _, _ = train_chunks(built.adapter, built.splits["train"], built.class_weights,
                            built.tcfg, variables=variables, capacity=capacity)
    return ch


def follow(cell, init: dict, wins: dict, n_steps: int, tf32: bool = False,
           eval_after: tuple[int, ...] = ()) -> dict:
    """The reference's first ``n_steps`` from ``init`` on ``wins["train"]``,
    scoring the other windows after each step of ``eval_after``."""
    eval_wins = {w: wins[w] for w in ("val", "test")} if eval_after else None
    return reftrain.follow(cell.family, cell.cfg, init, wins["train"],
                           cell.traffic["labels"]["class_weights"], n_steps, tf32=tf32,
                           eval_wins=eval_wins, eval_after=eval_after)


def eval_rows(row) -> dict:
    """The evaluation of a loop row (F1 val 6, loss val 7, F1 test 10,
    loss test 11), as ``follow`` gives it."""
    return {"val": (float(row[6]), float(row[7])), "test": (float(row[10]), float(row[11]))}


@contextlib.contextmanager
def planted(fault: str | None):
    """The port's training loop with ``fault`` planted (None: as it is).

    ``state_unchanged``: the optimizer's update does nothing;
    ``half_batch``: the loss takes the first half of the labelled edges
    alone, the mean over them."""
    from tmgcn_torch.train import loop

    if fault is None:
        yield
        return
    if fault == "state_unchanged":
        name, saved = "step", loop._Optimizer.step
        owner, patch = loop._Optimizer, (lambda self, grads: None)
    elif fault == "half_batch":
        name, saved = "weighted_cross_entropy", loop.weighted_cross_entropy
        owner = loop

        def patch(logits, targets, class_weights, mask=None):
            n = logits.shape[0] // 2
            return saved(logits[:n], targets[:n], class_weights)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(owner, name, patch)
    try:
        yield
    finally:
        setattr(owner, name, saved)

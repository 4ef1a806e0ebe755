"""The calls into the port (``tmgcn_torch``) that every cell shares.

The port is the system under test: its data pipeline, its adapters (the
packings, the cached propagation, the operator the ``auto`` rule picks),
its training loop and its captured step. The graph kind
(``benchmark/graphs/``) builds the port's data from the cell's traffic,
the task (``benchmark/tasks/``) its adapter and loop entries, the drive
(``benchmark/drives/``) runs the window; they meet here.

A trial's loop calls its checkpointer after every evaluation epoch; the
benchmark passes ``BlockHook`` as that checkpointer, which saves nothing
and is where the benchmark reads the trial's state, marks block
boundaries and cuts the window.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from tmgcn_torch.configs.build import build_data
from tmgcn_torch.configs.schema import ExperimentConfig
from tmgcn_torch.core.mmatrix import make_m_matrix
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.ops.degree import degree_features_np
from tmgcn_torch.train.loop import TrainConfig


class Spans:
    """Host-clock spans of the set-up, by name, in seconds."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    def __call__(self, name: str, device):
        spans = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                spans.seconds[name] = spans.seconds.get(name, 0.0) + time.perf_counter() - self.t0

        return _Span()


@dataclasses.dataclass
class Built:
    """The port's side of a cell: its adapter, the windows' labelled edges,
    class weights and loop settings."""

    adapter: object
    splits: dict
    class_weights: np.ndarray
    tcfg: TrainConfig
    n_train_edges: int


def experiment_config(cell) -> ExperimentConfig:
    """The port's config of a cell: the model of its configuration, the task
    and training schedule of its traffic."""
    cfg, traffic = cell.cfg, cell.traffic
    n_classes = traffic["labels"]["classes"]
    drive = traffic["drive"]
    return ExperimentConfig(
        name=cell.name, dataset=traffic["graph"].get("dataset", traffic["name"]),
        method=cfg["method"], task=cell.task.TASK, n_layers=len(cfg["hidden_feat"]),
        hidden_feat=(*cfg["hidden_feat"], n_classes), nonlin2=cfg.get("nonlin2", "selu"),
        condensed_W=cfg.get("condensed_W", True), n_classes=n_classes,
        n_epochs=drive.get("epochs", 1), eval_every=drive.get("eval_every", 1),
        same_block_size=cfg["same_block_size"], lr=cfg["lr"], momentum=cfg["momentum"],
        optimizer=cfg["optimizer"], dtype=cfg["dtype"], spmm_impl=cfg["spmm_impl"],
    )


def train_config(ecfg: ExperimentConfig) -> TrainConfig:
    return TrainConfig(n_epochs=ecfg.n_epochs, lr=ecfg.lr, momentum=ecfg.momentum,
                       eval_every=ecfg.eval_every, optimizer=ecfg.optimizer)


def check_variables(adapter, shapes: dict) -> None:
    """The port's parameter tree has the names and shapes the reference
    draws; raise otherwise (the benchmark hands both the same values)."""

    def tree(v):
        return {k: tree(x) if isinstance(x, dict) else tuple(x.shape) for k, x in v.items()}

    got = tree(adapter.init(torch.Generator().manual_seed(0)))
    want = {k: {n: tree_shapes(s) for n, s in v.items()} for k, v in shapes.items()}
    if got != want:
        raise RuntimeError(f"the port's variables {got} are not the reference's {want}")


def tree_shapes(s):
    return {k: tree_shapes(v) for k, v in s.items()} if isinstance(s, dict) else tuple(s)


def build_konect(cell, data_dir, device, spans: Spans) -> Built:
    """The port's data and adapter of a dataset of its registry
    (``build_data`` caches its artifact in ``data_dir``)."""
    ecfg = experiment_config(cell)
    with spans("setup.data", device):
        data = build_data(ecfg, data_dir=data_dir)
    with spans("setup.adapter", device):
        return cell.task.from_experiment_data(cell, ecfg, data, device)


def build_generated(cell, graph, device, spans: Spans) -> Built:
    """The port's data and adapter of a generated graph: its slices as the
    port's ``TemporalCOO`` (duplicates summed, rows sorted), the port's
    degree features, M over the graph's slices, one window for all three."""
    ecfg = experiment_config(cell)
    T, N = graph.n_slices, graph.n_nodes
    with spans("setup.data", device):
        t, r, c, v = (x.cpu().numpy() for x in (graph.t, graph.r, graph.c, graph.v))
        cuts = np.searchsorted(t, np.arange(T + 1))
        A = TemporalCOO.from_slices(
            [(r[a:b], c[a:b], v[a:b]) for a, b in zip(cuts[:-1], cuts[1:])], N)
        X = degree_features_np(A)
        edges = graph.edges.cpu().numpy()
        target = graph.target.cpu().numpy()
    with spans("setup.adapter", device):
        M = None
        if ecfg.method == "tmgcn":
            M = make_m_matrix(T, cell.cfg["m_diagonals"], weight=cell.cfg["m_weight"])
        return cell.task.from_graph(cell, ecfg, A, X, M, edges, target, device)


class Cut(Exception):
    """The window's end at a block boundary: the trial stops after the
    evaluation epoch ``epoch``."""

    def __init__(self, epoch: int, results: np.ndarray | None):
        super().__init__(epoch)
        self.epoch = epoch
        self.results = results


def snapshot(params: dict, opt_state: dict, results: np.ndarray, epoch: int) -> dict:
    from benchmark.reference.train import leaves

    return {
        "params": {k: v.detach().clone() for k, v in leaves(params).items()},
        "mu": [m.detach().clone() for m in opt_state["mu"]],
        "rows": np.array(results[: epoch + 1]),
    }


class BlockHook:
    """The checkpointer the benchmark hands the loop: ``save`` runs after
    every evaluation epoch, at a block boundary, and saves nothing.

    In trial 0 it snapshots the state after the evaluation epochs of
    ``snap_epochs`` and opens the window at ``start_epoch``'s boundary, so
    the set-up has driven that trial through its first block. In the
    window it records each boundary (trial, epoch, host seconds) and, once
    ``seconds`` have passed, raises ``Cut``."""

    def __init__(self, start_epoch: int, seconds: float, snap_epochs=()):
        self.start_epoch = start_epoch
        self.seconds = seconds
        self.snap_epochs = set(snap_epochs)
        self.trial = 0
        self.snaps: dict[int, dict] = {}
        self.window_start = None
        self.deadline = None
        self.boundaries: list[tuple[int, int, float]] = []

    def restore(self):
        return None

    def save(self, epoch, params, opt_state, results, buffers=None):
        if self.trial == 0 and epoch in self.snap_epochs:
            self.snaps[epoch] = snapshot(params, opt_state, results, epoch)
        now = time.perf_counter()
        if self.window_start is None:
            if self.trial == 0 and epoch == self.start_epoch:
                self.window_start = now
                self.deadline = now + self.seconds
            return
        self.boundaries.append((self.trial, epoch, now))
        if now >= self.deadline:
            raise Cut(epoch, np.array(results[: epoch + 1]))


def memory(device) -> tuple[int, int]:
    """(allocated, peak allocated) bytes on the device; zeros off the card."""
    if device.type != "cuda":
        return 0, 0
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device), torch.cuda.max_memory_allocated(device)


def run_trials(task, built: Built, draw, hook: BlockHook, device) -> dict:
    """Trials from fresh parameters (``draw()``) until the hook cuts one.
    Returns the window's epochs, its seconds, the epochs whose loss is not
    finite, the trials begun, trial 0's initial variables, the peak of
    the set-up and trial 0, and the bytes allocated at each trial's start."""
    trial, epochs, failed, init0, peak_first, starts = 0, 0, 0, None, None, []
    while True:
        hook.trial = trial
        starts.append(memory(device)[0])
        variables = draw()
        if trial == 0:
            init0 = {k: {n: x for n, x in v.items()} for k, v in variables.items()}
        cut = False
        try:
            rows = task.trial(built, variables, hook)
        except Cut as c:
            rows, cut = c.results, True
        if trial == 0:
            peak_first = memory(device)[1]
        # The trial's step and graph go before the next is built, as a sweep
        # that frees one trial's state before the next would.
        del variables
        gc.collect()
        end = time.perf_counter()
        if hook.window_start is None:
            raise RuntimeError("trial 0 ended before the window opened")
        first = hook.start_epoch + 1 if trial == 0 else 0
        losses = rows[first:, 3]
        epochs += len(losses)
        failed += int(np.sum(~np.isfinite(losses)))
        if cut or end >= hook.deadline:
            return {"epochs": epochs, "seconds": end - hook.window_start, "failed": failed,
                    "trials": trial + 1, "init0": init0, "peak": peak_first,
                    "trial_start_bytes": starts}
        trial += 1


def step_snapshot(chunks) -> dict:
    """The step's parameters, optimizer trace and losses so far (synchronises)."""
    from benchmark.reference.train import leaves

    st = chunks.step
    return {"params": {k: v.detach().clone() for k, v in leaves(st.variables["params"]).items()},
            "mu": [m.detach().clone() for m in st.opt.mu],
            "losses": chunks.stats(chunks.n_done)[:, 0].cpu().numpy().copy()}


def run_steps(chunks, seconds: float, chunk: int) -> dict:
    """Chunks of ``chunk`` captured steps, each ending in a fetch of its
    losses, until ``seconds`` have passed."""
    steps, failed, walls = 0, 0, []
    t0 = end = time.perf_counter()
    while True:
        chunks(chunk)
        losses = chunks.stats(chunk)[:, 0].cpu().numpy()
        steps += chunk
        failed += int(np.sum(~np.isfinite(losses)))
        walls.append(time.perf_counter() - end)
        end = time.perf_counter()
        if end - t0 >= seconds:
            return {"epochs": steps, "seconds": end - t0, "failed": failed, "block_walls": walls}

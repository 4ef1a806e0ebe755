"""Task training loops: full-batch SGD with periodic evaluation (port of
tmgcn_tpu.train.loop: edge classification, link prediction and node
regression).

Reproduces the reference experiment-script protocol (capability reference:
TensorGCN-master/experiment_bitcoin_our.py:100-173 for edge
classification, experiment_bitcoin_our_link_prediction.py:82-139 for link
prediction, test_graph_SEIR.py:149-200 for regression): full-batch SGD (lr
0.01, momentum 0.9), evaluation of val/test every ``eval_every`` epochs,
and per-epoch metric rows in the reference's layouts ((epochs, 12) for F1,
(epochs, 9) for MAP-MRR); regression trains in chunks of ``eval_every``
epochs and scores val and test once, at the end.

Cadence as in the JAX package: one evaluation epoch (a step whose fresh
training logits are scored, then val/test), then ``eval_every - 1`` plain
steps. The per-epoch loss and confusion counts stay on the device and are
fetched once per chunk of plain steps. Matmuls run in full float32 with
TF32 off — the port's form of the JAX package's HIGHEST-precision
training contract.

On a card every epoch's step is one CUDA graph, captured once and replayed
— the port of the JAX package's ``chunk_step`` (a ``lax.scan`` of steps in
one device call): a chunk of k plain epochs is k replays with no kernel
issued from Python between them, and evaluation epochs replay the same
graph. There is no switch: on the CPU the same step runs eagerly. An
adapter with ``train_stats`` (the sharded ones) has a second step for the
plain epochs, as the JAX package's ``chunk_step`` trains on it: loss and
confusion counts without the full logits. It is captured as a graph of its
own, over the same parameters, optimizer state and stats ring.

Checkpoints (``train.checkpoint.RunCheckpointer``), as the JAX package
takes them: classification and link prediction save after each evaluation
epoch, regression after each chunk. A run given a checkpointer that holds
one copies its params and optimizer state into the step's own tensors
before the step is built or captured, and goes on at the epoch after it.
The classification and link-prediction loops then start with an
evaluation epoch, so a resumed run repeats the chunk after the saved
epoch on a shifted schedule: its train losses (and classification's train
F1) equal the uninterrupted run's, its evaluation rows do not. Regression
saves at chunk ends, so its resumed run is the uninterrupted one.

Spans (``utils.profiling``; they record only while the recorder is on): a
loop run is one ``loop.trial``; inside it ``loop.prepare`` (building the
step), ``loop.capture`` (the warm-up step and the capture), ``loop.steps``
(a chunk of replays, ``n``), ``loop.fetch`` (a chunk's stats to the host,
where the host waits for the card), ``loop.rows`` (the host rows of a
plain chunk), ``loop.eval`` (an evaluation epoch) with its
``loop.eval.forward`` and ``loop.eval.score``, and ``loop.checkpoint``.
None is opened per replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from tmgcn_torch.kernels import spmm_cuda
from tmgcn_torch.tasks import metrics as M
from tmgcn_torch.tasks.adapters import ModelAdapter
from tmgcn_torch.tasks.windows import EdgeSplit, LinkPredSplit
from tmgcn_torch.train.losses import (
    sigmoid_pair_logits,
    summed_per_slice_mse,
    weighted_cross_entropy,
)
from tmgcn_torch.utils.profiling import TRIAL, span, spanned


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_epochs: int = 100
    lr: float = 0.01
    momentum: float = 0.9
    eval_every: int = 100
    verbose: bool = False
    optimizer: str = "sgd"  # "sgd" (reference) | "adam"
    grad_clip: float | None = None  # global-norm clip (None = off)
    debug_nans: bool = False  # eager steps checked for NaN (_NanCheckedChunks)


class _Optimizer:
    """optax's sgd(lr, momentum) or adam(lr), after clip_by_global_norm
    when ``grad_clip`` is set, written out with tensor ops in optax's
    arithmetic order. ``step(grads)`` updates the parameters and the state
    in place, reading nothing on the host: Adam's step count is a float64
    tensor beside the parameters, so a replayed step reads its own epoch's
    count, and its bias corrections 1 - decay**count are taken in float64
    and divided in the moments' type, as optax takes them.

    Not torch.optim: constructing one imports torch._dynamo, which costs
    seconds of start-up in every process. torch's SGD with momentum
    (dampening 0) makes the same update as optax's trace-then-scale.
    """

    def __init__(self, cfg: TrainConfig, params: list[torch.Tensor]):
        if cfg.optimizer not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.params = params
        self.mu = [torch.zeros_like(p) for p in params]  # sgd: the trace
        adam = cfg.optimizer == "adam"
        self.nu = [torch.zeros_like(p) for p in params] if adam else []
        self.count = torch.zeros((), dtype=torch.float64, device=params[0].device) if adam else None

    def state_dict(self) -> dict:
        """The state's tensors (not copies): {"mu"} for SGD, {"mu", "nu",
        "count"} for Adam, in the order of ``params``."""
        if self.count is None:
            return {"mu": self.mu}
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict`` into this state's own tensors, in place: a
        captured step keeps reading the same storage."""
        own = self.state_dict()
        if set(state) != set(own):
            raise ValueError(f"optimizer state {sorted(state)} does not fit {sorted(own)}")
        for key, dst in own.items():
            src = state[key]
            if key == "count":
                dst.copy_(src)
                continue
            if len(src) != len(dst) or any(a.shape != b.shape for a, b in zip(src, dst)):
                raise ValueError(f"optimizer state {key!r} does not fit the parameters")
            for a, b in zip(dst, src):
                a.copy_(b)

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        cfg = self.cfg
        if cfg.grad_clip is not None:
            grads = _clip_by_global_norm(grads, cfg.grad_clip)
        if cfg.optimizer == "sgd":
            for p, g, t in zip(self.params, grads, self.mu):
                t.mul_(cfg.momentum).add_(g)  # t = g + momentum * t
                p.add_(t, alpha=-cfg.lr)
            return
        b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam's defaults
        self.count.add_(1)
        bc1, bc2 = 1 - b1**self.count, 1 - b2**self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * g**2 + b2 * v)
            m_hat = m / bc1.to(m.dtype)
            v_hat = v / bc2.to(v.dtype)
            p.add_(-cfg.lr * (m_hat / (torch.sqrt(v_hat) + eps)))


def _optimizer(cfg: TrainConfig, params: list[torch.Tensor]) -> _Optimizer:
    return _Optimizer(cfg, params)


def _tree_map(fn, tree: dict) -> dict:
    """fn on every tensor of a nested dict; the same nesting back."""
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _tree_leaves(tree: dict) -> list[torch.Tensor]:
    """Every tensor of a nested dict, in key order at each level (as optax
    flattens a dict pytree)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def _tree_names(tree: dict, prefix: str = "") -> list[str]:
    """The dotted name of every tensor of a nested dict, in ``_tree_leaves``'s order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_tree_names(v, f"{prefix}{k}.") if isinstance(v, dict) else [prefix + k])
    return out


@torch.no_grad()
def _copy_tree_(dst: dict, src: dict) -> None:
    """Copy every tensor of ``src`` into the same place of ``dst``, in
    place; the trees must have the same keys and shapes."""
    if set(dst) != set(src):
        raise ValueError(f"checkpoint keys {sorted(src)} do not fit {sorted(dst)}")
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_tree_(v, src[k])
        elif v.shape != src[k].shape:
            raise ValueError(f"checkpoint {k!r} has shape {tuple(src[k].shape)}, "
                             f"not {tuple(v.shape)}")
        else:
            v.copy_(src[k])


def _restore(checkpointer, params: dict, opt: _Optimizer) -> tuple[int, np.ndarray] | None:
    """The newest checkpoint's params and optimizer state copied into
    ``params`` and ``opt`` in place (never rebound: a captured step holds
    their addresses); (epoch, results rows) or None if there is none."""
    restored = checkpointer.restore()
    if restored is None:
        return None
    step, state = restored
    _copy_tree_(params, state["params"])
    opt.load_state_dict(state["opt_state"])
    return step, state["results"].numpy()


def _clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """optax.clip_by_global_norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return [torch.where(norm < max_norm, g, (g / norm) * max_norm) for g in grads]


def _f1(tp: float, fp: float, fn: float) -> tuple[float, float, float]:
    with np.errstate(invalid="ignore", divide="ignore"):
        p = float(np.float64(tp) / (tp + fp))
        r = float(np.float64(tp) / (tp + fn))
        f1 = float(2 * np.float64(p) * r / (p + r))
    return p, r, f1


def _confusion(out: torch.Tensor, tgt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    guess = torch.argmax(out, dim=1)
    tp = torch.sum((guess == 0) & (tgt == 0))
    fp = torch.sum((guess == 0) & (tgt != 0))
    fn = torch.sum((guess != 0) & (tgt == 0))
    return tp, fp, fn


def _prepare(
    adapter: ModelAdapter,
    cfg: TrainConfig,
    generator: torch.Generator | None,
    variables: dict | None,
    checkpointer,
) -> tuple[dict, dict, _Optimizer, tuple[int, np.ndarray] | None]:
    """TF32 off; (params, buffers, optimizer, resumed) on the adapter's
    device.

    ``variables`` (e.g. parameters carried over from the JAX package with
    ``configs.build.params_from_jax``) are copied to the adapter's device;
    otherwise they are drawn from ``generator`` (seed 0 if None). Params
    and buffers may nest (WD-GCN's ``lstm``): every leaf of ``params`` is
    trained. With a ``checkpointer`` that holds a checkpoint, its params
    and optimizer state are then copied over them (``_restore``; the draw
    still happens, so a shared generator stays aligned for later runs) and
    ``resumed`` is (its epoch, its results rows); otherwise None.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = adapter.device
    if variables is None:
        variables = adapter.init(
            generator if generator is not None else torch.Generator().manual_seed(0)
        )
    params = _tree_map(
        lambda v: v.detach().to(device).clone().requires_grad_(True), variables["params"]
    )
    buffers = _tree_map(lambda v: v.to(device), variables["buffers"])
    opt = _optimizer(cfg, _tree_leaves(params))
    resumed = _restore(checkpointer, params, opt) if checkpointer is not None else None
    return params, buffers, opt, resumed


class _Step:
    """One SGD step on the train bundle, written so that a CUDA graph can
    hold it: the JAX package's ``sgd_step`` and the confusion counts of its
    ``chunk_step`` body.

    A call runs the forward, ``loss(out, target)`` (the weighted
    cross-entropy of a task's class weights, or the regression's summed
    per-slice MSE), the backward (``torch.autograd.grad``: the gradients are
    the step's own tensors, with no ``.grad`` to zero or free) and the
    optimizer's update in place; writes the step's stats — [loss] (and tp,
    fp, fn with ``with_confusion``) of the pre-update outputs, float64 — into
    row ``slot`` of ``stats``, a ring of ``capacity`` rows on the device, and
    advances ``slot``; and returns (out, carry): those outputs after
    ``logit_transform`` and the adapter's carry (EvolveGCN's evolved final
    weights, which the evaluation windows start from), both detached.
    Nothing in it reads the device from the host or keeps state in Python,
    so each replay of its capture is the next epoch. ``check``, when set
    (by ``_NanCheckedChunks``, eager only), sees the loss and the gradients
    before the update. ``phase_events`` (on a card): four timing events,
    recorded before the forward, after the loss, after the gradients and
    after the update and the stats; captured, they are event-record nodes
    of the graph, and ``_EagerChunks.phase_ms`` reads the last step's
    phases from them. Without them the step records no event.
    """

    check = None

    def __init__(self, adapter: ModelAdapter, variables: dict, opt: _Optimizer,
                 loss, target, with_confusion: bool, capacity: int,
                 logit_transform=None, phase_events: bool = False):
        self.device = adapter.device
        self.adapter = adapter
        self.variables = variables
        self.opt = opt
        self.bundle = adapter.bundles["train"]
        self.loss = loss
        self.tgt = torch.as_tensor(target, device=self.device)
        self.with_confusion = with_confusion
        self.logit_transform = logit_transform
        self.capacity = capacity
        n_stats = 4 if with_confusion else 1
        self.stats = torch.zeros((capacity, n_stats), dtype=torch.float64, device=self.device)
        self.slot = torch.zeros((1,), dtype=torch.long, device=self.device)
        self.events = None
        if phase_events:
            self.events = [torch.cuda.Event(enable_timing=True, external=True) for _ in range(4)]

    def __call__(self) -> tuple[torch.Tensor, object]:
        self._mark(0)
        out, carry = self.adapter.apply(self.variables, self.bundle, ())
        if self.logit_transform is not None:
            out = self.logit_transform(out)
        loss = self.loss(out, self.tgt)
        self._mark(1)
        self._update(loss)
        out = out.detach()
        stats = [loss.detach().double()]
        if self.with_confusion:
            stats.extend(c.double() for c in _confusion(out, self.tgt))
        self._record(stats)
        self._mark(3)
        return out, tuple(c.detach() for c in carry)

    def _mark(self, i: int) -> None:
        if self.events is not None:
            self.events[i].record()

    def _update(self, loss: torch.Tensor) -> None:
        grads = list(torch.autograd.grad(loss, self.opt.params))
        self._mark(2)
        if self.check is not None:
            self.check(loss, grads)
        self.opt.step(grads)

    def _record(self, stats: list[torch.Tensor]) -> None:
        self.stats.index_copy_(0, self.slot, torch.stack(stats)[None])
        self.slot.add_(1).remainder_(self.capacity)


class _StatsStep(_Step):
    """The step of the plain epochs on an adapter with ``train_stats`` (the
    sharded adapters): the JAX package's ``sgd_step_stats``. Its loss and
    confusion counts come from ``train_stats``, which never restores the
    full logits; it shares ``step``'s parameters, optimizer and stats ring,
    and returns (None, ()).
    """

    def __init__(self, step: _Step, class_weights: torch.Tensor):
        self.__dict__.update(step.__dict__)
        self.cw = class_weights

    def __call__(self) -> tuple[None, tuple]:
        self._mark(0)
        loss, counts = self.adapter.train_stats(
            self.variables, self.bundle, self.tgt, self.cw, self.logit_transform,
            confusion=self.with_confusion,
        )
        self._mark(1)
        self._update(loss)
        self._record([loss.detach().double(), *(c.double() for c in counts)])
        self._mark(3)
        return None, ()


class _EagerChunks:
    """Runs a step n times from Python, op by op: the CPU's path, and on a
    card the reference that the captured chunks are held to.

    ``chunks(n)`` takes n steps and returns the last one's (out, carry);
    ``chunks(n, plain=True)`` takes them with ``plain``, the step of the
    plain epochs where the adapter has one (``_StatsStep``), and returns
    its (None, ()); ``stats(n)`` is the stats rows of the last n steps,
    oldest first (the steps this runner took: a resumed run's first step is
    its first). ``resumed``: (epoch, results rows) of the checkpoint the
    step's state was restored from, or None. A chunk's steps are one
    ``loop.steps`` span, with their count ``n``.
    """

    def __init__(self, step: _Step, plain: _Step | None = None):
        self.step = step
        self.plain = type(self)(plain) if plain is not None else None
        self.n_done = 0
        self.resumed = None

    def __call__(self, n: int, plain: bool = False) -> tuple[torch.Tensor, object]:
        if n < 1:
            raise ValueError(f"a chunk takes at least one step, not {n}")
        out = self.plain(n) if plain and self.plain is not None else self._run(n)
        self.n_done += n
        return out

    def _run(self, n: int) -> tuple[torch.Tensor, object]:
        with span("loop.steps", n=n):
            for _ in range(n):
                out = self.step()
        return out

    def phase_ms(self) -> dict[str, float]:
        """The last step's forward (with the loss), backward and update
        milliseconds on the card, from its timing events (``train_chunks``
        with ``phase_events``); synchronise before reading."""
        ev = self.step.events
        if ev is None:
            raise ValueError("the step records no phase events: train_chunks(phase_events=True)")
        return {name: a.elapsed_time(b)
                for name, a, b in zip(("forward", "backward", "update"), ev, ev[1:])}

    def stats(self, n: int) -> torch.Tensor:
        cap = self.step.capacity
        if not 1 <= n <= min(cap, self.n_done):
            raise ValueError(f"the stats of {n} steps: {self.n_done} done, {cap} kept")
        start = (self.n_done - n) % cap
        if start + n <= cap:
            return self.step.stats[start : start + n]
        return torch.cat([self.step.stats[start:], self.step.stats[: start + n - cap]])


@contextlib.contextmanager
def _syncs_raise():
    """Any operation that makes the host wait for the card raises, naming
    itself: in the step it would stall every epoch, and fail the capture."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class _CapturedChunks(_EagerChunks):
    """On a card: the step captured once as a CUDA graph and replayed.

    The first step runs eagerly on a side stream, as PyTorch asks before a
    capture (cuBLAS handles, workspaces and the autograd engine's buffers
    come into being there); it is the run's first epoch, so the trajectory
    is the eager one. Then the step is captured (which records and runs
    nothing) and every later step is a replay: n steps are n replays, with
    no kernel issued from Python between them. The kernels' launch counts
    follow what ran: the capture's calls count nothing, each replay adds the
    launches the capture recorded. A host sync in the step, or a capture or
    replay that fails, raises; nothing falls back to the eager steps. The
    warm-up step and the capture are the ``loop.capture`` span; the
    replays of a chunk one ``loop.steps`` span.
    """

    def __init__(self, step: _Step, plain: _Step | None = None):
        super().__init__(step, plain)
        self.graph = None
        self.out = None
        self.launches = spmm_cuda.LaunchLog()

    def _run(self, n: int) -> tuple[torch.Tensor, object]:
        if self.graph is None:
            with span("loop.capture"):
                out = self._warm_up()
                self._capture()
            n -= 1
            if n == 0:
                return out
        with span("loop.steps", n=n):
            for _ in range(n):
                self.graph.replay()
        self.launches.replayed(n)
        return self.out

    def _warm_up(self) -> tuple[torch.Tensor, object]:
        device = self.step.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), _syncs_raise():
            out = self.step()
        torch.cuda.current_stream(device).wait_stream(side)
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        try:
            with self.launches.recording(), torch.cuda.graph(graph), _syncs_raise():
                self.out = self.step()
        except RuntimeError as e:
            raise RuntimeError(f"capturing the training step as a CUDA graph failed: {e}") from e
        self.graph = graph


class _NanCheckedChunks(_EagerChunks):
    """``--debug-nans``: the port's form of the JAX package's
    ``jax_debug_nans``. Every step runs eagerly (a captured graph cannot
    stop at a host check), under ``torch.autograd.detect_anomaly(
    check_nan=True)``, and its loss and every gradient are read before the
    update. The first NaN raises ``FloatingPointError`` naming the epoch and
    the tensor (or the backward function that returned it); the parameters
    then hold the previous epoch's values. As under ``jax_debug_nans``, an
    inf is not a NaN and passes.
    """

    def __init__(self, step: _Step, plain: _Step | None = None):
        super().__init__(step)
        self.plain_step = plain
        self.names = ["loss"] + [f"the gradient of {n}"
                                 for n in _tree_names(step.variables["params"])]

    def __call__(self, n: int, plain: bool = False) -> tuple[torch.Tensor, object]:
        if n < 1:
            raise ValueError(f"a chunk takes at least one step, not {n}")
        step = self.plain_step if plain and self.plain_step is not None else self.step
        with torch.autograd.detect_anomaly(check_nan=True):
            for _ in range(n):
                out = self._checked(step)
                self.n_done += 1
        return out

    def _checked(self, step: _Step) -> tuple[torch.Tensor, object]:
        epoch = self.n_done + (self.resumed[0] + 1 if self.resumed is not None else 0)

        def check(loss: torch.Tensor, grads: list[torch.Tensor]) -> None:
            bad = [name for name, t in zip(self.names, [loss, *grads]) if torch.isnan(t).any()]
            if bad:
                raise FloatingPointError(f"NaN at epoch {epoch}: {', '.join(bad)}")

        step.check = check
        try:
            return step()
        except RuntimeError as e:  # anomaly mode: a backward function returned NaN
            if "nan values" not in str(e):
                raise
            raise FloatingPointError(f"NaN at epoch {epoch}: {e}") from e
        finally:
            step.check = None


def _chunks(step: _Step, plain: _Step | None = None) -> _EagerChunks:
    """The steps' chunk runner: captured on a card (each step its own graph),
    eager on the CPU."""
    runner = _CapturedChunks if step.device.type == "cuda" else _EagerChunks
    return runner(step, plain)


def _lp_target(train: LinkPredSplit) -> np.ndarray:
    """The labels of a link-prediction window's model edges: its slice-0
    edges dropped, as the adapter's bundles drop them."""
    return train.target[train.edges[0] != 0]


@spanned("loop.prepare")
def train_chunks(
    adapter: ModelAdapter,
    train: EdgeSplit | LinkPredSplit | np.ndarray,
    class_weights: np.ndarray | None,
    cfg: TrainConfig,
    task: str = "edge_cls",
    loss_type: str = "softmax",
    generator: torch.Generator | None = None,
    variables: dict | None = None,
    checkpointer=None,
    capacity: int | None = None,
    phase_events: bool = False,
) -> tuple[_EagerChunks, object, dict]:
    """The step that a task trains on the adapter's train bundle, as the
    JAX package's ``_make_steps`` (and ``run_regression``'s chunk body)
    builds it: (chunks, eval_forward, variables).

    ``task`` "edge_cls": the step scores ``train.target`` by the weighted
    cross-entropy of ``class_weights``; its stats rows are [loss, tp, fp,
    fn]. "link_pred": it scores the window's model edges (``_lp_target``),
    loss_type "sigmoid" maps 1-column logits to [p, 1-p] pairs; its stats
    rows are [loss]. "regression": ``train`` is the train window's (T, N)
    targets, scored in float32 by the summed per-slice MSE
    (``class_weights`` unused); its stats rows are [loss]. ``chunks`` runs
    the step (see ``_chunks``), keeping the stats of its last ``capacity``
    steps (default ``cfg.n_epochs``). ``eval_forward(window, carry)`` is
    the window's forward without grad, eager. The arguments ``generator``,
    ``variables`` and ``checkpointer``: as ``_prepare`` takes them; the
    ``variables`` returned are the params the step trains and the buffers.
    ``phase_events`` (a card's adapter only; off it raises ``ValueError``):
    the step records its phases' timing events (``_Step``), read by
    ``chunks.phase_ms()``. The ``loop.prepare`` span.
    """
    if phase_events and adapter.device.type != "cuda":
        raise ValueError(f"phase events time the step on a CUDA device, not {adapter.device}")
    transform = None
    if task == "edge_cls":
        if loss_type != "softmax":
            raise ValueError(f"edge classification trains the softmax loss, not {loss_type!r}")
        target = train.target
    elif task == "link_pred":
        if loss_type not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown loss_type {loss_type!r}")
        target = _lp_target(train)
        transform = sigmoid_pair_logits if loss_type == "sigmoid" else None
    elif task == "regression":
        # float32: the JAX package's default float (x64 off).
        target = np.asarray(train, dtype=np.float32)
    else:
        raise ValueError(f"no training step for task {task!r}")
    params, buffers, opt, resumed = _prepare(adapter, cfg, generator, variables, checkpointer)
    if resumed is not None and resumed[0] >= cfg.n_epochs:
        # The JAX package fails here too, in a numpy broadcast.
        raise ValueError(f"the newest checkpoint is of epoch {resumed[0]}, past this run's "
                         f"{cfg.n_epochs} epochs")
    variables = {"params": params, "buffers": buffers}
    if task == "regression":
        loss = summed_per_slice_mse
    else:
        cw = torch.as_tensor(class_weights, dtype=torch.float64, device=adapter.device)
        loss = functools.partial(weighted_cross_entropy, class_weights=cw)
    step = _Step(adapter, variables, opt, loss, target,
                 with_confusion=task == "edge_cls",
                 capacity=capacity if capacity is not None else max(cfg.n_epochs, 1),
                 logit_transform=transform, phase_events=phase_events)
    # Plain epochs train on the adapter's train_stats where it has one, as
    # the JAX package's chunk_step does (tmgcn_tpu/train/loop.py:112-140).
    plain = None
    if adapter.train_stats is not None and task != "regression":
        plain = _StatsStep(step, cw)

    @torch.no_grad()
    def eval_forward(window: str, carry):
        return adapter.apply(variables, adapter.bundles[window], carry)

    chunks = _NanCheckedChunks(step, plain) if cfg.debug_nans else _chunks(step, plain)
    chunks.resumed = resumed
    return chunks, eval_forward, variables


def _save(checkpointer, epoch: int, chunks: _EagerChunks, results: np.ndarray) -> None:
    """Epoch ``epoch``'s params, optimizer state, rows and buffers, read
    after the chunk's steps (outside the captured step): the
    ``loop.checkpoint`` span."""
    v = chunks.step.variables
    with span("loop.checkpoint", epoch=epoch):
        checkpointer.save(epoch, v["params"], chunks.step.opt.state_dict(), results,
                          buffers=v["buffers"])


@spanned(TRIAL)
def run_edge_classification(
    adapter: ModelAdapter,
    splits: dict[str, EdgeSplit],
    class_weights: np.ndarray,
    cfg: TrainConfig,
    generator: torch.Generator | None = None,
    variables: dict | None = None,
    checkpointer=None,
) -> tuple[np.ndarray, dict]:
    """Train an edge classifier; returns ((epochs, 12) metrics, variables).

    ``variables``, ``generator``: as ``_prepare`` takes them; the returned
    variables have the same tree. ``checkpointer``: saved after each
    evaluation epoch; a run that finds a checkpoint takes its rows up to
    its epoch and the val/test stats of that row, and goes on at the next
    epoch (see the module's docstring).
    """
    chunks, eval_forward, variables = train_chunks(
        adapter, splits["train"], class_weights, cfg, generator=generator,
        variables=variables, checkpointer=checkpointer,
    )

    results = np.zeros((cfg.n_epochs, 12))
    val_stats = (0.0,) * 4
    test_stats = (0.0,) * 4
    ep = 0
    if chunks.resumed is not None:
        step, rows = chunks.resumed
        results[: step + 1] = rows[: step + 1]
        val_stats, test_stats = tuple(rows[step, 4:8]), tuple(rows[step, 8:12])
        ep = step + 1
    while ep < cfg.n_epochs:
        # Evaluation epoch: one step, then score val/test.
        with span("loop.eval", epoch=ep):
            _, carry = chunks(1)
            with span("loop.fetch", n=1):
                loss, tp, fp, fn = chunks.stats(1)[0].cpu().numpy()
            p_tr, r_tr, f1_tr = _f1(tp, fp, fn)
            scored = {}
            for wname in ("val", "test"):
                s = splits[wname]
                with span("loop.eval.forward", window=wname):
                    out, carry = eval_forward(wname, carry)
                    out_np = out.cpu().numpy()[s.eval_mask]
                with span("loop.eval.score"):
                    tgt_np = s.target[s.eval_mask]
                    p, r, f1 = M.precision_recall_f1(np.argmax(out_np, axis=1), tgt_np)
                    l = M.weighted_ce_loss_np(out_np, tgt_np, np.asarray(class_weights))
                scored[wname] = (p, r, f1, l)
            val_stats, test_stats = scored["val"], scored["test"]
            results[ep] = [p_tr, r_tr, f1_tr, loss, *val_stats, *test_stats]
            if cfg.verbose:
                print(
                    f"ep {ep}: train f1 {f1_tr:.4f} loss {loss:.4f} | "
                    f"val f1 {val_stats[2]:.4f} | test f1 {test_stats[2]:.4f}"
                )
        if checkpointer is not None:
            _save(checkpointer, ep, chunks, results)
        ep += 1

        # Non-evaluation epochs: stats stay on the device until the chunk ends.
        k = min(cfg.eval_every - 1, cfg.n_epochs - ep)
        if k > 0:
            chunks(k, plain=True)
            with span("loop.fetch", n=k):
                stats = chunks.stats(k).cpu().numpy()
            with span("loop.rows"):
                for i, (loss_i, tp_i, fp_i, fn_i) in enumerate(stats):
                    p_tr, r_tr, f1_tr = _f1(tp_i, fp_i, fn_i)
                    results[ep + i] = [p_tr, r_tr, f1_tr, loss_i, *val_stats, *test_stats]
            ep += k

    return results, {"params": _tree_map(torch.Tensor.detach, variables["params"]),
                     "buffers": variables["buffers"]}


@spanned(TRIAL)
def run_link_prediction(
    adapter: ModelAdapter,
    splits: dict[str, LinkPredSplit],
    class_weights: np.ndarray,
    cfg: TrainConfig,
    generator: torch.Generator | None = None,
    variables: dict | None = None,
    checkpointer=None,
    loss_type: str = "softmax",
    eval_type: str = "MAP-MRR",
) -> tuple[np.ndarray, dict]:
    """Train a link predictor; returns ((epochs, K) metrics, variables).

    eval_type="MAP-MRR" (default): (epochs, 9) rows [MAP_tr, MRR_tr,
    loss_tr, MAP_v, MRR_v, loss_v, MAP_te, MRR_te, loss_te];
    eval_type="F1": the (epochs, 12) classification layout.
    loss_type="sigmoid" expects 1-column model outputs and trains on
    [p, 1-p] pairs (reference loss_type option,
    experiment_bitcoin_our_link_prediction.py:195-197).

    The adapter's bundles hold each window's ``model_edges``; the training
    target drops the window's slice-0 edges to match. Same-block windows
    score their last ``n_eval_tail`` edges, disjoint windows every model
    edge. ``variables``, ``generator``: as ``_prepare`` takes them;
    ``checkpointer``: as ``run_edge_classification`` takes it.
    """
    if eval_type not in ("MAP-MRR", "F1"):
        raise ValueError(f"unknown eval_type {eval_type!r}")
    use_f1 = eval_type == "F1"
    train = splits["train"]
    chunks, eval_forward, variables = train_chunks(
        adapter, train, class_weights, cfg, task="link_pred", loss_type=loss_type,
        generator=generator, variables=variables, checkpointer=checkpointer,
    )
    tgt_train, train_edges = _lp_target(train), train.edges[:, train.edges[0] != 0]

    def _pairs(out_np: np.ndarray) -> np.ndarray:
        if loss_type == "softmax":
            return out_np
        p = 1.0 / (1.0 + np.exp(-out_np.astype(np.float64)))
        return np.concatenate([p, 1.0 - p], axis=1)

    width = 12 if use_f1 else 9
    n_stats = 4 if use_f1 else 3
    results = np.zeros((cfg.n_epochs, width))
    val_stats = (0.0,) * n_stats
    test_stats = (0.0,) * n_stats
    ep = 0
    if chunks.resumed is not None:
        step, rows = chunks.resumed
        results[: step + 1] = rows[: step + 1]
        val_stats = tuple(rows[step, width - 2 * n_stats : width - n_stats])
        test_stats = tuple(rows[step, width - n_stats :])
        ep = step + 1
    while ep < cfg.n_epochs:
        with span("loop.eval", epoch=ep):
            out_train, carry = chunks(1)
            with span("loop.fetch", n=1):
                loss = float(chunks.stats(1)[0, 0])
                # The step's logits are already [p, 1-p] under loss_type="sigmoid";
                # _pairs maps them again, so train is scored on 4 columns, as the
                # JAX package scores it (tmgcn_tpu/train/loop.py:316).
                out_tr = _pairs(out_train.cpu().numpy())
            with span("loop.eval.score"):
                if use_f1:
                    tr_stats = M.precision_recall_f1(np.argmax(out_tr, 1), tgt_train)
                else:
                    tr_stats = M.map_mrr(out_tr, tgt_train, train_edges)
            scored = {}
            for wname in ("val", "test"):
                s = splits[wname]
                with span("loop.eval.forward", window=wname):
                    out, carry = eval_forward(wname, carry)
                    out_np = _pairs(out.cpu().numpy())
                with span("loop.eval.score"):
                    if s.n_eval_tail is not None:
                        # Same-block windows: score only the new tail slices.
                        K = s.n_eval_tail
                        out_np, tgt_np, metric_edges = out_np[-K:], s.target[-K:], s.edges[:, -K:]
                    else:
                        # Disjoint windows: score every model edge.
                        keep = s.edges[0] != 0
                        tgt_np, metric_edges = s.target[keep], s.edges[:, keep]
                    l = M.weighted_ce_loss_np(out_np, tgt_np, np.asarray(class_weights))
                    if use_f1:
                        scored[wname] = (*M.precision_recall_f1(np.argmax(out_np, 1), tgt_np), l)
                    else:
                        scored[wname] = (*M.map_mrr(out_np, tgt_np, metric_edges), l)
            val_stats, test_stats = scored["val"], scored["test"]
            results[ep] = [*tr_stats, loss, *val_stats, *test_stats]
            if cfg.verbose:
                print(
                    f"ep {ep}: train {tr_stats} loss {loss:.4f} | "
                    f"val {val_stats[0]:.4f} | test {test_stats[0]:.4f}"
                )
        if checkpointer is not None:
            _save(checkpointer, ep, chunks, results)
        ep += 1

        # Non-evaluation epochs: losses stay on the device until the chunk ends.
        k = min(cfg.eval_every - 1, cfg.n_epochs - ep)
        if k > 0:
            chunks(k, plain=True)
            with span("loop.fetch", n=k):
                losses = chunks.stats(k)[:, 0].cpu().numpy()
            with span("loop.rows"):
                for i in range(k):
                    results[ep + i] = [*tr_stats, losses[i], *val_stats, *test_stats]
            ep += k

    return results, {"params": _tree_map(torch.Tensor.detach, variables["params"]),
                     "buffers": variables["buffers"]}


@spanned(TRIAL)
def run_regression(
    adapter: ModelAdapter,
    targets: dict[str, np.ndarray],
    cfg: TrainConfig,
    generator: torch.Generator | None = None,
    variables: dict | None = None,
    checkpointer=None,
) -> tuple[dict, dict]:
    """Train a node regressor; returns (result, variables).

    The SEIR protocol, as the JAX package runs it: chunks of
    ``eval_every`` epochs with no evaluation between them, then val and
    test scored once, at the end, by an eager forward without grad (each
    window from the model's own initial state: the carry is ``()``) and
    ``metrics.l1_and_ratio``. Result: {"train_loss": (n_epochs,), "val_l1",
    "val_l1_ratio", "test_l1", "test_l1_ratio"}. ``variables``,
    ``generator``: as ``_prepare`` takes them. ``checkpointer``: saved
    after each chunk (at its last epoch); a run that finds a checkpoint
    takes its losses and goes on at the next epoch.
    """
    chunks, eval_forward, variables = train_chunks(
        adapter, targets["train"], None, cfg, task="regression", generator=generator,
        variables=variables, checkpointer=checkpointer,
    )
    losses = np.zeros(cfg.n_epochs)
    chunk = max(1, cfg.eval_every)
    ep = 0
    if chunks.resumed is not None:
        step, rows = chunks.resumed
        losses[: step + 1] = rows[: step + 1]
        ep = step + 1
    while ep < cfg.n_epochs:
        k = min(chunk, cfg.n_epochs - ep)
        chunks(k)
        with span("loop.fetch", n=k):
            losses[ep : ep + k] = chunks.stats(k)[:, 0].cpu().numpy()
        if cfg.verbose:
            print(f"ep {ep + k - 1}: train mse {losses[ep + k - 1]:.5f}")
        ep += k
        if checkpointer is not None:
            _save(checkpointer, ep - 1, chunks, losses)

    result = {"train_loss": losses}
    with span("loop.eval", epoch=cfg.n_epochs - 1):
        for wname in ("val", "test"):
            with span("loop.eval.forward", window=wname):
                out, _ = eval_forward(wname, ())
                out_np = out.cpu().numpy()
            with span("loop.eval.score"):
                l1, ratio = M.l1_and_ratio(out_np, targets[wname])
            result[f"{wname}_l1"] = l1
            result[f"{wname}_l1_ratio"] = ratio
    return result, {"params": _tree_map(torch.Tensor.detach, variables["params"]),
                    "buffers": variables["buffers"]}

"""Task training loops: full-batch SGD with periodic evaluation (port of
tmgcn_tpu.train.loop: edge classification and link prediction).

Reproduces the reference experiment-script protocol (capability reference:
TensorGCN-master/experiment_bitcoin_our.py:100-173 for edge
classification, experiment_bitcoin_our_link_prediction.py:82-139 for link
prediction): full-batch SGD (lr 0.01, momentum 0.9), evaluation of
val/test every ``eval_every`` epochs, and per-epoch metric rows in the
reference's layouts ((epochs, 12) for F1, (epochs, 9) for MAP-MRR).

Cadence as in the JAX package: one evaluation epoch (a step whose fresh
training logits are scored, then val/test), then ``eval_every - 1`` plain
steps. The per-epoch loss and confusion counts stay on the device and are
fetched once per chunk of plain steps. Matmuls run in full float32 with
TF32 off — the port's form of the JAX package's HIGHEST-precision
training contract.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tmgcn_torch.tasks import metrics as M
from tmgcn_torch.tasks.adapters import ModelAdapter
from tmgcn_torch.tasks.windows import EdgeSplit, LinkPredSplit
from tmgcn_torch.train.losses import sigmoid_pair_logits, weighted_cross_entropy


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_epochs: int = 100
    lr: float = 0.01
    momentum: float = 0.9
    eval_every: int = 100
    verbose: bool = False
    optimizer: str = "sgd"  # "sgd" (reference) | "adam"
    grad_clip: float | None = None  # global-norm clip (None = off)


class _Optimizer:
    """optax's sgd(lr, momentum) or adam(lr), after clip_by_global_norm
    when ``grad_clip`` is set, written out with tensor ops in optax's
    arithmetic order.

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
        self.nu = [torch.zeros_like(p) for p in params] if cfg.optimizer == "adam" else []
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        cfg = self.cfg
        grads = [p.grad for p in self.params]
        if cfg.grad_clip is not None:
            grads = _clip_by_global_norm(grads, cfg.grad_clip)
        if cfg.optimizer == "sgd":
            for p, g, t in zip(self.params, grads, self.mu):
                t.mul_(cfg.momentum).add_(g)  # t = g + momentum * t
                p.add_(t, alpha=-cfg.lr)
            return
        b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam's defaults
        self.count += 1
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * g**2 + b2 * v)
            m_hat = m / (1 - b1**self.count)
            v_hat = v / (1 - b2**self.count)
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
) -> tuple[dict, dict, _Optimizer]:
    """TF32 off; (params, buffers, optimizer) on the adapter's device.

    ``variables`` (e.g. parameters carried over from the JAX package with
    ``configs.build.params_from_jax``) are copied to the adapter's device;
    otherwise they are drawn from ``generator`` (seed 0 if None). Params
    and buffers may nest (WD-GCN's ``lstm``): every leaf of ``params`` is
    trained.
    """
    if checkpointer is not None:
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP queue 1, item 13)")
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
    return params, buffers, _optimizer(cfg, _tree_leaves(params))


def _make_steps(
    adapter: ModelAdapter,
    params: dict,
    buffers: dict,
    opt: _Optimizer,
    class_weights: np.ndarray,
    target: np.ndarray,
    with_confusion: bool,
    logit_transform=None,
):
    """(sgd_step, eval_forward) over the adapter's bundles, as the JAX
    package's ``_make_steps`` builds them for both tasks; ``target`` is the
    train bundle's labels, one per output row.

    ``sgd_step()`` makes one update on the train bundle and returns
    (stats, out, carry): ``stats`` is [loss] (and tp, fp, fn with
    ``with_confusion``) of the pre-update logits, one float64 tensor left on
    the device; ``out`` those logits after ``logit_transform``, detached.
    ``eval_forward(window, carry)`` is the window's forward without grad.
    """
    variables = {"params": params, "buffers": buffers}
    bundle_train = adapter.bundles["train"]
    cw = torch.as_tensor(class_weights, dtype=torch.float64, device=adapter.device)
    tgt = torch.as_tensor(target, device=adapter.device)

    def sgd_step() -> tuple[torch.Tensor, torch.Tensor, object]:
        opt.zero_grad()
        out, carry = adapter.apply(variables, bundle_train, ())
        if logit_transform is not None:
            out = logit_transform(out)
        loss = weighted_cross_entropy(out, tgt, cw)
        loss.backward()
        opt.step()
        out = out.detach()
        stats = [loss.detach().double()]
        if with_confusion:
            stats.extend(c.double() for c in _confusion(out, tgt))
        return torch.stack(stats), out, carry

    @torch.no_grad()
    def eval_forward(window: str, carry):
        return adapter.apply(variables, adapter.bundles[window], carry)

    return sgd_step, eval_forward


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
    variables have the same tree.
    """
    params, buffers, opt = _prepare(adapter, cfg, generator, variables, checkpointer)
    sgd_step, eval_forward = _make_steps(
        adapter, params, buffers, opt, class_weights, splits["train"].target,
        with_confusion=True,
    )

    results = np.zeros((cfg.n_epochs, 12))
    val_stats = (0.0,) * 4
    test_stats = (0.0,) * 4
    ep = 0
    while ep < cfg.n_epochs:
        # Evaluation epoch: one step, then score val/test.
        stats, _, carry = sgd_step()
        loss, tp, fp, fn = stats.cpu().numpy()
        p_tr, r_tr, f1_tr = _f1(tp, fp, fn)
        scored = {}
        for wname in ("val", "test"):
            out, carry = eval_forward(wname, carry)
            s = splits[wname]
            out_np = out.cpu().numpy()[s.eval_mask]
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
        ep += 1

        # Non-evaluation epochs: stats stay on the device until the chunk ends.
        k = min(cfg.eval_every - 1, cfg.n_epochs - ep)
        if k > 0:
            chunk = torch.stack([sgd_step()[0] for _ in range(k)]).cpu().numpy()
            for i, (loss_i, tp_i, fp_i, fn_i) in enumerate(chunk):
                p_tr, r_tr, f1_tr = _f1(tp_i, fp_i, fn_i)
                results[ep + i] = [p_tr, r_tr, f1_tr, loss_i, *val_stats, *test_stats]
            ep += k

    params = _tree_map(torch.Tensor.detach, params)
    return results, {"params": params, "buffers": buffers}


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
    edge. ``variables``, ``generator``: as ``_prepare`` takes them.
    """
    transform = None
    if loss_type == "sigmoid":
        transform = sigmoid_pair_logits
    elif loss_type != "softmax":
        raise ValueError(f"unknown loss_type {loss_type!r}")
    if eval_type not in ("MAP-MRR", "F1"):
        raise ValueError(f"unknown eval_type {eval_type!r}")
    use_f1 = eval_type == "F1"
    params, buffers, opt = _prepare(adapter, cfg, generator, variables, checkpointer)
    train = splits["train"]
    keep_train = train.edges[0] != 0
    tgt_train = train.target[keep_train]  # the model edges' labels
    sgd_step, eval_forward = _make_steps(
        adapter, params, buffers, opt, class_weights, tgt_train, with_confusion=False,
        logit_transform=transform,
    )

    def _pairs(out_np: np.ndarray) -> np.ndarray:
        if transform is None:
            return out_np
        p = 1.0 / (1.0 + np.exp(-out_np.astype(np.float64)))
        return np.concatenate([p, 1.0 - p], axis=1)

    width = 12 if use_f1 else 9
    n_stats = 4 if use_f1 else 3
    results = np.zeros((cfg.n_epochs, width))
    val_stats = (0.0,) * n_stats
    test_stats = (0.0,) * n_stats
    ep = 0
    while ep < cfg.n_epochs:
        stats, out_train, carry = sgd_step()
        loss = float(stats[0])
        # The step's logits are already [p, 1-p] under loss_type="sigmoid";
        # _pairs maps them again, so train is scored on 4 columns, as the
        # JAX package scores it (tmgcn_tpu/train/loop.py:316).
        out_tr = _pairs(out_train.cpu().numpy())
        if use_f1:
            tr_stats = M.precision_recall_f1(np.argmax(out_tr, 1), tgt_train)
        else:
            tr_stats = M.map_mrr(out_tr, tgt_train, train.edges[:, keep_train])
        scored = {}
        for wname in ("val", "test"):
            out, carry = eval_forward(wname, carry)
            s = splits[wname]
            out_np = _pairs(out.cpu().numpy())
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
        ep += 1

        # Non-evaluation epochs: losses stay on the device until the chunk ends.
        k = min(cfg.eval_every - 1, cfg.n_epochs - ep)
        if k > 0:
            losses = torch.stack([sgd_step()[0][0] for _ in range(k)]).cpu().numpy()
            for i in range(k):
                results[ep + i] = [*tr_stats, losses[i], *val_stats, *test_stats]
            ep += k

    params = _tree_map(torch.Tensor.detach, params)
    return results, {"params": params, "buffers": buffers}

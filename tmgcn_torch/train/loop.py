"""Task training loop: full-batch SGD with periodic evaluation (port of
tmgcn_tpu.train.loop, edge classification).

Reproduces the reference experiment-script protocol (capability reference:
TensorGCN-master/experiment_bitcoin_our.py:100-173): full-batch SGD
(lr 0.01, momentum 0.9), evaluation of val/test every ``eval_every``
epochs, and per-epoch metric rows in the reference's (epochs, 12) layout.

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
from tmgcn_torch.tasks.windows import EdgeSplit
from tmgcn_torch.train.losses import weighted_cross_entropy


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

    ``variables`` (e.g. parameters carried over from the JAX package with
    ``configs.build.params_from_jax``) are copied to the adapter's device;
    otherwise they are drawn from ``generator`` (seed 0 if None).
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
    params = {
        k: v.detach().to(device).clone().requires_grad_(True)
        for k, v in variables["params"].items()
    }
    buffers = {k: v.to(device) for k, v in variables["buffers"].items()}
    cw = torch.as_tensor(class_weights, dtype=torch.float64, device=device)
    tgt_train = torch.as_tensor(splits["train"].target, device=device)
    bundle_train = adapter.bundles["train"]
    opt = _optimizer(cfg, list(params.values()))

    def sgd_step() -> torch.Tensor:
        """One update; returns [loss, tp, fp, fn] of its pre-update logits."""
        opt.zero_grad()
        out, _ = adapter.apply({"params": params, "buffers": buffers}, bundle_train, ())
        loss = weighted_cross_entropy(out, tgt_train, cw)
        loss.backward()
        opt.step()
        counts = _confusion(out.detach(), tgt_train)
        return torch.stack([loss.detach().double(), *(c.double() for c in counts)])

    results = np.zeros((cfg.n_epochs, 12))
    val_stats = (0.0,) * 4
    test_stats = (0.0,) * 4
    ep = 0
    while ep < cfg.n_epochs:
        # Evaluation epoch: one step, then score val/test.
        loss, tp, fp, fn = sgd_step().cpu().numpy()
        p_tr, r_tr, f1_tr = _f1(tp, fp, fn)
        stats = {}
        carry = ()
        with torch.no_grad():
            for wname in ("val", "test"):
                out, carry = adapter.apply(
                    {"params": params, "buffers": buffers}, adapter.bundles[wname], carry
                )
                s = splits[wname]
                out_np = out.cpu().numpy()[s.eval_mask]
                tgt_np = s.target[s.eval_mask]
                p, r, f1 = M.precision_recall_f1(np.argmax(out_np, axis=1), tgt_np)
                l = M.weighted_ce_loss_np(out_np, tgt_np, np.asarray(class_weights))
                stats[wname] = (p, r, f1, l)
        val_stats, test_stats = stats["val"], stats["test"]
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
            chunk = torch.stack([sgd_step() for _ in range(k)]).cpu().numpy()
            for i, (loss_i, tp_i, fp_i, fn_i) in enumerate(chunk):
                p_tr, r_tr, f1_tr = _f1(tp_i, fp_i, fn_i)
                results[ep + i] = [p_tr, r_tr, f1_tr, loss_i, *val_stats, *test_stats]
            ep += k

    params = {k: v.detach() for k, v in params.items()}
    return results, {"params": params, "buffers": buffers}

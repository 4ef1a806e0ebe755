"""The reference's training: the first steps of full-batch SGD with momentum
(torch.optim.SGD's update, dampening 0: mu = momentum·mu + g, p -= lr·mu),
the class-weighted cross-entropy of the train window, and the evaluation
windows' F1 (class 0 positive) and weighted cross-entropy after chosen
steps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def leaves(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """Every tensor of a nested dict by dotted name, keys sorted at each
    level (the order the port's optimizer keeps its state in)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def f1_pos0(guess: torch.Tensor, target: torch.Tensor) -> float:
    """F1 with class 0 as the positive class (NaN where undefined)."""
    tp = float(((guess == 0) & (target == 0)).sum())
    fp = float(((guess == 0) & (target != 0)).sum())
    fn = float(((guess != 0) & (target == 0)).sum())
    p = tp / (tp + fp) if tp + fp else float("nan")
    r = tp / (tp + fn) if tp + fn else float("nan")
    return 2 * p * r / (p + r) if p + r else float("nan")


def weighted_ce64(logits: torch.Tensor, target: torch.Tensor, cw) -> float:
    """The weighted mean cross-entropy, in float64."""
    logp = torch.log_softmax(logits.double(), dim=1)
    w = torch.as_tensor(cw, dtype=torch.float64, device=logits.device)[target]
    return float(-(w * logp.gather(1, target[:, None])[:, 0]).sum() / w.sum())


def evaluate(family, cfg: dict, params: dict, buffers: dict, win, cache: dict, cw,
             tf32: bool = False) -> tuple[float, float]:
    """(F1, loss) of one window's scored edges."""
    with torch.no_grad():
        out = family.logits(params, buffers, win, cache, cfg, tf32)[win.eval_mask]
    tgt = win.target[win.eval_mask]
    return f1_pos0(torch.argmax(out, dim=1), tgt), weighted_ce64(out, tgt, cw)


def follow(family, cfg: dict, variables: dict, train, cw, n_steps: int, tf32: bool = False,
           eval_wins: dict | None = None, eval_after: tuple[int, ...] = ()) -> dict:
    """``n_steps`` SGD steps from ``variables`` on the window ``train``.

    Returns {"losses": [loss of step 1..n (pre-update)], "grad1": {leaf:
    the first gradient}, "change": {leaf: params after n - initial}, and
    "eval": {step: {window: (F1, loss)}} after each step of ``eval_after``}.
    """
    params = _tree_map(lambda v: v.detach().clone().requires_grad_(True), variables["params"])
    buffers = variables["buffers"]
    named = leaves(params)
    start = {k: v.detach().clone() for k, v in named.items()}
    mu = {k: torch.zeros_like(v) for k, v in named.items()}
    lr, momentum = cfg["lr"], cfg["momentum"]
    weight = torch.as_tensor(cw, dtype=torch.float32, device=train.vals.device)
    cache = family.prepare(train, cfg, tf32)
    eval_caches = {w: family.prepare(win, cfg, tf32) for w, win in (eval_wins or {}).items()}
    out = {"losses": [], "eval": {}}
    for step in range(1, n_steps + 1):
        logits = family.logits(params, buffers, train, cache, cfg, tf32)
        loss = F.cross_entropy(logits, train.target, weight=weight)
        grads = torch.autograd.grad(loss, list(named.values()))
        with torch.no_grad():
            for (k, p), g in zip(named.items(), grads):
                mu[k].mul_(momentum).add_(g)
                p.add_(mu[k], alpha=-lr)
        out["losses"].append(float(loss.detach()))
        if step == 1:
            out["grad1"] = {k: g.detach().clone() for k, g in zip(named, grads)}
        if step in eval_after:
            out["eval"][step] = {w: evaluate(family, cfg, params, buffers, win, eval_caches[w], cw,
                                             tf32)
                                 for w, win in eval_wins.items()}
    out["change"] = {k: (p.detach() - start[k]) for k, p in named.items()}
    return out

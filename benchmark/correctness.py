"""How ``correct`` is decided: the port's first training steps against the
reference's, from the same inputs and initial parameters.

Numbers compared (each has a limit per cell, ``benchmark/limits/<cell>.json``):

* ``loss``: the largest relative gap of a step's loss, over the steps
  followed;
* ``grad1``: the first gradient as the optimizer got it (its momentum
  trace after one step), by the worst leaf: the gap between the two
  norms over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
* ``change``: the parameters' change over the steps followed, by the worst
  leaf, measured the same way; leaves whose reference gradient is under a
  thousandth of the median leaf's move by round-off alone and are left out;
* ``eval_loss``, ``eval_f1`` (trials only): the evaluation windows' weighted
  cross-entropy (relative gap) and F1 (absolute gap) after the evaluated
  steps.

A number that is not finite on either side reads as infinitely far.
"""

from __future__ import annotations

import math

import torch


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def _norms(tree: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    pn, rn = _norms(prog), _norms(ref)
    median = sorted(rn.values())[len(rn) // 2]
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30)
            for k in rn if keep is None or k in keep]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def moving_leaves(grad1: dict) -> set[str]:
    rn = _norms(grad1)
    median = sorted(rn.values())[len(rn) // 2]
    return {k for k, v in rn.items() if v >= 1e-3 * median}


def readings(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers compared, from two dicts of the same shape:
    {"losses": [...], "grad1": {leaf: tensor}, "change": {leaf: tensor},
    and optionally "eval": {step: {window: (F1, loss)}}}."""
    if set(prog["grad1"]) != set(ref["grad1"]):
        raise ValueError(f"leaves {sorted(prog['grad1'])} are not {sorted(ref['grad1'])}")
    out = {
        "loss": max(_rel(float(a), float(b)) for a, b in zip(prog["losses"], ref["losses"],
                                                            strict=True)),
        "grad1": _leaf_gap(prog["grad1"], ref["grad1"]),
        "change": _leaf_gap(prog["change"], ref["change"], moving_leaves(ref["grad1"])),
    }
    if ref.get("eval"):
        loss_gaps, f1_gaps = [], []
        for step, wins in ref["eval"].items():
            for w, (f1_r, loss_r) in wins.items():
                f1_p, loss_p = prog["eval"][step][w]
                loss_gaps.append(_rel(loss_p, loss_r))
                both_nan = math.isnan(f1_p) and math.isnan(f1_r)
                f1_gaps.append(0.0 if both_nan else abs(f1_p - f1_r) if not (
                    math.isnan(f1_p) or math.isnan(f1_r)) else math.inf)
        out["eval_loss"] = max(loss_gaps)
        out["eval_f1"] = max(f1_gaps)
    return out


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number within its limit.
    A number without a limit is reported and not judged."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is None or c["value"] <= c["limit"] for c in checks.values())
    missing = [k for k in limits if k not in numbers]
    return ok and not missing, checks

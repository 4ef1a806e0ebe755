"""Command-line entry point of the PyTorch / CUDA port.

    python -m tmgcn_torch.cli list
    python -m tmgcn_torch.cli run chess_tmgcn_cls --data-dir data/chess \
        --spmm-impl pallas --epochs 200 --out results_torch/

``run`` uses the card (``--device cuda``, the default) and fails if there
is none; ``--device cpu`` runs the plain PyTorch path on the CPU. The JAX
package's ``preprocess``, ``synth``, ``fetch`` and ``predict`` commands are
not ported yet (ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pickle
import time
from pathlib import Path

import numpy as np


def _cmd_list(args) -> int:
    from tmgcn_torch.configs.presets import PRESETS

    for name in sorted(PRESETS):
        cfg = PRESETS[name]
        print(f"{name:32s} dataset={cfg.dataset:14s} method={cfg.method:10s} task={cfg.task}")
    return 0


def _cmd_run(args) -> int:
    from tmgcn_torch.configs.build import run_experiment, run_tag
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.train.logging import summarize, write_metrics_jsonl

    cfg = get_preset(args.preset)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.spmm_impl is not None:
        cfg = dataclasses.replace(cfg, spmm_impl=args.spmm_impl)
    alphas = tuple(args.alphas) if args.alphas else None
    t0 = time.time()
    out = run_experiment(
        cfg,
        data_dir=args.data_dir,
        artifact=args.artifact,
        n_epochs=args.epochs,
        alpha_vec=alphas,
        verbose=not args.quiet,
        device=args.device,
    )
    elapsed = time.time() - t0
    print(f"{cfg.name}: {len(out['results'])} runs in {elapsed:.1f}s on {args.device}")

    if args.out:
        out_dir = Path(args.out)
        out_dir.mkdir(parents=True, exist_ok=True)
        summary = {"preset": cfg.name, "elapsed_s": elapsed, "device": args.device, "runs": {}}
        for (tr, alpha), res in out["results"].items():
            tag = f"{cfg.name}_{run_tag(tr, alpha)}"
            with open(out_dir / f"results_{tag}.pkl", "wb") as f:
                pickle.dump(np.asarray(res), f)
            write_metrics_jsonl(
                out_dir / f"metrics_{tag}.jsonl",
                res,
                eval_every=cfg.eval_every,
                run_info={"preset": cfg.name, "trial": tr, "alpha": alpha},
            )
            summary["runs"][tag] = summarize(res, cfg.eval_every)
        (out_dir / f"summary_{cfg.name}.json").write_text(json.dumps(summary, indent=2))
        print(f"results written to {out_dir}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tmgcn_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list experiment presets")

    rp = sub.add_parser("run", help="run an experiment preset")
    rp.add_argument("preset")
    rp.add_argument("--data-dir")
    rp.add_argument("--artifact")
    rp.add_argument("--epochs", type=int)
    rp.add_argument("--alphas", type=float, nargs="*")
    rp.add_argument("--out")
    rp.add_argument(
        "--spmm-impl",
        choices=["jnp", "pallas"],
        help="override the preset's SpMM implementation (pallas = the CUDA kernel)",
    )
    rp.add_argument("--seed", type=int)
    rp.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; cpu runs the plain path)",
    )
    rp.add_argument("--quiet", action="store_true")

    args = ap.parse_args(argv)
    if args.cmd == "list":
        return _cmd_list(args)
    if args.cmd == "run":
        return _cmd_run(args)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())

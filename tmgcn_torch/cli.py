"""Command-line entry point of the PyTorch / CUDA port.

    python -m tmgcn_torch.cli list
    python -m tmgcn_torch.cli run chess_tmgcn_cls --data-dir data/chess \
        --spmm-impl pallas --epochs 200 --out results_torch/
    python -m tmgcn_torch.cli run chess_wdgcn_cls --data-dir data/chess --epochs 200
    python -m tmgcn_torch.cli run chess_tmgcn2_cls --data-dir data/chess \
        --spmm-impl pallas_bf16 --epochs 200
    python -m tmgcn_torch.cli run chess_tmgcn_lp --data-dir data/chess --epochs 200
    python -m tmgcn_torch.cli run chess_wdgcn_lp --data-dir data/chess --epochs 200
    python -m tmgcn_torch.cli run chess_gcn_cls --data-dir data/chess \
        --spmm-impl pallas --epochs 200           # KW-GCN; also chess_gcn_lp
    python -m tmgcn_torch.cli run chess_evolvegcn_cls --data-dir data/chess --epochs 200
                             # EvolveGCN-H; also chess_evolvegcn2_cls, chess_evolvegcn_lp
    python -m tmgcn_torch.cli run chess_tmgcn_cls --data-dir data/chess --epochs 5 \
        --profile prof/        # torch.profiler trace of the run: prof/trace.json
    python -m tmgcn_torch.cli run seir_tmgcn_reg --debug-nans
                             # eager steps; FloatingPointError at the first NaN
    python -m tmgcn_torch.cli run seir_tmgcn_reg_tuned --epochs 300
                             # SEIR node regression (also seir_{evolvegcn,wdgcn}_reg
                             # and their _tuned variants); no --data-dir: generated
    python -m tmgcn_torch.cli run sbm_tmgcn_lp_tuned --epochs 300
                             # SBM link prediction (also sbm_evolvegcn_lp[_tuned],
                             # sbm_tmgcn_lp and sbm_tmgcn_lp_spectral); generated
    torchrun --standalone --nproc-per-node 4 -m tmgcn_torch.cli run chess_tmgcn_cls \
        --data-dir data/chess --mesh graph=2,time=2 --epochs 200
                             # sharded on a (graph x time) mesh, one process per
                             # card (NCCL); with --device cpu, gloo. TM-GCN (1 or 2
                             # layers) and KW-GCN on any mesh; EvolveGCN-H and
                             # WD-GCN on graph=G,time=1; every task (SEIR
                             # regression too), with or without --checkpoint-dir
                             # (rank 0 writes); rank 0 prints and writes --out
    python -m tmgcn_torch.cli run chess_tmgcn2_cls --data-dir data/chess \
        --spmm-impl pallas --epochs 1000 --checkpoint-dir ck/
                             # saves after each evaluation epoch (regression: each
                             # chunk) under ck/<preset>/<tr0_w90>; run it again to
                             # resume from the newest checkpoint there
    python -m tmgcn_torch.cli predict chess_tmgcn2_cls --data-dir data/chess \
        --spmm-impl pallas --checkpoint-dir ck/ --window val --out scores.npz
    python -m tmgcn_torch.cli synth [--dataset uci] --out data/synthetic --seed 0
    python -m tmgcn_torch.cli preprocess uci --data-dir data/synthetic/uci
    python -m tmgcn_torch.cli fetch bitcoin_otc --data-root data/real   # downloads

``run`` and ``predict`` use the card (``--device cuda``, the default) and
fail if there is none; ``--device cpu`` runs the plain PyTorch path on the
CPU. The results pickles hold each run's (epochs, 12) F1 rows or, for link
prediction, its (epochs, 9) MAP-MRR rows; for regression, its result dict
(the per-epoch train losses, val and test L1 and L1 ratio). Checkpoints
are the port's own files (``train/checkpoint.py``), not the JAX package's
Orbax directories. ``run --mesh graph=G,time=T`` needs G x T processes
(``torchrun``), one per card; one card allows only ``graph=1,time=1``; the
recurrent families refuse a time axis, as the JAX package does. ``run
--debug-nans`` trains the steps eagerly and raises ``FloatingPointError``
at the first NaN in a loss or a gradient, naming the epoch and the tensor
(the JAX package's ``jax_debug_nans``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
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


def _cmd_preprocess(args) -> int:
    from tmgcn_torch.preprocess.datasets import REGISTRY, load_raw
    from tmgcn_torch.preprocess.matio import save_artifact
    from tmgcn_torch.preprocess.pipeline import preprocess

    spec = REGISTRY[args.dataset]
    t0 = time.time()
    raw = load_raw(spec, args.data_dir)
    data = preprocess(raw, spec.preprocess)
    out = Path(args.out or args.data_dir) / f"saved_content_{args.dataset}.mat"
    out.parent.mkdir(parents=True, exist_ok=True)  # the JAX CLI fails on a new --out
    save_artifact(out, data)
    print(
        f"{args.dataset}: N={raw.n_nodes} T={raw.n_slices} "
        f"edges={len(raw.src)} -> {out} in {time.time() - t0:.1f}s"
    )
    return 0


def _cmd_synth(args) -> int:
    from tmgcn_torch.preprocess.synthetic_raw import SYNTH, generate

    names = [args.dataset] if args.dataset else sorted(SYNTH)
    for name in names:
        path = generate(name, Path(args.out) / name, seed=args.seed)
        print(f"{name}: {path}")
    return 0


def _cmd_fetch(args) -> int:
    from tmgcn_torch.preprocess.fetch import fetch, fetch_all

    if args.dataset == "all":
        res = fetch_all(args.data_root)
        return 1 if any(str(v).startswith("FAILED") for v in res.values()) else 0
    fetch(args.dataset, args.data_root)
    return 0


def _cmd_predict(args) -> int:
    """Inference: restore a trained checkpoint and score a window's edges.

    Rebuilds the preset's adapter on the device, restores the newest
    checkpoint that ``run --checkpoint-dir`` saved for (trial, alpha)
    (params and frozen buffers), threads the carry train -> val -> test
    from ``initial_carry`` as the training loops do, prints the window's
    metrics and writes its per-edge scores, edges and the epoch to
    ``--out``.
    """
    import torch

    from tmgcn_torch.configs.build import build_experiment, run_tag
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.tasks import metrics as M
    from tmgcn_torch.train.checkpoint import RunCheckpointer

    cfg = get_preset(args.preset)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.spmm_impl is not None:
        cfg = dataclasses.replace(cfg, spmm_impl=args.spmm_impl)
    if cfg.task not in ("edge_cls", "link_pred"):
        raise SystemExit(f"predict supports edge_cls/link_pred, not {cfg.task!r}")
    alphas = cfg.alpha_vec or (None,)
    alpha = args.alpha if args.alpha is not None else alphas[0]
    tag = run_tag(args.trial, alpha)
    ck = RunCheckpointer(Path(args.checkpoint_dir) / cfg.name / tag)
    if ck.latest_epoch() is None:
        raise SystemExit(f"no checkpoint under {args.checkpoint_dir}/{cfg.name}/{tag}")
    exp = build_experiment(cfg, args.data_dir, args.artifact, args.device)
    adapter, splits = exp.adapter, exp.splits

    # The checkpoint carries params AND frozen buffers; the draw here only
    # gives their shapes, dtypes and device.
    variables = adapter.init(torch.Generator().manual_seed(cfg.seed))
    step, params, buffers = ck.restore_inference(variables["params"], variables["buffers"])
    ck.close()
    variables = {"params": params, "buffers": buffers}

    # The training loop's full float32 matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    carry = adapter.initial_carry(variables)
    with torch.no_grad():
        for w in ("train", "val", "test"):
            out, carry = adapter.apply(variables, adapter.bundles[w], carry)
            if w == args.window:
                out = out.cpu().numpy()
                break
    s = splits[args.window]

    if cfg.task == "link_pred" and cfg.loss_type == "sigmoid":
        p = 1.0 / (1.0 + np.exp(-out.astype(np.float64)))
        out = np.concatenate([p, 1.0 - p], axis=1)

    if cfg.task == "edge_cls":
        mask = s.eval_mask
        prec, rec, f1 = M.precision_recall_f1(np.argmax(out[mask], 1), s.target[mask])
        print(
            f"{cfg.name} [{args.window}] epoch {step}: "
            f"precision {prec:.4f} recall {rec:.4f} f1 {f1:.4f} "
            f"({int(mask.sum())} eval edges)"
        )
        edges_out = s.edges
    else:
        if s.n_eval_tail is not None:
            K = s.n_eval_tail
            out_np, tgt_np, metric_edges = out[-K:], s.target[-K:], s.edges[:, -K:]
        else:
            keep = s.edges[0] != 0
            out_np, tgt_np, metric_edges = out, s.target[keep], s.edges[:, keep]
        mp, mr = M.map_mrr(out_np, tgt_np, metric_edges)
        print(
            f"{cfg.name} [{args.window}] epoch {step}: "
            f"MAP {mp:.4f} MRR {mr:.4f} ({out_np.shape[0]} eval edges)"
        )
        edges_out = s.model_edges

    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, scores=out, edges=edges_out, epoch=step)
        print(f"wrote {path}")
    return 0


def _parse_mesh(spec: str) -> tuple[int, int]:
    """Parse 'graph=G,time=T' (either key optional, any order)."""
    parts = dict(kv.split("=", 1) for kv in spec.replace(" ", "").split(",") if kv)
    unknown = set(parts) - {"graph", "time"}
    if unknown:
        raise SystemExit(f"--mesh: unknown axes {sorted(unknown)}; use graph=G,time=T")
    return int(parts.get("graph", 1)), int(parts.get("time", 1))


def _cmd_run(args) -> int:
    from tmgcn_torch.configs.build import run_experiment, run_tag
    from tmgcn_torch.configs.presets import get_preset
    from tmgcn_torch.train.logging import summarize, write_metrics_jsonl

    mesh_shape = _parse_mesh(args.mesh) if args.mesh else None
    # Every rank of a sharded run trains the same rows; rank 0 reports them.
    lead = mesh_shape is None or int(os.environ.get("RANK", 0)) == 0
    cfg = get_preset(args.preset)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.spmm_impl is not None:
        cfg = dataclasses.replace(cfg, spmm_impl=args.spmm_impl)
    alphas = tuple(args.alphas) if args.alphas else None
    t0 = time.time()
    profile_cm = contextlib.nullcontext()
    if args.profile:
        from tmgcn_torch.utils.profiling import trace

        profile_cm = trace(args.profile)
    with profile_cm:
        out = run_experiment(
            cfg,
            data_dir=args.data_dir,
            artifact=args.artifact,
            n_epochs=args.epochs,
            alpha_vec=alphas,
            verbose=not args.quiet and lead,
            checkpoint_dir=args.checkpoint_dir,
            mesh_shape=mesh_shape,
            device=args.device,
            debug_nans=args.debug_nans,
        )
    elapsed = time.time() - t0
    if mesh_shape:
        from tmgcn_torch.parallel import distributed

        distributed.shutdown()
    if not lead:
        return 0
    mesh = f" on a {mesh_shape[0]}x{mesh_shape[1]} mesh" if mesh_shape else ""
    print(f"{cfg.name}: {len(out['results'])} runs in {elapsed:.1f}s on {args.device}{mesh}")

    if args.out:
        out_dir = Path(args.out)
        out_dir.mkdir(parents=True, exist_ok=True)
        summary = {"preset": cfg.name, "elapsed_s": elapsed, "device": args.device, "runs": {}}
        for (tr, alpha), res in out["results"].items():
            tag = f"{cfg.name}_{run_tag(tr, alpha)}"
            if isinstance(res, dict):  # regression: the JAX CLI's summary
                with open(out_dir / f"results_{tag}.pkl", "wb") as f:
                    pickle.dump(res, f)
                summary["runs"][tag] = {
                    k: (float(v) if np.isscalar(v) else None) for k, v in res.items()
                }
                continue
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

    sp = sub.add_parser("synth", help="generate synthetic raw dataset files")
    sp.add_argument("--dataset", help="one dataset (default: all)")
    sp.add_argument("--out", default="data/synthetic")
    sp.add_argument("--seed", type=int, default=0)

    pp = sub.add_parser("preprocess", help="raw edge list -> .mat artifact")
    pp.add_argument("dataset")
    pp.add_argument("--data-dir", required=True)
    pp.add_argument("--out")

    fp = sub.add_parser(
        "fetch",
        help="download a REAL dataset (URL+sha256 manifest, "
             "preprocess/fetch.py) into --data-root/<name>/",
    )
    fp.add_argument("dataset", help="dataset name or 'all'")
    fp.add_argument("--data-root", default="data/real")

    spmm_impls = ["jnp", "rowsplit", "pallas", "pallas_bf16", "pallas_tiled",
                  "pallas_tiled_bf16", "blockdense", "blockdense_bf16"]
    device_help = "torch device to run on (default cuda; cpu runs the plain path)"
    rp = sub.add_parser("run", help="run an experiment preset")
    rp.add_argument("preset")
    rp.add_argument("--data-dir")
    rp.add_argument("--artifact")
    rp.add_argument("--epochs", type=int)
    rp.add_argument("--alphas", type=float, nargs="*")
    rp.add_argument("--out")
    rp.add_argument("--checkpoint-dir",
                    help="save each run under DIR/<preset>/<run tag>, resuming from the "
                         "newest checkpoint there")
    rp.add_argument(
        "--spmm-impl",
        choices=spmm_impls,
        help="override the preset's SpMM implementation (pallas* = the CUDA kernels: "
             "K1, its bf16-gather tier, K3 and its bf16 tier)",
    )
    rp.add_argument("--seed", type=int)
    rp.add_argument("--device", default="cuda", help=device_help)
    rp.add_argument("--debug-nans", action="store_true",
                    help="train eagerly and raise on the first NaN in a loss or a gradient")
    rp.add_argument("--quiet", action="store_true")
    rp.add_argument("--profile", metavar="DIR",
                    help="trace the run with torch.profiler into DIR/trace.json")
    rp.add_argument("--mesh", help="sharded execution, e.g. graph=4,time=2 (one process "
                                   "per device: launch with torchrun)")

    pp2 = sub.add_parser("predict", help="restore a checkpoint and score a window's edges")
    pp2.add_argument("preset")
    pp2.add_argument("--data-dir")
    pp2.add_argument("--artifact")
    pp2.add_argument("--checkpoint-dir", required=True)
    pp2.add_argument("--window", choices=["train", "val", "test"], default="test")
    pp2.add_argument("--trial", type=int, default=0)
    pp2.add_argument("--alpha", type=float)
    pp2.add_argument("--seed", type=int)
    pp2.add_argument("--spmm-impl", choices=spmm_impls,
                     help="the SpMM implementation the run was trained with")
    pp2.add_argument("--device", default="cuda", help=device_help)
    pp2.add_argument("--out", help="write scores/edges to this .npz")

    args = ap.parse_args(argv)
    commands = {"list": _cmd_list, "synth": _cmd_synth, "preprocess": _cmd_preprocess,
                "fetch": _cmd_fetch, "run": _cmd_run, "predict": _cmd_predict}
    return commands[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())

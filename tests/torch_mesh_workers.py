"""Spawned ranks of the port's mesh tests (tests/test_torch_sharded_adapter.py
and tests/test_torch_sharded_recurrent.py).

Imports neither JAX nor the JAX package: each rank is a fresh process that
joins a gloo world over a FileStore (no ports, so parallel test workers
never collide), runs one function and writes its result beside the store.
``spawn`` joins the ranks with a deadline and kills them past it, so a hung
collective fails its test instead of the suite.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import pickle
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tmgcn_torch.core.mmatrix import make_m_matrix
from tmgcn_torch.core.sparse import TemporalCOO

DEADLINE_S = 180
CASES = ("tmgcn1", "tmgcn2_gather", "tmgcn2_blockdense", "tmgcn2_m3", "kwgcn2", "tmgcn1_lp")


def _rank_main(fn_name: str, rank: int, world: int, store: str, out: str, args: tuple) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
        result = globals()[fn_name](*args)
        dist.destroy_process_group()
        Path(out).write_bytes(pickle.dumps(result))
    except BaseException:
        Path(out + ".err").write_text(traceback.format_exc())
        raise


def spawn(fn_name: str, world: int, tmp_path: Path, *args) -> list:
    """Run ``fn_name(*args)`` on ``world`` gloo ranks; their results in rank
    order. Fails (after killing every rank) past ``DEADLINE_S``."""
    ctx = mp.get_context("spawn")
    store = str(tmp_path / f"store_{fn_name}_{world}")
    outs = [str(tmp_path / f"{fn_name}_{world}_rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(fn_name, r, world, store, outs[r], args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=DEADLINE_S)
    try:
        for p in procs:
            p.join(max(0.0, (deadline - datetime.datetime.now()).total_seconds()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    errors = [Path(o + ".err").read_text() for o in outs if Path(o + ".err").exists()]
    assert not hung, f"{len(hung)} of {world} ranks still ran after {DEADLINE_S} s: {errors}"
    assert all(p.exitcode == 0 for p in procs), errors
    return [pickle.loads(Path(o).read_bytes()) for o in outs]


# ---------------------------------------------------------------------------
# The shared problem (the JAX suite's tests/test_sharded_adapter.py sizes).
# ---------------------------------------------------------------------------

T, N, F0, E = 8, 48, 4, 200


def problem(band: int = 3) -> dict:
    """numpy arrays from seed 0: dense adjacency (T, N, N), M, X, edges,
    targets, and the params of every case (the same on both packages)."""
    rng = np.random.default_rng(0)
    dense = (rng.random((T, N, N)) < 0.06) * rng.random((T, N, N))
    X = rng.standard_normal((T, N, F0)).astype(np.float32)
    edges = np.stack(
        [rng.integers(0, T, E), rng.integers(0, N, E), rng.integers(0, N, E)]
    ).astype(np.int64)
    targets = rng.integers(0, 2, E)
    params = {
        "tmgcn1": {"W": rng.standard_normal((F0, 6)), "U": rng.standard_normal((12, 2))},
        "tmgcn2": {"W1": rng.standard_normal((F0, 6)), "W2": rng.standard_normal((6, 5)),
                   "U": rng.standard_normal((10, 2))},
        "kwgcn2": {"W1": rng.standard_normal((F0, 6)), "W2": rng.standard_normal((6, 5)),
                   "U": rng.standard_normal((10, 2))},
    }
    lp_edges = edges.copy()
    lp_edges[0] = np.clip(lp_edges[0], 0, T - 2)
    return {
        "dense": dense, "M": make_m_matrix(T, band).astype(np.float32), "X": X,
        "edges": edges, "lp_edges": lp_edges, "targets": targets,
        "cw": np.array([0.6, 0.4]), "params": params,
    }


def case_setup(case: str, p: dict):
    """(model, edges, params, adapter kwargs) of one case, with the port's
    model (the tests build the JAX one alike)."""
    from tmgcn_torch.models.gcn import KWGCN
    from tmgcn_torch.models.tmgcn import TMGCN, TMGCN2

    if case in ("tmgcn1", "tmgcn1_lp"):
        lp = case == "tmgcn1_lp"
        model = TMGCN(n_slices=T - lp, in_feat=F0, hidden_feat=(6, 2))
        return model, p["lp_edges" if lp else "edges"], p["params"]["tmgcn1"], {
            "drop_last_slice": lp}
    if case.startswith("tmgcn2"):
        m3 = case == "tmgcn2_m3"
        model = TMGCN2(n_slices=T, in_feat=F0, hidden_feat=(6, 5, 2), nonlin2="selu",
                       apply_M_twice=m3, apply_M_three_times=m3)
        kw = {"l2_impl": case.split("_")[1]} if not m3 else {}
        return model, p["edges"], p["params"]["tmgcn2"], kw
    if case == "kwgcn2":
        return KWGCN(n_slices=T, in_feat=F0, hidden_feat=(6, 5, 2)), p["edges"], \
            p["params"]["kwgcn2"], {}
    raise ValueError(case)


def _windows(x) -> dict:
    return {w: x for w in ("train", "val", "test")}


def _variables(params: dict, requires_grad: bool = True) -> dict:
    return {"params": {k: torch.tensor(v, dtype=torch.float32, requires_grad=requires_grad)
                       for k, v in params.items()}, "buffers": {}}


def adapter_for(case: str, p: dict, mesh=None):
    """The port's adapter of a case: single-device, or sharded on ``mesh``."""
    from tmgcn_torch.parallel.adapter import make_sharded_edge_adapter
    from tmgcn_torch.tasks.adapters import make_edge_adapter

    model, edges, _, kw = case_setup(case, p)
    A = TemporalCOO.from_dense(p["dense"], pad_multiple=16)
    if mesh is None:
        kw.pop("l2_impl", None)
        return make_edge_adapter(model, _windows(A), _windows(p["X"]), _windows(edges),
                                 M=p["M"], device="cpu", **kw)
    return make_sharded_edge_adapter(model, _windows(A), _windows(p["X"]), _windows(edges),
                                     p["M"], mesh, **kw)


def logits_and_grads(adapter, case: str, p: dict) -> dict:
    """Train-window logits, the weighted cross-entropy's parameter
    gradients through ``apply``, and (sharded adapters) ``train_stats``'s
    loss, counts and gradients."""
    from tmgcn_torch.train.losses import weighted_cross_entropy

    _, edges, params, _ = case_setup(case, p)
    variables = _variables(params)
    tgt = torch.as_tensor(p["targets"][: edges.shape[1]])
    cw = torch.as_tensor(p["cw"])
    out, _ = adapter.apply(variables, adapter.bundles["train"], ())
    loss = weighted_cross_entropy(out, tgt, cw)
    keys = sorted(variables["params"])
    grads = torch.autograd.grad(loss, [variables["params"][k] for k in keys])
    res = {"out": out.detach().numpy(), "loss": float(loss.detach()),
           "grads": {k: g.numpy() for k, g in zip(keys, grads)}}
    if adapter.train_stats is not None:
        s_loss, counts = adapter.train_stats(variables, adapter.bundles["train"], tgt, cw)
        s_grads = torch.autograd.grad(s_loss, [variables["params"][k] for k in keys])
        res.update(stats_loss=float(s_loss.detach()), counts=[int(c) for c in counts],
                   stats_grads={k: g.numpy() for k, g in zip(keys, s_grads)})
    return res


def loop_rows(adapter, case: str, p: dict, n_epochs: int = 5) -> tuple[np.ndarray, dict]:
    """Rows and final parameters of the port's classification loop
    (eval_every 3: an evaluation epoch, two plain epochs, another
    evaluation epoch, one plain)."""
    from tmgcn_torch.tasks.windows import EdgeSplit
    from tmgcn_torch.train.loop import TrainConfig, run_edge_classification

    _, edges, params, _ = case_setup(case, p)
    split = EdgeSplit(edges=edges, target=p["targets"], eval_mask=np.ones(E, bool))
    cfg = TrainConfig(n_epochs=n_epochs, eval_every=3, lr=1e-3)
    rows, variables = run_edge_classification(adapter, _windows(split), p["cw"], cfg,
                                              variables=_variables(params, requires_grad=False))
    return rows, {k: v.numpy() for k, v in variables["params"].items()}


def halo_case(band: int) -> dict:
    """The banded M-transform of this rank's time block (halo wider than
    the block where band - 1 > T_loc) and the gradient of a replicated
    loss, sum(out * R), with respect to the rank's block."""
    from tmgcn_torch.core.mmatrix import band_offsets
    from tmgcn_torch.parallel import collectives
    from tmgcn_torch.parallel.distributed import initialize
    from tmgcn_torch.parallel.halo import banded_m_transform_local, local_banded_m
    from tmgcn_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, dist.get_world_size(), device=initialize("cpu"))
    rng = np.random.default_rng(1)
    M = make_m_matrix(T, band)
    X = rng.standard_normal((T, 5, 3))
    R = rng.standard_normal((T, 5, 3))
    halo = band_offsets(M)[0]
    t_loc = T // mesh.n_time
    sl = slice(mesh.t * t_loc, (mesh.t + 1) * t_loc)
    x_loc = torch.tensor(X[sl], requires_grad=True)
    block = torch.tensor(local_banded_m(M, mesh.n_time, halo)[mesh.t])
    out = banded_m_transform_local(x_loc, block, halo, mesh.time_group)
    total = collectives.reduce_from(torch.sum(out * torch.tensor(R[sl])), mesh.time_group)
    (grad,) = torch.autograd.grad(total, x_loc)
    return {"halo": halo, "t_loc": t_loc, "out": out.detach().numpy(), "grad": grad.numpy(),
            "M": M, "X": X, "R": R}


def standalone_problem() -> tuple:
    """(dense, M, X, edges, targets, params) of the standalone steps: T = 8,
    N = 40, F = 4, 90 edges, from seed 7."""
    rng = np.random.default_rng(7)
    dense = (rng.random((T, 40, 40)) < 0.06) * rng.random((T, 40, 40))
    M = make_m_matrix(T, 3).astype(np.float32)
    X = rng.standard_normal((T, 40, 4)).astype(np.float32)
    edges = np.stack([rng.integers(0, T, 90), rng.integers(0, 40, 90), rng.integers(0, 40, 90)])
    targets = rng.integers(0, 2, 90)
    params = {"W": rng.standard_normal((4, 6)), "U": rng.standard_normal((12, 2))}
    return dense, M, X, edges, targets, params


def standalone_losses(mesh, step: str, n_steps: int = 4) -> list[float]:
    """The losses of ``n_steps`` of a standalone sharded step on this rank's
    shard (tmgcn_sharded: "v1", the gather forward with its replicated
    readout, or "halo", the banded exchange and the partitioned readout),
    SGD lr 1e-4, momentum 0.9, class weights [0.9, 0.1]."""
    from tmgcn_torch.core.mmatrix import band_offsets
    from tmgcn_torch.parallel import halo, partition, tmgcn_sharded
    from tmgcn_torch.train.loop import TrainConfig

    dense, M, X, edges, targets, params = standalone_problem()
    A_sh = partition.pad_time(partition.partition_rows(
        TemporalCOO.from_dense(dense, pad_multiple=16), mesh.n_graph, 16), mesh.n_time)
    p = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True) for k, v in params.items()}
    cfg = TrainConfig(lr=1e-4, momentum=0.9)
    cw = torch.tensor([0.9, 0.1])
    batch = tmgcn_sharded.shard_batch(mesh, A_sh, X, M, edges, targets)
    if step == "v1":
        train = tmgcn_sharded.make_sharded_train_step(mesh, A_sh.n_local_rows, p, cfg)
        return [float(train(batch, cw)) for _ in range(n_steps)]
    h = band_offsets(M)[0]
    train = tmgcn_sharded.make_sharded_train_step_halo(
        mesh, A_sh.n_local_rows, p, cfg, halo.local_banded_m(M, mesh.n_time, h), h)
    e_b, t_b, m_b = (torch.as_tensor(a[mesh.t]) for a in tmgcn_sharded.partition_edges_by_time(
        edges, targets, T, mesh.n_time, 16))
    return [float(train(batch, e_b.long(), t_b, m_b, cw)) for _ in range(n_steps)]


def mesh_cases(n_graph: int, n_time: int) -> dict:
    """Everything one rank of a (n_graph, n_time) mesh computes for the
    tests: each case's logits and gradients (apply and train_stats), the
    5-epoch loop rows and final parameters of two cases, the standalone
    steps' losses, the multi-hop halo and its gradient, and the mesh's
    position."""
    from tmgcn_torch.parallel.distributed import initialize, runtime_info
    from tmgcn_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_graph, n_time, device=initialize("cpu"))
    p = problem()
    res = {"position": (mesh.g, mesh.t), "info": runtime_info(), "cases": {}, "rows": {}}
    for case in CASES:
        res["cases"][case] = logits_and_grads(adapter_for(case, p, mesh), case, p)
    for case in ("tmgcn1", "tmgcn2_m3"):
        res["rows"][case] = loop_rows(adapter_for(case, p, mesh), case, p)
    res["steps"] = {step: standalone_losses(mesh, step) for step in ("v1", "halo")}
    if n_time > 1:
        res["halo"] = halo_case(band=6)
        wide = problem(band=6)
        res["wide_m3"] = logits_and_grads(adapter_for("tmgcn2_m3", wide, mesh), "tmgcn2_m3",
                                          wide)
    return res


# ---------------------------------------------------------------------------
# The recurrent families and regression over the mesh
# (tests/test_torch_sharded_recurrent.py). N = 46: the (4, 1) mesh pads its
# last row block, whose rows the distributed top-k must score -inf.
# ---------------------------------------------------------------------------

RN = 46
# case -> (family, hidden, link prediction)
RECURRENT = {
    "wdgcn": ("wdgcn", (6, 2), False),
    "evolvegcn1": ("evolvegcn", (4, 2), False),
    "evolvegcn2": ("evolvegcn", (4, 5, 2), False),
    "evolvegcn2_wide": ("evolvegcn", (4, 16, 2), False),  # k2 16 > N_loc 12 at (4, 1)
    "wdgcn_lp": ("wdgcn", (6, 2), True),
    "evolvegcn1_lp": ("evolvegcn", (4, 2), True),
}
REGRESSION = {"tmgcn_reg": (6, 1), "wdgcn_reg": (6, 1), "evolvegcn_reg": (4, 1)}
LOOPED = ("wdgcn", "evolvegcn1", "evolvegcn2")


def recurrent_problem() -> dict:
    """numpy arrays from seed 5: dense adjacency (T, 46, 46), M, standard
    normal features (the JAX suite's), edges and LP edges, class targets and
    the regression windows' (T, N) targets. Layer 2's scores tie where the
    ReLU zeroes a hidden row (``tied_summaries`` holds ties alone)."""
    rng = np.random.default_rng(5)
    dense = (rng.random((T, RN, RN)) < 0.06) * rng.random((T, RN, RN))
    X = rng.standard_normal((T, RN, F0)).astype(np.float32)
    edges = np.stack(
        [rng.integers(0, T, E), rng.integers(0, RN, E), rng.integers(0, RN, E)]
    ).astype(np.int64)
    lp_edges = edges.copy()
    lp_edges[0] = np.clip(lp_edges[0], 0, T - 2)
    return {
        "dense": dense, "M": make_m_matrix(T, 3).astype(np.float32), "X": X, "edges": edges,
        "lp_edges": lp_edges, "targets": rng.integers(0, 2, E), "cw": np.array([0.6, 0.4]),
        "reg_targets": {w: rng.standard_normal((T, RN)).astype(np.float32)
                        for w in ("train", "val", "test")},
    }


def recurrent_model(case: str):
    """The port's model of a recurrent or regression case (the tests build
    the JAX one alike)."""
    from tmgcn_torch.models.evolvegcn import EvolveGCN, EvolveGCNReg
    from tmgcn_torch.models.tmgcn import TMGCNReg
    from tmgcn_torch.models.wdgcn import WDGCN, WDGCNReg

    if case in REGRESSION:
        cls = {"tmgcn_reg": TMGCNReg, "wdgcn_reg": WDGCNReg, "evolvegcn_reg": EvolveGCNReg}[case]
        return cls(n_slices=T, in_feat=F0, hidden_feat=REGRESSION[case])
    family, hidden, lp = RECURRENT[case]
    return (WDGCN if family == "wdgcn" else EvolveGCN)(n_slices=T - lp, in_feat=F0,
                                                       hidden_feat=hidden)


def recurrent_adapter(case: str, p: dict, mesh=None):
    """The port's adapter of a case: single-device, or sharded on ``mesh``."""
    from tmgcn_torch.parallel import adapter as sharded
    from tmgcn_torch.tasks import adapters

    model = recurrent_model(case)
    A = _windows(TemporalCOO.from_dense(p["dense"], pad_multiple=16))
    X = _windows(p["X"])
    if case in REGRESSION:
        M = p["M"] if case == "tmgcn_reg" else None
        if mesh is None:
            return adapters.make_regression_adapter(model, A, X, M=M, device="cpu")
        return sharded.make_sharded_regression_adapter(model, A, X, M, mesh)
    lp = RECURRENT[case][2]
    edges = _windows(p["lp_edges" if lp else "edges"])
    if mesh is None:
        return adapters.make_edge_adapter(model, A, X, edges, drop_last_slice=lp, device="cpu")
    return sharded.make_sharded_edge_adapter(model, A, X, edges, None, mesh, drop_last_slice=lp)


def _torch_variables(tree: dict) -> dict:
    """A JAX variable tree (numpy leaves) as the port's, parameters
    requiring grad."""
    from tmgcn_torch.configs.build import params_from_jax

    v = params_from_jax(tree)
    for leaf in _named_leaves(v["params"]).values():
        leaf.requires_grad_(True)
    return v


def _named_leaves(tree: dict) -> dict:
    """{"cell1.W_Z": tensor, ...}: a nested dict's leaves by dotted path,
    in sorted key order."""
    from tmgcn_torch.parallel.collectives import _leaf_paths

    return {".".join(path): leaf for path, leaf in _leaf_paths(tree)}


def recurrent_outputs_and_grads(adapter, case: str, p: dict, jvars: dict) -> dict:
    """The train window's output (logits, or the (T, N) regression output),
    the carry (EvolveGCN's evolved weights) and the gradients of the loss
    the loop trains (the weighted cross-entropy, or the summed per-slice
    MSE) by parameter path."""
    from tmgcn_torch.train.losses import summed_per_slice_mse, weighted_cross_entropy

    from tmgcn_torch.parallel import collectives

    variables = _torch_variables(jvars)
    collectives.ISSUED.clear()
    out, carry = adapter.apply(variables, adapter.bundles["train"], ())
    if case in REGRESSION:
        loss = summed_per_slice_mse(out, torch.as_tensor(p["reg_targets"]["train"]))
    else:
        tgt = torch.as_tensor(p["targets"])
        loss = weighted_cross_entropy(out, tgt, torch.as_tensor(p["cw"]))
    leaves = _named_leaves(variables["params"])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {"out": out.detach().numpy(), "carry": [c.detach().numpy() for c in carry],
            "grads": {k: g.numpy() for k, g in zip(leaves, grads)},
            "issued": dict(collectives.ISSUED)}


def banded_issued(case: str, mesh) -> dict:
    """The collectives (``collectives.ISSUED``) of one evaluation step
    (``apply``, the loss, its gradients) and one plain step
    (``train_stats``) of a banded case of ``mesh_cases``."""
    from tmgcn_torch.parallel import collectives
    from tmgcn_torch.train.losses import weighted_cross_entropy

    p = problem()
    adapter = adapter_for(case, p, mesh)
    _, edges, params, _ = case_setup(case, p)
    variables = _variables(params)
    tgt = torch.as_tensor(p["targets"][: edges.shape[1]])
    cw = torch.as_tensor(p["cw"])
    leaves = [variables["params"][k] for k in sorted(variables["params"])]
    out = {}
    collectives.ISSUED.clear()
    logits, _ = adapter.apply(variables, adapter.bundles["train"], ())
    torch.autograd.grad(weighted_cross_entropy(logits, tgt, cw), leaves)
    out["eval"] = dict(collectives.ISSUED)
    collectives.ISSUED.clear()
    loss, _ = adapter.train_stats(variables, adapter.bundles["train"], tgt, cw,
                                  confusion=not case.endswith("_lp"))
    torch.autograd.grad(loss, leaves)
    out["plain"] = dict(collectives.ISSUED)
    return out


def recurrent_loop_rows(adapter, case: str, p: dict, jvars: dict, n_epochs: int = 5,
                        checkpointer=None):
    """Rows (regression: the result dict) and final parameters of the
    port's loop, eval_every 3 (regression 2), SGD lr 1e-3."""
    from tmgcn_torch.tasks.windows import EdgeSplit
    from tmgcn_torch.train.loop import TrainConfig, run_edge_classification, run_regression

    variables = _torch_variables(jvars)
    if case in REGRESSION:
        cfg = TrainConfig(n_epochs=n_epochs, eval_every=2, lr=1e-3)
        res, v = run_regression(adapter, p["reg_targets"], cfg, variables=variables,
                                checkpointer=checkpointer)
    else:
        split = EdgeSplit(edges=p["edges"], target=p["targets"], eval_mask=np.ones(E, bool))
        cfg = TrainConfig(n_epochs=n_epochs, eval_every=3, lr=1e-3)
        res, v = run_edge_classification(adapter, _windows(split), p["cw"], cfg,
                                         variables=variables, checkpointer=checkpointer)
    return res, {k: x.numpy() for k, x in _named_leaves(v["params"]).items()}


def resumed_rows(mesh, case: str, p: dict, jvars: dict, directory: str) -> dict:
    """A run of 6 epochs (eval_every 3) without checkpoints; one of 4 epochs
    saving under ``directory`` (rank 0 alone, a barrier after each save),
    then resumed to 6 from its newest checkpoint. Each rank counts the
    checkpoint files it wrote."""
    from tmgcn_torch.train import checkpoint

    writes = []
    save = checkpoint.torch.save

    def counted(obj, f, *args, **kwargs):
        writes.append(1)
        return save(obj, f, *args, **kwargs)

    adapter = recurrent_adapter(case, p, mesh)
    full, _ = recurrent_loop_rows(adapter, case, p, jvars, n_epochs=6)
    checkpoint.torch.save = counted
    try:
        ck = checkpoint.RunCheckpointer(directory, group=mesh.world)
        recurrent_loop_rows(adapter, case, p, jvars, n_epochs=4, checkpointer=ck)
        resumed, _ = recurrent_loop_rows(adapter, case, p, jvars, n_epochs=6,
                                         checkpointer=checkpoint.RunCheckpointer(
                                             directory, group=mesh.world))
    finally:
        checkpoint.torch.save = save
    return {"full": full, "resumed": resumed, "writes": len(writes)}


def tied_summaries(mesh) -> dict:
    """The distributed top-k (``parallel.adapter._distributed_summaries``)
    on this rank's block of (4, 46, 3) hidden rows full of ties (small
    integers, a slice of one repeated row, a slice of zeros, zero rows),
    the (4, 1) mesh's padding rows past 46 included, and the single-device
    ``batched_summaries`` of the whole rows: {k: (sharded, single)} for k
    from 1 to all 46 rows (k > N_loc where the shards are small)."""
    from tmgcn_torch.models.evolvegcn import batched_summaries
    from tmgcn_torch.parallel.adapter import _distributed_summaries

    rng = np.random.default_rng(11)
    H = rng.integers(0, 3, (4, RN, 3)).astype(np.float32)
    H[1] = H[1, 0]
    H[2] = 0.0
    H[3, ::2] = 0.0
    p2 = torch.as_tensor(rng.standard_normal(3).astype(np.float32))
    n_loc = -(-RN // mesh.n_graph)
    padded = np.zeros((4, n_loc * mesh.n_graph, 3), np.float32)
    padded[:, :RN] = H
    local = torch.as_tensor(padded[:, mesh.g * n_loc:(mesh.g + 1) * n_loc])
    return {k: (_distributed_summaries(local, p2, k, RN, mesh).numpy(),
                batched_summaries({"p": p2}, torch.as_tensor(H), k).numpy())
            for k in (1, 5, n_loc + 1, RN)}


def recurrent_cases(n_graph: int, n_time: int, jvars: dict, directory: str | None = None) -> dict:
    """Everything one rank of a (n_graph, n_time) mesh computes for the
    tests: on a graph-only mesh every recurrent case's outputs, carry and
    gradients and the looped cases' rows; TMGCNReg on any mesh, WDGCNReg
    and EvolveGCNReg on (1, 1) and (2, 1), each with its 5-epoch result;
    the collectives a step of three banded cases issues; the distributed
    top-k on tied rows (graph-only meshes); with
    ``directory`` the interrupted and resumed run."""
    from tmgcn_torch.parallel.distributed import initialize
    from tmgcn_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_graph, n_time, device=initialize("cpu"))
    p = recurrent_problem()
    cases = [c for c in RECURRENT if n_time == 1]
    cases += [c for c in REGRESSION if c == "tmgcn_reg" or (n_time == 1 and n_graph <= 2)]
    res = {"position": (mesh.g, mesh.t), "cases": {}, "rows": {}}
    for case in cases:
        adapter = recurrent_adapter(case, p, mesh)
        res["cases"][case] = recurrent_outputs_and_grads(adapter, case, p, jvars[case])
        if case in LOOPED or case in REGRESSION:
            res["rows"][case] = recurrent_loop_rows(adapter, case, p, jvars[case])
    res["banded_issued"] = {case: banded_issued(case, mesh)
                            for case in ("tmgcn1", "tmgcn2_m3", "tmgcn1_lp")}
    if n_time == 1:
        res["tied"] = tied_summaries(mesh)
    if directory is not None:
        res["resume"] = resumed_rows(mesh, "evolvegcn1", p, jvars["evolvegcn1"], directory)
    return res


def scaling_rows() -> list:
    """``utils/scaling_bench.run`` on a tiny problem under gloo, 2 steps a
    mesh: the rows of meshes of 1 and 2 ranks."""
    from tmgcn_torch.utils import scaling_bench

    tiny = {"T": 4, "N": 64, "F": 4, "E": 300, "nnz": 200, "band": 2}
    return scaling_bench.run(tiny, device="cpu", iters=2, control_iters=1, verbose=False)

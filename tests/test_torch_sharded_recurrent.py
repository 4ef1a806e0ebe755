"""The port's sharded recurrent and regression adapters
(tmgcn_torch/parallel/adapter.py) under gloo on the CPU, against the JAX
package's sharded adapters on the same mesh shape and the port's single
device.

Meshes: (1, 1) (this process as the world), (2, 1) and (4, 1) for WD-GCN
and EvolveGCN-H, 1 and 2 layers, classification and link prediction (the
last slice dropped); TMGCNReg on (1, 1), (2, 1), (1, 2) and (2, 2);
WDGCNReg and EvolveGCNReg on (1, 1) and (2, 1). The ranks are spawned by
tests/torch_mesh_workers.py (no JAX; each spawn has a deadline). The
features are standard normal (the JAX suite's); ties in the distributed
top-k are held on their own (``test_distributed_top_k_ties``). N = 46 pads
the (4, 1) mesh's last row block, and
EvolveGCN-2 "wide" takes k2 = 16 summaries, more than a (4, 1) shard's 12
rows. The JAX variables are carried across with ``params_from_jax``.

Held: the train window's output and EvolveGCN's evolved weights against
the JAX sharded adapter (atol 2e-5, the JAX suite's, or 1e-6 of the
largest output where EvolveGCN-2's logits are large); the loss's parameter
gradients against the port's single device (atol 2e-5 and rtol 1e-5); 5
epochs of the loops against the single-device rows (loss rtol 1e-4, F1
rtol 1e-3; regression losses and L1 rtol 1e-3); every rank's outputs,
rows and trained parameters alike; a 2 x 1 run interrupted at an
evaluation epoch and resumed from its checkpoint (rank 0 alone wrote),
whose train columns are the uninterrupted sharded run's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_mesh_workers as W
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.models.evolvegcn import EvolveGCN as JEvolveGCN
from tmgcn_tpu.models.evolvegcn import EvolveGCNReg as JEvolveGCNReg
from tmgcn_tpu.models.tmgcn import TMGCNReg as JTMGCNReg
from tmgcn_tpu.models.wdgcn import WDGCN as JWDGCN
from tmgcn_tpu.models.wdgcn import WDGCNReg as JWDGCNReg
from tmgcn_tpu.parallel.adapter import make_sharded_edge_adapter as j_sharded
from tmgcn_tpu.parallel.adapter import make_sharded_regression_adapter as j_sharded_reg
from tmgcn_tpu.parallel.mesh import make_mesh as j_make_mesh
from tmgcn_torch.parallel import distributed

GRAPH_MESHES = [(1, 1), (2, 1), (4, 1)]
TMGCN_REG_MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
# The JAX suite's atol, or 1e-6 of the largest output where that is more:
# EvolveGCN-2's logits reach |88|, where one float32 ulp is 7.6e-6, and a
# logit summed from terms of that size keeps their rounding (the JAX
# package's own sharded and single-device logits differ by 9.5e-6 there;
# the port's single-device ones from the JAX package's by 2.2e-5).
ATOL, SCALE_RTOL = 2e-5, 1e-6


def _assert_close(got, want, err_msg=""):
    atol = max(ATOL, SCALE_RTOL * float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=err_msg)
SEEDS = {case: i for i, case in enumerate([*W.RECURRENT, *W.REGRESSION])}


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _jax_model(case: str):
    if case in W.REGRESSION:
        cls = {"tmgcn_reg": JTMGCNReg, "wdgcn_reg": JWDGCNReg,
               "evolvegcn_reg": JEvolveGCNReg}[case]
        return cls(n_slices=W.T, in_feat=W.F0, hidden_feat=W.REGRESSION[case])
    family, hidden, lp = W.RECURRENT[case]
    cls = JWDGCN if family == "wdgcn" else JEvolveGCN
    return cls(n_slices=W.T - lp, in_feat=W.F0, hidden_feat=hidden)


@pytest.fixture(scope="module")
def jvars():
    """Every case's JAX initial variables, as numpy."""
    return {case: _np_tree(_jax_model(case).init(jax.random.PRNGKey(seed)))
            for case, seed in SEEDS.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jvars):
    """{mesh shape: every rank's ``recurrent_cases`` results, rank order};
    the (2, 1) ranks also run the interrupted and resumed run."""
    out = {}
    for G, T in [(2, 1), (4, 1), (1, 2), (2, 2)]:
        tmp = tmp_path_factory.mktemp(f"recurrent_{G}x{T}")
        directory = str(tmp / "ck") if (G, T) == (2, 1) else None
        out[(G, T)] = W.spawn("recurrent_cases", G * T, tmp, G, T, jvars, directory)
    distributed.initialize("cpu")  # this process alone: the 1 x 1 mesh
    out[(1, 1)] = [W.recurrent_cases(1, 1, jvars)]
    return out


@pytest.fixture(scope="module")
def single(jvars):
    """The port's single-device outputs and gradients of every case, and
    the loop results of the looped and regression cases."""
    p = W.recurrent_problem()
    res, rows = {}, {}
    for case in [*W.RECURRENT, *W.REGRESSION]:
        adapter = W.recurrent_adapter(case, p)
        res[case] = W.recurrent_outputs_and_grads(adapter, case, p, jvars[case])
        if case in W.LOOPED or case in W.REGRESSION:
            rows[case] = W.recurrent_loop_rows(adapter, case, p, jvars[case])[0]
    return res, rows


_JAX = {}


def jax_sharded(mesh_shape, case: str, jvars: dict) -> dict:
    """The JAX sharded adapter's train output and carry on the same problem,
    variables and mesh shape (memoized)."""
    key = (mesh_shape, case)
    if key not in _JAX:
        p = W.recurrent_problem()
        A = JaxCOO.from_dense(p["dense"], dtype=jnp.float32, pad_multiple=16)
        wins = ("train", "val", "test")
        adj, feats = {w: A for w in wins}, {w: p["X"] for w in wins}
        G, T = mesh_shape
        mesh = j_make_mesh(G, T, devices=jax.devices()[: G * T])
        if case in W.REGRESSION:
            sh = j_sharded_reg(_jax_model(case), adj, feats,
                               p["M"] if case == "tmgcn_reg" else None, mesh)
        else:
            lp = W.RECURRENT[case][2]
            edges = {w: p["lp_edges" if lp else "edges"] for w in wins}
            sh = j_sharded(_jax_model(case), adj, feats, edges, None, mesh, drop_last_slice=lp)
        variables = jax.tree_util.tree_map(jnp.asarray, jvars[case])
        out, carry = sh.apply(variables, sh.bundles["train"], ())
        _JAX[key] = {"out": np.asarray(out), "carry": [np.asarray(c) for c in carry]}
    return _JAX[key]


def _cases(mesh_shape):
    G, T = mesh_shape
    if T > 1:
        return ["tmgcn_reg"]
    cases = [*W.RECURRENT, "tmgcn_reg"]
    return cases + (["wdgcn_reg", "evolvegcn_reg"] if G <= 2 else [])


MESH_CASES = [(m, c) for m in [*GRAPH_MESHES, (1, 2), (2, 2)] for c in _cases(m)]


@pytest.mark.parametrize("mesh_shape,case", MESH_CASES)
def test_against_jax_sharded(ranks, jvars, mesh_shape, case):
    got = ranks[mesh_shape][0]["cases"][case]
    want = jax_sharded(mesh_shape, case, jvars)
    _assert_close(got["out"], want["out"])
    assert len(got["carry"]) == len(want["carry"])
    for ours, theirs in zip(got["carry"], want["carry"]):
        _assert_close(ours, theirs)


@pytest.mark.parametrize("mesh_shape,case", MESH_CASES)
def test_against_single_device(ranks, single, mesh_shape, case):
    """Outputs, carries and the loss's parameter gradients: a wrong backward
    rule of a collective shows as gradients G (or G x T) times too large,
    or as this shard's share alone."""
    want = single[0][case]
    for r in ranks[mesh_shape]:
        got = r["cases"][case]
        _assert_close(got["out"], want["out"])
        for ours, theirs in zip(got["carry"], want["carry"]):
            _assert_close(ours, theirs)
        assert set(got["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=1e-5, atol=ATOL, err_msg=k)


LOOP_CASES = [(m, c) for m, c in MESH_CASES if c in W.LOOPED or c in W.REGRESSION]


@pytest.mark.parametrize("mesh_shape,case", LOOP_CASES)
def test_loop_rows(ranks, single, mesh_shape, case):
    """5 epochs of the unmodified loops against the single-device run:
    classification loss rtol 1e-4 and F1 rtol 1e-3 (EvolveGCN's evaluation
    windows start from the train window's evolved weights); regression's
    train losses and val/test L1 and L1 ratio rtol 1e-3."""
    ref = single[1][case]
    for r in ranks[mesh_shape]:
        rows, _ = r["rows"][case]
        if case in W.REGRESSION:
            for k, v in ref.items():
                np.testing.assert_allclose(rows[k], v, rtol=1e-3, err_msg=k)
            continue
        for col in (3, 7, 11):
            np.testing.assert_allclose(rows[:, col], ref[:, col], rtol=1e-4)
        for col in (2, 6, 10):
            np.testing.assert_allclose(rows[:, col], ref[:, col], rtol=1e-3, equal_nan=True)


@pytest.mark.parametrize("mesh_shape", GRAPH_MESHES)
def test_distributed_top_k_ties(ranks, mesh_shape):
    """EvolveGCN-2's distributed top-k on rows full of ties (equal rows
    within and across shards, a slice of zeros, the padding rows scored
    -inf), k from 1 to every row: bitwise the single-device summaries, so
    equal scores go in index order as ``jax.lax.top_k`` orders them."""
    for r in ranks[mesh_shape]:
        for k, (sharded, single) in r["tied"].items():
            np.testing.assert_array_equal(sharded, single, err_msg=f"k={k}")


@pytest.mark.parametrize("mesh_shape", [(2, 1), (4, 1), (1, 2), (2, 2)])
def test_ranks_agree(ranks, mesh_shape):
    """Rank r sits at (r // T, r % T); every rank returns bitwise the same
    outputs, carries and gradients, and the same trained parameters; the
    rows within 1e-6 (each rank scores the logits itself)."""
    G, T = mesh_shape
    results = ranks[mesh_shape]
    assert [r["position"] for r in results] == [divmod(i, T) for i in range(G * T)]
    first = results[0]
    for r in results[1:]:
        for case, c in first["cases"].items():
            np.testing.assert_array_equal(r["cases"][case]["out"], c["out"])
            for a, b in zip(r["cases"][case]["carry"], c["carry"]):
                np.testing.assert_array_equal(a, b)
            for k, g in c["grads"].items():
                np.testing.assert_array_equal(r["cases"][case]["grads"][k], g)
        for case, (rows, params) in first["rows"].items():
            got_rows, got_params = r["rows"][case]
            if case in W.REGRESSION:
                for k, v in rows.items():
                    np.testing.assert_allclose(got_rows[k], v, rtol=1e-6)
            else:
                np.testing.assert_allclose(got_rows, rows, rtol=1e-6)
            for k, v in params.items():
                np.testing.assert_array_equal(got_params[k], v)


def test_resume_under_a_mesh(ranks):
    """2 x 1, EvolveGCN-H 1 layer (its evolved weights the carry): a run
    of 4 epochs saving at its evaluation epochs 0 and 3, resumed to 6 from
    the checkpoint of epoch 3: the train columns are the uninterrupted
    sharded run's (the evaluation rows after the save shift, as on one
    device); rank 0 alone wrote its two files, every rank resumed."""
    (r0, r1) = ranks[(2, 1)]
    # 2 saves in the interrupted run, 1 at the resumed run's evaluation epoch 4.
    assert r0["resume"]["writes"] == 3 and r1["resume"]["writes"] == 0
    for r in (r0, r1):
        full, resumed = r["resume"]["full"], r["resume"]["resumed"]
        np.testing.assert_array_equal(resumed[:, :4], full[:, :4])
        np.testing.assert_array_equal(resumed[:4], full[:4])


@pytest.mark.parametrize("case,n_layers", [("evolvegcn1", 3), ("wdgcn", None)])
def test_refusals_as_jax(case, n_layers):
    """The JAX package's refusals, message for message: a time axis for the
    recurrent families (the edge and the regression adapter), and an
    EvolveGCN of other than 1 or 2 layers."""
    from tmgcn_torch.parallel import adapter
    from tmgcn_torch.parallel.mesh import make_mesh

    p = W.recurrent_problem()
    wins = ("train", "val", "test")
    JA = JaxCOO.from_dense(p["dense"], dtype=jnp.float32, pad_multiple=16)
    mesh11 = make_mesh(1, 1, device=distributed.initialize("cpu"))
    # The refusals come before any collective: a 1 x 2 view of this world.
    time_mesh = dataclasses.replace(mesh11, shape={"graph": 1, "time": 2})
    A = W._windows(W.TemporalCOO.from_dense(p["dense"], pad_multiple=16))

    def both(ours, theirs):
        with pytest.raises(Exception) as t_err:
            ours()
        with pytest.raises(Exception) as j_err:
            theirs()
        assert type(t_err.value) is type(j_err.value) is NotImplementedError
        assert str(t_err.value) == str(j_err.value)

    j_time = j_make_mesh(1, 2, devices=jax.devices()[:2])
    feats, edges = W._windows(p["X"]), W._windows(p["edges"])
    jA = {w: JA for w in wins}
    both(lambda: adapter.make_sharded_edge_adapter(W.recurrent_model(case), A, feats, edges,
                                                   None, time_mesh),
         lambda: j_sharded(_jax_model(case), jA, feats, edges, None, j_time))
    reg = "evolvegcn_reg" if case.startswith("evolve") else "wdgcn_reg"
    both(lambda: adapter.make_sharded_regression_adapter(W.recurrent_model(reg), A, feats, None,
                                                         time_mesh),
         lambda: j_sharded_reg(_jax_model(reg), jA, feats, None, j_time))
    if n_layers is not None:
        from tmgcn_torch.models.evolvegcn import EvolveGCN

        hidden = (4,) * n_layers + (2,)
        both(lambda: adapter.make_sharded_edge_adapter(
                 EvolveGCN(n_slices=W.T, in_feat=W.F0, hidden_feat=hidden), A, feats, edges,
                 None, mesh11),
             lambda: j_sharded(JEvolveGCN(n_slices=W.T, in_feat=W.F0, hidden_feat=hidden), jA,
                               feats, edges, None, j_make_mesh(1, 1, devices=jax.devices()[:1])))


def _workload(case: str):
    """The comm model's workload of a worker case: the problem's shape, the
    largest time bucket's edges reckoned as the adapter buckets them."""
    from tmgcn_torch.parallel.adapter import bucket_edges_by_time
    from tmgcn_torch.utils.comm_model import Workload

    if case in W.REGRESSION:
        family = case.split("_")[0]
        return lambda G, T: Workload(case, family, "regression", W.T, W.RN, W.F0,
                                     W.REGRESSION[case], halo=2)
    if case in W.RECURRENT:
        family, hidden, lp = W.RECURRENT[case]
        return lambda G, T: Workload(case, family, "link_pred" if lp else "edge_cls",
                                     W.T - lp, W.RN, W.F0, hidden, E=W.E)
    p = W.problem()
    _, edges, _, _ = W.case_setup(case, p)
    lp = case.endswith("_lp")
    hidden = (6, 5, 2) if case.startswith("tmgcn2") else (6, 2)

    def at(G, T):
        t_pad = -(-(W.T - lp) // T) * T
        _, mask, _ = bucket_edges_by_time(edges, t_pad, T)
        return Workload(case, "tmgcn", "link_pred" if lp else "edge_cls", W.T - lp, W.N, W.F0,
                        hidden, E=W.E, edges_per_bucket=int(mask.sum(1).max()), halo=2,
                        m2=case == "tmgcn2_m3", m3=case == "tmgcn2_m3")

    return at


@pytest.mark.parametrize("mesh_shape,case", MESH_CASES)
def test_comm_model_counts_the_issued_collectives(ranks, mesh_shape, case):
    """utils/comm_model reckons, from the workload's shape alone, every
    collective a step issues (kind, group size, buffer bytes, calls), as
    ``collectives.ISSUED`` recorded it on every rank: the recurrent and
    regression cases (``apply`` in every step)."""
    from tmgcn_torch.utils.comm_model import step_collectives

    want = dict(step_collectives(_workload(case)(*mesh_shape), *mesh_shape))
    for r in ranks[mesh_shape]:
        assert r["cases"][case]["issued"] == want


@pytest.mark.parametrize("case", ["tmgcn1", "tmgcn2_m3", "tmgcn1_lp"])
@pytest.mark.parametrize("mesh_shape", [*GRAPH_MESHES, (1, 2), (2, 2)])
def test_comm_model_counts_the_banded_steps(ranks, mesh_shape, case):
    """The same for the banded family's evaluation step (``apply``: the
    readout's sum, the bucket logits' gather over time) and plain step
    (``train_stats``: the loss sums and, for classification, the counts over
    time), with layer 2's row gather and the m2/m3 halo exchanges."""
    from tmgcn_torch.utils.comm_model import step_collectives

    w = _workload(case)(*mesh_shape)
    for r in ranks[mesh_shape]:
        got = r["banded_issued"][case]
        assert got["eval"] == dict(step_collectives(w, *mesh_shape))
        assert got["plain"] == dict(step_collectives(w, *mesh_shape, plain=True))

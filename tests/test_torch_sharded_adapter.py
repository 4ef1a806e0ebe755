"""The port's sharded adapter (tmgcn_torch/parallel/adapter.py) under gloo
on the CPU, against the port's single-device adapter and the JAX package's
sharded adapter on the same mesh shape.

Meshes (1, 1) (this process as the world), (2, 1), (1, 2) and (2, 2) (the
ranks spawned by tests/torch_mesh_workers.py, which imports no JAX; each
spawn has a deadline). Cases: TM-GCN, TM-GCN 2 with layer 2 "gather" and
"blockdense", TM-GCN 2 with the m2/m3 mixings (halo exchanges inside the
step), KW-GCN 2 layers, and the link-prediction convention (the last slice
dropped, T - 1 = 7 slices padded to the time mesh). Held: train-window
logits and the weighted cross-entropy's parameter gradients at the JAX
suite's atol 2e-5 (tests/test_sharded_adapter.py); ``train_stats`` against
``apply`` (the loss, its gradients, the confusion counts); 5-epoch loop
rows against the single-device rows (loss rtol 1e-4, F1 rtol 1e-3, the
JAX suite's); every rank the same results and parameters; the
standalone steps (tmgcn_sharded) on the 1 x 1 trajectory; the halo
exchange with halo > T_loc (several hops) and its gradient against the
dense M-transform; and the JAX package's refusals, message for message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_mesh_workers as W
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.models.gcn import KWGCN as JKWGCN
from tmgcn_tpu.models.tmgcn import TMGCN as JTMGCN
from tmgcn_tpu.models.tmgcn import TMGCN2 as JTMGCN2
from tmgcn_tpu.parallel.adapter import make_sharded_edge_adapter as j_sharded
from tmgcn_tpu.parallel.mesh import make_mesh as j_make_mesh
from tmgcn_tpu.train.losses import weighted_cross_entropy as j_wce
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.evolvegcn import EvolveGCN
from tmgcn_torch.models.gcn import KWGCN
from tmgcn_torch.models.tmgcn import TMGCN, TMGCN2
from tmgcn_torch.models.wdgcn import WDGCN
from tmgcn_torch.parallel import distributed
from tmgcn_torch.parallel.adapter import make_sharded_edge_adapter
from tmgcn_torch.parallel.mesh import make_mesh

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
ATOL = 2e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh shape: every rank's ``mesh_cases`` results, rank order}."""
    out = {}
    for G, T in MESHES[1:]:
        out[(G, T)] = W.spawn("mesh_cases", G * T, tmp_path_factory.mktemp(f"mesh_{G}x{T}"),
                              G, T)
    distributed.initialize("cpu")  # this process alone: the 1 x 1 mesh
    out[(1, 1)] = [W.mesh_cases(1, 1)]
    return out


@pytest.fixture(scope="module")
def single():
    """The port's single-device results of every case (and of the band-6
    m3 problem), and the loop rows of the looped cases."""
    p, wide = W.problem(), W.problem(band=6)
    res = {case: W.logits_and_grads(W.adapter_for(case, p), case, p) for case in W.CASES}
    res["wide_m3"] = W.logits_and_grads(W.adapter_for("tmgcn2_m3", wide), "tmgcn2_m3", wide)
    rows = {case: W.loop_rows(W.adapter_for(case, p), case, p)[0]
            for case in ("tmgcn1", "tmgcn2_m3")}
    return res, rows


def _jax_model(case: str):
    if case in ("tmgcn1", "tmgcn1_lp"):
        return JTMGCN(n_slices=W.T - (case == "tmgcn1_lp"), in_feat=W.F0, hidden_feat=(6, 2))
    if case.startswith("tmgcn2"):
        m3 = case == "tmgcn2_m3"
        return JTMGCN2(n_slices=W.T, in_feat=W.F0, hidden_feat=(6, 5, 2), nonlin2="selu",
                       apply_M_twice=m3, apply_M_three_times=m3)
    return JKWGCN(n_slices=W.T, in_feat=W.F0, hidden_feat=(6, 5, 2))


_JAX = {}


def jax_sharded(mesh_shape, case: str, band: int = 3) -> dict:
    """The JAX sharded adapter's train logits and weighted cross-entropy
    gradients on the same problem and mesh shape (memoized)."""
    key = (mesh_shape, case, band)
    if key not in _JAX:
        p = W.problem(band)
        _, edges, params, kw = W.case_setup(case, p)
        A = JaxCOO.from_dense(p["dense"], dtype=jnp.float32, pad_multiple=16)
        G, T = mesh_shape
        mesh = j_make_mesh(G, T, devices=jax.devices()[: G * T])
        wins = ("train", "val", "test")
        sh = j_sharded(_jax_model(case), {w: A for w in wins}, {w: p["X"] for w in wins},
                       {w: edges for w in wins}, p["M"], mesh, **kw)
        tgt = jnp.asarray(p["targets"][: edges.shape[1]])
        cw = jnp.asarray(p["cw"])

        def loss(q):
            out, _ = sh.apply({"params": q, "buffers": {}}, sh.bundles["train"], ())
            return j_wce(out, tgt, cw), out

        q = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(q)
        _JAX[key] = {"out": np.asarray(out), "grads": {k: np.asarray(v) for k, v in grads.items()}}
    return _JAX[key]


def _close(got: dict, want: dict, atol: float = ATOL) -> None:
    np.testing.assert_allclose(got["out"], want["out"], rtol=0, atol=atol)
    assert set(got["grads"]) == set(want["grads"])
    for k in want["grads"]:
        np.testing.assert_allclose(got["grads"][k], want["grads"][k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("case", W.CASES)
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_against_single_device(ranks, single, mesh_shape, case):
    for r in ranks[mesh_shape]:
        _close(r["cases"][case], single[0][case])


@pytest.mark.parametrize("case", W.CASES)
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_against_jax_sharded(ranks, mesh_shape, case):
    _close(ranks[mesh_shape][0]["cases"][case], jax_sharded(mesh_shape, case))


@pytest.mark.parametrize("case", W.CASES)
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_train_stats_against_apply(ranks, mesh_shape, case):
    """The plain epochs' loss and counts (bucket logits, no gather) are the
    evaluation epochs' (full logits)."""
    p = W.problem()
    _, edges, _, _ = W.case_setup(case, p)
    tgt = p["targets"][: edges.shape[1]]
    for r in ranks[mesh_shape]:
        c = r["cases"][case]
        assert c["stats_loss"] == pytest.approx(c["loss"], rel=1e-6)
        for k, g in c["grads"].items():
            np.testing.assert_allclose(c["stats_grads"][k], g, rtol=1e-5, atol=1e-6)
        guess = np.argmax(c["out"], axis=1)
        assert c["counts"] == [int(np.sum((guess == 0) & (tgt == 0))),
                               int(np.sum((guess == 0) & (tgt != 0))),
                               int(np.sum((guess != 0) & (tgt == 0)))]


@pytest.mark.parametrize("case", ["tmgcn1", "tmgcn2_m3"])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_loop_rows(ranks, single, mesh_shape, case):
    """5 epochs of the unmodified loop (its evaluation steps on ``apply``,
    its plain steps on ``train_stats``) against the single-device rows."""
    ref = single[1][case]
    for r in ranks[mesh_shape]:
        rows, _ = r["rows"][case]
        for col in (3, 7, 11):
            np.testing.assert_allclose(rows[:, col], ref[:, col], rtol=1e-4)
        for col in (2, 6, 10):
            np.testing.assert_allclose(rows[:, col], ref[:, col], rtol=1e-3, equal_nan=True)


@pytest.mark.parametrize("mesh_shape", MESHES[1:])
def test_ranks_agree(ranks, mesh_shape):
    """Rank r sits at (r // T, r % T); every rank returns bitwise the same
    logits (gathered), gradients and trained parameters (all-reduced, then
    the same update); the rows within 1e-6 (each rank scores the gathered
    logits itself, and the CPU's float32 matmuls may round differently in
    another process)."""
    G, T = mesh_shape
    results = ranks[mesh_shape]
    assert [r["position"] for r in results] == [divmod(i, T) for i in range(G * T)]
    assert all(r["info"]["process_count"] == G * T for r in results)
    first = results[0]
    for r in results[1:]:
        for case in W.CASES:
            np.testing.assert_array_equal(r["cases"][case]["out"], first["cases"][case]["out"])
            for k, g in first["cases"][case]["grads"].items():
                np.testing.assert_array_equal(r["cases"][case]["grads"][k], g)
        for case, (rows, params) in first["rows"].items():
            np.testing.assert_allclose(r["rows"][case][0], rows, rtol=1e-6)
            for k, v in params.items():
                np.testing.assert_array_equal(r["rows"][case][1][k], v)


@pytest.mark.parametrize("step", ["v1", "halo"])
@pytest.mark.parametrize("mesh_shape", MESHES[1:])
def test_standalone_steps(ranks, mesh_shape, step):
    """The standalone sharded steps (tmgcn_sharded) take the 1 x 1 steps'
    trajectory on every mesh (rtol 1e-5): the v1 forward sums only W's
    gradient over the world (every rank scores every edge with U), the halo
    step both; a wrong rule shows from the second step on."""
    ref = ranks[(1, 1)][0]["steps"][step]
    for r in ranks[mesh_shape]:
        np.testing.assert_allclose(r["steps"][step], ref, rtol=1e-5)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_halo_several_hops(ranks, mesh_shape):
    """Band 6 (halo 5) over time groups of 2 (T_loc 4: 2 hops) and of 4 (the
    (2, 2) mesh's world as one time group, T_loc 2: 3 hops): each block of
    M ×₁ X, and the gradient of sum(M ×₁ X * R) with respect to it, against
    the dense transform."""
    for i, r in enumerate(ranks[mesh_shape]):
        h = r["halo"]
        assert h["halo"] > h["t_loc"]
        sl = slice(i * h["t_loc"], (i + 1) * h["t_loc"])
        np.testing.assert_allclose(h["out"], np.einsum("st,tnf->snf", h["M"], h["X"])[sl],
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(h["grad"], np.einsum("st,snf->tnf", h["M"], h["R"])[sl],
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_m3_with_a_halo_past_the_block(ranks, single, mesh_shape):
    """TM-GCN 2 with m2/m3 on a band-6 M: the step's two halo exchanges run
    two hops each; logits and gradients against single device and JAX."""
    for r in ranks[mesh_shape]:
        _close(r["wide_m3"], single[0]["wide_m3"])
    _close(ranks[mesh_shape][0]["wide_m3"], jax_sharded(mesh_shape, "tmgcn2_m3", band=6))


def _refusal(model_t, model_j):
    """The port's and the JAX package's exception on the 1 x 1 mesh."""
    p = W.problem()
    wins = ("train", "val", "test")
    A = TemporalCOO.from_dense(p["dense"], pad_multiple=16)
    JA = JaxCOO.from_dense(p["dense"], dtype=jnp.float32, pad_multiple=16)
    mesh = make_mesh(1, 1, device=distributed.initialize("cpu"))
    with pytest.raises(Exception) as ours:
        make_sharded_edge_adapter(model_t, {w: A for w in wins}, {w: p["X"] for w in wins},
                                  {w: p["edges"] for w in wins}, p["M"], mesh)
    if model_j is None:
        return ours.value, None
    with pytest.raises(Exception) as theirs:
        j_sharded(model_j, {w: JA for w in wins}, {w: p["X"] for w in wins},
                  {w: p["edges"] for w in wins}, p["M"], j_make_mesh(1, 1, jax.devices()[:1]))
    return ours.value, theirs.value


@pytest.mark.parametrize("kw", [{"use_Minv": True}, {"condensed_W": False},
                                {"readout": "bilinear"}])
def test_tmgcn_refusals_as_jax(kw):
    ours, theirs = _refusal(TMGCN(n_slices=8, in_feat=4, hidden_feat=(6, 2), **kw),
                            JTMGCN(n_slices=8, in_feat=4, hidden_feat=(6, 2), **kw))
    assert type(ours) is type(theirs) is NotImplementedError and str(ours) == str(theirs)


@pytest.mark.parametrize("family,kw", [
    ("tmgcn2", {"use_Minv": True}), ("tmgcn2", {"condensed_W": False}),
    ("tmgcn2", {"interlayer_dtype": "float64"}), ("kwgcn2", {"interlayer_dtype": "float64"}),
])
def test_two_layer_refusals_as_jax(family, kw):
    t_kw = {k: torch.float64 if v == "float64" else v for k, v in kw.items()}
    j_kw = {k: jnp.float64 if v == "float64" else v for k, v in kw.items()}
    hidden = (6, 5, 2)
    if family == "tmgcn2":
        pair = TMGCN2(n_slices=8, in_feat=4, hidden_feat=hidden, **t_kw), \
            JTMGCN2(n_slices=8, in_feat=4, hidden_feat=hidden, **j_kw)
    else:
        pair = KWGCN(n_slices=8, in_feat=4, hidden_feat=hidden, **t_kw), \
            JKWGCN(n_slices=8, in_feat=4, hidden_feat=hidden, **j_kw)
    ours, theirs = _refusal(*pair)
    assert type(ours) is type(theirs) is NotImplementedError and str(ours) == str(theirs)


@pytest.mark.parametrize("family", [EvolveGCN, WDGCN])
def test_recurrent_families_wait_for_14b(family):
    """The recurrent families shard over graph alone: a time axis raises
    the JAX package's refusal, message for message (the port's refusal
    comes before any collective, so a 1 x 2 view of this one-process world
    reaches it)."""
    from tmgcn_tpu.models.evolvegcn import EvolveGCN as JEvolveGCN
    from tmgcn_tpu.models.wdgcn import WDGCN as JWDGCN

    p = W.problem()
    wins = ("train", "val", "test")
    A = TemporalCOO.from_dense(p["dense"], pad_multiple=16)
    JA = JaxCOO.from_dense(p["dense"], dtype=jnp.float32, pad_multiple=16)
    mesh = make_mesh(1, 1, device=distributed.initialize("cpu"))
    time_mesh = dataclasses.replace(mesh, shape={"graph": 1, "time": 2})
    j_family = JEvolveGCN if family is EvolveGCN else JWDGCN
    with pytest.raises(Exception) as ours:
        make_sharded_edge_adapter(family(n_slices=8, in_feat=4, hidden_feat=(6, 2)),
                                  {w: A for w in wins}, {w: p["X"] for w in wins},
                                  {w: p["edges"] for w in wins}, None, time_mesh)
    with pytest.raises(Exception) as theirs:
        j_sharded(j_family(n_slices=8, in_feat=4, hidden_feat=(6, 2)), {w: JA for w in wins},
                  {w: p["X"] for w in wins}, {w: p["edges"] for w in wins}, None,
                  j_make_mesh(1, 2, jax.devices()[:2]))
    assert type(ours.value) is type(theirs.value) is NotImplementedError
    assert str(ours.value) == str(theirs.value)

"""The port's streamed restricted layer 2 against the JAX package.

``make_edge_adapter(..., l2_stream_chunks=n)`` splits the 2-layer TM-GCN's
restricted layer 2 into n groups of time slices, one K1 operator each
(``tasks/adapters._build_streamed_layer2``). The problem is the JAX suite's
own (tests/test_tasks.py's TestStreamedLayer2: T = 9, N = 48, E = 80, seed
7), so the JAX side runs its Pallas operators in interpret mode in seconds.
JAX's initial parameters are carried across with ``params_from_jax``.

Tolerances are the JAX suite's: logits atol 2e-5, gradients atol
1e-5 · max(|g|, 1), the bf16 tier 2e-2 of the output's scale; the index
arrays and the packings bitwise. The JAX package pads every group's
packing to one chunk count (it stacks them for a ``lax.scan``); the port
keeps each group's own, so a port group equals the JAX group's chunks
before its padding, and the padding chunks hold no entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.core.mmatrix import make_m_matrix
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.models.tmgcn import TMGCN2 as JaxTMGCN2
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda
from tmgcn_torch.models.tmgcn import TMGCN2
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks.windows import EdgeSplit
from tmgcn_torch.train import loop as tloop

T, N, F0, E = 9, 48, 3, 80
HIDDEN = (4, 4, 2)
WINDOWS = ("train", "val", "test")
FIELDS = ("rows", "cols", "vals", "window_id", "is_first")
# (n_chunks, drop_last_slice); 4 groups of ceil(9 / 4) = 3 slices leave the
# fourth group without a slice.
CASES = [(1, False), (3, False), (4, False), (3, True)]


@pytest.fixture(scope="module")
def problem():
    """tests/test_tasks.py TestStreamedLayer2's problem, as numpy."""
    rng = np.random.default_rng(7)
    dense = (rng.random((T, N, N)) < 0.12) * rng.random((T, N, N))
    M = make_m_matrix(T, 3).astype(np.float32)
    X = rng.standard_normal((T, N, F0)).astype(np.float32)
    edges = np.stack([rng.integers(0, T, E), rng.integers(0, N, E), rng.integers(0, N, E)])
    return dense, M, X, edges


def _edges(edges, drop_last_slice):
    if not drop_last_slice:
        return edges
    e = edges.copy()
    e[0] = np.clip(e[0], 0, T - 2)  # the JAX suite's drop_last_slice edges
    return e


def _adapters(problem, n_chunks, drop_last_slice=False, impl="jnp", edges=None):
    """(port streamed, port single, JAX streamed or None, JAX single, JAX vars)."""
    dense, M, X, e_all = problem
    e = _edges(e_all if edges is None else edges, drop_last_slice)
    kw = dict(n_slices=T - drop_last_slice, in_feat=F0, hidden_feat=HIDDEN, nonlin2="selu",
              spmm_impl=impl)
    adj_t = {w: TemporalCOO.from_dense(dense, pad_multiple=8) for w in WINDOWS}
    adj_j = {w: JaxCOO.from_dense(dense, dtype=np.float32, pad_multiple=8) for w in WINDOWS}
    A_t, A_j = adj_t["train"], adj_j["train"]
    adj_t, adj_j = {w: A_t for w in WINDOWS}, {w: A_j for w in WINDOWS}
    feats = {w: X for w in WINDOWS}
    ed = {w: e for w in WINDOWS}
    common = dict(M=M, drop_last_slice=drop_last_slice)
    st = tad.make_edge_adapter(TMGCN2(**kw), adj_t, feats, ed, l2_stream_chunks=n_chunks,
                               device="cpu", **common)
    one = tad.make_edge_adapter(TMGCN2(**kw), adj_t, feats, ed, device="cpu", **common)
    j_single = jad.make_edge_adapter(JaxTMGCN2(**kw), adj_j, feats, ed, **common)
    try:
        j_st = jad.make_edge_adapter(JaxTMGCN2(**kw), adj_j, feats, ed,
                                     l2_stream_chunks=n_chunks, **common)
    except IndexError:  # the JAX build's edge-free group with entries
        j_st = None
    return st, one, j_st, j_single, j_single.init(jax.random.PRNGKey(3))


def _torch_logits_and_grads(ad, jvars, G):
    params = {k: v.requires_grad_(True) for k, v in params_from_jax(
        {k: np.asarray(v) for k, v in jvars["params"].items()}).items()}
    out, _ = ad.apply({"params": params, "buffers": {}}, ad.bundles["train"], ())
    (out * torch.from_numpy(G)).sum().backward()
    return out.detach().numpy(), {k: v.grad.numpy() for k, v in params.items()}


def _jax_logits_and_grads(ad, jvars, G):
    def f(p):
        o, _ = ad.apply({"params": p, "buffers": {}}, ad.bundles["train"], ())
        return jnp.vdot(o, jnp.asarray(G, o.dtype)), o

    (_, out), grads = jax.value_and_grad(f, has_aux=True)(jvars["params"])
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


def _close(got, ref, rel=None):
    """Logits and W1/W2/U gradients: the JAX suite's tolerances (2e-5 and
    1e-5 · max(|g|, 1)), or ``rel`` of each reference's scale for bf16."""
    (out, grads), (out_ref, grads_ref) = got, ref
    scale = max(np.abs(out_ref).max(), 1.0)
    np.testing.assert_allclose(out, out_ref, rtol=0, atol=2e-5 if rel is None else rel * scale)
    for k in ("W1", "W2", "U"):
        r = grads_ref[k]
        tol = (1e-5 if rel is None else rel) * max(np.abs(r).max(), 1.0)
        np.testing.assert_allclose(grads[k], r, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("n_chunks,drop_last_slice", CASES)
def test_streamed_build_matches_jax(problem, n_chunks, drop_last_slice):
    """The index arrays, the index behind l2s_Hin, and each group's
    packings (forward and transposed) bitwise the JAX bundle's."""
    dense, _, _, edges = problem
    e = _edges(edges, drop_last_slice)
    Tw = T - drop_last_slice
    # Distinct integers as the cached propagation: l2s_Hin then shows the
    # rows it was gathered from.
    cached = np.arange(Tw * N * F0, dtype=np.float32).reshape(Tw, N, F0)
    b_t, b_j = {"cached": torch.from_numpy(cached)}, {"cached": jnp.asarray(cached)}
    tad._build_streamed_layer2(b_t, TemporalCOO.from_dense(dense, pad_multiple=8), e,
                               drop_last_slice, n_chunks)
    jad._build_streamed_layer2(b_j, JaxCOO.from_dense(dense, dtype=np.float32, pad_multiple=8),
                               e, drop_last_slice, n_chunks)
    for key in ("l2s_src", "l2s_trg", "l2s_Hin"):
        np.testing.assert_array_equal(b_t[key].numpy(), np.asarray(b_j[key]), key)
    ops = b_t["l2s_op"]
    assert len(ops) == n_chunks
    for c, op in enumerate(ops):
        assert isinstance(op, spmm_cuda.FlatPallasOperator) and op.gather_dtype is None
        assert (op.n_in, op.n_out) == (b_j["l2s_op"].n_in, b_j["l2s_op"].n_out)
        for side in ("packed", "packed_t"):
            p, pj = getattr(op, side), getattr(b_j["l2s_op"], side)
            J = p.n_chunks
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(pj, f)[c, :J]),
                                              f"group {c} {side}.{f}")
            assert not np.any(np.asarray(pj.vals[c, J:]))  # the JAX padding: no entry


@pytest.mark.parametrize("n_chunks,drop_last_slice", CASES)
def test_streamed_adapter_matches_jax(problem, n_chunks, drop_last_slice):
    """Logits and W1/W2/U gradients against JAX's streamed adapter and the
    port's own single operator."""
    st, one, j_st, _, jvars = _adapters(problem, n_chunks, drop_last_slice)
    G = np.random.default_rng(1).standard_normal((E, HIDDEN[-1])).astype(np.float32)
    got = _torch_logits_and_grads(st, jvars, G)
    _close(got, _jax_logits_and_grads(j_st, jvars, G))
    _close(got, _torch_logits_and_grads(one, jvars, G))


def test_streamed_bf16_matches_jax(problem):
    """pallas_bf16: every group in K1's bf16 tier, at 2e-2 of the scale."""
    st, _, j_st, _, jvars = _adapters(problem, 3, impl="pallas_bf16")
    assert all(op.gather_dtype == "bfloat16" for op in st.bundles["train"]["l2s_op"])
    G = np.random.default_rng(2).standard_normal((E, HIDDEN[-1])).astype(np.float32)
    _close(_torch_logits_and_grads(st, jvars, G), _jax_logits_and_grads(j_st, jvars, G), rel=2e-2)


def test_group_with_entries_but_no_edge(problem):
    """Slices 6-8 hold entries but no labelled edge: the third of 3 groups
    has no endpoint row. The JAX build indexes that group's entries with a
    mask of length 0, which raises IndexError where numpy rejects the
    mismatch (ROADMAP queue 3), so the port is held against JAX's
    single-operator adapter and its own, and against JAX's streamed
    adapter where that builds."""
    edges = problem[3].copy()
    edges[0] %= 6
    st, one, j_st, j_single, jvars = _adapters(problem, 3, edges=edges)
    assert st.bundles["train"]["l2s_op"][2].packed.entry_order.shape[0] == 0
    G = np.random.default_rng(3).standard_normal((E, HIDDEN[-1])).astype(np.float32)
    got = _torch_logits_and_grads(st, jvars, G)
    for ref in (j_single, j_st):
        if ref is not None:
            _close(got, _jax_logits_and_grads(ref, jvars, G))
    _close(got, _torch_logits_and_grads(one, jvars, G))


def test_empty_groups_run_no_operator(problem, monkeypatch):
    """A group whose operator has no entry is not called (its rows are
    zeros): with 4 groups of 3 slices the fourth runs nothing, so a forward
    and backward runs 3 operators and 3 transposes."""
    st, *_, jvars = _adapters(problem, 4)
    packings = []
    fwd_impl = spmm_cuda._flat_fwd_impl
    monkeypatch.setattr(spmm_cuda, "_flat_fwd_impl",
                        lambda *a: packings.append(id(a[3])) or fwd_impl(*a))
    ops = st.bundles["train"]["l2s_op"]
    assert [op.packed.entry_order.shape[0] > 0 for op in ops] == [True, True, True, False]
    G = np.ones((E, HIDDEN[-1]), np.float32)
    _torch_logits_and_grads(st, jvars, G)
    assert sorted(packings) == sorted(id(getattr(op, side)) for op in ops[:3]
                                      for side in ("packed", "packed_t"))


def test_five_epochs_match_jax(problem):
    """run_edge_classification, 5 epochs (eval_every 3), on the streamed
    adapter against JAX's loop on its streamed adapter: the loss columns
    rtol 1e-4, precision, recall and F1 within 1e-3."""
    st, _, j_st, _, jvars = _adapters(problem, 3)
    rng = np.random.default_rng(4)
    e = problem[3]
    splits = {w: EdgeSplit(e, rng.integers(0, 2, E), np.ones(E, bool)) for w in WINDOWS}
    cw = np.array([0.4, 0.6])
    epochs, eval_every = 5, 3
    res_j, _ = jloop.run_edge_classification(
        j_st, splits, cw, jloop.TrainConfig(n_epochs=epochs, eval_every=eval_every),
        variables=jvars)
    params = params_from_jax({k: np.asarray(v) for k, v in jvars["params"].items()})
    res_t, _ = tloop.run_edge_classification(
        st, splits, cw, tloop.TrainConfig(n_epochs=epochs, eval_every=eval_every),
        variables={"params": params, "buffers": {}})
    assert res_t.shape == res_j.shape == (epochs, 12)
    losses = [3, 7, 11]
    np.testing.assert_allclose(res_t[:, losses], res_j[:, losses], rtol=1e-4)
    rates = [0, 1, 2, 4, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(np.isnan(res_t[:, rates]), np.isnan(res_j[:, rates]))
    np.testing.assert_allclose(res_t[:, rates], res_j[:, rates], atol=1e-3)

"""The port's EvolveGCN-H modules against the JAX package: the top-k
summaries (ties included), the GRU cell, the weight-evolution loop, the
one-slice SpMM, and the model at 1 and 2 layers, with and without the
cached propagation AX, with the plain gather readout and the readout plan.

Inputs are made with numpy from a seed; JAX's initial variables are carried
across with ``params_from_jax``. The JAX readout plans run
``interpret=True``, as the JAX suite's own tests run them. Tolerances:
float64 1e-10 (only summation order differs); float32 1e-5 for values and
1e-4 for gradients through the GRU loop, as tests/test_torch_wdgcn.py holds
the LSTM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.models import evolvegcn as jev
from tmgcn_tpu.ops import edge_readout as jro
from tmgcn_tpu.ops.spmm import spmm_slice as j_spmm_slice
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models import evolvegcn as tev
from tmgcn_torch.ops import edge_readout as tro
from tmgcn_torch.ops.spmm import spmm_slice

T, N, F0, C, E = 6, 40, 3, 3, 50
DTYPES = {"float64": (torch.float64, jnp.float64, 1e-10, 1e-10),
          "float32": (torch.float32, jnp.float32, 1e-5, 1e-4)}


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_tree_close(ours, ref, rtol, atol):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert ours.keys() == ref.keys()
    for k in ours:
        o = ours[k].detach().numpy() if isinstance(ours[k], torch.Tensor) else ours[k]
        np.testing.assert_allclose(o, np.asarray(ref[k]), rtol=rtol, atol=atol, err_msg=k)


def _requires_grad(tree):
    for _, v in _leaves(tree):
        v.requires_grad_(True)
    return tree


def _jax_variables(hidden, dtype=jnp.float64, seed=0):
    model = jev.EvolveGCN(n_slices=T, in_feat=F0, hidden_feat=hidden, dtype=dtype)
    return _np_tree(model.init(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    dense = (rng.random((T, N, N)) < 0.1) * rng.random((T, N, N))
    X = rng.standard_normal((T, N, F0))
    edges = np.stack([
        np.sort(rng.integers(0, T, E)), rng.integers(0, N, E), rng.integers(0, N, E),
    ])
    G = rng.standard_normal((E, C))
    return dense, X, edges, G


def _tied_features(seed: int = 3) -> np.ndarray:
    """(T, N, F) degree-like features full of ties: repeated rows, slices of
    one repeated row, an all-zero slice, and zero rows among the rest."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, (T, N, F0)).astype(np.float64)  # many repeated rows
    X[1] = X[1, 0]  # every row of slice 1 the same
    X[2] = 0.0  # an empty slice: every score 0
    X[3, ::2] = 0.0
    return X


class TestTopK:
    @pytest.mark.parametrize("features", ["random", "tied"])
    @pytest.mark.parametrize("k", [1, 4, N])
    def test_indices_are_jax_top_k(self, case, features, k):
        X = case[1] if features == "random" else _tied_features()
        p = np.random.default_rng(1).standard_normal(F0)
        y_j = jnp.asarray(X) @ jnp.asarray(p) / jnp.linalg.norm(jnp.asarray(p))
        top_j, idx_j = jax.lax.top_k(y_j, k)
        top_t, idx_t = tev._top_k(tev._scores(torch.from_numpy(X), torch.from_numpy(p)), k)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_allclose(top_t.numpy(), np.asarray(top_j), rtol=1e-12, atol=1e-12)

    def test_ties_keep_index_order(self):
        y = torch.tensor([[0.0, 2.0, 1.0, 2.0, 2.0, 0.0], [0.0] * 6])
        _, idx = tev._top_k(y, 4)
        assert idx.tolist() == [[1, 3, 4, 2], [0, 1, 2, 3]]

    @pytest.mark.parametrize("features", ["random", "tied"])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_summaries_match_jax(self, case, features, dtype):
        tdt, jdt, tol, gtol = DTYPES[dtype]
        X = (case[1] if features == "random" else _tied_features()).astype(np.dtype(dtype))
        cell = _jax_variables((5, C), jdt)["params"]["cell1"]
        k = 5
        G = np.random.default_rng(2).standard_normal((T, F0, k)).astype(np.dtype(dtype))

        tcell = _requires_grad(params_from_jax(cell))
        Xt = torch.from_numpy(X).requires_grad_(True)
        S = tev.batched_summaries(tcell, Xt, k)
        (S * torch.from_numpy(G)).sum().backward()
        per_slice = torch.stack([tev.summarize(x, tcell["p"], k).T for x in Xt.detach()])

        def f(c, x):
            s = jev.batched_summaries(c, x, k)
            return jnp.vdot(s, jnp.asarray(G)), s

        (_, ref), (gc, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, cell), jnp.asarray(X))
        ref_slices = np.stack([np.asarray(jev.summarize(jnp.asarray(x), jnp.asarray(cell["p"]), k)).T
                               for x in X])
        assert S.shape == (T, F0, k) and S.dtype == tdt
        np.testing.assert_allclose(S.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)
        np.testing.assert_allclose(per_slice.detach().numpy(), ref_slices, rtol=tol, atol=tol)
        np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(gx), rtol=gtol, atol=gtol)
        np.testing.assert_allclose(tcell["p"].grad.numpy(), np.asarray(gc["p"]), rtol=gtol,
                                   atol=gtol)


class TestGru:
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_cell_matches_jax(self, dtype):
        tdt, jdt, tol, gtol = DTYPES[dtype]
        rng = np.random.default_rng(4)
        cell = _jax_variables((5, C), jdt)["params"]["cell1"]
        Xs, H, G = (rng.standard_normal((F0, 5)).astype(np.dtype(dtype)) for _ in range(3))
        tcell = _requires_grad(params_from_jax(cell))
        Ht = torch.from_numpy(H).requires_grad_(True)
        out = tev.gru_cell(tcell, torch.from_numpy(Xs), Ht)
        (out * torch.from_numpy(G)).sum().backward()

        def f(c, h):
            o = jev.gru_cell(c, jnp.asarray(Xs), h)
            return jnp.vdot(o, jnp.asarray(G)), o

        (_, ref), (gc, gh) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, cell), jnp.asarray(H))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)
        np.testing.assert_allclose(Ht.grad.numpy(), np.asarray(gh), rtol=gtol, atol=gtol)
        _assert_tree_close({k: v.grad for k, v in tcell.items() if k != "p"},
                           {k: v for k, v in _np_tree(gc).items() if k != "p"}, gtol, gtol)

    @pytest.mark.parametrize("features", ["random", "tied"])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_weight_stack_matches_jax(self, case, features, dtype):
        """Final W and the (T, F0, F1) stack, values and gradients (the
        parameters, the features and the initial weights)."""
        tdt, jdt, tol, gtol = DTYPES[dtype]
        X = (case[1] if features == "random" else _tied_features()).astype(np.dtype(dtype))
        variables = _jax_variables((5, C), jdt)
        cell, W0 = variables["params"]["cell1"], variables["buffers"]["W_init1"]
        rng = np.random.default_rng(5)
        Gs = rng.standard_normal((T, F0, 5)).astype(np.dtype(dtype))
        Gf = rng.standard_normal((F0, 5)).astype(np.dtype(dtype))

        tcell = _requires_grad(params_from_jax(cell))
        W0t = torch.from_numpy(W0).requires_grad_(True)
        Xt = torch.from_numpy(X).requires_grad_(True)
        W_fin, Ws = tev.evolve_weight_stack(tcell, Xt, W0t)
        ((Ws * torch.from_numpy(Gs)).sum() + (W_fin * torch.from_numpy(Gf)).sum()).backward()
        # The loop is the per-step GRU of the uncached path, step by step.
        W = W0t.detach()
        for t in range(T):
            W = tev._evolve_step({k: v.detach() for k, v in tcell.items()}, W, Xt[t].detach())
            torch.testing.assert_close(W, Ws[t].detach(), rtol=tol, atol=tol)

        def f(c, x, w0):
            wf, ws = jev.evolve_weight_stack(c, x, w0)
            return jnp.vdot(ws, jnp.asarray(Gs)) + jnp.vdot(wf, jnp.asarray(Gf)), (wf, ws)

        (_, (wf, ws)), (gc, gx, gw) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
            jax.tree.map(jnp.asarray, cell), jnp.asarray(X), jnp.asarray(W0))
        np.testing.assert_allclose(W_fin.detach().numpy(), np.asarray(wf), rtol=tol, atol=tol)
        np.testing.assert_allclose(Ws.detach().numpy(), np.asarray(ws), rtol=tol, atol=tol)
        np.testing.assert_allclose(W0t.grad.numpy(), np.asarray(gw), rtol=gtol, atol=gtol)
        np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(gx), rtol=gtol, atol=gtol)
        _assert_tree_close({k: v.grad for k, v in tcell.items()}, _np_tree(gc), gtol, gtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_spmm_slice_matches_jax(case, dtype):
    tdt, jdt, tol, gtol = DTYPES[dtype]
    dense, X, _, _ = case
    A_t = TemporalCOO.from_dense(dense, dtype=np.dtype(dtype), pad_multiple=16)
    A_j = JaxCOO.from_dense(dense, dtype=np.dtype(dtype), pad_multiple=16)
    x = X[2].astype(np.dtype(dtype))
    G = np.random.default_rng(6).standard_normal((N, F0)).astype(np.dtype(dtype))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm_slice(torch.from_numpy(A_t.rows[2]), torch.from_numpy(A_t.cols[2]),
                     torch.from_numpy(A_t.vals[2]), xt, N)
    (out * torch.from_numpy(G)).sum().backward()

    def f(xx):
        o = j_spmm_slice(jnp.asarray(A_j.rows[2]), jnp.asarray(A_j.cols[2]),
                         jnp.asarray(A_j.vals[2]), xx, N)
        return jnp.vdot(o, jnp.asarray(G)), o

    (_, ref), gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    assert A_t.nnz[2] < A_t.capacity  # the padding is in the stream
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=gtol, atol=gtol)
    np.testing.assert_allclose(out.detach().numpy(), dense[2] @ x, rtol=tol, atol=tol)


class TestModel:
    @pytest.mark.parametrize("hidden", [(5, C), (5, 4, C)], ids=["1layer", "2layer"])
    def test_init_tree_matches_jax(self, hidden):
        ref = _jax_variables(hidden)
        model = tev.EvolveGCN(n_slices=T, in_feat=F0, hidden_feat=hidden)
        ours = model.init(torch.Generator().manual_seed(0))
        assert [(k, tuple(v.shape)) for k, v in _leaves(ours)] == [
            (k, v.shape) for k, v in _leaves(ref)
        ]
        assert set(ours["buffers"]) == {"W_init1", "W_init2"}.intersection(
            {f"W_init{i + 1}" for i in range(len(hidden) - 1)})
        again = model.init(torch.Generator().manual_seed(0))
        for (_, a), (_, b) in zip(_leaves(ours), _leaves(again)):
            assert torch.equal(a, b)
        copied = params_from_jax(ref)
        _assert_tree_close(copied, ref, 0, 0)

    @pytest.mark.parametrize("cached,readout", [(False, "gather"), (True, "gather"),
                                                (True, "plan"), (False, "plan_lane_major")],
                             ids=["scan-gather", "AX-gather", "AX-plan", "scan-plan_lane_major"])
    @pytest.mark.parametrize("hidden", [(5, C), (5, 4, C)], ids=["1layer", "2layer"])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_apply_matches_jax(self, case, hidden, cached, readout, dtype):
        """Logits, final weights and every parameter's gradient, from
        explicit initial weights (a carry) or from the W_init buffers."""
        tdt, jdt, tol, gtol = DTYPES[dtype]
        dense, X, edges, G = case
        npdt = np.dtype(dtype)
        X = X.astype(npdt)
        jvars = _jax_variables(hidden, jdt)
        A_t = TemporalCOO.from_dense(dense, dtype=npdt, pad_multiple=16)
        A_j = JaxCOO.from_dense(dense, dtype=npdt, pad_multiple=16)
        rng = np.random.default_rng(7)
        inits = [rng.standard_normal(jvars["buffers"][f"W_init{i + 1}"].shape).astype(npdt)
                 for i in range(len(hidden) - 1)] if readout != "gather" else []
        t_op = j_op = None
        if readout != "gather":
            lane_major = readout == "plan_lane_major"
            plan = tro.make_readout_plan(edges, T, N, 32, 64, lane_major=lane_major)
            jplan = jro.make_readout_plan(edges, T, N, 32, 64, interpret=True,
                                          lane_major=lane_major)
            t_op = lambda Y, U: tro.apply_readout(plan, Y, U)  # noqa: E731
            j_op = lambda Y, U: jro.apply_readout(jplan, Y, U)  # noqa: E731

        model = tev.EvolveGCN(n_slices=T, in_feat=F0, hidden_feat=hidden, dtype=tdt)
        tvars = params_from_jax(jvars)
        _requires_grad(tvars["params"])
        Xt = torch.from_numpy(X)
        AX = model.propagate(A_t, Xt) if cached else None
        out, finals = model.apply(tvars, A_t, Xt, torch.from_numpy(edges),
                                  *(torch.from_numpy(w) for w in inits), AX=AX, readout_op=t_op)
        (out * torch.from_numpy(G).to(tdt)).sum().backward()

        jmodel = jev.EvolveGCN(n_slices=T, in_feat=F0, hidden_feat=hidden, dtype=jdt)
        jAX = jmodel.propagate(A_j, jnp.asarray(X)) if cached else None

        def f(p):
            o, fin = jmodel.apply({"params": p, "buffers": jvars["buffers"]}, A_j, jnp.asarray(X),
                                  jnp.asarray(edges), *(jnp.asarray(w) for w in inits), AX=jAX,
                                  readout_op=j_op)
            return jnp.vdot(o, jnp.asarray(G, o.dtype)), (o, fin)

        (_, (ref, ref_fin)), grads = jax.value_and_grad(f, has_aux=True)(
            jax.tree.map(jnp.asarray, jvars["params"]))
        assert out.dtype == tdt and len(finals) == len(hidden) - 1
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)
        for a, b in zip(finals, ref_fin):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=tol, atol=tol)
        _assert_tree_close({k: v.grad for k, v in _leaves(tvars["params"])},
                           dict(_leaves(_np_tree(grads))), gtol, gtol)

    def test_store_dtype_truncates_the_embeddings(self, case):
        """embed_dtype float32 under a float64 model: the embeddings are the
        float64 ones rounded to float32, as in the JAX package."""
        dense, X, _, _ = case
        jvars = _jax_variables((5, C))
        A_t = TemporalCOO.from_dense(dense, dtype=np.float64, pad_multiple=16)
        A_j = JaxCOO.from_dense(dense, dtype=np.float64, pad_multiple=16)
        model = tev.EvolveGCN(n_slices=T, in_feat=F0, hidden_feat=(5, C), dtype=torch.float64,
                              embed_dtype=torch.float32)
        Y, _ = model.embed_and_weights(params_from_jax(jvars), A_t, torch.from_numpy(X))
        jmodel = jev.EvolveGCN(n_slices=T, in_feat=F0, hidden_feat=(5, C), dtype=jnp.float64,
                               embed_dtype=jnp.float32)
        ref, _ = jmodel.embed_and_weights(jvars, A_j, jnp.asarray(X))
        assert Y.dtype == torch.float32 and model.store_dtype == torch.float32
        np.testing.assert_allclose(Y.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)

    def test_evolved_weights_is_the_one_layer_trajectory(self, case):
        _, X, _, _ = case
        jvars = _jax_variables((5, C))
        model = tev.EvolveGCN(n_slices=T, in_feat=F0, hidden_feat=(5, C), dtype=torch.float64)
        W_fin, Ws = model.evolved_weights(params_from_jax(jvars), torch.from_numpy(X))
        jmodel = jev.EvolveGCN(n_slices=T, in_feat=F0, hidden_feat=(5, C), dtype=jnp.float64)
        ref_fin, ref = jmodel.evolved_weights(jvars, jnp.asarray(X))
        np.testing.assert_allclose(Ws.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(W_fin.numpy(), np.asarray(ref_fin), rtol=1e-10, atol=1e-10)
        with pytest.raises(ValueError):
            tev.EvolveGCN(n_slices=T, in_feat=F0, hidden_feat=(5, 4, C)).evolved_weights(
                params_from_jax(_jax_variables((5, 4, C))), torch.from_numpy(X))

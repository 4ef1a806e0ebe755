"""The port's KW-GCN against the JAX package: the model at 1 and 2 layers,
and the adapter's 1-layer fast path and 2-layer generic path with the
"jnp", "rowsplit" and "pallas" impls (tests/test_torch_kwgcn_slice.py holds
the chess_gcn_cls and chess_gcn_lp slices at full width).

Inputs are made with numpy from a seed; JAX's initial variables are
carried across with ``params_from_jax``. The JAX operator and readout plans
run in interpret mode (``make_operator`` picks it off the TPU), as the JAX
suite's own tests run them; the port's "pallas" runs K1's plain version on
the CPU. Tolerances: float64 1e-10; float32 1e-5 for values and 1e-4 for
gradients (tests/test_torch_tmgcn.py's).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.models import gcn as jgcn
from tmgcn_tpu.ops import edge_readout as jro
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda as tk
from tmgcn_torch.models import gcn as tgcn
from tmgcn_torch.ops import edge_readout as tro
from tmgcn_torch.tasks import adapters as tad

T, N, F0, C, E = 6, 40, 2, 3, 50
WINDOWS = ("train", "val", "test")
DTYPES = {"float64": (torch.float64, jnp.float64, 1e-10, 1e-10),
          "float32": (torch.float32, jnp.float32, 1e-5, 1e-4)}
HIDDEN = {"1layer": (5, C), "2layer": (5, 4, C)}


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _assert_close(ours: dict, ref: dict, rtol, atol):
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(ref[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


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


def _jax_model(hidden, dtype=jnp.float64, **kw):
    return jgcn.KWGCN(n_slices=T, in_feat=F0, hidden_feat=hidden, dtype=dtype, **kw)


@pytest.mark.parametrize("layers", list(HIDDEN))
def test_init_tree_matches_jax(layers):
    hidden = HIDDEN[layers]
    ref = _np_tree(_jax_model(hidden).init(jax.random.PRNGKey(0)))
    ours = tgcn.KWGCN(n_slices=T, in_feat=F0, hidden_feat=hidden).init(
        torch.Generator().manual_seed(0))
    assert ours["buffers"] == {} == ref["buffers"]
    assert {k: tuple(v.shape) for k, v in ours["params"].items()} == {
        k: v.shape for k, v in ref["params"].items()}
    _assert_close(params_from_jax(ref["params"]), ref["params"], 0, 0)
    with pytest.raises(ValueError):
        tgcn.KWGCN(n_slices=T, in_feat=F0, hidden_feat=(5, 4, 4, C)).init(torch.Generator())


@pytest.mark.parametrize("readout", ["gather", "plan"])
@pytest.mark.parametrize("cached", [False, True], ids=["propagate", "AX"])
@pytest.mark.parametrize("layers", list(HIDDEN))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_matches_jax(case, layers, cached, readout, dtype):
    """Logits and every parameter's gradient; the 2-layer model with the
    reference's float64 interlayer cast and its selu."""
    tdt, jdt, tol, gtol = DTYPES[dtype]
    dense, X, edges, G = case
    npdt = np.dtype(dtype)
    hidden = HIDDEN[layers]
    kw = {"nonlin2": "selu", "interlayer_dtype": jnp.float64} if layers == "2layer" else {}
    jmodel = _jax_model(hidden, jdt, **kw)
    jvars = _np_tree(jmodel.init(jax.random.PRNGKey(1)))
    tkw = {"nonlin2": "selu", "interlayer_dtype": torch.float64} if layers == "2layer" else {}
    model = tgcn.KWGCN(n_slices=T, in_feat=F0, hidden_feat=hidden, dtype=tdt, **tkw)
    A_t = TemporalCOO.from_dense(dense, dtype=npdt, pad_multiple=16)
    A_j = JaxCOO.from_dense(dense, dtype=npdt, pad_multiple=16)
    X = X.astype(npdt)
    t_op = j_op = None
    if readout == "plan":
        plan = tro.make_readout_plan(edges, T, N, 32, 64)
        jplan = jro.make_readout_plan(edges, T, N, 32, 64, interpret=True)
        t_op = lambda Y, U: tro.apply_readout(plan, Y, U)  # noqa: E731
        j_op = lambda Y, U: jro.apply_readout(jplan, Y, U)  # noqa: E731

    tvars = params_from_jax(jvars)
    for v in tvars["params"].values():
        v.requires_grad_(True)
    AX = model.propagate(A_t, torch.from_numpy(X)) if cached else None
    out = model.apply(tvars, A_t, torch.from_numpy(X), torch.from_numpy(edges), AX,
                      readout_op=t_op)
    (out * torch.from_numpy(G).to(tdt)).sum().backward()
    jAX = jmodel.propagate(A_j, jnp.asarray(X)) if cached else None

    def f(p):
        o = jmodel.apply({"params": p, "buffers": {}}, A_j, jnp.asarray(X), jnp.asarray(edges),
                         jAX, readout_op=j_op)
        return jnp.vdot(o, jnp.asarray(G, o.dtype)), o

    (_, ref), grads = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, jvars["params"]))
    assert out.dtype == tdt
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)
    _assert_close({k: v.grad for k, v in tvars["params"].items()}, _np_tree(grads), gtol, gtol)


def _adapters(case, hidden, spmm_impl):
    dense, X, edges, _ = case
    rng = np.random.default_rng(5)
    edict = {w: edges if w == "train" else np.stack([
        np.sort(rng.integers(0, T, 20)), rng.integers(0, N, 20), rng.integers(0, N, 20),
    ]) for w in WINDOWS}
    feats = {w: X.astype(np.float32) for w in WINDOWS}
    A_t = TemporalCOO.from_dense(dense, pad_multiple=16)
    A_j = JaxCOO.from_dense(dense, pad_multiple=16)
    jmodel = _jax_model(hidden, jnp.float32, spmm_impl=spmm_impl, nonlin2="selu")
    tmodel = tgcn.KWGCN(n_slices=T, in_feat=F0, hidden_feat=hidden, spmm_impl=spmm_impl,
                        nonlin2="selu")
    ja = jad.make_edge_adapter(jmodel, {w: A_j for w in WINDOWS}, feats, edict)
    ta = tad.make_edge_adapter(tmodel, {w: A_t for w in WINDOWS}, feats, edict, device="cpu")
    return ja, ta, edict


@pytest.mark.parametrize("layers,spmm_impl", [
    ("1layer", "jnp"), ("1layer", "pallas"),
    ("2layer", "jnp"), ("2layer", "rowsplit"), ("2layer", "pallas"),
])
def test_adapter_matches_jax(case, layers, spmm_impl):
    """The 1-layer fast path (endpoint rows, no gather) and the 2-layer
    generic path (the layer-2 SpMM and the readout plan every epoch):
    logits and gradients on every window, and no carry."""
    ja, ta, _ = _adapters(case, HIDDEN[layers], spmm_impl)
    jvars = _np_tree(ja.init(jax.random.PRNGKey(4)))
    G = np.random.default_rng(8)
    for w in WINDOWS:
        jb, tb = ja.bundles[w], ta.bundles[w]
        fast = layers == "1layer"
        assert ("cached_src" in tb) == fast
        # The plan where the JAX package uses it off the TPU (operator-backed
        # configs); the fast path's epoch never gathers, so it has none.
        assert ("readout" in tb) == (not fast and spmm_impl != "jnp")
        assert ("readout" in jb) == (spmm_impl != "jnp")
        np.testing.assert_allclose(tb["cached"].numpy(), np.asarray(jb["cached"]), rtol=1e-5,
                                   atol=1e-5)
        tvars = params_from_jax(jvars)
        for v in tvars["params"].values():
            v.requires_grad_(True)
        out, carry = ta.apply(tvars, tb, ())
        g = G.standard_normal(out.shape).astype(np.float32)
        (out * torch.from_numpy(g)).sum().backward()

        def f(p, jb=jb, g=g):
            o, _ = ja.apply({"params": p, "buffers": {}}, jb, ())
            return jnp.vdot(o, jnp.asarray(g)), o

        (_, ref), grads = jax.value_and_grad(f, has_aux=True)(
            jax.tree.map(jnp.asarray, jvars["params"]))
        assert carry == ()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        _assert_close({k: v.grad for k, v in tvars["params"].items()}, _np_tree(grads),
                      1e-4, 1e-4)


def test_adapter_launches_no_kernel_on_the_cpu(case):
    """The 2-layer "pallas" step on CPU tensors (propagation, layer 2 forward
    and backward, the readout plan's backward) runs K1's plain version."""
    before = tk.windowed_segment_matmul.launches
    _, ta, _ = _adapters(case, HIDDEN["2layer"], "pallas")
    tvars = ta.init(torch.Generator().manual_seed(0))
    for v in tvars["params"].values():
        v.requires_grad_(True)
    out, _ = ta.apply(tvars, ta.bundles["train"], ())
    out.sum().backward()
    assert all(v.grad is not None for v in tvars["params"].values())
    assert tk.windowed_segment_matmul.launches == before

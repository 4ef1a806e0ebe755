"""The port's SpMM and edge readouts against the JAX package.

``spmm(impl="jnp")`` (sorted segment sum) and ``spmm(impl="pallas")`` (K1,
here its plain version on the CPU) must match JAX's ``spmm`` and the dense
oracle, forward and backward. In float64 the two sides differ only by
summation order (atol 1e-12); in float32 by float32 rounding of sums of
~10 products (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.ops import edge_readout as jer
from tmgcn_tpu.ops import spmm as jspmm
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.ops import edge_readout as ter
from tmgcn_torch.ops import spmm as tspmm

TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    T, N, F = 5, 60, 4
    dense = (rng.random((T, N, N)) < 0.1) * rng.standard_normal((T, N, N))
    dense[2] = 0.0  # an empty slice
    X = rng.standard_normal((T, N, F))
    G = rng.standard_normal((T, N, F))
    return dense, X, G


@pytest.mark.parametrize(
    "impl,dtype", [("jnp", np.float32), ("jnp", np.float64), ("pallas", np.float32)]
)
def test_spmm_forward_matches_jax(graph, impl, dtype):
    """K1 has a float32 tier only, as in the JAX package."""
    dense, X, _ = graph
    A_t = TemporalCOO.from_dense(dense, dtype=dtype, pad_multiple=16)
    A_j = JaxCOO.from_dense(dense, dtype=dtype, pad_multiple=16)
    out = tspmm.spmm(A_t, torch.from_numpy(X.astype(dtype)), impl=impl)
    ref = jspmm.spmm(A_j, jnp.asarray(X.astype(dtype)), impl="jnp")
    dense_ref = jspmm.spmm_dense_reference(jnp.asarray(dense.astype(dtype)), jnp.asarray(X.astype(dtype)))
    assert out.dtype == torch.from_numpy(X.astype(dtype)).dtype
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL[dtype])
    np.testing.assert_allclose(out.numpy(), np.asarray(dense_ref), atol=TOL[dtype])


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_spmm_backward_matches_jax(graph, impl):
    dense, X, G = graph
    dtype = np.float32
    A_t = TemporalCOO.from_dense(dense, dtype=dtype, pad_multiple=16)
    A_j = JaxCOO.from_dense(dense, dtype=dtype, pad_multiple=16)
    Xt = torch.from_numpy(X.astype(dtype)).requires_grad_(True)
    (tspmm.spmm(A_t, Xt, impl=impl) * torch.from_numpy(G.astype(dtype))).sum().backward()
    dX = jax.grad(lambda x: jnp.vdot(jspmm.spmm(A_j, x), jnp.asarray(G.astype(dtype))))(
        jnp.asarray(X.astype(dtype))
    )
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(dX), atol=TOL[dtype])


def test_spmm_jnp_float64_backward_is_transpose(graph):
    dense, X, G = graph
    A_t = TemporalCOO.from_dense(dense, dtype=np.float64, pad_multiple=16)
    Xt = torch.from_numpy(X).requires_grad_(True)
    (tspmm.spmm(A_t, Xt) * torch.from_numpy(G)).sum().backward()
    np.testing.assert_allclose(
        Xt.grad.numpy(), np.einsum("tji,tjf->tif", dense, G), atol=1e-12
    )


def test_spmm_on_device_arrays(graph):
    """A TemporalCOO moved with .to() gives the same result."""
    dense, X, _ = graph
    A = TemporalCOO.from_dense(dense, pad_multiple=16)
    Xt = torch.from_numpy(X.astype(np.float32))
    torch.testing.assert_close(
        tspmm.spmm(A.to("cpu"), Xt), tspmm.spmm(A, Xt), rtol=0, atol=0
    )


def test_spmm_dense_reference_matches_jax(graph):
    dense, X, _ = graph
    out = tspmm.spmm_dense_reference(torch.from_numpy(dense), torch.from_numpy(X))
    ref = jspmm.spmm_dense_reference(jnp.asarray(dense), jnp.asarray(X))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12)


def test_spmm_operator_dispatch(graph):
    """A prepacked operator is called as it is, as in the JAX package."""
    from tmgcn_torch.kernels.spmm_cuda import make_operator

    dense, X, _ = graph
    A = TemporalCOO.from_dense(dense, pad_multiple=16)
    Xt = torch.from_numpy(X.astype(np.float32))
    op = make_operator(A, chunk=32, window=64)
    torch.testing.assert_close(tspmm.spmm(op, Xt), op(Xt), rtol=0, atol=0)


@pytest.mark.parametrize(
    "impl", ["pallas_bf16", "pallas_tiled", "pallas_tiled_bf16", "rowsplit",
             "blockdense", "blockdense_bf16"]
)
def test_unported_impls_raise(graph, impl):
    dense, X, _ = graph
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tspmm.spmm(TemporalCOO.from_dense(dense), torch.from_numpy(X), impl=impl)


def test_unknown_impl_raises(graph):
    dense, X, _ = graph
    with pytest.raises(ValueError):
        tspmm.spmm(TemporalCOO.from_dense(dense), torch.from_numpy(X), impl="nope")


@pytest.mark.parametrize("readout", ["concat", "bilinear"])
def test_edge_readouts_match_jax(readout):
    rng = np.random.default_rng(1)
    T, N, F, C, E = 3, 20, 5, 3, 40
    Y = rng.standard_normal((T, N, F))
    U = rng.standard_normal((2 * F if readout == "concat" else F, C))
    edges = np.stack([rng.integers(0, T, E), rng.integers(0, N, E), rng.integers(0, N, E)])
    t_fn = ter.edge_readout if readout == "concat" else ter.edge_readout_bilinear
    j_fn = jer.edge_readout if readout == "concat" else jer.edge_readout_bilinear
    Yt = torch.from_numpy(Y).requires_grad_(True)
    Ut = torch.from_numpy(U).requires_grad_(True)
    out = t_fn(Yt, torch.from_numpy(edges), Ut)
    ref = j_fn(jnp.asarray(Y), jnp.asarray(edges), jnp.asarray(U))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-12)
    Gl = rng.standard_normal((E, C))
    (out * torch.from_numpy(Gl)).sum().backward()
    gY, gU = jax.grad(
        lambda y, u: jnp.vdot(j_fn(y, jnp.asarray(edges), u), jnp.asarray(Gl)), argnums=(0, 1)
    )(jnp.asarray(Y), jnp.asarray(U))
    np.testing.assert_allclose(Yt.grad.numpy(), np.asarray(gY), atol=1e-12)
    np.testing.assert_allclose(Ut.grad.numpy(), np.asarray(gU), atol=1e-12)


def test_edge_flat_indices_match_jax():
    edges = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    s, t = ter.edge_flat_indices(torch.from_numpy(edges), 10)
    sj, tj = jer.edge_flat_indices(jnp.asarray(edges), 10)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(t.numpy(), np.asarray(tj))

"""The fast tier of K1 and K3 (float32 input at the TPU's DEFAULT matrix
precision) against a numpy rounding oracle and the JAX package.

What the TPU kernels compute at DEFAULT on float32 operands, by the JAX
code's own account (tmgcn_tpu/kernels/spmm_pallas.py:628-630, "DEFAULT
rounds the value operand to bf16"): K1 rounds each float32 product g·v to
bf16 in its one-hot matmul; K3's expand matmul rounds v and g to bf16 and
its scatter matmul rounds their product to bf16 again. The sums are
float32. The oracle below rounds exactly so and sums in float64; the
port's plain versions and operators must meet it within 1e-5·scale (only
the order of the float32 sums differs).

Interpret mode on the CPU computes DEFAULT in float32, so the JAX fast
operator run here is the float32 operator. The port's fast operator is held
against it at the bf16 tier's tolerance, 2e-2·scale
(tests/test_pallas_spmm.py:115), and must differ from the port's float32
tier somewhere, so that no tier silently stays float32.

The CUDA kernels have no CPU mode: tests/test_torch_cuda.py holds them
against these plain versions on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.kernels import spmm_pallas as jk
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda as tk
from tmgcn_torch.ops.spmm_rowsplit import flatten_stream

ATOL = 1e-5  # against the oracle, times max(1, |oracle|)
JAX_REL = 2e-2  # against the JAX interpret operator, times max(1, |JAX|)


def bf16(x) -> np.ndarray:
    """float32 rounded to the nearest bf16 (ties to even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def oracle(rows, cols, vals, X, n_out, kernel: str) -> np.ndarray:
    """out[r] = Σ over entries with row r of the rounded term, in float64:
    K1 bf16(v·x) with the float32 product; K3 bf16(bf16(v)·bf16(x))."""
    vals = np.asarray(vals, np.float32)[:, None]
    x = np.asarray(X, np.float32)[cols]
    terms = bf16(vals * x) if kernel == "k1" else bf16(bf16(vals) * bf16(x))
    out = np.zeros((n_out, X.shape[1]), np.float64)
    np.add.at(out, rows, terms.astype(np.float64))
    return out


def assert_scaled(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(1.0, np.abs(ref).max()))


def _stream(seed, n_out=1000, n_in=700, P=3000):
    """Row-sorted entries with empty windows and a window of many chunks."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([
        rng.integers(0, 300, P // 2), rng.integers(640, 700, P // 4),
        rng.integers(900, n_out, P - P // 2 - P // 4),
    ]))
    cols = rng.integers(0, n_in, P)
    vals = rng.standard_normal(P).astype(np.float32)
    return rows, cols, vals, n_out, n_in


@pytest.mark.parametrize("F", [1, 2, 6, 128])
@pytest.mark.parametrize("use_init", [False, True])
def test_k1_fast_plain_version_matches_oracle(F, use_init):
    rows, cols, vals, n_out, n_in = _stream(F)
    X = np.random.default_rng(100 + F).standard_normal((n_in, F)).astype(np.float32)
    p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128, True, all_windows=not use_init)
    g = tk.gather_chunks(torch.from_numpy(X), p)
    init = torch.zeros(p.n_rows_out, F) if use_init else None
    out = tk.windowed_segment_matmul(p, g, init=init, fast=True)
    assert out.dtype == torch.float32
    assert_scaled(out[:n_out].numpy(), oracle(rows, cols, vals, X, n_out, "k1"), ATOL)
    assert not torch.equal(out, tk.windowed_segment_matmul(p, g))


@pytest.mark.parametrize("F", [1, 2, 6, 128])
@pytest.mark.parametrize("ut_cap", [2, 64])
def test_k3_fast_plain_version_matches_oracle(F, ut_cap):
    rows, cols, vals, n_out, n_in = _stream(20 + F, n_in=200)
    X = np.random.default_rng(200 + F).standard_normal((n_in, F)).astype(np.float32)
    p = tk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, ut_cap)
    g = tk.gather_chunks(torch.from_numpy(X), p)
    out = tk.windowed_tiled_segment_matmul(p, g, fast=True)
    assert out.dtype == torch.float32
    assert_scaled(out[:n_out].numpy(), oracle(rows, cols, vals, X, n_out, "k3"), ATOL)
    assert not torch.equal(out, tk.windowed_tiled_segment_matmul(p, g))


@pytest.mark.parametrize("tiled", [False, True])
def test_fast_with_bf16_gathers_is_the_bf16_tier(tiled):
    """gather_dtype="bfloat16" runs the bf16 tier with or without fast, as the
    JAX package runs DEFAULT either way; forward and backward bitwise."""
    rng = np.random.default_rng(5)
    dense = (rng.random((3, 120, 120)) < 0.1) * rng.standard_normal((3, 120, 120))
    A = TemporalCOO.from_dense(dense, pad_multiple=16)
    X = torch.from_numpy(rng.standard_normal((3, 120, 6)).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((3, 120, 6)).astype(np.float32))
    outs = []
    for fast in (False, True):
        op = tk.make_operator(A, 64, 64, fast=fast, gather_dtype="bfloat16", tile_dedup=tiled)
        Xg = X.clone().requires_grad_(True)
        out = op(Xg)
        (out * G).sum().backward()
        outs.append((out.detach(), Xg.grad))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def _kind_operators(kind, A, T, N):
    """(port operator, JAX operator, and the flat entry stream rows, cols,
    vals) of one kind: temporal or flat, plain or tiled, both fast."""
    tiled = kind.endswith("tiled")
    if kind.startswith("flat"):
        rows, cols, vals = flatten_stream(A)
        n = T * N
        op_t = tk.make_flat_operator(rows, cols, vals, n, n, 64, 64, fast=True, tile_dedup=tiled)
        op_j = jk.make_flat_operator(rows, cols, vals, n, n, 64, 64, fast=True, interpret=True,
                                     tile_dedup=tiled)
        return op_t, op_j, rows, cols, vals
    A_j = JaxCOO(rows=jnp.asarray(A.rows), cols=jnp.asarray(A.cols), vals=jnp.asarray(A.vals),
                 nnz=jnp.asarray(A.nnz), n_nodes=A.n_nodes)
    op_t = tk.make_operator(A, 64, 64, fast=True, tile_dedup=tiled)
    op_j = jk.make_operator(A_j, 64, 64, fast=True, interpret=True, tile_dedup=tiled)
    rows, cols, vals = flatten_stream(A)
    return op_t, op_j, rows, cols, vals


@pytest.mark.parametrize("kind", ["operator", "operator_tiled", "flat", "flat_tiled"])
@pytest.mark.parametrize("F", [2, 6])
def test_fast_operators_forward_and_backward(kind, F):
    """make_operator / make_flat_operator with fast=True, plain and tiled:
    forward and backward (the same tier on the transposed packing) against
    the oracle at 1e-5·scale and the JAX interpret operator at 2e-2·scale,
    and not the float32 tier."""
    rng = np.random.default_rng(F)
    T, N = 3, 150
    dense = (rng.random((T, N, N)) < 0.08) * rng.standard_normal((T, N, N))
    A = TemporalCOO.from_dense(dense, pad_multiple=16)
    X = rng.standard_normal((T, N, F)).astype(np.float32)
    G = rng.standard_normal((T, N, F)).astype(np.float32)
    op_t, op_j, rows, cols, vals = _kind_operators(kind, A, T, N)
    flat = kind.startswith("flat")
    shape = (T * N, F) if flat else (T, N, F)

    Xt = torch.from_numpy(X.reshape(shape)).requires_grad_(True)
    out = op_t(Xt)
    (out * torch.from_numpy(G.reshape(shape))).sum().backward()
    out_j = np.asarray(op_j(jnp.asarray(X.reshape(shape))))
    dX_j = np.asarray(jax.grad(lambda x: jnp.vdot(op_j(x), jnp.asarray(G.reshape(shape))))(
        jnp.asarray(X.reshape(shape))))

    kernel = "k3" if kind.endswith("tiled") else "k1"
    fwd_ref = oracle(rows, cols, vals, X.reshape(T * N, F), T * N, kernel)
    bwd_ref = oracle(cols, rows, vals, G.reshape(T * N, F), T * N, kernel)
    assert_scaled(out.detach().numpy().reshape(T * N, F), fwd_ref, ATOL)
    assert_scaled(Xt.grad.numpy().reshape(T * N, F), bwd_ref, ATOL)
    assert_scaled(out.detach().numpy(), out_j, JAX_REL)
    assert_scaled(Xt.grad.numpy(), dX_j, JAX_REL)

    exact = dataclasses.replace(op_t, fast=False)(torch.from_numpy(X.reshape(shape)))
    assert not torch.equal(out.detach(), exact)


def test_fast_tier_launches_nothing_on_the_cpu():
    """The plain versions run for CPU tensors; no kernel launch is counted."""
    rows, cols, vals, n_out, n_in = _stream(7)
    p = tk.pack_windowed_flat(rows, cols, vals, n_out, 64, 128)
    pt = tk.pack_windowed_tiled_flat(rows, cols, vals, n_out, 64, 128, 8)
    X = torch.randn(n_in, 4)
    before = (tk.windowed_segment_matmul.launches_fast,
              tk.windowed_tiled_segment_matmul.launches_fast)
    tk.windowed_segment_matmul(p, tk.gather_chunks(X, p), fast=True)
    tk.windowed_tiled_segment_matmul(pt, tk.gather_chunks(X, pt), fast=True)
    assert (tk.windowed_segment_matmul.launches_fast,
            tk.windowed_tiled_segment_matmul.launches_fast) == before


def test_bf16_rounding_helper():
    """The oracle's rounding is torch's float32 -> bf16 (ties to even)."""
    x = np.random.default_rng(0).standard_normal(10_000).astype(np.float32) * 1e3
    x[:4] = [1.0 + 2**-8, 1.0 + 3 * 2**-8, -(1.0 + 2**-8), 0.0]  # ties, both ways
    ref = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(bf16(x), ref)

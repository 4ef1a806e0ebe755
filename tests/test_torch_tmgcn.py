"""The port's TM-GCN, fast edge logits, loss and optimizers against JAX.

JAX's initial parameters are carried across with ``params_from_jax`` so
both sides start from the same weights. Inputs are made with numpy from
a seed. The comparisons run in float64 where the model allows it (the
JAX suite runs with x64), tolerance 1e-10 relative: only summation order
differs. The model's own float32 truncation of the cached propagation
(the reference's f32 buffer) makes the embed/apply outputs float32 on
both sides: tolerance 1e-5 relative there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmgcn_tpu.core.mmatrix import make_m_matrix
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.models.tmgcn import TMGCN as JaxTMGCN
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.train import loop as jloop
from tmgcn_tpu.train.losses import weighted_cross_entropy as jax_wce
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.tmgcn import TMGCN
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.train import loop as tloop
from tmgcn_torch.train.losses import weighted_cross_entropy

T, N, F0, F1, C, E = 6, 40, 2, 5, 3, 50


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    dense = (rng.random((T, N, N)) < 0.1) * rng.random((T, N, N))
    X = rng.standard_normal((T, N, F0))
    M = make_m_matrix(T, 3)
    edges = np.stack([rng.integers(0, T, E), rng.integers(0, N, E), rng.integers(0, N, E)])
    G = rng.standard_normal((E, C))
    return dense, X, M, edges, G


def _models(readout, spmm_impl="jnp"):
    j = JaxTMGCN(n_slices=T, in_feat=F0, hidden_feat=(F1, C), readout=readout)
    t = TMGCN(n_slices=T, in_feat=F0, hidden_feat=(F1, C), readout=readout, spmm_impl=spmm_impl)
    jvars = j.init(jax.random.PRNGKey(3))
    np_params = {k: np.asarray(v) for k, v in jvars["params"].items()}
    return j, t, jvars, np_params


def test_params_from_jax_copies_layouts():
    _, t, jvars, np_params = _models("concat")
    params = params_from_jax(np_params)
    assert set(params) == {"W", "U"}
    init = t.init(torch.Generator().manual_seed(0))["params"]
    for k, v in params.items():
        assert v.dtype == torch.float32 and v.shape == init[k].shape
        np.testing.assert_array_equal(v.numpy(), np_params[k])


def test_init_shapes_and_generator():
    _, t, _, _ = _models("bilinear")
    a = t.init(torch.Generator().manual_seed(5))
    b = t.init(torch.Generator().manual_seed(5))
    assert a["params"]["W"].shape == (F0, F1) and a["params"]["U"].shape == (F1, C)
    torch.testing.assert_close(a["params"]["U"], b["params"]["U"], rtol=0, atol=0)


@pytest.mark.parametrize("spmm_impl", ["jnp", "pallas"])
def test_propagate_matches_jax(case, spmm_impl):
    dense, X, M, _, _ = case
    j, t, _, _ = _models("concat", spmm_impl)
    dtype = np.float32 if spmm_impl == "pallas" else np.float64
    out = t.propagate(
        TemporalCOO.from_dense(dense, dtype=dtype, pad_multiple=16),
        torch.from_numpy(X.astype(dtype)), torch.from_numpy(M.astype(dtype)),
    )
    ref = j.propagate(
        JaxCOO.from_dense(dense, dtype=dtype, pad_multiple=16),
        jnp.asarray(X.astype(dtype)), jnp.asarray(M.astype(dtype)),
    )
    tol = 1e-5 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("readout", ["concat", "bilinear"])
def test_embed_and_apply_match_jax(case, readout):
    dense, X, M, edges, G = case
    j, t, jvars, np_params = _models(readout)
    A_t = TemporalCOO.from_dense(dense, dtype=np.float64, pad_multiple=16)
    A_j = JaxCOO.from_dense(dense, dtype=np.float64, pad_multiple=16)
    Xt, Mt = torch.from_numpy(X), torch.from_numpy(M)
    params = {k: v.requires_grad_(True) for k, v in params_from_jax(np_params).items()}
    tvars = {"params": params, "buffers": {}}

    emb = t.embed(tvars, A_t, Xt, Mt)
    emb_ref = j.embed(jvars, A_j, jnp.asarray(X), jnp.asarray(M))
    assert emb.dtype == torch.float32
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(emb_ref), rtol=1e-5, atol=1e-5)

    out = t.apply(tvars, A_t, Xt, torch.from_numpy(edges), Mt)
    (out * torch.from_numpy(G).float()).sum().backward()

    def f(p):
        o = j.apply({"params": p, "buffers": {}}, A_j, jnp.asarray(X), jnp.asarray(edges), jnp.asarray(M))
        return jnp.vdot(o, jnp.asarray(G, o.dtype)), o

    (_, ref), grads = jax.value_and_grad(f, has_aux=True)(jvars["params"])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for k in ("W", "U"):
        np.testing.assert_allclose(
            params[k].grad.numpy(), np.asarray(grads[k]), rtol=1e-4, atol=1e-4, err_msg=k
        )


@pytest.mark.parametrize("readout", ["concat", "bilinear"])
def test_fast_edge_logits_match_jax(case, readout):
    """Value and gradient of the cached-row epoch, float64 on both sides."""
    dense, X, M, edges, G = case
    rng = np.random.default_rng(7)
    cached = rng.standard_normal((T, N, F0))
    W = rng.standard_normal((F0, F1))
    U = rng.standard_normal((F1 if readout == "bilinear" else 2 * F1, C))

    bt = {"cached": torch.from_numpy(cached), "edges": torch.from_numpy(edges)}
    tad._cache_edge_rows(bt, torch.float64)
    Wt = torch.from_numpy(W).requires_grad_(True)
    Ut = torch.from_numpy(U).requires_grad_(True)
    out = tad._fast_edge_logits(Wt, Ut, bt, torch.float64, readout)
    (out * torch.from_numpy(G)).sum().backward()

    bj = {"cached": jnp.asarray(cached), "edges": jnp.asarray(edges)}
    jad._cache_edge_rows(bj, jnp.float64)

    def f(w, u):
        o = jad._fast_edge_logits(w, u, bj, jnp.float64, readout)
        return jnp.vdot(o, jnp.asarray(G)), o

    (_, ref), (gW, gU) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(W), jnp.asarray(U)
    )
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(Wt.grad.numpy(), np.asarray(gW), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(Ut.grad.numpy(), np.asarray(gU), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("with_mask", [False, True])
def test_weighted_cross_entropy_matches_jax(with_mask):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((30, 3)) * 3
    tgt = rng.integers(0, 3, 30)
    cw = np.array([0.2, 0.5, 0.3])
    mask = rng.random(30) < 0.7 if with_mask else None
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = weighted_cross_entropy(
        lt, torch.from_numpy(tgt), torch.from_numpy(cw),
        torch.from_numpy(mask) if with_mask else None,
    )
    loss.backward()
    ref, g = jax.value_and_grad(
        lambda x: jax_wce(x, jnp.asarray(tgt), jnp.asarray(cw),
                          jnp.asarray(mask) if with_mask else None)
    )(jnp.asarray(logits))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-12)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g), rtol=1e-10, atol=1e-12)
    # torch's own weighted CrossEntropyLoss agrees (the reference's loss).
    if not with_mask:
        ce = torch.nn.functional.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(tgt), weight=torch.from_numpy(cw)
        )
        np.testing.assert_allclose(loss.item(), ce.item(), rtol=1e-12)


def _quadratic_steps(opt_name, grad_clip, n_steps=5):
    """n updates of both optimizers on the same float64 loss."""
    rng = np.random.default_rng(2)
    p0 = {"W": rng.standard_normal((3, 4)), "U": rng.standard_normal((4, 2))}
    target = rng.standard_normal((3, 2))

    def loss_np(W, U, lib):
        tgt = torch.from_numpy(target) if lib is torch else jnp.asarray(target)
        return lib.sum((W @ U - tgt) ** 2) * 3.0

    cfg = tloop.TrainConfig(lr=0.01, momentum=0.9, optimizer=opt_name, grad_clip=grad_clip)
    jcfg = jloop.TrainConfig(lr=0.01, momentum=0.9, optimizer=opt_name, grad_clip=grad_clip)
    jopt = jloop._optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jopt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = tloop._optimizer(cfg, list(tp.values()))
    for _ in range(n_steps):
        g = jax.grad(lambda p: loss_np(p["W"], p["U"], jnp))(jp)
        upd, state = jopt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(torch.autograd.grad(loss_np(tp["W"], tp["U"], torch), list(tp.values())))
    return tp, jp


@pytest.mark.parametrize(
    "opt_name,grad_clip", [("sgd", None), ("adam", None), ("sgd", 1.0), ("adam", 1.0)]
)
def test_optimizer_steps_match_optax(opt_name, grad_clip):
    """The written-out updates against optax, and SGD against torch.optim."""
    tp, jp = _quadratic_steps(opt_name, grad_clip)
    for k in tp:
        np.testing.assert_allclose(
            tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-10, atol=1e-12, err_msg=k
        )


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_optimizer_matches_torch_optim(opt_name):
    rng = np.random.default_rng(5)
    W0, target = rng.standard_normal((3, 4)), rng.standard_normal((3, 4))
    ours = torch.tensor(W0, requires_grad=True)
    ref = torch.tensor(W0, requires_grad=True)
    opt = tloop._optimizer(tloop.TrainConfig(optimizer=opt_name), [ours])
    ref_opt = (torch.optim.SGD([ref], lr=0.01, momentum=0.9) if opt_name == "sgd"
               else torch.optim.Adam([ref], lr=0.01))
    for _ in range(6):
        opt.step(torch.autograd.grad(((ours - torch.from_numpy(target)) ** 2).sum(), [ours]))
        ref_opt.zero_grad()
        ((ref - torch.from_numpy(target)) ** 2).sum().backward()
        ref_opt.step()
    np.testing.assert_allclose(ours.detach().numpy(), ref.detach().numpy(), rtol=1e-12, atol=1e-12)


def test_optimizer_unknown_raises():
    with pytest.raises(ValueError):
        tloop._optimizer(tloop.TrainConfig(optimizer="lamb"), [torch.zeros(1, requires_grad=True)])


def test_f1_and_confusion_match_jax():
    rng = np.random.default_rng(4)
    out = rng.standard_normal((200, 3))
    tgt = rng.integers(0, 3, 200)
    counts = [int(c) for c in tloop._confusion(torch.from_numpy(out), torch.from_numpy(tgt))]
    ref = [int(c) for c in jloop._confusion(jnp.asarray(out), jnp.asarray(tgt))]
    assert counts == ref
    assert tloop._f1(*counts) == jloop._f1(*ref)
    p, r, f1 = tloop._f1(0, 0, 5)
    assert np.isnan(p) and r == 0.0 and np.isnan(f1)

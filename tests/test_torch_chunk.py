"""The training loop's step in the form a CUDA graph holds it, on the CPU.

On a card the loop captures one SGD step and replays it for every epoch
(train/loop.py: ``_Step``, ``_CapturedChunks``); on the CPU the same step
runs eagerly. Here:

* the step (gradients from ``torch.autograd.grad``, the stats written into
  a device ring, Adam's step count a tensor) gives bitwise the rows and the
  parameters of the eager algorithm it replaces, written out below as the
  oracle (``.grad`` set to None, ``loss.backward()``, the update read from
  ``.grad``, Adam's count a Python int, a chunk's stats stacked from one
  tensor a step), for run_edge_classification and run_link_prediction on
  small graphs made with numpy from a seed, 7 epochs with eval_every=3
  (evaluations at epochs 0, 3 and 6, two chunks of plain steps);
* the same runs equal the JAX package's (its ``chunk_step``) from the same
  initial variables, carried over with ``params_from_jax``: every model
  runs in float64 on dyadic inputs, so only the summation order differs;
  tolerances as tests/test_torch_slice.py holds the classification slice
  (losses rtol 1e-4, precision, recall and F1 within 1e-3) and
  tests/test_torch_lp_loop.py the link-prediction loop (rtol 1e-9);
* Adam with its count on the device equals optax over 6 steps, with and
  without grad_clip=1.0 (rtol 1e-10 in float64), and keeps no state in
  Python that a replay would freeze;
* EvolveGCN's carry (its evolved final weights, threaded train -> val ->
  test) comes out of the step detached and equal to the eager algorithm's,
  on each of its adapter paths; KW-GCN and EvolveGCN run the same cases
  as the other families;
* the launch-accounting rule of spmm_cuda as a pure function;
* WD-GCN's rematerialized scan, whose checkpoint keeps no RNG state,
  against the JAX scan in value and gradients.
"""

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.models import wdgcn as jwd
from tmgcn_tpu.models.evolvegcn import EvolveGCN as JEvolveGCN
from tmgcn_tpu.models.gcn import KWGCN as JKWGCN
from tmgcn_tpu.models.tmgcn import TMGCN as JTMGCN
from tmgcn_tpu.models.tmgcn import TMGCN2 as JTMGCN2
from tmgcn_tpu.tasks import adapters as jad
from tmgcn_tpu.train import loop as jloop
from tmgcn_torch.configs import build
from tmgcn_torch.configs.build import params_from_jax
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda
from tmgcn_torch.models import wdgcn as twd
from tmgcn_torch.models.evolvegcn import EvolveGCN
from tmgcn_torch.models.gcn import KWGCN
from tmgcn_torch.models.tmgcn import TMGCN, TMGCN2
from tmgcn_torch.tasks import adapters as tad
from tmgcn_torch.tasks import metrics as M
from tmgcn_torch.tasks.sampling import augment_edges
from tmgcn_torch.tasks.windows import WindowSpec, split_data_link_prediction, window_features
from tmgcn_torch.train import loop as tloop
from tmgcn_torch.train.losses import weighted_cross_entropy
from tmgcn_torch.utils import profile_slice

T_ALL, N, F0 = 12, 30, 2
WINDOWS = ("train", "val", "test")
EPOCHS, EVAL_EVERY = 7, 3


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _graph():
    """Dyadic adjacency values, small integer features, a dyadic M."""
    rng = np.random.default_rng(0)
    dense = (rng.random((T_ALL, N, N)) < 0.12) * rng.choice([0.25, 0.5, 1.0], (T_ALL, N, N))
    X = rng.integers(0, 4, (T_ALL, N, F0)).astype(np.float32)
    k = np.arange(8)
    Mm = np.where((k[:, None] >= k[None, :]) & (k[:, None] - k[None, :] < 3),
                  0.5 ** (k[:, None] - k[None, :] + 1), 0.0).astype(np.float32)
    return rng, dense, X, Mm


def _windows(spec, dense):
    adj_t, adj_j = {}, {}
    for w in WINDOWS:
        a, b = spec.bounds(w)
        adj_t[w] = TemporalCOO.from_dense(dense[a:b], pad_multiple=16)
        adj_j[w] = JaxCOO.from_dense(dense[a:b], dtype=np.float32, pad_multiple=16)
    return adj_t, adj_j


def _models(family, n_slices, hidden, spmm_impl, jax_impl):
    kw = dict(n_slices=n_slices, in_feat=F0, hidden_feat=hidden)
    if family == "tmgcn":
        return (JTMGCN(dtype=jnp.float64, spmm_impl=jax_impl, **kw),
                TMGCN(dtype=torch.float64, spmm_impl=spmm_impl, **kw))
    if family == "tmgcn2":
        return (JTMGCN2(dtype=jnp.float64, nonlin2="selu", spmm_impl=jax_impl, **kw),
                TMGCN2(dtype=torch.float64, nonlin2="selu", spmm_impl=spmm_impl, **kw))
    if family == "gcn":
        return (JKWGCN(dtype=jnp.float64, nonlin2="selu", spmm_impl=jax_impl, **kw),
                KWGCN(dtype=torch.float64, nonlin2="selu", spmm_impl=spmm_impl, **kw))
    if family == "evolvegcn":
        return (JEvolveGCN(dtype=jnp.float64, **kw), EvolveGCN(dtype=torch.float64, **kw))
    if family == "evolvegcn_generic":  # embed_dtype != dtype: the JAX generic path
        return (JEvolveGCN(dtype=jnp.float64, embed_dtype=jnp.float32, **kw),
                EvolveGCN(dtype=torch.float64, embed_dtype=torch.float32, **kw))
    return (jwd.WDGCN(dtype=jnp.float64, scan_unroll=1, spmm_impl=jax_impl, **kw),
            twd.WDGCN(dtype=torch.float64, spmm_impl=spmm_impl, **kw))


def _same_block(family) -> bool:
    """TM-GCN's shifted windows; the baselines' disjoint ones."""
    return family in ("tmgcn", "tmgcn2")


# Classification: (family, hidden, the port's spmm_impl, the JAX side's).
# The JAX side runs "jnp" where its Pallas interpreter would only slow the
# test; the JAX suite holds its operators equal to "jnp".
# EvolveGCN's carry (its evolved final weights) threads train -> val -> test:
# at 1 layer through the gather-free path, at 2 the restricted layer 2, and
# with embed_dtype set the generic staged path.
CLS_CASES = {
    "tmgcn1": ("tmgcn", (4, 3), "jnp", "jnp"),
    "tmgcn2_pallas": ("tmgcn2", (5, 4, 3), "pallas", "jnp"),
    "wdgcn_pallas": ("wdgcn", (4, 3), "pallas", "pallas"),
    "gcn2_pallas": ("gcn", (5, 4, 3), "pallas", "jnp"),
    "evolvegcn1": ("evolvegcn", (4, 3), "jnp", "jnp"),
    "evolvegcn2": ("evolvegcn", (5, 4, 3), "jnp", "jnp"),
    "evolvegcn1_generic": ("evolvegcn_generic", (4, 3), "jnp", "jnp"),
}
# Link prediction: (family, hidden, spmm_impl, loss_type).
LP_CASES = {
    "tmgcn1_pallas": ("tmgcn", (4, 2), "pallas", "softmax"),
    "tmgcn1_sigmoid": ("tmgcn", (4, 1), "jnp", "sigmoid"),
    "wdgcn": ("wdgcn", (4, 2), "jnp", "softmax"),
    "gcn1_pallas": ("gcn", (4, 2), "pallas", "softmax"),
    "evolvegcn1": ("evolvegcn", (4, 2), "jnp", "softmax"),
}
CLS_CW = np.array([0.25, 0.5, 0.25])
LP_CW = np.array([0.9, 0.1])


def _cls_setup(case):
    """(JAX adapter, port adapter, splits) of a 3-class edge task on 8 slices."""
    family, hidden, impl, jax_impl = CLS_CASES[case]
    rng, dense, X, Mm = _graph()
    spec = WindowSpec(8, 2, 2, same_block_size=_same_block(family))
    adj_t, adj_j = _windows(spec, dense)
    feats = window_features(X, spec)
    splits = {}
    for w in WINDOWS:
        E = 60
        a, b = spec.bounds(w)
        edges = np.stack([np.sort(rng.integers(0, b - a, E)), rng.integers(0, N, E),
                          rng.integers(0, N, E)])
        splits[w] = types.SimpleNamespace(edges=edges, target=rng.integers(0, 3, E),
                                          eval_mask=rng.random(E) < 0.8)
    edges = {w: splits[w].edges for w in WINDOWS}
    Mw = Mm if _same_block(family) else None
    model_j, model_t = _models(family, 8, hidden, impl, jax_impl)
    ad_j = jad.make_edge_adapter(model_j, adj_j, feats, edges, M=Mw)
    ad_t = tad.make_edge_adapter(model_t, adj_t, feats, edges, M=Mw, device="cpu")
    return ad_j, ad_t, splits


def _lp_setup(case):
    """(JAX adapter, port adapter, splits) of link prediction on 7 model slices."""
    family, hidden, impl, _ = LP_CASES[case]
    rng, dense, X, Mm = _graph()
    spec = WindowSpec(8, 2, 2, same_block_size=_same_block(family))
    E = 15 * T_ALL
    real = np.stack([np.sort(rng.integers(0, T_ALL, E)), rng.integers(0, N, E),
                     rng.integers(0, N, E)])
    splits = split_data_link_prediction(*augment_edges(real, N, 3, 2, 10, seed=4), spec)
    adj_t, adj_j = _windows(spec, dense)
    feats = window_features(X, spec)
    edges = {w: splits[w].model_edges for w in WINDOWS}
    Mw = Mm if _same_block(family) else None
    model_j, model_t = _models(family, 7, hidden, impl, "jnp")
    ad_j = jad.make_edge_adapter(model_j, adj_j, feats, edges, M=Mw, drop_last_slice=True)
    ad_t = tad.make_edge_adapter(model_t, adj_t, feats, edges, M=Mw, drop_last_slice=True,
                                 device="cpu")
    return ad_j, ad_t, splits


def _oracle(adapter, splits, cw, cfg, variables, link_pred, loss_type="softmax"):
    """The eager algorithm the captured step replaces: (rows, params).

    Each step sets every ``.grad`` to None, runs ``loss.backward()`` and
    reads the update from ``.grad``; Adam counts its steps in a Python int;
    a chunk's stats are one tensor a step, stacked at the chunk's end.
    Rows as the loop writes them: F1 rows for classification, MAP-MRR rows
    for link prediction.
    """
    params = tloop._tree_map(lambda v: v.detach().clone().requires_grad_(True),
                             variables["params"])
    buffers = variables["buffers"]
    leaves = tloop._tree_leaves(params)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    count = 0
    transform = tloop.sigmoid_pair_logits if loss_type == "sigmoid" else None
    train = splits["train"]
    keep_train = train.edges[0] != 0 if link_pred else np.ones(train.target.size, bool)
    tgt_np = train.target[keep_train]
    tgt = torch.as_tensor(tgt_np)
    cw_t = torch.as_tensor(cw, dtype=torch.float64)
    variables = {"params": params, "buffers": buffers}

    def step():
        nonlocal count
        for p in leaves:
            p.grad = None
        out, carry = adapter.apply(variables, adapter.bundles["train"], ())
        if transform is not None:
            out = transform(out)
        loss = weighted_cross_entropy(out, tgt, cw_t)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad for p in leaves]
            if cfg.grad_clip is not None:
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                grads = [torch.where(norm < cfg.grad_clip, g, (g / norm) * cfg.grad_clip)
                         for g in grads]
            if cfg.optimizer == "sgd":
                for p, g, t in zip(leaves, grads, mu):
                    t.mul_(cfg.momentum).add_(g)
                    p.add_(t, alpha=-cfg.lr)
            else:
                count += 1
                for p, g, m, v in zip(leaves, grads, mu, nu):
                    m.copy_((1 - 0.9) * g + 0.9 * m)
                    v.copy_((1 - 0.999) * g**2 + 0.999 * v)
                    m_hat = m / (1 - 0.9**count)
                    v_hat = v / (1 - 0.999**count)
                    p.add_(-cfg.lr * (m_hat / (torch.sqrt(v_hat) + 1e-8)))
        out = out.detach()
        stats = [loss.detach().double()]
        if not link_pred:
            guess = torch.argmax(out, dim=1)
            stats += [torch.sum((guess == 0) & (tgt == 0)).double(),
                      torch.sum((guess == 0) & (tgt != 0)).double(),
                      torch.sum((guess != 0) & (tgt == 0)).double()]
        return torch.stack(stats), out, carry

    def pairs(o):
        if transform is None:
            return o
        p = 1.0 / (1.0 + np.exp(-o.astype(np.float64)))
        return np.concatenate([p, 1.0 - p], axis=1)

    def scored(wname, out):
        s = splits[wname]
        o = pairs(out.numpy())
        if not link_pred:
            o, t = o[s.eval_mask], s.target[s.eval_mask]
            return (*M.precision_recall_f1(np.argmax(o, 1), t), M.weighted_ce_loss_np(o, t, cw))
        if s.n_eval_tail is not None:
            K = s.n_eval_tail
            o, t, e = o[-K:], s.target[-K:], s.edges[:, -K:]
        else:
            keep = s.edges[0] != 0
            t, e = s.target[keep], s.edges[:, keep]
        return (*M.map_mrr(o, t, e), M.weighted_ce_loss_np(o, t, cw))

    rows = []
    ep = 0
    while ep < cfg.n_epochs:
        stats, out_train, carry = step()
        with torch.no_grad():
            outs = {}
            for wname in ("val", "test"):
                outs[wname], carry = adapter.apply(variables, adapter.bundles[wname], carry)
        ev = [*scored("val", outs["val"]), *scored("test", outs["test"])]
        if link_pred:
            tr = M.map_mrr(pairs(out_train.numpy()), tgt_np, train.edges[:, keep_train])
            rows.append([*tr, float(stats[0]), *ev])
        else:
            rows.append([*tloop._f1(*stats[1:].numpy()), stats[0].item(), *ev])
        ep += 1
        k = min(cfg.eval_every - 1, cfg.n_epochs - ep)
        if k > 0:
            chunk = torch.stack([step()[0] for _ in range(k)]).numpy()
            for s in chunk:
                head = [*tr, s[0]] if link_pred else [*tloop._f1(*s[1:]), s[0]]
                rows.append([*head, *ev])
            ep += k
    return np.array(rows), tloop._tree_map(torch.Tensor.detach, params)


def _assert_trees_equal(a, b):
    for (ka, va), (kb, vb) in zip(sorted(a.items()), sorted(b.items())):
        assert ka == kb
        if isinstance(va, dict):
            _assert_trees_equal(va, vb)
        else:
            assert torch.equal(va, vb), ka


OPTIMIZERS = {"sgd": {}, "adam_clip": {"optimizer": "adam", "grad_clip": 1.0}}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("case", sorted(CLS_CASES))
def test_classification_step_matches_the_eager_algorithm(case, opt):
    _, ad_t, splits = _cls_setup(case)
    variables = ad_t.init(torch.Generator().manual_seed(2))
    cfg = tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY, **OPTIMIZERS[opt])
    res, out = tloop.run_edge_classification(ad_t, splits, CLS_CW, cfg, variables=variables)
    ref, ref_params = _oracle(ad_t, splits, CLS_CW, cfg, variables, link_pred=False)
    assert res.shape == (EPOCHS, 12)
    np.testing.assert_array_equal(res, ref)
    _assert_trees_equal(out["params"], ref_params)


@pytest.mark.parametrize("case", sorted(LP_CASES))
def test_link_prediction_step_matches_the_eager_algorithm(case):
    loss_type = LP_CASES[case][3]
    _, ad_t, splits = _lp_setup(case)
    variables = ad_t.init(torch.Generator().manual_seed(3))
    cfg = tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY)
    res, out = tloop.run_link_prediction(ad_t, splits, LP_CW, cfg, variables=variables,
                                         loss_type=loss_type)
    ref, ref_params = _oracle(ad_t, splits, LP_CW, cfg, variables, link_pred=True,
                              loss_type=loss_type)
    assert res.shape == (EPOCHS, 9)
    np.testing.assert_array_equal(res, ref)
    _assert_trees_equal(out["params"], ref_params)


@pytest.mark.parametrize("case", ["evolvegcn1", "evolvegcn2", "evolvegcn1_generic"])
def test_step_returns_the_carry_detached(case):
    """EvolveGCN's carry, its evolved final weights, comes out of the step
    (the form a graph holds) as the eager algorithm's: equal to the train
    forward's finals before the update, a tree of tensors with no autograd
    history; and the val window evolves from it, not from W_init."""
    _, ad_t, splits = _cls_setup(case)
    variables = ad_t.init(torch.Generator().manual_seed(2))
    # The eager algorithm's train forward (with grad, as _oracle's step runs it).
    grad_vars = {"params": tloop._tree_map(lambda v: v.clone().requires_grad_(True),
                                           variables["params"]),
                 "buffers": variables["buffers"]}
    _, ref = ad_t.apply(grad_vars, ad_t.bundles["train"], ())
    chunks, eval_forward, trained = tloop.train_chunks(
        ad_t, splits["train"], CLS_CW, tloop.TrainConfig(n_epochs=3), variables=variables)
    _, carry = chunks(1)
    n_layers = len(CLS_CASES[case][1]) - 1
    assert isinstance(carry, tuple) and len(carry) == len(ref) == n_layers
    for c, r in zip(carry, ref):
        assert isinstance(c, torch.Tensor) and c.grad_fn is None and not c.requires_grad
        assert torch.equal(c, r.detach())
    out_val, carry_val = eval_forward("val", carry)
    assert all(c.grad_fn is None for c in carry_val)
    with torch.no_grad():
        ref_val, _ = ad_t.apply(trained, ad_t.bundles["val"], carry)
        val_from_init, _ = ad_t.apply(trained, ad_t.bundles["val"], ())
    assert torch.equal(out_val, ref_val)
    assert not torch.allclose(out_val, val_from_init)


@pytest.mark.parametrize("case", sorted(CLS_CASES))
def test_classification_rows_match_jax(case):
    ad_j, ad_t, splits = _cls_setup(case)
    jvars = ad_j.init(jax.random.PRNGKey(1))
    res_j, _ = jloop.run_edge_classification(
        ad_j, splits, CLS_CW, jloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=jvars,
    )
    res_t, _ = tloop.run_edge_classification(
        ad_t, splits, CLS_CW, tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=params_from_jax(_np_tree(jvars)),
    )
    losses = [3, 7, 11]
    assert np.all(np.isfinite(res_t[:, losses]))
    assert len(np.unique(res_t[:, 3])) == EPOCHS  # every epoch trains
    np.testing.assert_allclose(res_t[:, losses], res_j[:, losses], rtol=1e-4)
    rates = [0, 1, 2, 4, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(np.isnan(res_t[:, rates]), np.isnan(res_j[:, rates]))
    np.testing.assert_allclose(res_t[:, rates], res_j[:, rates], atol=1e-3)


@pytest.mark.parametrize("case", sorted(LP_CASES))
def test_link_prediction_rows_match_jax(case):
    loss_type = LP_CASES[case][3]
    ad_j, ad_t, splits = _lp_setup(case)
    jvars = ad_j.init(jax.random.PRNGKey(1))
    res_j, _ = jloop.run_link_prediction(
        ad_j, splits, LP_CW, jloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=jvars, loss_type=loss_type,
    )
    res_t, _ = tloop.run_link_prediction(
        ad_t, splits, LP_CW, tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY),
        variables=params_from_jax(_np_tree(jvars)), loss_type=loss_type,
    )
    assert len(np.unique(res_t[:, 2])) == EPOCHS
    np.testing.assert_array_equal(np.isnan(res_t), np.isnan(res_j))
    np.testing.assert_allclose(res_t, res_j, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_adam_device_count_matches_optax(grad_clip):
    """6 Adam steps on a float64 quadratic: the port's update, its count a
    tensor, against optax; no Python-side state changes between steps."""
    rng = np.random.default_rng(2)
    p0 = {"W": rng.standard_normal((3, 4)), "U": rng.standard_normal((4, 2))}
    target = rng.standard_normal((3, 2))

    def loss(p, lib):
        tgt = torch.from_numpy(target) if lib is torch else jnp.asarray(target)
        return lib.sum((p["W"] @ p["U"] - tgt) ** 2) * 3.0

    jopt = jloop._optimizer(jloop.TrainConfig(optimizer="adam", grad_clip=grad_clip))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jopt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = tloop._optimizer(tloop.TrainConfig(optimizer="adam", grad_clip=grad_clip),
                           tloop._tree_leaves(tp))
    assert isinstance(opt.count, torch.Tensor) and opt.count.dtype == torch.float64

    def host_state():
        return {k: v for k, v in vars(opt).items() if not isinstance(v, (torch.Tensor, list))}

    before = host_state()
    for _ in range(6):
        upd, state = jopt.update(jax.grad(lambda p: loss(p, jnp))(jp), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(list(torch.autograd.grad(loss(tp, torch), tloop._tree_leaves(tp))))
    assert host_state() == before
    assert opt.count.item() == 6
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-10,
                                   atol=1e-12, err_msg=k)


def test_launch_accounting_rule():
    """A capture's calls count 0; each replay adds the captured launches; an
    eager launch adds one; a capture outside a recording raises."""

    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.launches_fast = 0
    log = spmm_cuda.LaunchLog()
    with log.recording():
        spmm_cuda.count_launch((wrapper, "launches"), capturing=True)
        spmm_cuda.count_launch((wrapper, "launches_fast"), capturing=True)
        spmm_cuda.count_launch((wrapper, "launches"), capturing=True)
        assert (wrapper.launches, wrapper.launches_fast) == (0, 0)
        with pytest.raises(RuntimeError):
            with spmm_cuda.LaunchLog().recording():
                pass
    log.replayed()
    assert (wrapper.launches, wrapper.launches_fast) == (2, 1)
    log.replayed(5)
    assert (wrapper.launches, wrapper.launches_fast) == (12, 6)
    spmm_cuda.count_launch((wrapper, "launches"), capturing=False)
    assert wrapper.launches == 13
    with pytest.raises(RuntimeError, match="outside"):
        spmm_cuda.count_launch((wrapper, "launches"), capturing=True)
    assert wrapper.launches == 13


def test_stats_ring_and_cpu_chunks():
    """On the CPU the chunks are the eager ones; ``stats(n)`` gives the last
    n steps' rows, oldest first, across the ring's wrap."""
    _, ad_t, splits = _cls_setup("tmgcn1")
    chunks, _, _ = tloop.train_chunks(ad_t, splits["train"], CLS_CW, tloop.TrainConfig(),
                                      capacity=3)
    assert type(chunks) is tloop._EagerChunks
    losses = []
    for _ in range(5):
        chunks(1)
        losses.append(chunks.stats(1)[0, 0].item())
    assert chunks.stats(3)[:, 0].tolist() == losses[2:]
    assert chunks.stats(2)[:, 0].tolist() == losses[3:]
    with pytest.raises(ValueError):
        chunks.stats(4)
    with pytest.raises(ValueError):
        chunks(0)


@pytest.mark.parametrize("task,case", [("edge_cls", "tmgcn1"), ("link_pred", "tmgcn1_pallas"),
                                       ("link_pred", "tmgcn1_sigmoid")])
def test_trial_chunks_run_the_step_that_run_trial_trains(task, case):
    """configs.build.trial_chunks, the chunks that profile_slice and
    chip_smoke.py time, steps as run_trial's loop does from the same
    generator: the same losses epoch by epoch, bitwise, and for edge
    classification the train precision, recall and F1 of the same counts."""
    if task == "edge_cls":
        _, ad_t, splits = _cls_setup(case)
        loss_type = "softmax"
    else:
        _, ad_t, splits = _lp_setup(case)
        loss_type = LP_CASES[case][3]
    cfg = types.SimpleNamespace(task=task, n_classes=3, loss_type=loss_type, eval_type="MAP-MRR")
    exp = types.SimpleNamespace(cfg=cfg, adapter=ad_t, splits=splits,
                                link_pred=task == "link_pred")
    tcfg = tloop.TrainConfig(n_epochs=EPOCHS, eval_every=EVAL_EVERY)
    rows = build.run_trial(exp, tcfg, 0.75, torch.Generator().manual_seed(5))
    chunks = build.trial_chunks(exp, tcfg, 0.75, torch.Generator().manual_seed(5))
    chunks(EPOCHS)
    stats = chunks.stats(EPOCHS).numpy()
    if task == "edge_cls":
        np.testing.assert_array_equal(rows[:, 3], stats[:, 0])
        np.testing.assert_array_equal(rows[:, :3], [tloop._f1(*s[1:]) for s in stats])
    else:
        np.testing.assert_array_equal(rows[:, 2], stats[:, 0])


@pytest.mark.parametrize("kwargs,match", [
    ({"task": "node_cls"}, "task"),
    ({"task": "edge_cls", "loss_type": "sigmoid"}, "softmax"),
    ({"task": "link_pred", "loss_type": "hinge"}, "loss_type"),
])
def test_train_chunks_rejects(kwargs, match):
    _, ad_t, splits = _cls_setup("tmgcn1")
    with pytest.raises(ValueError, match=match):
        tloop.train_chunks(ad_t, splits["train"], CLS_CW, tloop.TrainConfig(), **kwargs)


def test_timed_chunks_grow_a_round_past_sixteen_probes(monkeypatch):
    """profile_slice.timed_chunks grows a short chunk until a round covers
    min_round_s, beyond bench.py's 16x cap, and times every run in turns
    (on a clock that advances 1 ms an epoch of "a", 3 ms of "b")."""
    clock = [0.0]
    calls = []
    monkeypatch.setattr(profile_slice.time, "perf_counter", lambda: clock[0])

    def runner(name, ms):
        def run(n):
            calls.append((name, n))
            clock[0] += ms * 1e-3 * n
            return torch.zeros(1)
        return run

    out = profile_slice.timed_chunks({"a": runner("a", 1), "b": runner("b", 3)}, 2, rounds=3,
                                     min_round_s=0.045)
    assert out["a"]["n_timed"] == 2 * 23 and out["b"]["n_timed"] == 2 * 8
    for name, ms in (("a", 1), ("b", 3)):
        t = out[name]
        assert t["median_ms"] == pytest.approx(ms) and t["run_spread"] == pytest.approx(0)
        assert t["round_s"] == pytest.approx(ms * 1e-3 * t["n_timed"]) and t["round_s"] > 0.045
    assert calls[:6] == [("a", 2), ("a", 2), ("a", 46), ("b", 2), ("b", 2), ("b", 16)]
    assert calls[6:] == [("a", 46), ("b", 16)] * 3


def test_wdgcn_remat_keeps_no_rng_state_and_matches_jax(monkeypatch):
    rng = np.random.default_rng(1)
    Tn, Nn, F = 7, 33, 4
    model = jwd.WDGCN(n_slices=Tn, in_feat=F0, hidden_feat=(F, 3), dtype=jnp.float64)
    variables = _np_tree(model.init(jax.random.PRNGKey(2)))
    lstm, bufs = variables["params"]["lstm"], variables["buffers"]
    Y = rng.standard_normal((Tn, F, Nn))
    G = rng.standard_normal((Tn, Nn, F))
    seen = []

    def checkpoint(*args, **kwargs):
        seen.append(kwargs)
        return torch.utils.checkpoint.checkpoint(*args, **kwargs)

    monkeypatch.setattr(twd, "checkpoint", checkpoint)
    p = params_from_jax(lstm)
    for v in p.values():
        v.requires_grad_(True)
    Yt = torch.from_numpy(Y).requires_grad_(True)
    out = twd.lstm_scan_t(p, torch.from_numpy(bufs["h_init"]), torch.from_numpy(bufs["c_init"]),
                          Yt, remat=True)
    (out * torch.from_numpy(G)).sum().backward()
    assert len(seen) == Tn
    assert all(k == {"use_reentrant": False, "preserve_rng_state": False} for k in seen)

    def f(pp, y):
        o = jwd.lstm_scan_t(pp, jnp.asarray(bufs["h_init"]), jnp.asarray(bufs["c_init"]), y,
                            remat=True)
        return jnp.vdot(o, jnp.asarray(G)), o

    (_, ref), (gp, gy) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in lstm.items()}, jnp.asarray(Y)
    )
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(Yt.grad.numpy(), np.asarray(gy), rtol=1e-10, atol=1e-10)
    for k, v in p.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(gp[k]), rtol=1e-10, atol=1e-10,
                                   err_msg=k)

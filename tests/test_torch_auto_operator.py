"""The full-row ``auto`` operator (``ops.spmm.make_auto_operator``) against
the JAX package's, its rule, and the presets that run it.

* On the CPU ``make_auto_operator`` returns A unpacked, as the JAX
  package's does off the TPU: ``spmm`` through it, and ``spmm(impl="auto")``,
  equal the JAX package's ``make_auto_operator`` + ``spmm`` (atol 1e-5),
  forward and backward; ``_prepare_bundles`` keeps A unpacked and records
  the pick.
* The rule on host counts: ``auto_counts`` of a block-friendly pattern and
  of a random one, a crafted K3 count, and the limits; built for a CUDA
  device (host packing only: nothing runs on a card here), each branch's
  operator — block-dense, K3, K1 with ``sort_cols``, their bf16 tiers, and
  the fall-through past the block tensor's byte budget — applied on CPU
  tensors (the kernels' plain versions) equals the JAX package's result
  (float32 atol 1e-5 of the scale; bf16 2e-2, block-dense bf16 3e-2, the
  suite's tolerances).
* ``run_experiment`` of chess_tmgcn_cls, uci_tmgcn_lp and
  seir_wdgcn_reg_tuned with ``spmm_impl="auto"`` on the CPU against the JAX
  package from the same variables (losses rtol 1e-4; F1 within 1e-3; MAP
  and MRR rtol 1e-3; L1 rtol 1e-4). The JAX package's own ``auto`` does not
  run end to end off the TPU: its ``make_auto_operator`` returns A
  unpacked there and the models' ``spmm(A, X, impl="auto")`` raises
  "unknown spmm impl" (held below). So its side runs what its ``auto``
  stands for there — A unpacked through the plain segment sum, "jnp".
"""

import dataclasses
import math
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.test_torch_synthetic import SMALL_SEIR, assert_losses_close, run_both
from tests.torch_registry import assert_rows_close, raw_copies
from tmgcn_tpu import native as jnative
from tmgcn_tpu.configs import presets as jpresets
from tmgcn_tpu.core.sparse import TemporalCOO as JaxCOO
from tmgcn_tpu.ops import spmm as jspmm
from tmgcn_torch.configs import presets as tpresets
from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda
from tmgcn_torch.ops import spmm as tspmm
from tmgcn_torch.ops import spmm_blockdense
from tmgcn_torch.ops.spmm_rowsplit import flatten_stream
from tmgcn_torch.tasks import adapters as tad

CHESS = Path(__file__).resolve().parents[1] / "data" / "chess" / "out.chess.csv"
WINDOWS = ("train", "val", "test")
T, N, F = 3, 256, 8
EPOCHS, EVAL_EVERY = 5, 3


def _pattern(kind: str, seed: int = 0):
    """(port COO, JAX COO) of one of three patterns: "dense_blocks" (every
    entry of two 128 x 128 blocks a slice: block-friendly), "random" (40
    entries a slice, ~10 a 128 x 128 block), or "banded" (1,500 a slice,
    within 4 of the diagonal)."""
    rng = np.random.default_rng(seed)
    slices = []
    for t in range(T):
        if kind == "dense_blocks":
            r, c = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
            r = np.r_[r.ravel(), r.ravel() + 128]
            c = np.r_[c.ravel(), c.ravel() + 128 * (t % 2)]
        elif kind == "random":
            r, c = rng.integers(0, N, 40), rng.integers(0, N, 40)
        else:
            r = rng.integers(0, N, 1500)
            c = np.clip(r + rng.integers(-4, 5, 1500), 0, N - 1)
        slices.append((r, c, rng.standard_normal(len(r)).astype(np.float32)))
    A = TemporalCOO.from_slices(slices, N)
    A_j = JaxCOO(rows=np.asarray(A.rows), cols=np.asarray(A.cols), vals=np.asarray(A.vals),
                 nnz=np.asarray(A.nnz), n_nodes=N)
    return A, A_j


def _jax_reference(A_j, X: np.ndarray, G: np.ndarray):
    """The JAX package's auto operator on the CPU (A itself) through its
    spmm: the output and the gradient of <Y, G> with respect to X."""
    op = jspmm.make_auto_operator(A_j)
    assert op is A_j

    def loss(x):
        return jnp.sum(jspmm.spmm(op, x) * G)

    Xj = jnp.asarray(X)
    return np.asarray(jspmm.spmm(op, Xj)), np.asarray(jax.grad(loss)(Xj))


def _port(op, X: np.ndarray, G: np.ndarray, impl: str = "jnp"):
    x = torch.from_numpy(X).requires_grad_(True)
    y = tspmm.spmm(op, x, impl=impl)
    (dx,) = torch.autograd.grad(y, x, torch.from_numpy(G))
    return y.detach().numpy(), dx.numpy()


def _inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, N, F)).astype(np.float32),
            rng.standard_normal((T, N, F)).astype(np.float32))


def _assert_close(got, ref, rel: float):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=rel * scale, rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_cpu_operator_is_a_unpacked_and_matches_jax(bf16):
    A, A_j = _pattern("random")
    X, G = _inputs()
    op, pick = tspmm.make_auto_operator(A, bf16=bf16, device="cpu")
    assert op is A
    assert pick == {"branch": "unpacked", "bf16": bf16, "blockdense_ratio": None,
                    "tiled_ratio": None, "over_budget": False}
    y_ref, dx_ref = _jax_reference(A_j, X, G)
    for impl in ("jnp", "auto_bf16" if bf16 else "auto"):
        y, dx = _port(op, X, G, impl)
        np.testing.assert_allclose(y, y_ref, atol=1e-5)
        np.testing.assert_allclose(dx, dx_ref, atol=1e-5)


def test_jax_auto_through_a_model_spmm_raises_off_the_tpu():
    """Why the preset runs below hold the port against the JAX package's
    "jnp": its spmm has no "auto" impl, and off the TPU its auto operator
    is A itself."""
    _, A_j = _pattern("random")
    X, _ = _inputs()
    with pytest.raises(ValueError, match="unknown spmm impl"):
        jspmm.spmm(jspmm.make_auto_operator(A_j), jnp.asarray(X), impl="auto")


@pytest.mark.parametrize("impl", ["auto", "auto_bf16"])
def test_prepare_bundles_keeps_a_unpacked_on_the_cpu(impl):
    A, _ = _pattern("banded")
    X, _ = _inputs()
    edges = np.stack([np.arange(6) % T, np.arange(6), np.arange(6)[::-1]]).astype(np.int64)
    bundles = tad._prepare_bundles({w: A for w in WINDOWS}, {w: X for w in WINDOWS},
                                   {w: edges for w in WINDOWS}, None, False, impl,
                                   torch.device("cpu"), readout=True)
    b = bundles["train"]
    assert isinstance(b["adj"], TemporalCOO)
    assert b["op_choice"]["branch"] == "unpacked"
    assert b["op_choice"]["bf16"] == (impl == "auto_bf16")
    # As the JAX package: an operator impl builds the readout plan.
    assert "readout" in b


def test_auto_counts_are_the_packers_counts():
    """The counts the rule prices are those of the packings it would make."""
    A, _ = _pattern("banded")
    g_rows, g_cols, g_vals = flatten_stream(A)
    n = T * N
    counts = tspmm.auto_counts(g_rows, g_cols, n, n, F, 4)
    k1 = spmm_cuda.make_operator(A, chunk=512, window=256, sort_cols=True)
    k3 = spmm_cuda.make_operator(A, chunk=512, window=256, tile_dedup=True)
    assert counts["nnz"] == len(g_rows)
    assert (counts["sectors"], counts["tile_sectors"]) == (1, 8)
    assert counts["k1_chunks"] == k1.packed.n_chunks + k1.packed_t.n_chunks
    assert counts["k3_chunks"] == k3.packed.n_chunks + k3.packed_t.n_chunks

    def tiles(p):
        return sum(len(np.unique(p.uidx[j][p.vals[j] != 0] // 8)) for j in range(p.n_chunks))

    assert counts["k3_tiles"] == tiles(k3.packed) + tiles(k3.packed_t)
    assert counts["blockdense_ratio"] == spmm_blockdense.estimate(g_rows, g_cols)["ratio"]
    for feat, itemsize, sectors in ((128, 4, 16), (128, 2, 8), (2, 4, 1), (2, 2, 1)):
        c = tspmm.auto_counts(g_rows, g_cols, n, n, feat, itemsize)
        assert (c["sectors"], c["tile_sectors"]) == (sectors, max(1, 8 * feat * itemsize // 32))


K1_COSTS = {"launch": 0.01, "entry": 1e-6, "chunk": 1e-4, "gather": 1e-7}
K3_COSTS = {"launch": 0.012, "entry": 1.2e-6, "chunk": 1e-4, "gather": 2e-7}


def _counts(kind: str, itemsize: int = 4) -> dict:
    A, _ = _pattern(kind)
    g_rows, g_cols, _ = flatten_stream(A)
    return tspmm.auto_counts(g_rows, g_cols, T * N, T * N, F, itemsize)


def test_rule_on_host_counts_reaches_each_branch():
    """A block-friendly pattern, a random one and a crafted K3 count, with
    stated costs and limits."""
    dense, rand = _counts("dense_blocks"), _counts("random")
    assert dense["blockdense_ratio"] < 0.01 < 1 < rand["blockdense_ratio"]

    def pick(counts, limits=(0.05, 0.8)):
        return tspmm.auto_pick(counts["blockdense_ratio"],
                               tspmm.tiled_ratio(counts, K1_COSTS, K3_COSTS), *limits)

    assert pick(dense) == "blockdense"
    assert pick(rand) == "windowed"
    # K3 gathering few tiles for many entries: its model under 0.8 of K1's.
    crafted = {**rand, "nnz": 10_000, "k1_chunks": 2_000, "k3_chunks": 40, "k3_tiles": 50}
    assert tspmm.tiled_ratio(crafted, K1_COSTS, K3_COSTS) < 0.8
    assert pick(crafted) == "tiled"
    # A limit of 0 takes neither branch; past the block budget the rule
    # goes on with an infinite ratio.
    assert pick(crafted, (0.0, 0.0)) == "windowed"
    assert tspmm.auto_pick(math.inf, 0.5, 0.05, 0.8) == "tiled"


def test_committed_constants_are_a_model():
    """The constants fitted on the card: non-negative costs, K1's model
    positive at every count, limits in [0, inf)."""
    for costs in (tspmm.AUTO_K1_COSTS, tspmm.AUTO_K3_COSTS):
        assert set(costs) == {"launch", "entry", "chunk", "gather"}
        assert all(v >= 0 for v in costs.values())
    assert tspmm.model_ms(_counts("random"), "k1") > 0
    assert 0 <= tspmm.AUTO_BLOCKDENSE_RATIO < math.inf
    assert 0 <= tspmm.AUTO_TILED_RATIO < math.inf
    # Random entries, 1 a block: no margin takes block-dense there.
    assert tspmm.auto_pick(_counts("random")["blockdense_ratio"], math.inf) == "windowed"


def _over_budget(monkeypatch):
    real = spmm_blockdense.make_operator
    monkeypatch.setattr(spmm_blockdense, "make_operator",
                        lambda A, **kw: real(A, max_bytes=1, **kw))


# (pattern, limits (block-dense, tiled), over budget) -> the branch.
BRANCHES = {
    "blockdense": ("dense_blocks", (math.inf, 0.0), False),
    "tiled": ("banded", (0.0, math.inf), False),
    "windowed": ("random", (0.0, 0.0), False),
    "over_budget_tiled": ("dense_blocks", (math.inf, math.inf), True),
    "over_budget_windowed": ("dense_blocks", (math.inf, 0.0), True),
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", list(BRANCHES))
def test_card_build_takes_each_branch_and_matches_jax(monkeypatch, case, bf16):
    """make_auto_operator for a CUDA device, its limits set so that each
    branch is taken: the operator it packs (on the host) and the pick, and
    the operator's forward and backward on CPU tensors against the JAX
    package's result."""
    kind, (bd_limit, tiled_limit), over = BRANCHES[case]
    monkeypatch.setattr(tspmm, "AUTO_BLOCKDENSE_RATIO", bd_limit)
    monkeypatch.setattr(tspmm, "AUTO_TILED_RATIO", tiled_limit)
    monkeypatch.setattr(tspmm, "AUTO_K1_COSTS", K1_COSTS)
    monkeypatch.setattr(tspmm, "AUTO_K3_COSTS", K3_COSTS)
    if over:
        _over_budget(monkeypatch)
    A, A_j = _pattern(kind)
    op, pick = tspmm.make_auto_operator(A, bf16=bf16, feat=F, device="cuda")
    branch = case.split("_")[-1] if over else case
    assert pick["branch"] == branch and pick["bf16"] == bf16 and pick["over_budget"] == over
    counts = _counts(kind, 2 if bf16 else 4)
    assert pick["blockdense_ratio"] == counts["blockdense_ratio"]
    assert math.isclose(pick["tiled_ratio"], tspmm.tiled_ratio(counts, K1_COSTS, K3_COSTS))
    if branch == "blockdense":
        assert isinstance(op, spmm_blockdense.TemporalBlockDenseOperator)
        assert op.mode == ("bf16" if bf16 else "exact")
    else:
        assert isinstance(op, spmm_cuda.PallasSpmmOperator)
        assert isinstance(op.packed, spmm_cuda.PackedTiled) == (branch == "tiled")
        assert (op.packed.chunk, op.packed.window) == (512, 256)
        assert op.gather_dtype == ("bfloat16" if bf16 else None) and not op.fast
        if branch == "windowed":
            # sort_cols: each window's entries in column order.
            p = op.packed
            cols = p.cols[p.vals != 0]
            wid = np.repeat(p.window_id, p.chunk).reshape(p.rows.shape)[p.vals != 0]
            assert np.all((np.diff(wid) > 0) | (np.diff(cols) >= 0))
    X, G = _inputs()
    y_ref, dx_ref = _jax_reference(A_j, X, G)
    y, dx = _port(op, X, G)
    rel = (3e-2 if branch == "blockdense" else 2e-2) if bf16 else 1e-5
    _assert_close(y, y_ref, rel)
    _assert_close(dx, dx_ref, rel)


def test_pack_operator_takes_the_rule(monkeypatch):
    monkeypatch.setattr(tspmm, "AUTO_BLOCKDENSE_RATIO", math.inf)
    A, _ = _pattern("dense_blocks")
    assert tspmm.pack_operator(A, "auto", device="cpu") is A
    op = tspmm.pack_operator(A, "auto_bf16", device="cuda")
    assert isinstance(op, spmm_blockdense.TemporalBlockDenseOperator) and op.mode == "bf16"


# ---------------------------------------------------------------- presets


def _copies(tmp_path: Path, raw: Path) -> dict:
    dirs = {}
    for side in ("torch", "jax"):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(raw, d / raw.name)
        dirs[side] = d
    return dirs


def _edge_cfgs(name: str):
    cfg_t = dataclasses.replace(tpresets.get_preset(name), spmm_impl="auto",
                                eval_every=EVAL_EVERY)
    cfg_j = dataclasses.replace(jpresets.get_preset(name), spmm_impl="jnp",
                                eval_every=EVAL_EVERY)
    return cfg_t, cfg_j


def test_chess_tmgcn_cls_auto_runs_like_jax(monkeypatch, tmp_path):
    cfg_t, cfg_j = _edge_cfgs("chess_tmgcn_cls")
    res_t, res_j, adapter = run_both(monkeypatch, cfg_t, cfg_j, EPOCHS,
                                     _copies(tmp_path, CHESS), cfg_t.alpha_vec[:1])
    for b in tad._unique_bundles(adapter.bundles):
        assert isinstance(b["adj"], TemporalCOO) and b["op_choice"]["branch"] == "unpacked"
    (key,) = res_t
    assert_rows_close(res_t[key], np.asarray(res_j[key]), None, None, cfg_t)


def test_uci_tmgcn_lp_auto_runs_like_jax(monkeypatch, tmp_path):
    """The full-row 2-layer operator every epoch; the preset diverges in
    both packages past these epochs (test_torch_registry_uci_divergence)."""
    if not jnative.available():
        pytest.skip("the JAX package's C++ sampler did not load: it draws other negatives")
    cfg_t, cfg_j = _edge_cfgs("uci_tmgcn_lp")
    with raw_copies(tmp_path, ["uci"]) as copies:
        dirs = {side: copies[side]["uci"] for side in copies}
        res_t, res_j, adapter = run_both(monkeypatch, cfg_t, cfg_j, EPOCHS, dirs,
                                         cfg_t.alpha_vec[:1])
    b = adapter.bundles["train"]
    assert isinstance(b["adj"], TemporalCOO) and "readout" in b and "l2op" not in b
    (key,) = res_t
    assert_rows_close(res_t[key], np.asarray(res_j[key]), None, None, cfg_t)


def test_seir_wdgcn_reg_tuned_auto_runs_like_jax(monkeypatch):
    """WD-GCN regression propagates through the operator every step."""
    cfg_t = dataclasses.replace(tpresets.get_preset("seir_wdgcn_reg_tuned"), **SMALL_SEIR,
                                eval_every=5, spmm_impl="auto")
    cfg_j = dataclasses.replace(jpresets.get_preset("seir_wdgcn_reg_tuned"), **SMALL_SEIR,
                                eval_every=5, spmm_impl="jnp")
    res_t, res_j, adapter = run_both(monkeypatch, cfg_t, cfg_j, 12)
    assert adapter.bundles["train"]["op_choice"]["branch"] == "unpacked"
    got, ref = res_t[(0, None)], res_j[(0, None)]
    assert got["train_loss"].shape == (12,) and np.all(np.isfinite(got["train_loss"]))
    assert_losses_close(got["train_loss"], ref["train_loss"])
    for k in ("val_l1", "val_l1_ratio", "test_l1", "test_l1_ratio"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)

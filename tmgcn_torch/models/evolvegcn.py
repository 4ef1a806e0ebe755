"""EvolveGCN-H: a GRU evolves the GCN weights across time (port of
tmgcn_tpu.models.evolvegcn).

At each time step a GRU cell updates the layer weight matrix from a top-k
summary of the current node embeddings, then the slice is propagated with
the evolved weights. As in the JAX package the top-k summaries depend only
on the features and the scoring vector p, so they are taken for all slices
at once, and the sequential loop carries only the (F, k) GRU.

Capability reference: IBM/TM-GCN TensorGCN-master/evolvegcn_functions.py —
EvolveGCN_1_layer :22-101, EvolveGCN_2_layer :104-213; summarize (top-k
scored by the learned vector p) :80-84, GRU cell g :86-91, GCONV :97-101.
The initial weights W_init are deliberately non-learned random buffers
threaded from training into the val/test forwards
(experiment_bitcoin_evolvegcn.py:132-148); ``apply`` therefore takes
optional explicit initial weights and always returns the evolved finals.

Top-k: ``jax.lax.top_k`` orders equal scores by the lower index; the port
takes the first k of a stable descending sort, which orders them the same
way (``torch.topk`` promises no order among equal values on CUDA, and
degree features tie often).
"""

from __future__ import annotations

import dataclasses

import torch

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.common import linear_head, randn
from tmgcn_torch.ops.edge_readout import edge_readout
from tmgcn_torch.ops.spmm import spmm, spmm_slice

_GATES = "ZRH"


def _promote(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both in their promoted dtype, as jnp promotes mixed operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _scores(X: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """X @ p / ||p||, the norm written as jnp.linalg.norm computes it."""
    X, p = _promote(X, p)
    return torch.matmul(X, p) / torch.sqrt(torch.sum(p * p))


def _top_k(y: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, equal values
    in index order: ``jax.lax.top_k``'s order."""
    idx = torch.sort(y, dim=-1, descending=True, stable=True).indices[..., :k]
    return y.gather(-1, idx), idx


def summarize(X: torch.Tensor, p: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k node summary: rows of X scored/scaled by X @ p / ||p||."""
    top_y, idx = _top_k(_scores(X, p), k)
    return X[idx].to(top_y.dtype) * top_y[:, None]


def gru_cell(cell: dict, Xs: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """The weight-evolution GRU: inputs (F, k) summary, carry (F, k) W."""
    Z = torch.sigmoid(cell["W_Z"] @ Xs + cell["U_Z"] @ H + cell["B_Z"])
    R = torch.sigmoid(cell["W_R"] @ Xs + cell["U_R"] @ H + cell["B_R"])
    Ht = torch.tanh(cell["W_H"] @ Xs + cell["U_H"] @ (R * H) + cell["B_H"])
    return (1.0 - Z) * H + Z * Ht


def _init_cell(generator: torch.Generator, f_in: int, f_out: int, dtype, device=None) -> dict:
    """Standard-normal p, then W_g, U_g, B_g for g in Z, R, H."""
    cell = {"p": randn(generator, (f_in,), dtype, device)}
    for g in _GATES:
        cell[f"W_{g}"] = randn(generator, (f_in, f_in), dtype, device)
        cell[f"U_{g}"] = randn(generator, (f_in, f_in), dtype, device)
        cell[f"B_{g}"] = randn(generator, (f_in, f_out), dtype, device)
    return cell


def _evolve_step(cell: dict, W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """W_t = GRU(summarize(X_t, k)^T, W_{t-1})."""
    return gru_cell(cell, summarize(x, cell["p"], W.shape[1]).T, W)


def batched_summaries(cell: dict, X: torch.Tensor, k: int) -> torch.Tensor:
    """All slices' GRU inputs summarize(X_t, p, k)^T at once: (T, F, k).

    The same math as ``summarize`` per slice: the summaries depend only on
    the features and the fixed scoring vector p, not on the evolving
    weights, so the top-k and the gather run once for all T slices.
    """
    top_y, idx = _top_k(_scores(X, cell["p"]), k)  # (T, k)
    F = X.shape[-1]
    S = X.gather(1, idx[..., None].expand(-1, -1, F)).to(top_y.dtype) * top_y[..., None]
    return S.transpose(1, 2)


def evolve_weight_stack(
    cell: dict, X: torch.Tensor, W0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched summaries + a GRU-only loop: (final W, (T, *W.shape) stack).

    The input-side gate contributions ``W_g @ S_t`` depend only on the
    summaries, so they are three batched matmuls before the loop; each step
    keeps only the recurrent ``U_g @ W`` halves, with U_Z/U_R stacked into
    one matmul (each output element the same length-F dot product). The
    bias is added after the recurrent term, in gru_cell's summation order
    (W@Xs + U@H) + B, as the JAX package's scan adds it.
    """
    return evolve_from_summaries(cell, batched_summaries(cell, X, W0.shape[1]), W0)


def evolve_from_summaries(
    cell: dict, S: torch.Tensor, W0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``evolve_weight_stack``'s GRU-only loop on given (T, F, k) summaries
    (the sharded 2-layer forward takes its layer-2 summaries from a
    distributed top-k)."""
    pre = {g: torch.matmul(cell[f"W_{g}"], S) for g in _GATES}  # (T, F, k) each
    UZR = torch.cat([cell["U_Z"], cell["U_R"]], dim=0)  # (2F, F)
    BZR = torch.stack([cell["B_Z"], cell["B_R"]])
    U_H, B_H = cell["U_H"], cell["B_H"]
    f = U_H.shape[0]
    W = W0
    Ws = []
    # unbind, not pre[t]: its backward stacks the T step gradients once,
    # where T indexings would each add a full-size gradient.
    for zr_t, h_t in zip(torch.stack([pre["Z"], pre["R"]], dim=1).unbind(0), pre["H"].unbind(0)):
        Z, R = torch.sigmoid((zr_t + (UZR @ W).reshape(2, f, -1)) + BZR).unbind(0)
        Ht = torch.tanh((h_t + U_H @ (R * W)) + B_H)
        W = (1.0 - Z) * W + Z * Ht
        Ws.append(W)
    return W, torch.stack(Ws)


def _slice_stream(A: TemporalCOO, device: torch.device):
    """The (T, P) rows, cols and vals of A on ``device``, one slice each."""
    return (torch.as_tensor(a, device=device).unbind(0) for a in (A.rows, A.cols, A.vals))


def apply_slice_weights(AX: torch.Tensor, Ws: torch.Tensor) -> torch.Tensor:
    """(T, N, F) x (T, F, K) -> (T, N, K), promoting as the JAX einsum does."""
    AX, Ws = _promote(AX, Ws)
    return torch.bmm(AX, Ws)


@dataclasses.dataclass(frozen=True)
class EvolveGCN:
    """EvolveGCN-H with 1 or 2 layers and edge-readout head.

    hidden_feat = [F1, C] or [F1, F2, C].
    """

    n_slices: int
    in_feat: int
    hidden_feat: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    # Stored embeddings dtype: the reference keeps GRU/GCONV math in
    # float64 but writes per-slice outputs into a float32 buffer
    # (evolvegcn_functions.py:66,164); None means same as dtype.
    embed_dtype: torch.dtype | None = None

    @property
    def store_dtype(self) -> torch.dtype:
        return self.embed_dtype if self.embed_dtype is not None else self.dtype

    @property
    def n_layers(self) -> int:
        return len(self.hidden_feat) - 1

    def init(self, generator: torch.Generator, device: str | torch.device | None = None) -> dict:
        """Standard-normal cell1, W_init1, U (, cell2, W_init2), drawn from
        ``generator`` in the JAX package's name order. W_init1/W_init2 are
        frozen buffers, never trained."""
        if self.n_layers not in (1, 2):
            raise ValueError("EvolveGCN supports 1 or 2 layers")
        f = (self.in_feat,) + tuple(self.hidden_feat)
        params = {"cell1": _init_cell(generator, f[0], f[1], self.dtype, device)}
        buffers = {"W_init1": randn(generator, (f[0], f[1]), self.dtype, device)}
        params["U"] = randn(generator, (2 * f[-2], f[-1]), self.dtype, device)
        if self.n_layers == 2:
            params["cell2"] = _init_cell(generator, f[1], f[2], self.dtype, device)
            buffers["W_init2"] = randn(generator, (f[1], f[2]), self.dtype, device)
        return {"params": params, "buffers": buffers}

    def propagate(self, A: TemporalCOO, X: torch.Tensor) -> torch.Tensor:
        """AX per slice — constant across training epochs, cacheable.

        GCONV computes (A @ X) @ W_t (evolvegcn_functions.py:97-101); with
        AX cached the 1-layer model runs no SpMM at all, and the 2-layer
        one keeps only its layer-2 (parameter-dependent) SpMM. Plain
        ``spmm``, as in the JAX package: no ``spmm_impl`` reaches EvolveGCN.
        """
        return spmm(A, X)

    def evolved_weights(
        self,
        variables: dict,
        X: torch.Tensor,
        W_init: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """1-layer weight evolution alone: (final W, (T, F0, F1) stack)."""
        if self.n_layers != 1:
            raise ValueError("evolved_weights is the 1-layer trajectory")
        W0 = variables["buffers"]["W_init1"] if W_init is None else W_init
        return evolve_weight_stack(variables["params"]["cell1"], X, W0)

    def embed_and_weights(
        self,
        variables: dict,
        A: TemporalCOO,
        X: torch.Tensor,
        W_init: torch.Tensor | None = None,
        W_init2: torch.Tensor | None = None,
        AX: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """(T, N, F_last) embeddings and the final weights of each layer."""
        p, b = variables["params"], variables["buffers"]
        W0 = b["W_init1"] if W_init is None else W_init

        if self.n_layers == 1:
            if AX is not None:
                # Batched summaries and propagation: the loop is only the
                # (F0, F1)-sized GRU; the (T, N, F) work runs as single ops.
                W_fin, Ws = evolve_weight_stack(p["cell1"], X, W0)
                return apply_slice_weights(AX, Ws).to(self.store_dtype), (W_fin,)
            W, Y = W0, []
            for r, c, v, x in zip(*_slice_stream(A, X.device), X.unbind(0)):
                W = _evolve_step(p["cell1"], W, x)
                h = torch.matmul(*_promote(spmm_slice(r, c, v, x, A.n_nodes), W))
                Y.append(h.to(self.store_dtype))
            return torch.stack(Y), (W,)

        W20 = b["W_init2"] if W_init2 is None else W_init2
        if AX is not None:
            # Layer-1 summaries depend only on X, so W1 evolves first; H1
            # then materializes in one batched matmul, which makes the
            # layer-2 summaries batchable too, and the layer-2 propagation
            # runs as ONE batched SpMM instead of T per-slice ones.
            W_fin, W1s = evolve_weight_stack(p["cell1"], X, W0)
            H1 = torch.relu(apply_slice_weights(AX, W1s))
            W2_fin, W2s = evolve_weight_stack(p["cell2"], H1, W20)
            Y = apply_slice_weights(spmm(A, H1), W2s)
            return Y.to(self.store_dtype), (W_fin, W2_fin)
        W, W2, Y = W0, W20, []
        for r, c, v, x in zip(*_slice_stream(A, X.device), X.unbind(0)):
            W = _evolve_step(p["cell1"], W, x)
            h = torch.relu(torch.matmul(*_promote(spmm_slice(r, c, v, x, A.n_nodes), W)))
            W2 = _evolve_step(p["cell2"], W2, h)
            h = torch.matmul(*_promote(spmm_slice(r, c, v, h, A.n_nodes), W2))
            Y.append(h.to(self.store_dtype))
        return torch.stack(Y), (W, W2)

    def apply(
        self,
        variables: dict,
        A: TemporalCOO,
        X: torch.Tensor,
        edges: torch.Tensor,
        W_init: torch.Tensor | None = None,
        W_init2: torch.Tensor | None = None,
        AX: torch.Tensor | None = None,
        readout_op=None,
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """((E, C) logits, evolved final weights); the readout through
        ``readout_op(Y, U)`` (a plan) if given."""
        Y, finals = self.embed_and_weights(variables, A, X, W_init, W_init2, AX)
        U = variables["params"]["U"]
        if readout_op is not None:
            return readout_op(Y, U), finals
        return edge_readout(Y, edges, U), finals


@dataclasses.dataclass(frozen=True)
class EvolveGCNReg:
    """1-layer EvolveGCN-H with a per-node linear regression head -> (T, N).

    As in the JAX package, which departs from the reference on purpose:
    the reference's SEIR script passes val/test data to a forward that
    ignores it without an explicit W_init (evolvegcn_functions.py:341-347
    falls back to the cached training tensors), so its val/test numbers
    re-score the training window; this model evaluates the data given,
    each window's weights evolving from W_init1 unless ``W_init`` is given.
    """

    n_slices: int
    in_feat: int
    hidden_feat: tuple[int, int]
    dtype: torch.dtype = torch.float32
    embed_dtype: torch.dtype | None = None

    @property
    def store_dtype(self) -> torch.dtype:
        return self.embed_dtype if self.embed_dtype is not None else self.dtype

    def init(self, generator: torch.Generator, device: str | torch.device | None = None) -> dict:
        """Standard-normal cell1 and W_init1, then the head (``linear_head``),
        drawn from ``generator`` in the JAX package's name order. W_init1
        is a frozen buffer."""
        f0, (f1, _) = self.in_feat, self.hidden_feat
        cell1 = _init_cell(generator, f0, f1, self.dtype, device)
        W_init1 = randn(generator, (f0, f1), self.dtype, device)
        lin_w, lin_b = linear_head(generator, f1, self.dtype, device)
        return {"params": {"cell1": cell1, "lin_w": lin_w, "lin_b": lin_b},
                "buffers": {"W_init1": W_init1}}

    def propagate(self, A: TemporalCOO, X: torch.Tensor) -> torch.Tensor:
        """AX per slice — constant across training epochs, cacheable; the
        plain ``spmm``, as in the JAX package."""
        return spmm(A, X)

    def apply(
        self,
        variables: dict,
        A: TemporalCOO,
        X: torch.Tensor,
        W_init: torch.Tensor | None = None,
        AX: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """(T, N) node outputs: from the cached AX by the GRU-only weight
        loop and one batched matmul, else one SpMM per slice in the loop."""
        p = variables["params"]
        W0 = variables["buffers"]["W_init1"] if W_init is None else W_init
        if AX is not None:
            _, Ws = evolve_weight_stack(p["cell1"], X, W0)
            Y = apply_slice_weights(AX, Ws).to(self.store_dtype)
        else:
            W, Y = W0, []
            for r, c, v, x in zip(*_slice_stream(A, X.device), X.unbind(0)):
                W = _evolve_step(p["cell1"], W, x)
                h = torch.matmul(*_promote(spmm_slice(r, c, v, x, A.n_nodes), W))
                Y.append(h.to(self.store_dtype))
            Y = torch.stack(Y)
        out = torch.matmul(Y, p["lin_w"].to(Y.dtype)) + p["lin_b"].to(Y.dtype)
        return out[..., 0]

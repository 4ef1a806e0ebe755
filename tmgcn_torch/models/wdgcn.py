"""WD-GCN: one GCN layer followed by a per-node LSTM over time (port of
tmgcn_tpu.models.wdgcn).

One per-slice graph convolution produces (T, N, F1) embeddings; a single
LSTM cell with weights shared across nodes then scans the time axis, all
nodes batched in one matmul per step.

Capability reference: IBM/TM-GCN TensorGCN-master/wd_gcn_functions.py —
WD_GCN :21-98, WD_GCN_reg :100-169. Two reference quirks reproduced for parity: the candidate
cell state uses a *sigmoid* (not tanh, wd_gcn_functions.py:94), and the
edge-readout matrix U is a frozen random tensor, never trained (:55) — it
lives in ``buffers`` here. The LSTM initial states h/c are likewise frozen
random buffers.

The scan state runs transposed, (F, N), as in the JAX package, so the
port computes the same per-gate dot products in the same order. The gate
pre-activations stack in the order f, j, o, c (W and b) to match the
recurrent U concatenated as [Uf, Uj, Uo, Uc].

On the card the scan is one hand-written kernel pair (``kernels/scan_cuda``):
a float32 CUDA input with F up to the kernels' cap takes it, whatever
``remat`` says; anything else (the CPU, float64, a larger F) runs the eager
scans below.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import scan_cuda
from tmgcn_torch.models.common import linear_head, randn
from tmgcn_torch.ops.edge_readout import edge_readout
from tmgcn_torch.ops.spmm import spmm

_GATES = "fjoc"  # the stacking order of the gate pre-activations


def _init_lstm(
    generator: torch.Generator, f: int, dtype: torch.dtype, device=None
) -> tuple[dict, dict]:
    """Standard-normal LSTM weights (params) and initial states (buffers).

    Drawn in the JAX package's name order — W, U for gates f, j, c, o,
    then the biases, then h_init, c_init — from one generator.
    """
    params = {}
    for w in ("W", "U"):
        for g in "fjco":
            params[f"{w}{g}"] = randn(generator, (f, f), dtype, device)
    for g in "fjco":
        params[f"b{g}"] = randn(generator, (f,), dtype, device)
    buffers = {
        "h_init": randn(generator, (f,), dtype, device),
        "c_init": randn(generator, (f,), dtype, device),
    }
    return params, buffers


# Above this many elements in the hoisted (T, 4, F, N) pre-gate tensor, the
# scan switches to the rematerialized in-body path: the hoisted stack, its
# saved copy and its gradient are ~4 buffers of T*4*F*N floats. The JAX
# package's budget, kept as it is so both take the same path.
_PRE_BUDGET_ELEMS = 1 << 28


def _recurrent_weights(p: dict) -> torch.Tensor:
    """(F, 4F): the recurrent weights stacked on the output axis."""
    return torch.cat([p["Uf"], p["Uj"], p["Uo"], p["Uc"]], dim=1)


def _stacked_weights(p: dict, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """W (F, 4F), U (F, 4F) and b (4F,), each stacked in the order f, j, o, c."""
    W = torch.cat([p[f"W{g}"].to(dtype) for g in _GATES], dim=1)
    return W, _recurrent_weights(p), torch.cat([p[f"b{g}"] for g in _GATES])


def _on_kernel(p: dict, Y: torch.Tensor) -> bool:
    """Whether the scan kernel pair takes this input: float32 on the card,
    F no greater than its register cap."""
    return Y.is_cuda and Y.dtype == torch.float32 and p["Uf"].shape[0] <= scan_cuda.MAX_F


def _lstm_scan_kernel(p: dict, h0, c0, Yt: torch.Tensor) -> torch.Tensor:
    """(T, F, N) -> (T, F, N) through the kernel pair, which reads Yt
    through its strides: no copy of a transposed view."""
    return scan_cuda.lstm_scan_cuda(Yt, *_stacked_weights(p, Yt.dtype), h0, c0)


def _cell(z: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One LSTM update from (4, F, N) pre-activations; sigmoid candidate."""
    f, j, o, ct = torch.sigmoid(z).unbind(0)
    c = j * ct + f * c
    return o * torch.tanh(c), c


def _initial_state(h0, c0, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    return h0[:, None].expand(-1, n), c0[:, None].expand(-1, n)


def _lstm_scan_pre(p: dict, h0, c0, pre: torch.Tensor) -> torch.Tensor:
    """Scan over precomputed (T, 4, F, N) gate contributions -> (T, F, N)."""
    U = _recurrent_weights(p)
    F = p["Uf"].shape[0]
    n = pre.shape[-1]
    h, c = _initial_state(h0, c0, n)
    Z = []
    # unbind, not pre[t]: its backward stacks the T step gradients once,
    # where T indexings would each add a full-size gradient.
    for pre_t in pre.unbind(0):
        h, c = _cell(pre_t + (U.T @ h).reshape(4, F, n), c)  # one (4F, F)@(F, N)
        Z.append(h)
    return torch.stack(Z)


def _remat_step(W, U, b, y, h, c):
    F = h.shape[0]
    z = ((W.T @ y + b[:, None]) + U.T @ h).reshape(4, F, -1)
    return _cell(z, c)


def _lstm_scan_remat(p: dict, h0, c0, Yt: torch.Tensor) -> torch.Tensor:
    """Memory-lean scan: gates computed per step from (T, F, N).

    Each step runs under ``torch.utils.checkpoint``, so the backward
    recomputes its gate pre-activations instead of keeping a (T, 4, F, N)
    stack alive. The same per-gate dot lengths as ``_lstm_scan_pre``
    (Wᵀy + b first, + Uᵀh second). The step draws no random numbers, so
    the checkpoint keeps no RNG state (``preserve_rng_state=False``): that
    would read the CUDA generator's state, which a graph capture refuses.
    """
    W, U, b = _stacked_weights(p, Yt.dtype)
    h, c = _initial_state(h0, c0, Yt.shape[-1])
    Z = []
    for y in Yt.unbind(0):
        h, c = checkpoint(_remat_step, W, U, b, y, h, c, use_reentrant=False,
                          preserve_rng_state=False)
        Z.append(h)
    return torch.stack(Z)


def _pre_gates(p: dict, Y: torch.Tensor, equation: str) -> torch.Tensor:
    """(T, 4, F, N) input-gate contributions, bias folded in."""
    return torch.stack(
        [torch.einsum(equation, p[f"W{g}"].to(Y.dtype), Y) + p[f"b{g}"][:, None] for g in _GATES],
        dim=1,
    )


def lstm_scan(
    params: dict, h0, c0, Y: torch.Tensor, unroll: int | None = None, remat: bool | None = None
) -> torch.Tensor:
    """Scan the shared-weight LSTM over (T, N, F) -> (T, N, F).

    On the card (``_on_kernel``) the kernel pair scans, whatever ``remat``
    says: it saves Z and the cell states alone, no more than either eager
    path. Elsewhere remat=None takes the checkpointed path when the hoisted
    pre-gate stack would exceed ``_PRE_BUDGET_ELEMS``. ``unroll`` is the JAX
    package's scan-unroll knob and has no meaning in eager PyTorch; it is
    accepted and ignored.
    """
    del unroll
    if _on_kernel(params, Y):
        return _lstm_scan_kernel(params, h0, c0, Y.transpose(1, 2)).transpose(1, 2)
    if remat is None:
        remat = Y.numel() * 4 > _PRE_BUDGET_ELEMS
    if remat:
        return _lstm_scan_remat(params, h0, c0, Y.transpose(1, 2)).transpose(1, 2)
    pre = _pre_gates(params, Y, "fk,tnf->tkn")
    return _lstm_scan_pre(params, h0, c0, pre).transpose(1, 2)


def lstm_scan_t(
    params: dict, h0, c0, Yt: torch.Tensor, unroll: int | None = None, remat: bool | None = None
) -> torch.Tensor:
    """lstm_scan on a transposed (T, F, N) input -> (T, N, F) output.

    The gate contributions are batched (F, F) @ (F, N) matmuls on the
    (F, N) layout; one transpose at the end returns the readout's layout.
    On the card the kernel pair scans, as in ``lstm_scan``; ``unroll`` is
    accepted and ignored.
    """
    del unroll
    if _on_kernel(params, Yt):
        return _lstm_scan_kernel(params, h0, c0, Yt).transpose(1, 2)
    if remat is None:
        remat = Yt.numel() * 4 > _PRE_BUDGET_ELEMS
    if remat:
        return _lstm_scan_remat(params, h0, c0, Yt).transpose(1, 2)
    pre = _pre_gates(params, Yt, "kg,tkn->tgn")
    return _lstm_scan_pre(params, h0, c0, pre).transpose(1, 2)


@dataclasses.dataclass(frozen=True)
class WDGCN:
    """WD-GCN with edge-readout head. hidden_feat = [F1, C]."""

    n_slices: int
    in_feat: int
    hidden_feat: tuple[int, int]
    dtype: torch.dtype = torch.float32
    spmm_impl: str = "jnp"
    # The JAX package's LSTM scan-unroll override; eager PyTorch has no
    # unroll, so it is accepted and ignored.
    scan_unroll: int | None = None

    def init(self, generator: torch.Generator, device: str | torch.device | None = None) -> dict:
        """Standard-normal W, LSTM, then U, drawn from ``generator``.

        U, h_init and c_init are frozen buffers, never trained
        (wd_gcn_functions.py:55).
        """
        f0, (f1, c) = self.in_feat, self.hidden_feat
        W = randn(generator, (f0, f1), self.dtype, device)
        lstm_params, lstm_buffers = _init_lstm(generator, f1, self.dtype, device)
        U = randn(generator, (2 * f1, c), self.dtype, device)
        return {"params": {"W": W, "lstm": lstm_params}, "buffers": {"U": U, **lstm_buffers}}

    def propagate(self, A: TemporalCOO, X: torch.Tensor) -> torch.Tensor:
        """AX — parameter-independent, cacheable (wd_gcn_functions.py:33)."""
        return spmm(A, X, impl=self.spmm_impl)

    def embed(
        self,
        variables: dict,
        A: TemporalCOO,
        X: torch.Tensor,
        AX: torch.Tensor | None = None,
        AXt: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """(T, N, F1) LSTM outputs; from the transposed (T, F0, N) AXt if given."""
        p, b = variables["params"], variables["buffers"]
        if AXt is not None:
            AXt = AXt.to(self.dtype)  # reference f32 buffer truncation
            Yt = torch.relu(torch.einsum("fk,tfn->tkn", p["W"].to(self.dtype), AXt))
            return lstm_scan_t(p["lstm"], b["h_init"], b["c_init"], Yt)
        if AX is None:
            AX = self.propagate(A, X)
        AX = AX.to(self.dtype)  # reference f32 buffer truncation
        Y = torch.relu(torch.matmul(AX, p["W"].to(AX.dtype)))
        return lstm_scan(p["lstm"], b["h_init"], b["c_init"], Y)

    def apply(
        self,
        variables: dict,
        A: TemporalCOO,
        X: torch.Tensor,
        edges: torch.Tensor,
        AX: torch.Tensor | None = None,
        readout_op=None,
        AXt: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """(E, C) edge logits; through ``readout_op(Z, U)`` (a plan) if given."""
        Z = self.embed(variables, A, X, AX, AXt=AXt)
        U = variables["buffers"]["U"]
        if readout_op is not None:
            return readout_op(Z, U)
        return edge_readout(Z, edges, U)


@dataclasses.dataclass(frozen=True)
class WDGCNReg:
    """WD-GCN with a per-node linear regression head -> (T, N).

    As in the JAX package, which departs from the reference on purpose:
    the reference's regression forward ignores its (A, X) arguments unless
    edges are also passed (wd_gcn_functions.py:138-142), so its SEIR
    val/test numbers re-score the training window; this model evaluates
    the data given. Its propagation AX is recomputed at every call, as the
    JAX package's is (with ``spmm_impl="pallas"`` one K1 launch a step).
    """

    n_slices: int
    in_feat: int
    hidden_feat: tuple[int, int]
    dtype: torch.dtype = torch.float32
    spmm_impl: str = "jnp"

    def init(self, generator: torch.Generator, device: str | torch.device | None = None) -> dict:
        """Standard-normal W and LSTM, then the head (``linear_head``),
        drawn from ``generator``; h_init and c_init are frozen buffers."""
        f0, (f1, _) = self.in_feat, self.hidden_feat
        W = randn(generator, (f0, f1), self.dtype, device)
        lstm_params, lstm_buffers = _init_lstm(generator, f1, self.dtype, device)
        lin_w, lin_b = linear_head(generator, f1, self.dtype, device)
        return {
            "params": {"W": W, "lstm": lstm_params, "lin_w": lin_w, "lin_b": lin_b},
            "buffers": lstm_buffers,
        }

    def apply(
        self,
        variables: dict,
        A: TemporalCOO,
        X: torch.Tensor,
        AX: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """(T, N) node outputs."""
        p, b = variables["params"], variables["buffers"]
        if AX is None:
            AX = spmm(A, X, impl=self.spmm_impl)
        AX = AX.to(self.dtype)
        Y = torch.relu(torch.matmul(AX, p["W"].to(AX.dtype)))
        Z = lstm_scan(p["lstm"], b["h_init"], b["c_init"], Y)
        out = torch.matmul(Z, p["lin_w"].to(Z.dtype)) + p["lin_b"].to(Z.dtype)
        return out[..., 0]

"""Static (Kipf–Welling-style) GCN baseline on temporal slices (port of
tmgcn_tpu.models.gcn).

Per-slice graph convolution on the *untransformed* normalized adjacency —
no temporal mixing anywhere. Capability reference: EmbeddingKWGCN in
IBM/TM-GCN (TensorGCN-master/embedding_help_functions.py:425-497),
including its float64 interlayer cast in the 2-layer path (:486).
"""

from __future__ import annotations

import dataclasses

import torch

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.common import nonlinearity, randn
from tmgcn_torch.ops.edge_readout import edge_readout
from tmgcn_torch.ops.spmm import spmm


@dataclasses.dataclass(frozen=True)
class KWGCN:
    """1- or 2-layer per-slice GCN with edge-readout head.

    hidden_feat = [F1, C] (1 layer) or [F1, F2, C] (2 layers).
    """

    n_slices: int
    in_feat: int
    hidden_feat: tuple[int, ...]
    nonlin2: str = "relu"
    dtype: torch.dtype = torch.float32
    interlayer_dtype: torch.dtype | None = None
    spmm_impl: str = "jnp"

    @property
    def n_layers(self) -> int:
        return len(self.hidden_feat) - 1

    def init(self, generator: torch.Generator, device: str | torch.device | None = None) -> dict:
        """Standard-normal W1 (, W2) then U, drawn from ``generator``."""
        if self.n_layers not in (1, 2):
            raise ValueError("KWGCN supports 1 or 2 layers")
        f = (self.in_feat,) + tuple(self.hidden_feat)
        params = {"W1": randn(generator, (f[0], f[1]), self.dtype, device)}
        if self.n_layers == 2:
            params["W2"] = randn(generator, (f[1], f[2]), self.dtype, device)
        params["U"] = randn(generator, (2 * f[-2], f[-1]), self.dtype, device)
        return {"params": params, "buffers": {}}

    def propagate(self, C: TemporalCOO, X: torch.Tensor) -> torch.Tensor:
        """First-layer AX — parameter-independent, cacheable (the
        reference caches it at init, embedding_help_functions.py:464)."""
        return spmm(C, X, impl=self.spmm_impl)

    def embed(
        self,
        variables: dict,
        C: TemporalCOO,
        X: torch.Tensor,
        AX: torch.Tensor | None = None,
    ) -> torch.Tensor:
        p = variables["params"]
        if AX is None:
            AX = self.propagate(C, X)
        # The reference stores propagations in float32 buffers (t.zeros,
        # embedding_help_functions.py:470); the cast reproduces the truncation.
        AX = AX.to(self.dtype)
        if self.n_layers == 2:
            Y = nonlinearity(self.nonlin2)(torch.matmul(AX, p["W1"].to(AX.dtype)))
            if self.interlayer_dtype is not None:
                Y = Y.to(self.interlayer_dtype)
            AY = spmm(C, Y, impl=self.spmm_impl).to(self.dtype)
            return torch.matmul(AY, p["W2"].to(AY.dtype))
        return torch.matmul(AX, p["W1"].to(AX.dtype))

    def apply(
        self,
        variables: dict,
        C: TemporalCOO,
        X: torch.Tensor,
        edges: torch.Tensor,
        AX: torch.Tensor | None = None,
        readout_op=None,
    ) -> torch.Tensor:
        """(E, C) edge logits; through ``readout_op(Z, U)`` (a plan) if given."""
        Z = self.embed(variables, C, X, AX).to(self.dtype)
        U = variables["params"]["U"]
        if readout_op is not None:
            return readout_op(Z, U)
        return edge_readout(Z, edges, U)

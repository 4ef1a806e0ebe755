"""TM-GCN: tensor M-product graph convolution (port of tmgcn_tpu.models.tmgcn).

A TM-GCN layer propagates node features through the M-transformed
normalized adjacency tensor Ct:

    layer(X) = Ct ⊛ (M ×₁ X) · W        (⊛ = per-slice SpMM)

optionally followed by the inverse transform M⁻¹ ×₁. All T slices run as
one batched SpMM and one matmul.

Capability reference (IBM/TM-GCN, TensorGCN-master/
embedding_help_functions.py): EmbeddingGCN :156-234 (1 layer). The 2-layer
and regression variants are not ported yet (ROADMAP queue 1, items 5
and 11).
"""

from __future__ import annotations

import dataclasses

import torch

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.common import randn
from tmgcn_torch.ops.edge_readout import edge_readout, edge_readout_bilinear
from tmgcn_torch.ops.mtransform import m_transform, m_transform_inverse
from tmgcn_torch.ops.spmm import spmm


@dataclasses.dataclass(frozen=True)
class TMGCN:
    """1-layer TM-GCN with edge-readout head.

    hidden_feat = [F1, C]: F1 embedding features, C output classes.
    """

    n_slices: int
    in_feat: int
    hidden_feat: tuple[int, int]
    condensed_W: bool = True
    use_Minv: bool = False
    dtype: torch.dtype = torch.float32
    spmm_impl: str = "jnp"
    # "concat" = the reference's additive head [Y_src, Y_trg] @ U
    # (U in R^{2F x C}); "bilinear" = (Y_src ⊙ Y_trg) @ U (U in R^{F x C}).
    readout: str = "concat"

    def init(
        self, generator: torch.Generator, device: str | torch.device | None = None
    ) -> dict:
        """Standard-normal W then U, drawn from ``generator``."""
        f0, (f1, c) = self.in_feat, self.hidden_feat
        w_shape = (f0, f1) if self.condensed_W else (self.n_slices, f0, f1)
        u_rows = f1 if self.readout == "bilinear" else 2 * f1
        return {
            "params": {
                "W": randn(generator, w_shape, self.dtype, device),
                "U": randn(generator, (u_rows, c), self.dtype, device),
            },
            "buffers": {},
        }

    def propagate(self, Ct: TemporalCOO, X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
        """AtXt = Ct ⊛ (M ×₁ X) — parameter-independent, cacheable.

        The reference computes this once at model construction and trains
        on the cached tensor (embedding_help_functions.py:195); the
        adapters do the same.
        """
        return spmm(Ct, m_transform(M, X), impl=self.spmm_impl)

    def embed(
        self,
        variables: dict,
        Ct: TemporalCOO,
        X: torch.Tensor,
        M: torch.Tensor,
        AtXt: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """(T, N, F1) node embeddings (the pre-readout tensor Y)."""
        if AtXt is None:
            AtXt = self.propagate(Ct, X, M)
        # The reference stores the cached propagation in a float32 buffer
        # regardless of input precision (t.zeros default dtype,
        # embedding_help_functions.py:205); casting to the model dtype
        # reproduces that truncation point exactly.
        AtXt = AtXt.to(self.dtype)
        Y = torch.matmul(AtXt, variables["params"]["W"].to(AtXt.dtype))
        if self.use_Minv:
            Y = m_transform_inverse(M, Y)
        return Y

    def apply(
        self,
        variables: dict,
        Ct: TemporalCOO,
        X: torch.Tensor,
        edges: torch.Tensor,
        M: torch.Tensor,
        AtXt: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """(E, C) edge logits."""
        Y = self.embed(variables, Ct, X, M, AtXt)
        U = variables["params"]["U"]
        if self.readout == "bilinear":
            return edge_readout_bilinear(Y, edges, U)
        return edge_readout(Y, edges, U)

"""TM-GCN: tensor M-product graph convolution (port of tmgcn_tpu.models.tmgcn).

A TM-GCN layer propagates node features through the M-transformed
normalized adjacency tensor Ct:

    layer(X) = Ct ⊛ (M ×₁ X) · W        (⊛ = per-slice SpMM)

optionally followed by the inverse transform M⁻¹ ×₁. All T slices run as
one batched SpMM and one matmul.

Capability reference (IBM/TM-GCN, TensorGCN-master/
embedding_help_functions.py): EmbeddingGCN :156-234 (1 layer),
EmbeddingGCN2 :236-357 (2 layers, nonlin2/apply_M_twice/
apply_M_three_times options, float64 interlayer cast :335 and float32 head
cast :355), EmbeddingGCN_reg :359-423 (regression head).
"""

from __future__ import annotations

import dataclasses

import torch

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.models.common import linear_head, nonlinearity, randn
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
        readout_op=None,
    ) -> torch.Tensor:
        """(E, C) edge logits. ``readout_op(Y, U)``, where given, replaces the
        concat readout over ``edges`` (the adapters' ReadoutPlan)."""
        Y = self.embed(variables, Ct, X, M, AtXt)
        U = variables["params"]["U"]
        if self.readout == "bilinear":
            return edge_readout_bilinear(Y, edges, U)
        if readout_op is not None:
            return readout_op(Y, U)
        return edge_readout(Y, edges, U)


@dataclasses.dataclass(frozen=True)
class TMGCN2:
    """2-layer TM-GCN with edge-readout head.

    hidden_feat = [F1, F2, C]. The second layer reuses the same Ct; with
    use_Minv=False the default is a plain propagation of the layer-1
    output, apply_M_twice re-mixes it through M first, and
    apply_M_three_times applies M once more after layer 2 (the UCI
    link-prediction configuration).

    interlayer_dtype mirrors the reference's ``Y = Y.double()`` between
    layers (float64 for parity runs; None keeps the model dtype).
    """

    n_slices: int
    in_feat: int
    hidden_feat: tuple[int, int, int]
    condensed_W: bool = True
    use_Minv: bool = False
    apply_M_twice: bool = False
    apply_M_three_times: bool = False
    nonlin2: str = "relu"
    dtype: torch.dtype = torch.float32
    interlayer_dtype: torch.dtype | None = None
    spmm_impl: str = "jnp"

    def __post_init__(self):
        if self.apply_M_three_times and not self.apply_M_twice:
            raise ValueError(
                "apply_M_three_times requires apply_M_twice (the third "
                "mixing happens inside the M-twice branch, "
                "embedding_help_functions.py:342-346)"
            )

    def init(
        self, generator: torch.Generator, device: str | torch.device | None = None
    ) -> dict:
        """Standard-normal W1, W2 then U, drawn from ``generator``."""
        f0, (f1, f2, c) = self.in_feat, self.hidden_feat
        if self.condensed_W:
            w1_shape, w2_shape = (f0, f1), (f1, f2)
        else:
            w1_shape = (self.n_slices, f0, f1)
            w2_shape = (self.n_slices, f1, f2)
        return {
            "params": {
                "W1": randn(generator, w1_shape, self.dtype, device),
                "W2": randn(generator, w2_shape, self.dtype, device),
                "U": randn(generator, (2 * f2, c), self.dtype, device),
            },
            "buffers": {},
        }

    def propagate(self, Ct: TemporalCOO, X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
        """First-layer AtXt — parameter-independent, cacheable."""
        return spmm(Ct, m_transform(M, X), impl=self.spmm_impl)

    def embed(
        self,
        variables: dict,
        Ct: TemporalCOO,
        X: torch.Tensor,
        M: torch.Tensor,
        AtXt: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """(T, N, F2) layer-2 embeddings."""
        p = variables["params"]
        nonlin = nonlinearity(self.nonlin2)

        if AtXt is None:
            AtXt = self.propagate(Ct, X, M)
        AtXt = AtXt.to(self.dtype)  # reference f32 buffer truncation
        Y = torch.matmul(AtXt, p["W1"].to(AtXt.dtype))
        if self.use_Minv:
            Y = m_transform_inverse(M, Y)
        Y = nonlin(Y)
        if self.interlayer_dtype is not None:
            Y = Y.to(self.interlayer_dtype)

        # Second-layer propagations run at Y's precision but land in the
        # reference's float32 buffers (compute_AX/compute_AtXt use t.zeros,
        # embedding_help_functions.py:302,309) — hence the dtype casts.
        W2 = p["W2"].to(self.dtype)
        if self.use_Minv:
            AtYt = spmm(Ct, m_transform(M, Y), impl=self.spmm_impl).to(self.dtype)
            return m_transform_inverse(M, torch.matmul(AtYt, W2))
        if self.apply_M_twice:
            AtYt = spmm(Ct, m_transform(M, Y), impl=self.spmm_impl).to(self.dtype)
            Z = torch.matmul(AtYt, W2)
            if self.apply_M_three_times:
                # Reference upcasts to float64 for the final mixing
                # (embedding_help_functions.py:346).
                up = self.interlayer_dtype if self.interlayer_dtype is not None else Z.dtype
                Z = m_transform(M.to(up), Z.to(up))
            return Z
        AY = spmm(Ct, Y, impl=self.spmm_impl).to(self.dtype)
        return torch.matmul(AY, W2)

    def apply(
        self,
        variables: dict,
        Ct: TemporalCOO,
        X: torch.Tensor,
        edges: torch.Tensor,
        M: torch.Tensor,
        AtXt: torch.Tensor | None = None,
        readout_op=None,
    ) -> torch.Tensor:
        """(E, C) edge logits."""
        Z = self.embed(variables, Ct, X, M, AtXt)
        # Reference casts edge embeddings back to float32 at the head
        # (embedding_help_functions.py:355).
        Z = Z.to(self.dtype)
        U = variables["params"]["U"]
        if readout_op is not None:
            return readout_op(Z, U)
        return edge_readout(Z, edges, U)


@dataclasses.dataclass(frozen=True)
class TMGCNReg:
    """1-layer TM-GCN with a per-node linear regression head -> (T, N).

    As in the JAX package, which departs from the reference on purpose:
    the reference's regression forward always uses the cached training
    propagation (embedding_help_functions.py:410-412), so its SEIR val/test
    numbers re-score the training window; this model evaluates the data
    given.
    """

    n_slices: int
    in_feat: int
    hidden_feat: tuple[int, int]
    condensed_W: bool = True
    use_Minv: bool = False
    dtype: torch.dtype = torch.float32
    spmm_impl: str = "jnp"

    def init(
        self, generator: torch.Generator, device: str | torch.device | None = None
    ) -> dict:
        """Standard-normal W, then the head (``linear_head``), drawn from
        ``generator``."""
        f0, (f1, _) = self.in_feat, self.hidden_feat
        w_shape = (f0, f1) if self.condensed_W else (self.n_slices, f0, f1)
        W = randn(generator, w_shape, self.dtype, device)
        lin_w, lin_b = linear_head(generator, f1, self.dtype, device)
        return {"params": {"W": W, "lin_w": lin_w, "lin_b": lin_b}, "buffers": {}}

    def propagate(self, Ct: TemporalCOO, X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
        """AtXt = Ct ⊛ (M ×₁ X) — parameter-independent, cacheable."""
        return spmm(Ct, m_transform(M, X), impl=self.spmm_impl)

    def apply(
        self,
        variables: dict,
        Ct: TemporalCOO,
        X: torch.Tensor,
        M: torch.Tensor,
        AtXt: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """(T, N) node outputs."""
        p = variables["params"]
        if AtXt is None:
            AtXt = self.propagate(Ct, X, M)
        AtXt = AtXt.to(self.dtype)  # reference f32 buffer truncation
        Y = torch.matmul(AtXt, p["W"].to(AtXt.dtype))
        if self.use_Minv:
            Y = m_transform_inverse(M, Y)
        out = torch.matmul(Y, p["lin_w"].to(Y.dtype)) + p["lin_b"].to(Y.dtype)
        return out[..., 0]

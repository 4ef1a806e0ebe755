"""Block-dense (BCSR-style) SpMM (port of tmgcn_tpu.ops.spmm_blockdense).

Each nonempty B x B block of the sparse operator is materialized densely,
host-side, once, and the SpMM runs as three dense matmuls in the (F, B)
block layout of the JAX package:

    YbT = pad(Y).panels^T                  # input, (ncb, F, B)
    G   = oh_cw @ YbT                      # block gather  (nb, F, B)
    P   = G @ AblkT                        # batched       (nb, F, B)
    Z^T = oh_rw @ P.reshape(nb, F*B)       # block scatter (nrb, F, B)

where oh_cw (nb, ncb) / oh_rw (nrb, nb) are 0/1 block incidences (dense
matrices, or nested block-dense operators over their staircase streams
past ``dense_limit``). The JAX package computes these with XLA dots outside
any Pallas kernel; here they are ``torch.matmul`` (cuBLAS on the card), and
autograd transposes each matmul.

Modes: ``exact``, every matmul and its gradients in float32 with TF32
off; ``fast``, all of them in TF32; ``bf16``, the blocks and the gathered
panels rounded to bf16, their products summed in float32 and written in
float32, the incidences and every gradient in float32. (The bf16 block
product runs with TF32 on: its operands are bf16 values, which TF32 holds
exactly, so nothing more is rounded.)

Capability reference: replaces the per-epoch A_t @ X_t loop of IBM/TM-GCN
(TensorGCN-master/embedding_help_functions.py:301-312) for layer-2
training.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from tmgcn_torch.core.sparse import to_device
from tmgcn_torch.ops.spmm_rowsplit import flatten_stream

DEFAULT_BLOCK = 128

_MODES = ("exact", "fast", "bf16")


@contextlib.contextmanager
def _tf32(enabled: bool):
    """TF32 on or off for the float32 matmuls inside, then as it was."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class _Matmul(torch.autograd.Function):
    """a @ b with TF32 on or off for the product and for its gradients."""

    @staticmethod
    def forward(ctx, a, b, tf32, tf32_grad):
        ctx.save_for_backward(a, b)
        ctx.tf32_grad = tf32_grad
        with _tf32(tf32):
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        with _tf32(ctx.tf32_grad):
            if ctx.needs_input_grad[0]:
                da = torch.matmul(g, b.transpose(-1, -2))
            if ctx.needs_input_grad[1]:
                db = torch.matmul(a.transpose(-1, -2), g)
        return da, db, None, None


def _matmul(a: torch.Tensor, b: torch.Tensor, mode: str, bf16_operands: bool = False):
    """a @ b under the mode's float32 setting (module docstring)."""
    fast = mode == "fast"
    return _Matmul.apply(a, b, fast or bf16_operands, fast)


def _apply_inc(inc, x2d: torch.Tensor, mode: str) -> torch.Tensor:
    """Apply a block incidence: a dense 0/1 matmul or a nested operator."""
    if isinstance(inc, BlockDenseOperator):
        return inc(x2d)
    return _matmul(inc.to(x2d.dtype), x2d, mode)


def _move(inc, device):
    """An incidence on ``device``: a nested operator or a 0/1 matrix."""
    return inc.to(device) if isinstance(inc, BlockDenseOperator) else to_device(inc, device)


@dataclasses.dataclass(frozen=True)
class BlockDenseOperator:
    """A prepacked rectangular block-dense operator: (n_in, F) -> (n_out, F).

    AblkT: (nb, B, B) dense blocks, each stored transposed (float32; bf16
        in "bf16" mode), so every intermediate keeps the block dimension
        last, as in the JAX package.
    oh_rw: output block-row incidence, a dense (nrb, nb) 0/1 matrix or a
        nested BlockDenseOperator over the incidence stream.
    oh_cw: input incidence, (nb, ncb) likewise.
    mode: "exact", "fast" or "bf16" (module docstring).

    The arrays are numpy on the host, or torch tensors after ``to``.
    """

    AblkT: np.ndarray | torch.Tensor
    oh_rw: object
    oh_cw: object
    n_in: int
    n_out: int
    block: int
    mode: str
    nrb: int
    ncb: int

    @property
    def n_blocks(self) -> int:
        return self.AblkT.shape[0]

    def to(self, device: str | torch.device) -> "BlockDenseOperator":
        AblkT = to_device(self.AblkT, device)
        if self.mode == "bf16":
            AblkT = AblkT.to(torch.bfloat16)
        return dataclasses.replace(
            self, AblkT=AblkT, oh_rw=_move(self.oh_rw, device),
            oh_cw=_move(self.oh_cw, device),
        )

    def __call__(self, flat: torch.Tensor) -> torch.Tensor:
        if not isinstance(self.AblkT, torch.Tensor):
            return self.to(flat.device)(flat)
        B = self.block
        F = flat.shape[-1]
        out_dtype = flat.dtype
        nb = self.AblkT.shape[0]
        nrb, ncb = self.nrb, self.ncb
        if nb == 0:
            return torch.zeros((self.n_out, F), dtype=out_dtype, device=flat.device)
        Yp = torch.nn.functional.pad(flat, (0, 0, 0, ncb * B - self.n_in))
        # (ncb, F, B) panels: one boundary transpose into the block layout.
        YbT = Yp.reshape(ncb, B, F).transpose(1, 2).reshape(ncb, F * B)
        G = _apply_inc(self.oh_cw, YbT, self.mode).reshape(nb, F, B)
        # P[b] = G[b] @ A[b]^T  <=>  (A[b] @ Y_panel[b])^T
        if self.mode == "bf16":
            P = _matmul(G.to(torch.bfloat16).float(), self.AblkT.float(), self.mode, True)
        else:
            P = _matmul(G.to(self.AblkT.dtype), self.AblkT, self.mode)  # float32, as in JAX
        Z = _apply_inc(self.oh_rw, P.reshape(nb, F * B), self.mode)
        Z = Z.reshape(nrb, F, B).transpose(1, 2).reshape(nrb * B, F)
        return Z[: self.n_out].to(out_dtype)


def estimate(
    rows: np.ndarray, cols: np.ndarray, block: int = DEFAULT_BLOCK, itemsize: int = 4
) -> dict:
    """Host-side cost preview: block count, bytes/apply, vs the gather floor.

    gather_floor_bytes is the JAX package's model of the sparse path's
    traffic on a TPU (one (8, 128) tile per nonzero row fetch); block_bytes
    is what this operator streams instead; ratio < 1 means block-dense
    moves less under that model. The same formula as the JAX package, so
    both packages pick the same operator from it.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    nnz = len(rows)
    if nnz == 0:
        return {"nnz": 0, "n_blocks": 0, "block_bytes": 0, "ratio": 0.0}
    keys = (rows // block) << 32 | (cols // block)
    nb = len(np.unique(keys))
    block_bytes = nb * block * block * itemsize
    gather_floor = nnz * 8 * 128 * itemsize  # one TPU tile per row fetch
    return {
        "nnz": int(nnz),
        "n_blocks": int(nb),
        "block_bytes": int(block_bytes),
        "gather_floor_bytes": int(gather_floor),
        "ratio": block_bytes / gather_floor,
    }


def make_flat_operator(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_in: int,
    n_out: int,
    block: int = DEFAULT_BLOCK,
    mode: str = "exact",
    max_bytes: int | None = 2 << 30,
    dense_limit: int | None = 1 << 22,
) -> BlockDenseOperator:
    """Prepack a rectangular flat (row, col, val) stream (host-side, once).

    Raises ValueError when the dense block tensor would exceed
    ``max_bytes`` (None disables the check): callers fall back to a sparse
    operator. Incidences above ``dense_limit`` elements become nested
    block-dense operators over their unit streams (None = always dense).
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    B = block
    nrb = max(1, -(-n_out // B))
    ncb = max(1, -(-n_in // B))
    if len(rows) == 0:
        return BlockDenseOperator(
            AblkT=np.zeros((0, B, B), np.float32),
            oh_rw=np.zeros((nrb, 0), np.float32),
            oh_cw=np.zeros((0, ncb), np.float32),
            n_in=int(n_in), n_out=int(n_out), block=B, mode=mode, nrb=nrb, ncb=ncb,
        )

    bkey = (rows // B) * ncb + (cols // B)
    order = np.argsort(bkey, kind="stable")
    rs, cs, vs = rows[order], cols[order], vals[order]
    ub, inv = np.unique(bkey[order], return_inverse=True)
    nb = len(ub)
    itemsize = 2 if mode == "bf16" else 4
    need = nb * B * B * itemsize
    if max_bytes is not None and need > max_bytes:
        raise ValueError(
            f"block-dense tensor would be {need / 1e9:.2f} GB "
            f"({nb} blocks of {B}x{B}) > max_bytes; use a sparse operator"
        )
    # Transposed per-block storage; duplicate (row, col) entries add, in
    # float64 as the JAX package does, then round once to float32.
    n_cells = nb * B * B
    if n_cells <= 1 << 28:
        flat_idx = (inv.astype(np.int64) * B + cs % B) * B + rs % B
        AblkT = np.bincount(
            flat_idx, weights=vs.astype(np.float64), minlength=n_cells
        ).astype(np.float32).reshape(nb, B, B)
    else:
        AblkT = np.zeros((nb, B, B), np.float32)
        np.add.at(AblkT, (inv, cs % B, rs % B), vs.astype(np.float64))
    rw = (ub // ncb).astype(np.int64)
    cw = (ub % ncb).astype(np.int64)

    def incidence(out_ids, in_ids, n_o, n_i):
        if dense_limit is None or n_o * n_i <= dense_limit:
            oh = np.zeros((n_o, n_i), np.float32)
            oh[out_ids, in_ids] = 1.0
            return oh
        # Nested operator over the unit stream; its own incidences are
        # small (the stream is a sorted staircase), so force dense. The
        # incidences run in float32 except in "fast" mode (the JAX package
        # nests "fast" for "bf16" too: on a TPU both round there).
        return make_flat_operator(
            out_ids, in_ids, np.ones(len(out_ids), np.float32),
            n_in=n_i, n_out=n_o, block=B,
            mode="fast" if mode == "fast" else "exact",
            max_bytes=None, dense_limit=None,
        )

    ar = np.arange(nb)
    return BlockDenseOperator(
        AblkT=AblkT,
        oh_rw=incidence(rw, ar, nrb, nb),
        oh_cw=incidence(ar, cw, nb, ncb),
        n_in=int(n_in), n_out=int(n_out), block=B, mode=mode, nrb=nrb, ncb=ncb,
    )


@dataclasses.dataclass(frozen=True)
class TemporalBlockDenseOperator:
    """Square per-slice SpMM as one flat block-dense operator over the
    global (t*N + i) ids; call on (T, N, F) features."""

    T: int
    N: int
    flat: BlockDenseOperator

    @property
    def n_slices(self) -> int:
        return self.T

    @property
    def n_nodes(self) -> int:
        return self.N

    @property
    def mode(self) -> str:
        return self.flat.mode

    def to(self, device: str | torch.device) -> "TemporalBlockDenseOperator":
        return dataclasses.replace(self, flat=self.flat.to(device))

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        F = X.shape[-1]
        return self.flat(X.reshape(self.T * self.N, F)).reshape(self.T, self.N, F)


def make_operator(
    A,
    block: int = DEFAULT_BLOCK,
    mode: str = "exact",
    max_bytes: int | None = 8 << 30,
    dense_limit: int | None = 1 << 22,
) -> TemporalBlockDenseOperator:
    """Prepack a TemporalCOO tensor as a block-dense operator (host-side)."""
    g_rows, g_cols, g_vals = flatten_stream(A)
    T, N = A.n_slices, A.n_nodes
    return TemporalBlockDenseOperator(
        T=T,
        N=N,
        flat=make_flat_operator(
            g_rows, g_cols, g_vals, n_in=T * N, n_out=T * N,
            block=block, mode=mode, max_bytes=max_bytes, dense_limit=dense_limit,
        ),
    )

"""Operation and byte counts, and the card's peaks.

Peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense rates at
the 700 W limit): 67 TFLOP/s in float32 outside the tensor cores (the
port trains in float32 with TF32 off) and 3.35 TB/s of HBM3. A result
states the card's power limit beside a share of these.

Counts follow one rule: each input byte is read once and each output
byte written once, whatever an implementation reads again; indices are 4
bytes, values 4. An operation's least time is the larger of its FLOPs
over the peak rate and its bytes over the peak bandwidth.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_S = 3.35e12
WORD = 4


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    flops: float
    bytes: float

    @property
    def least_s(self) -> float:
        return max(self.flops / PEAK_FLOPS_F32, self.bytes / PEAK_BYTES_S)


def least_s(ops) -> float:
    return sum(op.least_s for op in ops)


def matmul(name: str, m: int, k: int, n: int) -> Op:
    """(m, k) @ (k, n)."""
    return Op(name, 2.0 * m * k * n, WORD * (m * k + k * n + m * n))


def matmul_grads(name: str, m: int, k: int, n: int, input_grad: bool = True) -> Op:
    """The gradients of (m, k) @ (k, n) from the (m, n) cotangent: the
    weight's (k, n) and, with ``input_grad``, the input's (m, k)."""
    flops = 2.0 * m * k * n * (2 if input_grad else 1)
    words = m * n + m * k + k * n + (k * n if input_grad else 0) + (m * k if input_grad else 0)
    return Op(name, flops, WORD * words)


def elementwise(name: str, n: int, reads: int = 1, writes: int = 1, flops_each: int = 1) -> Op:
    return Op(name, float(n * flops_each), WORD * n * (reads + writes))


def spmm(name: str, nnz: int, n_out: int, n_in: int, feat: int) -> Op:
    """out (n_out, feat) = A (n_out, n_in; nnz entries) @ dense (n_in, feat):
    the entries in compressed rows (column and value each, a pointer a
    row), each used input row read once, each output row written once."""
    return Op(name, 2.0 * nnz * feat,
              WORD * (2 * nnz + n_out + 1 + n_in * feat + n_out * feat))


def scatter_rows(name: str, n_rows: int, n_out: int, feat: int) -> Op:
    """Add n_rows rows of feat into an (n_out, feat) output by a target
    index each: the rows and the indices read once, the output written."""
    return Op(name, float(n_rows * feat), WORD * (n_rows * feat + n_rows + n_out * feat))


def readout(name: str, n_edges: int, n_rows: int, feat: int, n_classes: int) -> Op:
    """Edge logits [Z[src], Z[trg]] @ U over ``n_rows`` distinct endpoint rows."""
    return Op(name, 2.0 * n_edges * 2 * feat * n_classes,
              WORD * (n_rows * feat + 2 * n_edges + 2 * feat * n_classes + n_edges * n_classes))


def readout_grads(name: str, n_edges: int, n_rows: int, feat: int, n_classes: int,
                  weight_grad: bool = True) -> Op:
    """The readout's backward: the endpoint rows' gradient (and U's)."""
    flops = 2.0 * n_edges * 2 * feat * n_classes * (2 if weight_grad else 1)
    words = n_edges * n_classes + 2 * n_edges + n_rows * feat + 2 * feat * n_classes
    words += n_rows * feat + (2 * feat * n_classes if weight_grad else 0)
    return Op(name, flops, WORD * words)


def cross_entropy(n_edges: int, n_classes: int) -> list[Op]:
    """The weighted loss and its gradient with respect to the logits."""
    return [Op("loss", 6.0 * n_edges * n_classes, WORD * (n_edges * n_classes + n_edges)),
            Op("loss_grad", 4.0 * n_edges * n_classes,
               WORD * (2 * n_edges * n_classes + n_edges))]


def sgd_momentum(n_params: int) -> Op:
    """mu = momentum·mu + g; p -= lr·mu: read p, g, mu; write p, mu."""
    return Op("sgd_momentum", 4.0 * n_params, WORD * 5 * n_params)

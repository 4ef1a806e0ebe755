"""WD-GCN's LSTM scan on Hopper: one forward and one backward launch.

``lstm_scan_cuda`` runs the shared-weight LSTM of ``models/wdgcn.py`` over a
(T, F, N) input, every node at every step, as the kernel pair of
``csrc/lstm_scan.cu``. Y (and, in the backward, dZ) may be a view with any
strides: the kernels read through them, so no copy precedes a launch. The
forward keeps each node's state on chip through all T steps and writes Z
and, when a gradient is needed, the cell states C.
The backward scans in reverse from dZ, recomputes each step's gates from Y,
Z and C, writes dY, and sums dW, dU and db per block into a partials buffer
that a second small kernel sums in a fixed order. No float atomics: two runs
are bitwise equal. What bounds the pair, and what its design does about it,
is noted at the top of the source.

The gate weights come stacked on the output axis in the order f, j, o, c
(as ``models/wdgcn._stacked_weights`` stacks them): W and U (F, 4F), b
(4F,). h0 and c0 (F,) are frozen buffers and get no gradient. Launch
counts: ``.launches`` (the forward), ``.launches_backward`` and
``.launches_reduce``; under a CUDA graph capture they count through
``spmm_cuda.LaunchLog`` at each replay, as K1's do. The wrapper launches
the kernels or raises; off the card ``models/wdgcn`` scans eagerly and never
calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from tmgcn_torch.kernels.build import load_library
from tmgcn_torch.kernels.spmm_cuda import count_launch

# The kernels' cap on F: a node's lanes are a group of F rounded up to a
# power of two within a warp, and a backward lane holds its feature's 8F + 4
# sums of dW, dU and db in registers (kMaxF in csrc/lstm_scan.cu).
MAX_F = 8
_SOURCE = "lstm_scan.cu"


def _check(Yt, W, U, b, h0, c0) -> None:
    """Raise on anything the kernels do not take, before any launch. Yt may
    be a view with any strides; the weights and states are contiguous."""
    named = {"Yt": Yt, "W": W, "U": U, "b": b, "h0": h0, "c0": c0}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.device != Yt.device:
            raise ValueError(f"{name} must be a tensor on {Yt.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {t.dtype}: the scan "
                             "kernels are float32 only")
        if name != "Yt" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Yt.dim() != 3 or min(Yt.shape) < 1:
        raise ValueError(f"Yt must be (T, F, N) with T, F, N >= 1, got {tuple(Yt.shape)}")
    F = Yt.shape[1]
    if F > MAX_F:
        raise ValueError(f"F = {F} is above the scan kernels' register cap MAX_F = {MAX_F}")
    shapes = {"W": (F, 4 * F), "U": (F, 4 * F), "b": (4 * F,), "h0": (F,), "c0": (F,)}
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(named[name].shape)}")


@functools.cache
def _entry(symbol: str, n_ptr: int, n_strides: int, n_int: int):
    """The ctypes entry point of a kernel: pointers, 64-bit strides, ints, the stream."""
    fn = getattr(load_library(_SOURCE), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * n_strides
                   + [ctypes.c_int] * n_int + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _blocks_entry():
    fn = load_library(_SOURCE).tmgcn_lstm_scan_blocks
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, tensors: list, strides: list, ints: list, counter: str) -> None:
    """One launch on the current stream; ``None`` passes a null pointer."""
    device = tensors[0].device
    ptrs = [0 if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(device):
        err = _entry(symbol, len(ptrs), len(strides), len(ints))(
            *ptrs, *strides, *ints, torch.cuda.current_stream(device).cuda_stream
        )
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    count_launch((lstm_scan_cuda, counter), torch.cuda.is_current_stream_capturing())


def _forward(Yt, W, U, b, h0, c0, cells: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Z and, with ``cells``, the cell states C the backward reads."""
    T, F, N = Yt.shape
    Z = torch.empty(T, F, N, dtype=torch.float32, device=Yt.device)
    C = torch.empty_like(Z) if cells else None
    _launch("tmgcn_lstm_scan_forward", [Yt, W, U, b, h0, c0, Z, C], [*Yt.stride()], [T, N, F],
            "launches")
    return Z, C


def _backward(Yt, W, U, b, h0, c0, Z, C, dZ) -> tuple[torch.Tensor, ...]:
    """dY (T, F, N), dW and dU (F, 4F), db (4F,)."""
    T, F, N = Yt.shape
    K = 4 * F
    n_blocks = _blocks_entry()(N, F)  # the backward's blocks: a row of partials each
    n_out = 2 * F * K + K
    dY = torch.empty_like(Z)
    partials = torch.empty(n_blocks, n_out, dtype=torch.float32, device=Yt.device)
    grads = torch.empty(n_out, dtype=torch.float32, device=Yt.device)
    _launch("tmgcn_lstm_scan_backward", [Yt, Z, C, dZ, W, U, b, h0, c0, dY, partials],
            [*Yt.stride(), *dZ.stride()], [T, N, F, n_blocks], "launches_backward")
    _launch("tmgcn_lstm_scan_sum_partials", [partials, grads], [], [n_blocks, n_out],
            "launches_reduce")
    dW, dU, db = grads.split([F * K, F * K, K])
    return dY, dW.view(F, K), dU.view(F, K), db


class _LstmScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Yt, W, U, b, h0, c0):
        Z, C = _forward(Yt, W, U, b, h0, c0, cells=True)
        ctx.save_for_backward(Yt, W, U, b, h0, c0, Z, C)
        return Z

    @staticmethod
    @once_differentiable
    def backward(ctx, dZ):
        dY, dW, dU, db = _backward(*ctx.saved_tensors, dZ)
        return dY, dW, dU, db, None, None


def lstm_scan_cuda(
    Yt: torch.Tensor, W: torch.Tensor, U: torch.Tensor, b: torch.Tensor, h0, c0
) -> torch.Tensor:
    """The LSTM scan (T, F, N) -> Z (T, F, N) as the kernel pair on a CUDA
    tensor, differentiable in Yt, W, U and b. Raises on a device, dtype,
    layout, shape or F the kernels do not take.
    """
    _check(Yt, W, U, b, h0, c0)
    if Yt.device.type != "cuda":
        raise ValueError(f"no kernel for device {Yt.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (Yt, W, U, b)):
        if h0.requires_grad or c0.requires_grad:
            raise ValueError("h0 and c0 get no gradient from the scan kernels: pass them frozen")
        return _LstmScan.apply(Yt, W, U, b, h0, c0)
    return _forward(Yt, W, U, b, h0, c0, cells=False)[0]


# Kernel launches, for run accounting: the forward, the backward scan, and
# the backward's reduction of the partials.
lstm_scan_cuda.launches = 0
lstm_scan_cuda.launches_backward = 0
lstm_scan_cuda.launches_reduce = 0

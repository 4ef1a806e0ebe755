"""The LSTM scan's dispatch and its kernel pair's wrapper, on the CPU.

On the card a float32 input with F up to ``scan_cuda.MAX_F`` takes the
kernel pair of ``tmgcn_torch/kernels/csrc/lstm_scan.cu`` (held against the
eager scan in tests/test_torch_cuda.py); here every input takes the eager
scans, unchanged. The kernel pair's wrapper refuses what the kernels do not
take, a tensor off the card included, before any launch.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tmgcn_torch.kernels import scan_cuda
from tmgcn_torch.models import wdgcn as twd

CSRC = Path(twd.__file__).resolve().parents[1] / "kernels" / "csrc" / "lstm_scan.cu"


def _lstm(F: int, dtype=torch.float64, seed: int = 0):
    """Standard-normal LSTM weights and frozen initial states, as WDGCN draws them."""
    return twd._init_lstm(torch.Generator().manual_seed(seed), F, dtype)


def _input(shape, dtype, seed: int = 1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.maximum(rng.standard_normal(shape), 0)).to(dtype)


def _eager(fn, p, h0, c0, Y, remat):
    """The eager scans of models/wdgcn.py as they were before the kernel pair."""
    if fn == "lstm_scan":
        if remat:
            return twd._lstm_scan_remat(p, h0, c0, Y.transpose(1, 2)).transpose(1, 2)
        pre = twd._pre_gates(p, Y, "fk,tnf->tkn")
    else:
        if remat:
            return twd._lstm_scan_remat(p, h0, c0, Y).transpose(1, 2)
        pre = twd._pre_gates(p, Y, "kg,tkn->tgn")
    return twd._lstm_scan_pre(p, h0, c0, pre).transpose(1, 2)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fn", ["lstm_scan", "lstm_scan_t"])
def test_cpu_inputs_take_the_eager_path(fn, dtype, remat, monkeypatch):
    """A CPU tensor, float32 or float64, never reaches the kernel pair's
    wrapper; values and gradients are the eager scan's, bitwise."""

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel pair's wrapper was called on the CPU")

    monkeypatch.setattr(scan_cuda, "lstm_scan_cuda", refuse)
    p, bufs = _lstm(4, dtype)
    shape = (10, 33, 4) if fn == "lstm_scan" else (10, 4, 33)
    G = _input((10, 33, 4), dtype, seed=2)

    def run(scan):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        Y = _input(shape, dtype).requires_grad_(True)
        out = scan(leaves, bufs["h_init"], bufs["c_init"], Y)
        (out * G).sum().backward()
        return out.detach(), Y.grad, {k: v.grad for k, v in leaves.items()}

    got = run(lambda *a: getattr(twd, fn)(*a, remat=remat))
    want = run(lambda *a: _eager(fn, *a, remat))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(got[2][k], want[2][k]) for k in p)


def test_wrapper_takes_a_strided_input():
    """Y as the GCN layer's einsum leaves it, a (T, F, N) view of (F, T, N)
    memory, passes the wrapper's checks: the kernels read it through its
    strides (held on the card in tests/test_torch_cuda.py)."""
    args = _args(F=4, T=5, N=30)
    args[0] = args[0].permute(1, 0, 2).contiguous().permute(1, 0, 2)
    assert not args[0].is_contiguous()
    scan_cuda._check(*args)


def test_stacked_weights_follow_the_gate_order():
    """Column g*F + i of W and U, entry g*F + i of b: gate g of f, j, o, c."""
    F = 3
    p, _ = _lstm(F)
    W, U, b = twd._stacked_weights(p, torch.float64)
    assert W.shape == U.shape == (F, 4 * F) and b.shape == (4 * F,)
    for g, gate in enumerate("fjoc"):
        assert torch.equal(W[:, g * F:(g + 1) * F], p[f"W{gate}"])
        assert torch.equal(U[:, g * F:(g + 1) * F], p[f"U{gate}"])
        assert torch.equal(b[g * F:(g + 1) * F], p[f"b{gate}"])


def _args(F: int = 6, T: int = 3, N: int = 20):
    p, bufs = _lstm(F, torch.float32)
    Y = _input((T, F, N), torch.float32)
    return [Y, *twd._stacked_weights(p, Y.dtype), bufs["h_init"], bufs["c_init"]]


def _float64(args, i):
    args[i] = args[i].double()
    return args


def _transposed(args, i):
    args[i] = args[i].T.contiguous().T
    return args


def _reshaped(i, shape):
    def edit(args):
        args[i] = torch.zeros(shape)
        return args
    return edit


# (what is wrong, the arguments, the message the wrapper raises with)
BAD_ARGS = {
    "Y float64": (lambda: _float64(_args(), 0), "float32"),
    "W float64": (lambda: _float64(_args(), 1), "float32"),
    "h0 float64": (lambda: _float64(_args(), 4), "float32"),
    "W not contiguous": (lambda: _transposed(_args(), 1), "W must be contiguous"),
    "U not contiguous": (lambda: _transposed(_args(), 2), "U must be contiguous"),
    "F above the cap": (lambda: _args(F=scan_cuda.MAX_F + 1), "register cap"),
    "Y of two axes": (lambda: _reshaped(0, (3, 6))(_args()), r"\(T, F, N\)"),
    "Y with no step": (lambda: _reshaped(0, (0, 6, 20))(_args()), r"\(T, F, N\)"),
    "W of another width": (lambda: _reshaped(1, (6, 20))(_args()), "W must be"),
    "U transposed": (lambda: _reshaped(2, (24, 6))(_args()), "U must be"),
    "b of another width": (lambda: _reshaped(3, (6,))(_args()), "b must be"),
    "c0 of another width": (lambda: _reshaped(5, (5,))(_args()), "c0 must be"),
    "h0 on another device": (lambda: [*_args()[:4], torch.zeros(6, device="meta"),
                                      _args()[5]], "tensor on"),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_wrapper_raises_before_any_launch(case):
    make, message = BAD_ARGS[case]
    counts = [getattr(scan_cuda.lstm_scan_cuda, c)
              for c in ("launches", "launches_backward", "launches_reduce")]
    with pytest.raises(ValueError, match=message):
        scan_cuda.lstm_scan_cuda(*make())
    assert counts == [getattr(scan_cuda.lstm_scan_cuda, c)
                      for c in ("launches", "launches_backward", "launches_reduce")]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrapper_raises_on_a_device_without_the_kernel(device):
    args = [a.to(device) for a in _args()]
    with pytest.raises(ValueError, match="no kernel for device"):
        scan_cuda.lstm_scan_cuda(*args)


def test_cap_matches_the_kernel_source():
    """MAX_F is the source's kMaxF, and the source instantiates every F up to it."""
    src = CSRC.read_text()
    assert int(re.search(r"kMaxF = (\d+);", src).group(1)) == scan_cuda.MAX_F
    cases = re.findall(r"case (\d+): fn\(std::integral_constant<int, (\d+)>", src)
    assert [(int(a), int(b)) for a, b in cases] == [(f, f) for f in range(1, scan_cuda.MAX_F + 1)]

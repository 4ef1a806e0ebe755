"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. The file imports no JAX, so it also runs on a
machine with the card and without JAX (tests/conftest.py imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerance 1e-5 · max(1, |reference|): float32 sums taken in another order
(the plain version's index_add_ uses atomics on the card).
"""

import numpy as np
import pytest
import torch

from tmgcn_torch.core.sparse import TemporalCOO
from tmgcn_torch.kernels import spmm_cuda as tk
from tmgcn_torch.ops.spmm import spmm

pytestmark = pytest.mark.cuda

ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _packing(seed, device, sort_cols=True, all_windows=True, F=2):
    """Row-sorted entries with empty windows and a window of many chunks."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([
        rng.integers(0, 300, 1500), rng.integers(640, 700, 750), rng.integers(900, 1000, 750),
    ]))
    cols = rng.integers(0, 700, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    p = tk.pack_windowed_flat(rows, cols, vals, 1000, 64, 128, sort_cols, all_windows)
    return p.to(device)


@pytest.mark.parametrize("F", [1, 2, 6, 128])
@pytest.mark.parametrize("use_init", [False, True])
def test_k1_matches_plain_and_repeats_bitwise(cuda_device, F, use_init):
    p = _packing(F, cuda_device, all_windows=not use_init)
    g = torch.randn(p.n_chunks, p.chunk, F, device=cuda_device)

    def init():
        return torch.zeros(p.n_rows_out, F, device=cuda_device) if use_init else None

    before = tk.windowed_segment_matmul.launches
    out = tk.windowed_segment_matmul(p, g, init=init())
    again = tk.windowed_segment_matmul(p, g, init=init())
    torch.cuda.synchronize()
    assert tk.windowed_segment_matmul.launches == before + 2
    ref = tk.windowed_segment_matmul_reference(p, g, init=init())
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL * scale)
    assert torch.equal(out, again)


def test_k1_operator_backward(cuda_device):
    rng = np.random.default_rng(0)
    dense = (rng.random((4, 100, 100)) < 0.08) * rng.random((4, 100, 100))
    X = rng.standard_normal((4, 100, 8)).astype(np.float32)
    G = torch.from_numpy(rng.standard_normal((4, 100, 8)).astype(np.float32))
    op = tk.make_operator(TemporalCOO.from_dense(dense, pad_multiple=16), 64, 64)
    Xc = torch.from_numpy(X).to(cuda_device).requires_grad_(True)
    (op.to(cuda_device)(Xc) * G.to(cuda_device)).sum().backward()
    Xh = torch.from_numpy(X).requires_grad_(True)
    (op(Xh) * G).sum().backward()
    torch.testing.assert_close(Xc.grad.cpu(), Xh.grad, rtol=0, atol=ATOL)


def test_k1_rejects_bf16(cuda_device):
    p = _packing(9, cuda_device)
    g = torch.randn(p.n_chunks, p.chunk, 2, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tk.windowed_segment_matmul(p, g)


def test_spmm_segment_path_is_deterministic_on_the_card(cuda_device):
    """spmm(impl="jnp"): sorted segment_reduce, no atomics, forward and backward."""
    rng = np.random.default_rng(1)
    dense = (rng.random((5, 200, 200)) < 0.05) * rng.standard_normal((5, 200, 200))
    A = TemporalCOO.from_dense(dense, pad_multiple=16)
    X = torch.from_numpy(rng.standard_normal((5, 200, 4)).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((5, 200, 4)).astype(np.float32))

    def run(device):
        Xd = X.to(device).requires_grad_(True)
        out = spmm(A.to(device), Xd)
        (out * G.to(device)).sum().backward()
        return out.detach().cpu(), Xd.grad.cpu()

    out1, g1 = run(cuda_device)
    out2, g2 = run(cuda_device)
    assert torch.equal(out1, out2) and torch.equal(g1, g2)
    out_h, g_h = run("cpu")
    torch.testing.assert_close(out1, out_h, rtol=0, atol=ATOL)
    torch.testing.assert_close(g1, g_h, rtol=0, atol=ATOL)

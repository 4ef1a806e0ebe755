"""tmgcn_torch — the PyTorch / CUDA port of tmgcn_tpu for NVIDIA Hopper.

The same framework for dynamic graph neural networks (tensor M-product
message passing, TM-GCN), written in PyTorch, with every TPU kernel of
``tmgcn_tpu`` replaced by a kernel written by hand for the H100. Module
names, function names and public signatures follow ``tmgcn_tpu`` so each
counterpart is found under the same path; the JAX package stays the
reference the port is held against.

Layout (the ported part so far: the 1-layer TM-GCN edge-classification
path):
    core/        temporal sparse tensor container, M-matrix constructors
    ops/         SpMM, M-transform, degree features, edge readout
    kernels/     hand-written CUDA kernels (csrc/) and their wrappers
    models/      TM-GCN
    preprocess/  raw edge lists -> normalized temporal adjacency tensors
    tasks/       windows, adapters, metrics
    train/       training loop, losses, metric logging
    configs/     experiment presets and run assembly

Host arrays stay numpy until they move to the device once; entry points
run on ``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from tmgcn_torch.core.sparse import TemporalCOO  # noqa: F401
from tmgcn_torch.core.mmatrix import make_m_matrix  # noqa: F401

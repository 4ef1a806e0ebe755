"""tmgcn_torch — the PyTorch / CUDA port of tmgcn_tpu for NVIDIA Hopper.

The same framework for dynamic graph neural networks (tensor M-product
message passing, TM-GCN), written in PyTorch, with every TPU kernel of
``tmgcn_tpu`` replaced by a kernel written by hand for the H100. Module
names, function names and public signatures follow ``tmgcn_tpu`` so each
counterpart is found under the same path; the JAX package stays the
reference the port is held against.

Layout (the ported part so far: TM-GCN (1 and 2 layers), KW-GCN,
EvolveGCN-H and WD-GCN; edge classification, link prediction and node
regression; checkpoints and resume; the CLI but for multi-device runs):
    core/        temporal sparse tensor container, M-matrix constructors
    ops/         SpMM, M-transform, degree features, edge readout
    kernels/     hand-written CUDA kernels (csrc/) and their wrappers
    native/      the C++ host runtime: raw-file parser, negative sampler,
                 chunk packer (built with g++ at first use)
    models/      TM-GCN, KW-GCN, EvolveGCN-H, WD-GCN
    preprocess/  raw edge lists -> normalized temporal adjacency tensors;
                 the synthetic raw files and the real-data fetcher
    tasks/       windows, negative sampling, adapters, metrics
    train/       training loop, losses, checkpoints, metric logging
    configs/     experiment presets and run assembly
    utils/       epoch profiling and the large-graph scale benchmark

Host arrays stay numpy until they move to the device once; entry points
run on ``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from tmgcn_torch.core.sparse import TemporalCOO  # noqa: F401
from tmgcn_torch.core.mmatrix import make_m_matrix  # noqa: F401

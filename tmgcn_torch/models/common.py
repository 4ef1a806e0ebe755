"""Shared model utilities (port of tmgcn_tpu.models.common).

Models are plain functional modules, as in the JAX package: a config
dataclass with ``init(generator) -> variables`` and
``apply(variables, ...) -> output``. ``variables`` is
``{"params": {...}, "buffers": {...}}``, dicts of tensors that may nest
(WD-GCN's ``params["lstm"]``); the optimizer updates every tensor of
``params`` and none of ``buffers`` (WD-GCN's frozen readout U and LSTM
initial states).
"""

from __future__ import annotations

import math

import torch


def randn(
    generator: torch.Generator,
    shape,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Standard-normal init, matching the reference's ``t.randn``.

    Drawn on the generator's device (the CPU for a default generator),
    then moved to ``device``.
    """
    out = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    return out.to(device) if device is not None else out


def linear_head(
    generator: torch.Generator,
    f: int,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The regression head's (f, 1) weight and (1,) bias, each drawn
    U(-1/√f, 1/√f) from ``generator`` as ``nn.Linear(f, 1)`` initializes
    them, weight first."""
    bound = 1.0 / math.sqrt(f)

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
        out = u * (2 * bound) - bound
        return out.to(device) if device is not None else out

    return uniform((f, 1)), uniform((1,))


def nonlinearity(name: str):
    """The interlayer nonlinearity family of the reference (nonlin2)."""
    if name == "relu":
        return torch.relu
    if name == "leaky":
        return lambda x: torch.nn.functional.leaky_relu(x, negative_slope=0.01)
    if name == "selu":
        return torch.nn.functional.selu
    raise ValueError(f"unknown nonlinearity: {name!r}")

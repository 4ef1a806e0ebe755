"""Shared model utilities (port of tmgcn_tpu.models.common).

Models are plain functional modules, as in the JAX package: a config
dataclass with ``init(generator) -> variables`` and
``apply(variables, ...) -> output``. ``variables`` is
``{"params": {name: tensor}, "buffers": {name: tensor}}``; the optimizer
updates only ``params``.
"""

from __future__ import annotations

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

"""The check that nothing the benchmark runs loads JAX or the JAX package.

Compares the top-level name of every loaded module (the part before the
first dot) whole: ``tmgcn_torch`` is not ``tmgcn_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tmgcn_tpu")


def top_level(modules=None) -> set[str]:
    return {name.split(".")[0] for name in (sys.modules if modules is None else modules)}


def forbidden_loaded(modules=None, names=FORBIDDEN) -> list[str]:
    return sorted(top_level(modules) & set(names))

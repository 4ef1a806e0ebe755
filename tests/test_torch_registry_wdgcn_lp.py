"""uci_wdgcn_lp against the JAX package: 5 epochs with two evaluations from
the same variables, negatives drawn on both sides from ``cfg.seed``
(tests/torch_registry.py's ``loop_pair``), on uci's whitespace text with
fractional-day timestamps.

WD-GCN is the costliest JAX loop of these presets (about a minute on the
CPU here), so it has a file of its own, and of the registry's WD-GCN link
prediction presets the one with the shortest window: uci's 62 slices (the
others run through ``run_experiment`` in tests/test_torch_registry_lp.py).
"""

import pytest

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.torch_registry import assert_rows_close, loop_pair, raw_copies
from tmgcn_tpu import native as jnative


def test_short_run_matches_jax(tmp_path):
    if not jnative.available():
        pytest.skip("the JAX package's C++ sampler did not load: it draws other negatives")
    with raw_copies(tmp_path, ["uci"]) as copies:
        out = loop_pair("uci_wdgcn_lp", {side: d["uci"] for side, d in copies.items()})
    assert_rows_close(*out)

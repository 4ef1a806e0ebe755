"""reddit_wdgcn_cls against the JAX package: 5 epochs with two evaluations
from the same variables (tests/torch_registry.py's ``loop_pair``), on the
reddit TSV (a header row, columns (0, 1, 4, 3)).

WD-GCN is the costliest JAX loop of these presets (its LSTM over the
window, about a minute on the CPU here), so it has a file of its own, and
of the registry's WD-GCN classification presets the one with the shortest
window: reddit's 66 slices (bitcoin's 95, amlsim's 150 run through
``run_experiment`` in tests/test_torch_registry_cls.py).
"""

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.torch_registry import assert_rows_close, loop_pair, raw_copies


def test_short_run_matches_jax(tmp_path):
    with raw_copies(tmp_path, ["reddit"]) as copies:
        out = loop_pair("reddit_wdgcn_cls", {side: d["reddit"] for side, d in copies.items()})
    assert_rows_close(*out)

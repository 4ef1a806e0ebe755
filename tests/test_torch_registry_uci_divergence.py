"""uci_tmgcn_lp diverges in both packages, from the same variables.

The registry's one 2-layer TM-GCN with M^2 and M^3 (lr 0.01) blows up
within its first epochs on the uci stand-in. ``loop_pair`` trains it 10
epochs in the JAX package (its preset's "jnp") and in the port ("pallas",
K1's plain version on the CPU) from the JAX adapter's initial variables:
the first 5 losses agree at the suite's rtol 1e-4, and both pass 1e12 at
epoch 5 and 1e18 by epoch 9. Past epoch 4 the blow-up amplifies float
rounding, so the two losses are held only to the same decade there.
"""

import numpy as np
import pytest

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.torch_registry import loop_pair, raw_copies
from tmgcn_tpu import native as jnative

EPOCHS = 10


def test_uci_tmgcn_lp_diverges_in_both_packages(tmp_path):
    if not jnative.available():
        pytest.skip("the JAX package's C++ sampler did not load: it draws other negatives")
    with raw_copies(tmp_path, ["uci"]) as dirs:
        res_t, res_j, *_ = loop_pair("uci_tmgcn_lp", {s: dirs[s]["uci"] for s in dirs},
                                     "pallas", epochs=EPOCHS, eval_every=EPOCHS)
    loss_t, loss_j = res_t[:, 2], res_j[:, 2]
    np.testing.assert_allclose(loss_t[:5], loss_j[:5], rtol=1e-4)
    for loss in (loss_t, loss_j):
        assert np.all(np.isfinite(loss)) and loss[0] < 1e4
        assert loss[5] > 1e12 and loss[9] > 1e18
    assert np.all(np.abs(np.log10(loss_t / loss_j)) < 0.1)

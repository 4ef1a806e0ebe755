"""``run --debug-nans``: the port's form of the JAX package's
``jax_debug_nans`` (``run_experiment(debug_nans=True)``,
``train.loop._NanCheckedChunks``).

seir_tmgcn_reg (untuned) diverges in both packages: its loss is finite at
epoch 0, inf at epoch 1 (an inf is not a NaN: neither package stops
there) and NaN from epoch 2 on. So the port raises ``FloatingPointError``
at epoch E = 2 and runs clean for 2 epochs; the JAX CLI with
``--debug-nans`` raises with ``--epochs 3`` (E + 1) and runs clean with
``--epochs 2`` (its check reads the chunk's outputs, and epoch 2's are the
first with a NaN; no intermediate NaN makes it fire earlier here). On runs
that stay finite the flag changes no row. The runner itself: which tensor
it names, the epoch it counts (a resumed run's too), and a backward
function's NaN (anomaly mode) turned into ``FloatingPointError``.
"""

import jax
import numpy as np
import pytest
import torch

from tests import torch_jax_native  # noqa: F401  (the JAX native library, built whole)
from tests.torch_registry import raw_copies
from tmgcn_tpu import cli as jcli
from tmgcn_torch import cli
from tmgcn_torch.configs import build as tbuild
from tmgcn_torch.configs.presets import get_preset
from tmgcn_torch.train import loop as tloop

FIRST_NAN_EPOCH = 2  # seir_tmgcn_reg: loss finite, inf, then NaN


def test_port_raises_at_the_first_nan_epoch():
    cfg = get_preset("seir_tmgcn_reg")
    plain = tbuild.run_experiment(cfg, n_epochs=FIRST_NAN_EPOCH + 1, verbose=False,
                                  device="cpu")["results"][(0, None)]["train_loss"]
    assert np.isfinite(plain[0]) and np.isinf(plain[1]) and np.isnan(plain[FIRST_NAN_EPOCH])
    with pytest.raises(FloatingPointError, match=f"NaN at epoch {FIRST_NAN_EPOCH}"):
        tbuild.run_experiment(cfg, verbose=False, device="cpu", debug_nans=True)
    clean = tbuild.run_experiment(cfg, n_epochs=FIRST_NAN_EPOCH, verbose=False, device="cpu",
                                  debug_nans=True)["results"][(0, None)]
    np.testing.assert_array_equal(clean["train_loss"], plain[:FIRST_NAN_EPOCH])


def test_cli_debug_nans_raises():
    with pytest.raises(FloatingPointError, match=f"epoch {FIRST_NAN_EPOCH}"):
        cli.main(["run", "seir_tmgcn_reg", "--debug-nans", "--device", "cpu", "--quiet"])


@pytest.mark.parametrize("epochs,raises", [(FIRST_NAN_EPOCH, False),
                                           (FIRST_NAN_EPOCH + 1, True)])
def test_jax_cli_raises_where_the_port_does(epochs, raises):
    argv = ["run", "seir_tmgcn_reg", "--debug-nans", "--epochs", str(epochs), "--quiet"]
    try:
        if raises:
            with pytest.raises(FloatingPointError):
                jcli.main(argv)
        else:
            assert jcli.main(argv) == 0
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("preset,epochs", [("bitcoin_otc_tmgcn_cls", 5), ("uci_gcn_lp", 4),
                                           ("seir_tmgcn_reg_tuned", 5)])
def test_finite_runs_keep_their_rows(tmp_path, preset, epochs):
    """The same run with and without the flag: the same rows, bitwise."""
    cfg = get_preset(preset)
    datasets = [] if cfg.dataset == "seir" else [cfg.dataset]
    with raw_copies(tmp_path, datasets, ("torch",)) as copies:
        runs = [tbuild.run_experiment(cfg, data_dir=copies["torch"].get(cfg.dataset),
                                      n_epochs=epochs, alpha_vec=cfg.alpha_vec[:1] or None,
                                      verbose=False, device="cpu", debug_nans=flag)["results"]
                for flag in (False, True)]
    assert list(runs[0]) == list(runs[1])
    for key, a in runs[0].items():
        b = runs[1][key]
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_array_equal(a, b)


class _FakeStep:
    """A step whose loss, or one gradient, is NaN at one epoch."""

    def __init__(self, bad_epoch: int, bad: str):
        self.W = torch.zeros(2, requires_grad=True)
        self.b = torch.zeros(3, requires_grad=True)
        self.variables = {"params": {"W": self.W, "cell": {"b": self.b}}}
        self.capacity = 10
        self.bad_epoch, self.bad, self.epoch = bad_epoch, bad, 0

    check = None

    def __call__(self):
        nan = self.epoch == self.bad_epoch
        loss = torch.tensor(float("nan") if nan and self.bad == "loss" else 1.0)
        gb = torch.full((3,), float("nan") if nan and self.bad == "b" else 0.5)
        self.check(loss, [torch.ones(2), gb])
        self.epoch += 1
        return None, ()


@pytest.mark.parametrize("bad,name", [("loss", "loss"), ("b", "the gradient of cell.b")])
def test_runner_names_the_tensor_and_the_epoch(bad, name):
    chunks = tloop._NanCheckedChunks(_FakeStep(3, bad))
    chunks(2)
    chunks(1)
    with pytest.raises(FloatingPointError, match=f"NaN at epoch 3: {name}$"):
        chunks(4)
    assert chunks.n_done == 3


def test_runner_counts_a_resumed_run_s_epochs():
    chunks = tloop._NanCheckedChunks(_FakeStep(1, "loss"))
    chunks.resumed = (9, np.zeros((20, 12)))
    with pytest.raises(FloatingPointError, match="NaN at epoch 11: loss"):
        chunks(5)


def test_a_backward_nan_becomes_floating_point_error():
    """Anomaly mode's RuntimeError for a backward function that returned
    NaN is raised as FloatingPointError; any other error passes as it is."""
    class Step(_FakeStep):
        def __call__(self):
            x = torch.tensor([-1.0], requires_grad=True)
            torch.autograd.grad(torch.sqrt(x * 0.0).sum() * 0.0 + (x * 0.0).sum(), x)
            return None, ()

    with pytest.raises(FloatingPointError, match="NaN at epoch 0: Function .* returned nan"):
        tloop._NanCheckedChunks(Step(0, "loss"))(1)

    class Broken(_FakeStep):
        def __call__(self):
            raise RuntimeError("another failure")

    with pytest.raises(RuntimeError, match="another failure"):
        tloop._NanCheckedChunks(Broken(0, "loss"))(1)

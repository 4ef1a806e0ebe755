"""Import hygiene and device policy of the port.

Every module of tmgcn_torch (and chip_smoke.py) must import in a process
where JAX and the JAX package cannot be imported at all; entry points
must refuse to run without a card unless the caller asks for the CPU.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tmgcn_torch import cli
from tmgcn_torch.configs import build
from tmgcn_torch.configs.presets import get_preset

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORTS = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "optax", "tmgcn_tpu")
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import tmgcn_torch
names = [m.name for m in pkgutil.walk_packages(tmgcn_torch.__path__, "tmgcn_torch.")]
assert "tmgcn_torch.tasks.sampling" in names  # the negative sampler keeps its own stream
assert {"tmgcn_torch.utils.profiling", "tmgcn_torch.utils.spmm_bench",
        "tmgcn_torch.utils.kernel_probe"} <= set(names)
# the synthetic data keep their own copies of the JAX package's generators
assert {"tmgcn_torch.preprocess.seir", "tmgcn_torch.preprocess.sbm"} <= set(names)
# so do the checkpoints, the raw-file generators and the fetcher
assert {"tmgcn_torch.train.checkpoint", "tmgcn_torch.preprocess.synthetic_raw",
        "tmgcn_torch.preprocess.fetch"} <= set(names)
# and the mesh (torch.distributed in place of shard_map)
assert {f"tmgcn_torch.parallel.{m}" for m in ("mesh", "distributed", "collectives", "partition",
        "halo", "tmgcn_sharded", "adapter")} <= set(names)
# and the native host runtime (its own C++ source, built and loaded here)
assert {"tmgcn_torch.native", "tmgcn_torch.native.build"} <= set(names)
for name in names:
    importlib.import_module(name)
from tmgcn_torch import native
native.load()
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every module was walked


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_run_experiment_needs_a_card_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build.run_experiment(get_preset("chess_tmgcn_cls"), data_dir=ROOT / "data" / "chess")


def test_cli_run_needs_a_card_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", "chess_tmgcn_cls", "--data-dir", str(ROOT / "data" / "chess")])


@pytest.mark.parametrize("preset", ["chess_tmgcn_lp", "chess_wdgcn_lp"])
def test_link_prediction_needs_a_card_by_default(no_cuda, preset):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build.run_experiment(get_preset(preset), data_dir=ROOT / "data" / "chess")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", preset, "--data-dir", str(ROOT / "data" / "chess")])


def test_resolve_device(no_cuda):
    assert build.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        build.resolve_device(None)
    with pytest.raises(RuntimeError):
        build.resolve_device("cuda:0")


def test_cli_list(capsys):
    assert cli.main(["list"]) == 0
    assert "chess_tmgcn_cls" in capsys.readouterr().out


@pytest.mark.parametrize(
    "preset,kwargs",
    [
        ("chess_evolvegcn2_cls", {"mesh_shape": (2, 1)}),
        ("chess_tmgcn_lp", {"mesh_shape": (1, 2)}),
        ("chess_tmgcn_cls", {"mesh_shape": (4, 1), "checkpoint_dir": "ck"}),
        ("chess_tmgcn_cls", {"mesh_shape": (2, 1)}),
    ],
)
def test_unported_paths_raise(preset, kwargs):
    """Every family shards now (the recurrent ones over graph, with and
    without checkpoints); a mesh larger than the world (this process alone,
    no launcher) raises naming the world size, before any data is built."""
    G, T = kwargs["mesh_shape"]
    with pytest.raises(ValueError, match=rf"mesh {G}x{T} != 1 devices \(the world size\)"):
        build.run_experiment(
            get_preset(preset), data_dir=ROOT / "data" / "chess", device="cpu", **kwargs
        )
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
for name in names:
    importlib.import_module(name)
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
    assert int(out.stdout.strip()) >= 25  # every module was walked


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_run_experiment_needs_a_card_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build.run_experiment(get_preset("chess_tmgcn_cls"), data_dir=ROOT / "data" / "chess")


def test_cli_run_needs_a_card_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", "chess_tmgcn_cls", "--data-dir", str(ROOT / "data" / "chess")])


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
        ("chess_tmgcn2_cls", {}),
        ("chess_tmgcn_lp", {}),
        ("chess_tmgcn_cls", {"checkpoint_dir": "ck"}),
        ("chess_tmgcn_cls", {"mesh_shape": (2, 1)}),
    ],
)
def test_unported_paths_raise(preset, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build.run_experiment(
            get_preset(preset), data_dir=ROOT / "data" / "chess", device="cpu", **kwargs
        )

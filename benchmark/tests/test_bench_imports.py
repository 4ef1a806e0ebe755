"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference and the counts load nothing of the
port."""

import subprocess
import sys

from benchmark import imports
from benchmark.tests.tiny import ROOT


def test_top_level_names_compared_whole():
    mods = ["tmgcn_torch", "tmgcn_torch.ops", "jaxtyping", "numpy"]
    assert imports.forbidden_loaded(mods) == []
    assert imports.forbidden_loaded(mods + ["jax.numpy"]) == ["jax"]
    assert imports.forbidden_loaded(["tmgcn_tpu.models", "flax.linen"]) == ["flax", "tmgcn_tpu"]


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    code = ("import torch\nfrom benchmark import harness, run, calibrate\n"
            "from benchmark.imports import forbidden_loaded\nassert not forbidden_loaded()")
    loaded = _loaded_after(code)
    assert "'tmgcn_torch'" in loaded and "'jax'" not in loaded and "'tmgcn_tpu'" not in loaded


def test_reference_and_counts_load_no_port():
    code = ("import benchmark.reference.data, benchmark.reference.train, "
            "benchmark.reference.tmgcn2, benchmark.reference.wdgcn, benchmark.cost.common\n"
            "import pathlib\nfrom benchmark.harness import _load\n"
            "for p in pathlib.Path('benchmark/cost').glob('*.py'):\n"
            "    _load(p)")
    loaded = _loaded_after(code.replace("from benchmark.harness import _load", _LOAD))
    assert "'tmgcn_torch'" not in loaded and "'jax'" not in loaded


# harness imports the port; the same loader, alone.
_LOAD = ("import importlib.util, sys\n"
         "def _load(p):\n"
         "    s = importlib.util.spec_from_file_location('m_' + p.stem, p)\n"
         "    m = importlib.util.module_from_spec(s)\n"
         "    sys.modules['m_' + p.stem] = m\n"
         "    s.loader.exec_module(m)")
